from .sh9 import project_sh9, evaluate_sh_irradiance, SH_NUM_COEFF  # noqa: F401
