from .obj import load_obj  # noqa: F401
from .png import write_png  # noqa: F401
