from .tlas import TLAS, build_tlas  # noqa: F401
