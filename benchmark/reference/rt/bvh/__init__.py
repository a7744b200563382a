from .lbvh import LBVH, build_lbvh  # noqa: F401
from .tlas import TLAS, build_tlas  # noqa: F401
