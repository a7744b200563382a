from . import math3d, halton  # noqa: F401
