from .spatial import (reflection_spatial_filter, diffuse_spatial_filter,  # noqa: F401
                      tm, itm)
from .temporal import temporal_ss  # noqa: F401
