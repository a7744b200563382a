from .mesh import Mesh, ground_cube  # noqa: F401
from .camera import Camera  # noqa: F401
from .material import Materials, default_materials  # noqa: F401
from .scene import Scene, GROUND, MODEL, NUM_MESH  # noqa: F401
