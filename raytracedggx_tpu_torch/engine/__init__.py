from .renderer import Renderer, RenderConfig, RenderState  # noqa: F401
