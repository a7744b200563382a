from .tonemap import tone_map  # noqa: F401
