from . import sharding  # noqa: F401
