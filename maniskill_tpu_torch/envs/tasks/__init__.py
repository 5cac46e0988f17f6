from . import pick_cube  # noqa: F401
