from . import pick_cube  # noqa: F401
from . import stack_cube  # noqa: F401
