from . import pick_cube  # noqa: F401
from . import pick_single_hull  # noqa: F401
from . import plug_charger  # noqa: F401
from . import rotate_in_hand  # noqa: F401
from . import stack_cube  # noqa: F401
from . import tabletop_extra  # noqa: F401
from . import ycb_variants  # noqa: F401
