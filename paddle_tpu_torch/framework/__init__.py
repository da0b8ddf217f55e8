from . import errors, flags, monitor, place, random  # noqa: F401
from .flags import flag, get_flags, set_flags  # noqa: F401
from .place import resolve_device  # noqa: F401
