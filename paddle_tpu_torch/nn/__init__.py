from . import functional, initializer, quant  # noqa: F401
from .clip import ClipGradByGlobalNorm  # noqa: F401
from .layer import *  # noqa: F401,F403
