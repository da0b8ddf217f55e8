from . import functional  # noqa: F401
from .clip import ClipGradByGlobalNorm  # noqa: F401
from .layer import CrossEntropyLoss  # noqa: F401
