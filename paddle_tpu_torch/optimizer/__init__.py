from . import lr  # noqa: F401
from .optimizer import Optimizer  # noqa: F401
from .optimizers import SGD, Adam, AdamW, Momentum  # noqa: F401
