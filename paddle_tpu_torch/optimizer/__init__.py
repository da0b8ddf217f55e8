from . import lr  # noqa: F401
from .optimizer import Optimizer  # noqa: F401
from .optimizers import (SGD, Adadelta, Adagrad, Adam, Adamax,  # noqa: F401
                         AdamW, Lamb, LarsMomentum, Momentum, RMSProp)
