from .activation import *  # noqa: F401,F403
from .activation import __all__ as _activation
from .common import Dropout, Embedding, Linear  # noqa: F401
from .container import *  # noqa: F401,F403
from .container import __all__ as _container
from .loss import CrossEntropyLoss  # noqa: F401
from .norm import LayerNorm  # noqa: F401
from .transformer import *  # noqa: F401,F403
from .transformer import __all__ as _transformer

__all__ = (list(_activation) + ["Dropout", "Embedding", "Linear"]
           + list(_container) + ["CrossEntropyLoss", "LayerNorm"]
           + list(_transformer))
