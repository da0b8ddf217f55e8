from .activation import *  # noqa: F401,F403
from .activation import __all__ as _activation
from .common import Dropout, Embedding, Linear  # noqa: F401
from .container import *  # noqa: F401,F403
from .container import __all__ as _container
from .conv import *  # noqa: F401,F403
from .conv import __all__ as _conv
from .loss import CrossEntropyLoss  # noqa: F401
from .norm import *  # noqa: F401,F403
from .norm import __all__ as _norm
from .pooling import *  # noqa: F401,F403
from .pooling import __all__ as _pooling
from .transformer import *  # noqa: F401,F403
from .transformer import __all__ as _transformer

__all__ = (list(_activation) + ["Dropout", "Embedding", "Linear"]
           + list(_container) + list(_conv) + ["CrossEntropyLoss"]
           + list(_norm) + list(_pooling) + list(_transformer))
