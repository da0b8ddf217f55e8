from .activation import GELU  # noqa: F401
from .common import Dropout, Embedding, Linear  # noqa: F401
from .loss import CrossEntropyLoss  # noqa: F401
from .norm import LayerNorm  # noqa: F401
