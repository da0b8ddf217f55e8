from . import functional  # noqa: F401
from .clip import ClipGradByGlobalNorm  # noqa: F401
from .layer import (GELU, CrossEntropyLoss, Dropout, Embedding,  # noqa: F401
                    LayerNorm, Linear)
