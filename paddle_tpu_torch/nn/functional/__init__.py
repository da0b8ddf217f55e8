from .activation import *  # noqa: F401,F403
from .activation import __all__ as _activations
from .attention import scaled_dot_product_attention  # noqa: F401
from .common import dropout, embedding, linear  # noqa: F401
from .conv import *  # noqa: F401,F403
from .conv import __all__ as _conv
from .loss import cross_entropy  # noqa: F401
from .norm import *  # noqa: F401,F403
from .norm import __all__ as _norm
from .pooling import *  # noqa: F401,F403
from .pooling import __all__ as _pooling

__all__ = list(_activations) + [
    "scaled_dot_product_attention", "dropout", "embedding", "linear",
    "cross_entropy"] + list(_conv) + list(_norm) + list(_pooling)
