from .activation import *  # noqa: F401,F403
from .activation import __all__ as _activations
from .attention import scaled_dot_product_attention  # noqa: F401
from .common import dropout, embedding, linear  # noqa: F401
from .loss import cross_entropy  # noqa: F401
from .norm import layer_norm  # noqa: F401

__all__ = list(_activations) + [
    "scaled_dot_product_attention", "dropout", "embedding", "linear",
    "cross_entropy", "layer_norm"]
