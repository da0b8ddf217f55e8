from .activation import *  # noqa: F401,F403
from .activation import __all__ as _activations
from .attention import scaled_dot_product_attention  # noqa: F401
from .common import *  # noqa: F401,F403
from .common import __all__ as _common
from .conv import *  # noqa: F401,F403
from .conv import __all__ as _conv
from .loss import *  # noqa: F401,F403
from .loss import __all__ as _loss
from .norm import *  # noqa: F401,F403
from .norm import __all__ as _norm
from .pooling import *  # noqa: F401,F403
from .pooling import __all__ as _pooling
from ...ops.extra_ops import (affine_grid, channel_shuffle,  # noqa: F401
                              gather_tree, max_unpool2d, pixel_unshuffle,
                              temporal_shift)

__all__ = (list(_activations) + ["scaled_dot_product_attention"]
           + list(_common) + list(_conv) + list(_loss) + list(_norm)
           + list(_pooling) + ["affine_grid", "channel_shuffle",
                               "gather_tree", "max_unpool2d",
                               "pixel_unshuffle", "temporal_shift"])
