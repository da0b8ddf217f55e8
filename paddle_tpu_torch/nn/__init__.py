from . import functional, initializer, quant, utils  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue)
from .decode import BeamSearchDecoder, Decoder, dynamic_decode  # noqa: F401
from .layer import *  # noqa: F401,F403
from .layer.layers import Layer  # noqa: F401
from ..framework.param_attr import ParamAttr  # noqa: F401
