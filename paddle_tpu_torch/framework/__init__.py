from . import dtype, errors, flags, io_state, monitor, param_attr  # noqa
from . import place, random  # noqa: F401
from .dtype import (DType, bfloat16, bool_, complex64, complex128,  # noqa
                    convert_dtype, float16, float32, float64, int8, int16,
                    int32, int64, uint8)
from .flags import flag, get_flags, set_flags  # noqa: F401
from .place import (CPUPlace, CUDAPlace, Place, TPUPlace,  # noqa: F401
                    default_place, get_device, resolve_device, set_device)
from .random import rng_scope, seed  # noqa: F401
from .selected_rows import SelectedRows  # noqa: F401
from ..autograd import (backward, enable_grad, grad,  # noqa: F401,E402
                        is_grad_enabled, no_grad)
from ..ops.creation import to_tensor  # noqa: F401,E402
