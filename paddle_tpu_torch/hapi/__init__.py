from . import callbacks, model_summary  # noqa: F401
from .model import Model  # noqa: F401
from .model_summary import summary  # noqa: F401
