from . import callbacks  # noqa: F401
from .model import Model  # noqa: F401
