"""Generative serving: continuous batching over a paged KV cache."""
from .generation import (EngineOverloaded, GenerationConfig,  # noqa: F401
                         GenerationEngine, TokenStream)
from .kv_cache import TRASH_PAGE, PagedKVCache  # noqa: F401

__all__ = ["EngineOverloaded", "GenerationConfig", "GenerationEngine",
           "PagedKVCache", "TokenStream", "TRASH_PAGE"]
