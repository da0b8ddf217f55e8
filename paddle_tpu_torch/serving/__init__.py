"""Generative serving: continuous batching over a paged KV cache (float
or int8 pages; a `quantization.quantize_weights`'d model serves as any
other)."""
from .generation import (EngineOverloaded, GenerationConfig,  # noqa: F401
                         GenerationEngine, TokenStream)
from .kv_cache import TRASH_PAGE, PagedKVCache  # noqa: F401
from .prefix_cache import PrefixCache, chain_digests  # noqa: F401
from .spec_decode import NGramProposer  # noqa: F401

__all__ = ["EngineOverloaded", "GenerationConfig", "GenerationEngine",
           "NGramProposer", "PagedKVCache", "PrefixCache", "TokenStream",
           "TRASH_PAGE", "chain_digests"]
