"""Generative serving: continuous batching over a paged KV cache (float
or int8 pages; a `quantization.quantize_weights`'d model serves as any
other), with a host demotion tier under the prefix cache and
flag-armed fault injection (`failpoints`)."""
from . import failpoints  # noqa: F401
from .generation import (EngineOverloaded, GenerationConfig,  # noqa: F401
                         GenerationEngine, TokenStream)
from .kv_cache import TRASH_PAGE, PagedKVCache  # noqa: F401
from .kv_tier import HostEntry, HostSlab, HostTier  # noqa: F401
from .prefix_cache import PrefixCache, chain_digests  # noqa: F401
from .spec_decode import NGramProposer  # noqa: F401

__all__ = ["EngineOverloaded", "GenerationConfig", "GenerationEngine",
           "HostEntry", "HostSlab", "HostTier", "NGramProposer",
           "PagedKVCache", "PrefixCache", "TokenStream", "TRASH_PAGE",
           "chain_digests", "failpoints"]
