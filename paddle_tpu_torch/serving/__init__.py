"""Generative serving: continuous batching over a paged KV cache (float
or int8 pages; a `quantization.quantize_weights`'d model serves as any
other), with a host demotion tier under the prefix cache, flag-armed fault
injection (`failpoints`), supervised restart with request replay
(`EngineSupervisor`: crash manifests, exactly-once streams, the
crash-storm breaker, degraded modes) and the prefix-affinity `Router` over
supervised replicas; and the micro-batching `InferenceEngine` over
`jit.save` artifacts (per-card dispatch lanes on their own CUDA streams);
`ProgramStore`, the generation engine's on-disk store of its
`torch.export` programs."""
from . import failpoints  # noqa: F401
from .engine import EngineConfig, InferenceEngine  # noqa: F401
from .generation import (CrashManifest, EngineOverloaded,  # noqa: F401
                         GenerationConfig, GenerationEngine, ReplayEntry,
                         TokenStream)
from .kv_cache import TRASH_PAGE, PagedKVCache  # noqa: F401
from .kv_tier import HostEntry, HostSlab, HostTier  # noqa: F401
from .prefix_cache import PrefixCache, chain_digests  # noqa: F401
from .program_store import ProgramStore  # noqa: F401
from .restart import CrashBreaker, RestartBackoff  # noqa: F401
from .router import Router  # noqa: F401
from .spec_decode import NGramProposer  # noqa: F401
from .supervisor import EngineSupervisor  # noqa: F401

__all__ = ["InferenceEngine", "EngineConfig",
           "CrashBreaker", "CrashManifest", "EngineOverloaded",
           "EngineSupervisor", "GenerationConfig", "GenerationEngine",
           "HostEntry", "HostSlab", "HostTier", "NGramProposer",
           "PagedKVCache", "PrefixCache", "ProgramStore", "ReplayEntry",
           "RestartBackoff",
           "Router", "TokenStream", "TRASH_PAGE", "chain_digests",
           "failpoints"]
