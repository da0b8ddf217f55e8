"""Global flags registry: the flags the serving and training slices read.

Same names and defaults as `paddle_tpu.framework.flags`. A default that
was measured there was measured on a TPU, and each help string says so;
none of those numbers has been measured on a GPU yet."""
from __future__ import annotations

import os
from typing import Any, Dict, Iterable

from .errors import InvalidArgumentError

__all__ = ["set_flags", "get_flags", "register_flag", "flag"]

_FLAGS: Dict[str, Any] = {}


def register_flag(name: str, default: Any, doc: str = "") -> None:
    env = os.environ.get(name)
    if env is not None:
        if isinstance(default, bool):
            default = env.lower() in ("1", "true", "yes")
        elif isinstance(default, int):
            default = int(env)
        elif isinstance(default, float):
            default = float(env)
        else:
            default = env
    _FLAGS[name] = default


register_flag("FLAGS_use_flash_attention", True,
              "dispatch F.scaled_dot_product_attention to flash attention "
              "(ops.flash_ops.flash_attention) for shapes that pass "
              "flash_supported, with or without dropout and grad: CUDA "
              "tensors launch the hand-written kernels csrc/flash_fwd.cu "
              "(forward) and csrc/flash_bwd_{dq,dkv}.cu (backward), CPU "
              "tensors run their plain versions. Not a measured default")
register_flag("FLAGS_flash_attention_min_seq", 512,
              "shortest query length dispatched to the flash kernel. The "
              "512 default is the crossover the JAX package measured on a "
              "TPU (v5e); it has not been measured on a GPU")
register_flag("FLAGS_use_splash_attention", True,
              "dispatch F.scaled_dot_product_attention(segment_ids=...) to "
              "splash attention (ops.splash_ops.splash_attention) for "
              "shapes that pass splash_supported: CUDA tensors launch the "
              "hand-written kernels csrc/splash_fwd.cu (forward) and "
              "csrc/splash_bwd_{dq,dkv}.cu (backward), CPU tensors run "
              "their plain versions; off takes the dense segment-masked "
              "attention. Not a measured default")
register_flag("FLAGS_splash_attention_min_seq", 512,
              "shortest packed row dispatched to the splash kernels. The "
              "512 default is the JAX package's TPU value; the crossover "
              "has not been measured on a GPU")
register_flag("FLAGS_use_paged_attention", True,
              "decode attention over the paged KV cache: CUDA tensors "
              "launch the paged decode kernel (csrc/paged_attention.cu), "
              "off gathers the page table into a dense cache and runs the "
              "plain masked attention. Not a measured default")
register_flag("FLAGS_kv_cache_dtype", "auto",
              "page dtype of serving.PagedKVCache pools: 'auto' stores "
              "pages in the served model's dtype, 'float32'/'bfloat16' "
              "force one. 'int8' is not ported yet. Not a measured default")
register_flag("FLAGS_paged_page_size", 16,
              "tokens per KV-cache page. The JAX package chose 16 for the "
              "TPU kernel's multiple-of-8 rule; not measured on a GPU")
register_flag("FLAGS_paged_num_pages", 512,
              "total pages in the per-layer K/V pools (page 0 is reserved "
              "scratch, so usable pages = this - 1); pool bytes = "
              "2*layers*heads*pages*page_size*head_dim*dtype. Not a "
              "measured default")
register_flag("FLAGS_paged_pages_per_seq", 0,
              "page-table width (most pages one sequence may hold); 0 "
              "derives ceil(max_position_embeddings / page_size)")
register_flag("FLAGS_gen_max_slots", 8,
              "serving.GenerationEngine: fixed decode-batch slot count; "
              "live sequences join and leave the batch without changing "
              "its shape. Not a measured default")
register_flag("FLAGS_gen_prefill_buckets", "16,64,256",
              "serving.GenerationEngine: prompt-length buckets a prompt is "
              "right-padded up to (clipped to max_position_embeddings). "
              "Not a measured default")
register_flag("FLAGS_gen_max_new_tokens", 64,
              "serving.GenerationEngine: default per-request new-token "
              "budget (admission reserves worst-case pages for it)")
register_flag("FLAGS_gen_max_queue_depth", 256,
              "serving.GenerationEngine: pending-request bound; submits "
              "beyond it fail fast with EngineOverloaded")
register_flag("FLAGS_gen_request_timeout_ms", 30000.0,
              "serving.GenerationEngine: default per-request deadline, "
              "enforced while queued and before every decode step "
              "(0 disables)")
register_flag("FLAGS_gen_prefix_cache", False,
              "serving.GenerationEngine: content-hash prefix cache over "
              "the paged KV pools (serving/prefix_cache.py) — a request "
              "whose prompt prefix matches a cached block chain maps "
              "those pages read-only (copy-on-write on the one "
              "divergent write) and prefills only the tail; refcount-0 "
              "chains are LRU-evicted before alloc. Opt-in: off keeps "
              "the single-owner page semantics exactly")
register_flag("FLAGS_gen_spec_k", 0,
              "serving.GenerationEngine: speculative-decoding draft "
              "tokens per decode step (serving/spec_decode.py prompt-"
              "lookup proposer + ONE fixed-k verify program scoring k+1 "
              "positions over the paged KV cache per step; the longest "
              "greedily-agreeing draft prefix is accepted plus the bonus "
              "token, so a step delivers 1 to k+1 tokens — greedy output "
              "stays token-identical to speculation off). 0 disables "
              "(the plain one-token decode program)")
register_flag("FLAGS_gen_spec_ngram", 3,
              "serving.GenerationEngine: longest n-gram the prompt-"
              "lookup draft proposer matches against the sequence's "
              "own token history (tried n..1, rightmost match wins); "
              "only read when FLAGS_gen_spec_k > 0")
register_flag("FLAGS_gen_prefill_chunk", 0,
              "serving.GenerationEngine: split prompts longer than "
              "this into fixed-size prefill chunks driven through the "
              "per-bucket tail-extension programs, ONE chunk per "
              "engine iteration interleaved with decode steps — a "
              "long prompt admitting no longer stalls every live "
              "sequence's TPOT for its whole prefill. 0 disables "
              "(whole-prompt bucketed prefill at admission)")
register_flag("FLAGS_gen_prefix_cache_max_pages", 0,
              "serving.GenerationEngine: byte budget for the prefix "
              "cache as a page-count cap — register() eagerly LRU-"
              "evicts cached chains back to this budget instead of "
              "waiting for an admission to run short of free pages. "
              "0 = unbounded (evict-on-demand only)")


def set_flags(flags: Dict[str, Any]) -> None:
    for k, v in flags.items():
        if k not in _FLAGS:
            raise InvalidArgumentError(f"Unknown flag {k!r}")
        _FLAGS[k] = v


def get_flags(names: Iterable[str] | str) -> Dict[str, Any]:
    if isinstance(names, str):
        names = [names]
    return {n: _FLAGS[n] for n in names}


def flag(name: str) -> Any:
    return _FLAGS[name]
