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
              "pages in the served model's dtype; 'int8' enables the "
              "quantized page mode — int8 pools + per-(layer,head,page) "
              "fp32 scale pools, quantize-on-append / dequantize-on-"
              "read (ops/paged_ops.py), ~4x pages per device byte so the "
              "same pool budget admits ~4x the concurrent sequences; "
              "'float32'/'bfloat16' force an unquantized page dtype")
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
register_flag("FLAGS_gen_tp", 1,
              "serving.GenerationEngine: tensor-parallel degree of the "
              "lane: that many ranks of the process group (one a card) "
              "each hold the heads/tp slice of every attention and MLP "
              "projection and of the paged K/V pools (+ int8 scale "
              "grids), the row-parallel partial sums all-reduced once "
              "a projection; rank 0 owns the scheduler and broadcasts "
              "each program call to the others. 1 = one card")
register_flag("FLAGS_gen_tp_timeout_s", 300.0,
              "serving tp lane: the bound, in seconds, on each collective "
              "of a lane's tp group. A rank that faults inside a program "
              "leaves the others waiting in an all-reduce; past this "
              "bound they end the lane with a typed LaneFault naming "
              "that rank. It must cover the slowest program's skew "
              "between ranks (a first call that builds the kernels). "
              "Read when the lane is built")
register_flag("FLAGS_gen_program_store_dir", "",
              "serving.GenerationEngine: root directory of the on-disk "
              "program store (serving/program_store.py). At warmup each "
              "covered program (prefill/tail/decode/verify/cow_copy) is "
              "loaded as a torch.export program saved under a content "
              "key; a miss exports it and writes it back, so a fresh "
              "process serves without tracing. Every load runs an "
              "in-place self-check and a numeric probe first. Empty = "
              "off")
register_flag("FLAGS_gen_program_store_force", False,
              "serving.GenerationEngine: use the program store even where "
              "device.serialization_unsafe_backend() is True, with a "
              "one-time warning; every load still runs the in-place "
              "self-check and the numeric probe and falls back to an "
              "export on any mismatch")
register_flag("FLAGS_xla_compilation_cache", True,
              "keep the kernel build cache (the nvcc libraries of "
              "csrc/*.cu) in FLAGS_xla_compilation_cache_dir when that "
              "flag names a directory; read at the first kernel build "
              "(device.maybe_enable_compilation_cache). The name is the "
              "JAX package's")
register_flag("FLAGS_xla_compilation_cache_dir", "",
              "directory of the kernel build cache: where ops/_build.py "
              "writes and looks up its nvcc libraries. Empty = "
              "build/paddle_tpu_torch in the checkout")
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

register_flag("FLAGS_kv_tier", False,
              "serving.GenerationEngine: host-memory demotion tier under "
              "the prefix cache (serving/kv_tier.py): a prefix-cache "
              "eviction copies a cold chain's pages off the device into "
              "a bounded host store (raw int8 bytes and fp32 scale rows, "
              "so the round trip is exact) instead of discarding them, "
              "and a later lookup that misses the device but hits the "
              "host tier re-uploads the pages in chunks on a side CUDA "
              "stream ahead of the tail prefill. Requires "
              "FLAGS_gen_prefix_cache; off keeps the two-state (device "
              "or gone) prefix cache")
register_flag("FLAGS_kv_tier_host_bytes", 256 << 20,
              "serving/kv_tier.py host-store byte budget: demoted page "
              "entries beyond it are LRU-evicted (audit code "
              "KV_TIER_EVICT); an entry that alone exceeds the budget "
              "is refused and the eviction proceeds plain")
register_flag("FLAGS_kv_tier_chunk_pages", 4,
              "pages per upload chunk of the promotion pipeline "
              "(serving/kv_tier.py): the engine stages chunk i+1 while "
              "chunk i's scatter is in flight, and the fixed width of "
              "the tier_write program in the ledger. Not a measured "
              "default")
register_flag("FLAGS_gen_step_log", True,
              "serving.GenerationEngine: record one compact scheduler "
              "record per engine iteration into the bounded per-engine "
              "step ring (profiler/step_log.py; /steps, chrome counter "
              "tracks, engine_step_ms/gen_queue_age_ms histograms); off "
              "removes the per-iteration accounting")
register_flag("FLAGS_gen_step_log_size", 4096,
              "per-engine step-ring capacity in records; the oldest "
              "record is overwritten")
register_flag("FLAGS_gen_audit_log", "",
              "optional JSONL sink for the generation scheduler's "
              "decision audit log (profiler/audit.py): every "
              "admit/defer/evict/expire/poison decision appends one "
              "reason-coded line to this path; '' keeps the bounded "
              "in-memory ring only")
register_flag("FLAGS_failpoints", "",
              "deterministic fault-injection spec (serving/failpoints.py): "
              "';'-separated `site@trigger[:arg]` terms where trigger is "
              "`N` (fire on the Nth hit only) or `every:K` (every Kth "
              "hit) and arg is a site-specific number (slow_step_ms "
              "sleep). Sites: decode_step_raise, prefill_raise, "
              "decode_poison_nan, alloc_exhaust, slow_step_ms, "
              "kv_tier.promote_upload, kv_tier.demote_gather. '' "
              "disables every site")
register_flag("FLAGS_gen_retry_limit", 2,
              "serving.EngineSupervisor: per-request replay budget: a "
              "request may survive at most this many engine restarts "
              "before it fails with a typed UnavailableError "
              "(audit code RETRY_EXHAUSTED)")
register_flag("FLAGS_gen_restart_backoff_ms", 100.0,
              "serving.EngineSupervisor base backoff between consecutive "
              "engine deaths (doubles per consecutive death, capped at "
              "32x). The JAX package's default; not measured on a GPU")
register_flag("FLAGS_gen_breaker_threshold", 5,
              "serving.EngineSupervisor crash-storm circuit breaker: "
              "this many engine deaths inside "
              "FLAGS_gen_breaker_window_s opens the breaker: the "
              "supervisor stays down, /readyz reports 503 with the "
              "breaker reason, and pending work fails typed "
              "(audit code BREAKER_OPEN)")
register_flag("FLAGS_gen_breaker_window_s", 30.0,
              "rolling window the crash-storm breaker counts engine "
              "deaths over (see FLAGS_gen_breaker_threshold)")
register_flag("FLAGS_gen_poison_degrade_k", 0,
              "serving.GenerationEngine degraded mode: this many poison "
              "events (non-finite logits) inside "
              "FLAGS_gen_degraded_window_s flips speculative decoding "
              "OFF for the engine (audit code DEGRADED_SPEC_OFF; the "
              "plain decode program is warmed too, so the flip adds no "
              "ledger entry). 0 disables the detector; snapshotted at "
              "engine construction")
register_flag("FLAGS_gen_exhaust_clamp_k", 0,
              "serving.GenerationEngine degraded mode: this many "
              "page-blocked admission iterations inside "
              "FLAGS_gen_degraded_window_s clamps admission: new "
              "submits that the pool cannot cover RIGHT NOW fail fast "
              "with ResourceExhaustedError instead of queueing toward a "
              "timeout (audit code DEGRADED_ADMIT_CLAMP; clears on the "
              "next successful admission). 0 disables; snapshotted at "
              "construction")
register_flag("FLAGS_gen_degraded_window_s", 60.0,
              "rolling window both degraded-mode detectors "
              "(FLAGS_gen_poison_degrade_k / "
              "FLAGS_gen_exhaust_clamp_k) count events over")
register_flag("FLAGS_slo_ttft_p99_ms", 0.0,
              "SLO objective: generative time-to-first-token p99 target "
              "in ms: at most 1% of requests in a window may exceed it "
              "(profiler/slo.py burn rates, /slo, Prometheus gauges); "
              "0 disables the objective")
register_flag("FLAGS_slo_tpot_p99_ms", 0.0,
              "SLO objective: generative time-per-output-token p99 "
              "target in ms (same 1% budget semantics); 0 disables")
register_flag("FLAGS_slo_error_rate", 0.0,
              "SLO objective: max fraction of requests that may fail "
              "(timeout/poison/engine death) per rolling window; "
              "0 disables")
register_flag("FLAGS_slo_windows_s", "60,300",
              "comma-separated rolling-window lengths (seconds) the SLO "
              "burn rates are evaluated over, shortest window first "
              "(the fast-burn window readiness shedding keys on)")
register_flag("FLAGS_slo_max_burn_rate", 0.0,
              "fold SLO burn into /readyz: an engine reports not-ready "
              "while any objective's fast-window burn rate is >= this "
              "value (0 never sheds; 1.0 = shedding exactly at "
              "budget-burn speed)")
register_flag("FLAGS_router_replicas", 2,
              "default replica count for serving.Router when neither "
              "num_replicas nor prebuilt replicas are passed; each "
              "replica is an EngineSupervisor-wrapped GenerationEngine "
              "(serving/router.py)")
register_flag("FLAGS_router_affinity", True,
              "prefix-affinity placement (serving/router.py): steer a "
              "request to the replica whose sketch holds the longest "
              "blake2b chain over the prompt's leading full pages; "
              "False = pure round-robin over undrained replicas")
register_flag("FLAGS_router_sketch_digests", 8192,
              "per-replica LRU sketch capacity, in chain digests, the "
              "router's affinity placement matches against (16 bytes a "
              "digest a replica); oldest digests age out first")
register_flag("FLAGS_router_pressure_ttl_ms", 50.0,
              "max age of the router's cached per-replica pressure and "
              "health snapshot before a placement refreshes it; 0 "
              "refreshes every placement (serving/router.py). The JAX "
              "package's default; not measured on a GPU")
register_flag("FLAGS_train_tail_bucketing", True,
              "hapi.Model fit/evaluate/predict with drop_last=False: pad "
              "the partial last batch to the loader's batch size by "
              "repeating its last real row and fold a row mask into the "
              "loss mean (hapi/model.py), as the JAX package does. The "
              "padded rows enter cross-row statistics (BatchNorm) and "
              "losses with a data-dependent denominator; a loss that "
              "gives no per-row values falls back to the unpadded batch "
              "once, with a warning")
register_flag("FLAGS_trace_ring_size", 16384,
              "profiler.tracer: per-thread trace event ring capacity; the "
              "ring overwrites its oldest events instead of growing")
register_flag("FLAGS_flight_recorder", True,
              "always-on bounded crash context: RecordEvent scopes keep "
              "recording into the per-thread rings even with the profiler "
              "stopped, and the engine's failure paths (engine death, "
              "poisoned sequence, allocator exhaustion) dump a postmortem "
              "JSON artifact (profiler/flight_recorder.py)")
register_flag("FLAGS_flight_recorder_events", 512,
              "how many trailing trace events a flight-recorder dump "
              "includes (the tail of the merged per-thread rings)")
register_flag("FLAGS_flight_recorder_dir", "",
              "directory for flight-recorder dump files; '' = "
              "<tempdir>/paddle_tpu_flightrec")
register_flag("FLAGS_flight_recorder_interval_s", 2.0,
              "period of the flight recorder's background counter "
              "sampler (the periodic monitor snapshots that give a dump "
              "its recent-counters timeline); 0 disables the sampler")
register_flag("FLAGS_flight_recorder_max_dumps", 16,
              "most dump files kept per process; the oldest is pruned "
              "so a crash-looping failure path cannot fill the disk")
register_flag("FLAGS_serving_spans", True,
              "per-request latency attribution (profiler/spans.py): "
              "GenerationEngine.submit() opens a span stamping queued/"
              "admitted/prefilled/first_token/last_token/resolved (the "
              "ttft_ms / tpot_ms histograms), InferenceEngine.submit() "
              "one stamping queued/claimed/padded/dispatched/device_done/"
              "sliced/resolved (the serving_queue_ms/pad_ms/device_ms/"
              "resolve_ms histograms and the engine.stats() phase "
              "breakdown); both drop `reqspan:` trace instants; off "
              "removes the per-request accounting from the hot path")
register_flag("FLAGS_serving_max_batch_size", 64,
              "serving.InferenceEngine: most request rows coalesced into "
              "one device batch (also the largest default shape bucket)")
register_flag("FLAGS_serving_max_batch_delay_ms", 2.0,
              "serving.InferenceEngine: how long the micro-batcher holds "
              "the first request of a batch open for co-riders before "
              "dispatching a partial batch. The JAX package's default; "
              "not measured on a GPU")
register_flag("FLAGS_serving_batch_buckets", "1,4,16,64",
              "serving.InferenceEngine: comma-separated batch-size buckets "
              "a device batch is padded up to, so each lane runs one "
              "program shape per bucket instead of one per observed "
              "batch size")
register_flag("FLAGS_serving_max_queue_depth", 256,
              "serving.InferenceEngine: pending-request bound; submits "
              "beyond it fail fast with EngineOverloaded (backpressure) "
              "instead of growing an unbounded queue")
register_flag("FLAGS_serving_max_inflight", 2,
              "serving.InferenceEngine: device batches a dispatch lane may "
              "have in flight (dispatched on its CUDA stream but not yet "
              "completed). 2 keeps the card fed while batch N computes; "
              "1 disables pipelining. The JAX package's default; not "
              "measured on a GPU")
register_flag("FLAGS_serving_devices", "",
              "serving.InferenceEngine default device set: '' = every "
              "CUDA device for artifact-path/Config models (one dispatch "
              "lane + Predictor replica per card), 'all', or a "
              "comma-separated list of CUDA device INDICES ('0,2'); an "
              "integer lane COUNT is only meaningful as the devices= "
              "argument, not through this string flag")
register_flag("FLAGS_serving_request_timeout_ms", 30000.0,
              "serving.InferenceEngine: default per-request deadline, "
              "enforced while queued AND again at completion: a request "
              "that expired while its batch was on the card fails with "
              "ExecutionTimeoutError, never a late result (0 disables)")
register_flag("FLAGS_serving_lane_restarts", 0,
              "serving.InferenceEngine: how many CONSECUTIVE times a "
              "dead dispatch lane is rebuilt in place (fresh threads, "
              "same replica/device) with exponential backoff "
              "(FLAGS_gen_restart_backoff_ms base) before it stays "
              "permanently out of rotation; deaths separated by more "
              "than FLAGS_gen_breaker_window_s reset the budget and "
              "the backoff. 0 keeps the legacy behavior: lane death "
              "permanently shrinks capacity")
register_flag("FLAGS_device_telemetry_interval_s", 5.0,
              "period of the lazy device-telemetry sampler "
              "(profiler/device_telemetry.py): per-device live and "
              "limit device-memory bytes from torch.cuda, and the MFU "
              "gauge when a FLOP rate is fed; 0 disables the sampler "
              "(explicit sample() calls still refresh the gauges)")
register_flag("FLAGS_device_peak_flops", 0.0,
              "per-device peak FLOP/s used for the MFU gauge; 0 = look "
              "up the device name in the built-in table (NVIDIA H100: "
              "989e12, its published dense bf16 rate); other cards "
              "export no MFU unless this is set")
register_flag("FLAGS_metrics_port", 0,
              "profiler.exporter.MetricsServer port: serve /metrics "
              "(Prometheus text), /stats, /steps, /slo, /trace, "
              "/history, /healthz and /readyz on 127.0.0.1; 0 = off; "
              "engines also accept GenerationEngine(metrics_port=)")
register_flag("FLAGS_trace_propagation", True,
              "trace-context propagation (profiler/trace_context.py): "
              "the engine mints one 16-hex trace id per direct submit "
              "(or takes the caller's); it rides the request's span "
              "(',tid=' reqspan field) and stream and is emitted as "
              "'fleet_request' chrome flow events; off = no ids minted")
register_flag("FLAGS_metrics_history_interval_s", 5.0,
              "period of the lazy time-series sampler "
              "(profiler/timeseries.py): every registered monitor "
              "counter (as a rate/s) and gauge (as a level) plus "
              "per-engine pressure() ticks recorded into bounded "
              "per-name rings, served as /history JSON and chrome 'C' "
              "counter tracks; 0 disables sampling")
register_flag("FLAGS_metrics_history_samples", 512,
              "max samples kept per series by the time-series sampler "
              "(ring semantics: oldest samples drop first)")


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
