"""The port's serving program store (`paddle_tpu_torch.serving.
program_store`), its `jit` / `device` helpers and the engine's store
seam, held to the JAX package's contract (`tests/test_program_store.py`,
whose own store tests are red in this image: ROADMAP C1).

- **Cold-process warm start**: process A exports and writes every
  covered program; process B, with the same key, serves with an EMPTY
  ledger (every program `loaded`), token-identical to a store-less run
  and to the JAX engine on the same weights.
- **Never wrong, never failed**: a corrupt payload is a miss, a tampered
  in-place spec fails the self-check (counter + flight dump) and falls
  back to an export, a stale key is a clean miss; each still serves the
  store-off tokens.
- **The in-place writes survive**: the artifact is a `torch.export`
  program whose pool writes stay in place through save / load (the
  port's gate, `serialization_unsafe_backend()`, is False on the CPU:
  ROADMAP C45); a `run_decompositions()`'d program writes copies and
  fails the self-check.
"""
import io
import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import serving as jserving
from paddle_tpu.models import GPTConfig as JConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu_torch import device as pdevice
from paddle_tpu_torch import jit as pjit
from paddle_tpu_torch.framework import monitor
from paddle_tpu_torch.framework.errors import InvalidArgumentError
from paddle_tpu_torch.framework.flags import get_flags, set_flags
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     load_reference_state)
from paddle_tpu_torch.models.gpt import (sample_logits,
                                         sample_logits_with_noise,
                                         sampling_noise)
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.profiler import flight_recorder
from paddle_tpu_torch.serving import (EngineSupervisor, GenerationConfig,
                                      GenerationEngine, failpoints)
from paddle_tpu_torch.serving.generation import _Program
from paddle_tpu_torch.serving.program_store import (ProgramStore,
                                                    read_manifest)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_program_store_worker.py")

_KW = dict(max_slots=2, page_size=4, num_pages=64, prefill_buckets=(8,),
           max_new_tokens=5, request_timeout_ms=0)


@pytest.fixture(scope="module")
def pair():
    """The JAX package's tiny GPT (seed 11) and the port's with its
    weights."""
    paddle.seed(11)
    ref = JGPT(JConfig.tiny(dropout=0.0))
    ref.eval()
    state = {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}
    port = GPTForCausalLM(GPTConfig.tiny(dropout=0.0), device="cpu").eval()
    load_reference_state(port, state)
    return ref, port, state


@pytest.fixture(scope="module")
def model(pair):
    return pair[1]


def _prompts(n=2, S=7, seed=0, vocab=512):
    return np.random.RandomState(seed).randint(
        0, vocab, size=(n, S)).astype("int64")


def _engine(model, **kw):
    return GenerationEngine(model, device="cpu", **{**_KW, **kw})


def _serve(eng, ids, max_new=5, **kw):
    return [np.asarray(f.result(timeout=300)) for f in
            [eng.submit(p, max_new_tokens=max_new, **kw) for p in ids]]


def _build_store(model, store, **kw):
    """One engine lifetime with the store on; returns (outputs, stats)."""
    with _engine(model, program_store=str(store), **kw) as eng:
        outs = _serve(eng, _prompts())
        stats = eng.stats()
    return outs, stats


def _store_off(model, ids=None, **kw):
    with _engine(model, **kw) as eng:
        return _serve(eng, _prompts() if ids is None else ids)


def _only_key_dir(store):
    dirs = [d for d in os.listdir(store)
            if os.path.isdir(os.path.join(store, d))]
    assert len(dirs) == 1, dirs
    return os.path.join(store, dirs[0])


def _same(outs, ref):
    assert len(outs) == len(ref)
    for got, want in zip(outs, ref):
        np.testing.assert_array_equal(got, want)


class _Pool(torch.nn.Module):
    """A program that writes rows into a pool it is given, in place
    (through a view, as the engine's per-layer writes do), then reads
    them."""

    def forward(self, pool, idx, rows):
        pool[1][idx] = rows * 2.0
        return pool[1][idx].sum(-1) + 1.0


def _pool_program():
    pool = torch.zeros(3, 8, 4)
    idx = torch.tensor([1, 5])
    rows = torch.arange(8, dtype=torch.float32).reshape(2, 4)
    return torch.export.export(_Pool(), (pool, idx, rows), strict=False), \
        (pool, idx, rows)


# -- serde helpers (jit layer) ----------------------------------------------

def test_serialize_round_trip_preserves_alias_and_math():
    ep, (pool, idx, rows) = _pool_program()
    alias = pjit.compiled_alias_spec(ep)
    assert alias == "0:pool"                  # the write is in the graph
    assert ep.graph_signature.user_inputs_to_mutate == {}
    blob = pjit.serialize_compiled(ep)
    loaded = pjit.deserialize_compiled(blob)
    assert pjit.compiled_alias_spec(loaded) == alias
    ptr = pool.data_ptr()
    out = loaded.module()(pool, idx, rows)
    assert pool.data_ptr() == ptr             # written in place
    np.testing.assert_array_equal(pool[1][idx].numpy(), rows.numpy() * 2)
    np.testing.assert_allclose(out.numpy(), rows.sum(-1).numpy() * 2 + 1)
    assert pool[0].abs().sum() == 0 and pool[2].abs().sum() == 0


def test_round_trip_keeps_in_place_writes_on_cpu():
    """The question `serialization_unsafe_backend()` answers, asked of
    this device: a loaded program keeps writing its inputs in place on
    the CPU, so the port's gate is False where the JAX package's is True
    (XLA:CPU): ROADMAP C45."""
    ep, (pool, idx, rows) = _pool_program()
    loaded = pjit.deserialize_compiled(pjit.serialize_compiled(ep))
    before = pool.clone()
    loaded.module()(pool, idx, rows)
    assert not torch.equal(pool, before)
    assert pdevice.serialization_unsafe_backend() is False


def test_decomposed_program_writes_copies_and_fails_selfcheck(model,
                                                              tmp_path):
    """`run_decompositions()` functionalizes the pool writes: the spec
    read off the graph changes (to none), and the engine's self-check
    refuses the program."""
    ep, _ = _pool_program()
    dec = ep.run_decompositions()
    assert dec.graph_signature.user_inputs_to_mutate  # a copy back
    assert pjit.compiled_alias_spec(dec) == ""
    with _engine(model, program_store=str(tmp_path / "s")) as eng:
        recorded = pjit.compiled_alias_spec(ep)
        assert eng._selfcheck_alias(ep, recorded) is None
        err = eng._selfcheck_alias(dec, recorded)
        assert err is not None and "mismatch" in err
        err = eng._selfcheck_alias(dec, "")
        assert err is not None and "aliasing-drop" in err


def test_artifact_holds_no_weight(model, tmp_path):
    """Weights and pools are inputs of every program: no artifact holds a
    parameter, a buffer or a constant tensor."""
    _, stats = _build_store(model, tmp_path / "s")
    key_dir = stats["program_store"]["dir"]
    for name, entry in read_manifest(key_dir)["programs"].items():
        with open(os.path.join(key_dir, entry["file"]), "rb") as f:
            ep = pjit.deserialize_compiled(f.read())
        assert not ep.state_dict and not ep.constants, name
        assert entry["bytes"] < sum(p.numel() * 4
                                    for p in model.parameters())


def test_key_material_digest_is_canonical_and_sensitive():
    from paddle_tpu.jit import key_material_digest as jdigest
    base = {"model": {"n_layer": 2, "n_head": 2}, "knobs": [8, 4]}
    same = {"knobs": [8, 4], "model": {"n_head": 2, "n_layer": 2}}
    d = pjit.key_material_digest
    assert d(base) == d(same)
    bumped = {"model": {"n_layer": 2, "n_head": 2}, "knobs": [8, 8]}
    assert d(base) != d(bumped)
    odd = {"a": [1.5, None, True, "x"], "b": {"c": object.__name__}}
    for m in (base, same, bumped, odd):
        assert d(m) == jdigest(m)


def test_pytree_spec_equals_jax():
    from paddle_tpu.jit import pytree_spec as jspec
    rng = np.random.RandomState(0)
    tree = {"wte": rng.randn(8, 4).astype(np.float32),
            "lnf": (np.ones(4, np.float32), np.zeros(4, np.float16)),
            "blocks": [(rng.randint(-127, 127, (4, 4)).astype(np.int8),
                        np.ones(4, np.float32)), np.int32(3)],
            "a": {"z": np.zeros((2, 3), np.int64), "b": [None, 2.5]}}
    assert pjit.pytree_spec(tree) == jspec(tree)
    torched = {"wte": torch.zeros(8, 4), "q": (torch.zeros(2, 2,
                                                          dtype=torch.int8),
                                              torch.ones(2))}
    assert pjit.pytree_spec(torched) == [
        ["['q'][0]", [2, 2], "int8"], ["['q'][1]", [2], "float32"],
        ["['wte']", [8, 4], "float32"]]


def test_sampling_noise_reproduces_multinomial():
    """The engine draws its sampling noise outside the programs:
    argmax(p / q) over `sampling_noise`'s Exp(1) draw is
    `torch.multinomial`'s one-sample path, token for token, generator
    state for generator state."""
    logits = torch.randn(6, 50, generator=torch.Generator().manual_seed(1))
    for seed in range(5):
        for top_k, temp in ((0, 1.0), (5, 0.7)):
            g1 = torch.Generator().manual_seed(seed)
            g2 = torch.Generator().manual_seed(seed)
            want = sample_logits(logits, True, temp, top_k, g1)
            got = sample_logits_with_noise(
                logits, temp, top_k, sampling_noise(logits.shape, "cpu", g2))
            assert torch.equal(got, want)
            assert torch.equal(g1.get_state(), g2.get_state())


# -- cold-process warm start --------------------------------------------------

def _run_worker(out_path, weights, store=""):
    env = dict(os.environ, PYTHONPATH=REPO)
    cmd = [sys.executable, WORKER, "--out", str(out_path), "--weights",
           str(weights)]
    if store:
        cmd += ["--store", str(store)]
    proc = subprocess.run(cmd, env=env, cwd=REPO, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out_path, "r", encoding="utf-8") as f:
        return json.load(f)


def test_cold_process_warm_start(pair, tmp_path):
    """Process A exports and writes back; process B (same key, fresh
    process) serves with ZERO traces, every covered program `loaded`,
    token-identical to a store-less process and to the JAX engine's
    store-off tokens on the same weights."""
    ref, _, state = pair
    weights = tmp_path / "gpt.npz"
    np.savez(weights, **state)
    store = tmp_path / "store"
    cold = _run_worker(tmp_path / "a.json", weights, store=store)
    assert cold["compiles"] == {"prefill[b=8]": 1, "decode[m=2]": 1}
    assert cold["loaded"] == {}
    assert cold["program_store"]["active"] is True

    warm = _run_worker(tmp_path / "b.json", weights, store=store)
    assert warm["compiles"] == {}, warm["compiles"]
    assert set(warm["loaded"]) == set(cold["compiles"])
    assert warm["programs"] == {k: "loaded" for k in warm["loaded"]}
    assert warm["program_store"]["key"] == cold["program_store"]["key"]

    off = _run_worker(tmp_path / "c.json", weights)
    assert off["program_store"]["configured"] is False
    assert warm["outputs"] == cold["outputs"] == off["outputs"]
    with jserving.GenerationEngine(ref, **_KW) as jeng:
        want = _serve(jeng, _prompts())
    _same([np.asarray(o) for o in warm["outputs"]], want)


def test_warm_engine_same_process(model, tmp_path):
    """In-process replay of the same invariant: a second engine over the
    same store loads everything the first exported, and the
    pack_load_ms histogram saw the loads."""
    store = tmp_path / "store"
    _, cold_stats = _build_store(model, store)
    before = monitor.histogram("pack_load_ms").snapshot()["count"]
    hits = monitor.stat_get("STAT_pack_store_hits")
    with _engine(model, program_store=str(store)) as eng:
        outs = _serve(eng, _prompts())
        stats = eng.stats()
    assert stats["compiles"] == {}
    assert set(stats["loaded"]) == set(cold_stats["compiles"])
    assert monitor.histogram("pack_load_ms").snapshot()["count"] > before
    assert monitor.stat_get("STAT_pack_store_hits") - hits == 2
    assert ProgramStore(str(store), {}).entries() == {}
    _same(outs, _store_off(model))


def test_full_pack_coverage_prefix_and_spec(model, tmp_path):
    """With the prefix cache and speculation on, the covered set grows
    to prefill + prefill_tail + cow_copy + verify[k]: EVERY one must
    warm-start from the store."""
    store = tmp_path / "store"
    kw = dict(prefix_cache=True, spec_k=2)
    _, cold_stats = _build_store(model, store, **kw)
    for name in ("prefill[b=8]", "prefill_tail[b=8]", "cow_copy",
                 "verify[k=2]"):
        assert name in cold_stats["compiles"], cold_stats["compiles"]
    with _engine(model, program_store=str(store), **kw) as eng:
        outs = _serve(eng, _prompts())
        stats = eng.stats()
    assert stats["compiles"] == {}
    assert set(stats["loaded"]) == set(cold_stats["compiles"])
    _same(outs, _store_off(model, **kw))


def _prefix_prompts():
    rng = np.random.RandomState(4)
    system = rng.randint(0, 512, size=(8,))
    return [np.concatenate([system, rng.randint(0, 512, size=(n,))])
            for n in (3, 9, 0, 20)] + [rng.randint(0, 512, size=(30,))]


@pytest.mark.parametrize("mode", [
    "prefix", "int8_prefix", "spec", "chunk", "bf16", "fp16", "w_int8",
    "w_int4", "sampled", "sampled_spec"])
def test_every_keyed_mode_warm_starts_token_identical(model, tmp_path,
                                                      mode):
    """Each mode the store keys on (pool types, int8 pages, quantized
    weights, the prefix cache, speculation, chunked prefill, sampling):
    store off, a miss and a hit give the same tokens, and the hit loads
    every program the miss exported."""
    from paddle_tpu_torch import quantization
    net, sample = model, False
    kw = dict(max_slots=3, num_pages=96, prefill_buckets=(8, 32),
              max_new_tokens=6)
    kw.update({"prefix": dict(prefix_cache=True),
               "int8_prefix": dict(prefix_cache=True,
                                   kv_cache_dtype="int8"),
               "spec": dict(spec_k=2), "chunk": dict(prefill_chunk=8),
               "bf16": dict(kv_cache_dtype="bfloat16"),
               "sampled": dict(seed=5, top_k=5),
               "sampled_spec": dict(spec_k=2, seed=3)}.get(mode, {}))
    if mode == "fp16":
        net = GPTForCausalLM(GPTConfig.tiny(dropout=0.0), device="cpu",
                             seed=3).eval().half()
    if mode.startswith("w_"):
        net = GPTForCausalLM(GPTConfig.tiny(dropout=0.0), device="cpu",
                             seed=3).eval()
        quantization.quantize_weights(net, bits=8 if mode == "w_int8"
                                      else 4)
    sample = mode.startswith("sampled")
    ids = _prefix_prompts()

    def serve(**extra):
        with _engine(net, **kw, **extra) as eng:
            outs = _serve(eng, ids, max_new=6, do_sample=sample,
                          temperature=0.8)
            return outs, eng.stats()

    off, off_stats = serve()
    miss, miss_stats = serve(program_store=str(tmp_path / "s"))
    hit, hit_stats = serve(program_store=str(tmp_path / "s"))
    _same(miss, off)
    _same(hit, off)
    assert miss_stats["compiles"] == off_stats["compiles"]
    assert hit_stats["compiles"] == {}
    assert set(hit_stats["loaded"]) == set(miss_stats["compiles"])


# -- corruption / staleness: a bad entry costs a trace, never a wrong answer

def test_corrupt_payload_is_a_miss_not_an_error(model, tmp_path):
    store = tmp_path / "store"
    _build_store(model, store)
    key_dir = _only_key_dir(store)
    victim = os.path.join(key_dir, "decode_m_2.bin")
    assert os.path.isfile(victim)
    with open(victim, "wb") as f:
        f.write(b"not a saved program")
    misses = monitor.stat_get("STAT_pack_store_misses")
    with _engine(model, program_store=str(store)) as eng:
        outs = _serve(eng, _prompts())
        stats = eng.stats()
    # the corrupted program was exported again (and re-persisted); the
    # intact one still loaded
    assert stats["compiles"] == {"decode[m=2]": 1}
    assert set(stats["loaded"]) == {"prefill[b=8]"}
    assert monitor.stat_get("STAT_pack_store_misses") > misses
    _same(outs, _store_off(model))
    # the write-back healed the store: a third engine loads everything
    with _engine(model, program_store=str(store)) as eng:
        _serve(eng, _prompts())
        assert eng.stats()["compiles"] == {}


def test_alias_tamper_fails_selfcheck_and_falls_back(model, tmp_path):
    store = tmp_path / "store"
    _build_store(model, store)
    key_dir = _only_key_dir(store)
    mf = read_manifest(key_dir)
    mf["programs"]["decode[m=2]"]["alias"] = "99:args_9"
    with open(os.path.join(key_dir, "manifest.json"), "w",
              encoding="utf-8") as f:
        json.dump(mf, f)
    fails = monitor.stat_get("STAT_pack_selfcheck_failures")
    dumps = len(flight_recorder.dump_records())
    with _engine(model, program_store=str(store)) as eng:
        outs = _serve(eng, _prompts())
        stats = eng.stats()
    assert stats["compiles"] == {"decode[m=2]": 1}
    assert monitor.stat_get("STAT_pack_selfcheck_failures") - fails == 1
    recs = flight_recorder.dump_records()[dumps:]
    assert [r["reason"] for r in recs].count("program_store_selfcheck") == 1
    _same(outs, _store_off(model))


def test_failed_probe_falls_back(model, tmp_path, monkeypatch):
    """A loaded program whose smoke probe fails (here: forced) is not
    served: the engine exports it again and stays token-identical."""
    store = tmp_path / "store"
    _build_store(model, store)
    fails = monitor.stat_get("STAT_pack_selfcheck_failures")
    monkeypatch.setattr(GenerationEngine, "_probe_ok",
                        staticmethod(lambda name, out:
                                     not name.startswith("prefill")))
    with _engine(model, program_store=str(store)) as eng:
        outs = _serve(eng, _prompts())
        stats = eng.stats()
    assert stats["compiles"] == {"prefill[b=8]": 1}
    assert stats["loaded"] == {"decode[m=2]": 1}
    assert monitor.stat_get("STAT_pack_selfcheck_failures") - fails == 1
    _same(outs, _store_off(model))


def test_stale_key_is_a_clean_miss(model, tmp_path):
    """Any trace-shaping knob change gives another content key: a fresh
    key directory and a full export; the old entries are never read."""
    store = tmp_path / "store"
    _, first = _build_store(model, store)
    with _engine(model, program_store=str(store), num_pages=32) as eng:
        outs = _serve(eng, _prompts())
        stats = eng.stats()
    assert stats["loaded"] == {}
    assert set(stats["compiles"]) == set(first["compiles"])
    assert stats["program_store"]["key"] != first["program_store"]["key"]
    key_dirs = [d for d in os.listdir(store)
                if os.path.isdir(os.path.join(store, d))]
    assert len(key_dirs) == 2
    _same(outs, _store_off(model, num_pages=32))


def test_edited_kernel_source_is_a_new_key(model, monkeypatch):
    """The key holds the hash of every kernel source a program can
    launch, so an edited kernel misses."""
    with _engine(model, warmup=False) as eng:
        a = eng._store_key_material()
        monkeypatch.setattr(_build, "source_hash",
                            lambda src: "edited" + src)
        b = eng._store_key_material()
    assert set(a["kernels"]) == {"paged_attention.cu", "flash_fwd.cu"}
    assert pjit.key_material_digest(a) != pjit.key_material_digest(b)
    json.dumps(a)                               # JSON-able material


# -- the gate -------------------------------------------------------------------

def test_refusal_without_force(model, tmp_path, monkeypatch):
    """Where the gate says a loaded program may drop its in-place writes,
    the store refuses to engage unless forced: the engine runs as store
    off and the directory stays empty."""
    monkeypatch.setattr(pdevice, "serialization_unsafe_backend",
                        lambda: True)
    store = tmp_path / "store"
    with _engine(model, program_store=str(store)) as eng:
        _serve(eng, _prompts())
        stats = eng.stats()
    assert stats["program_store"]["configured"] is True
    assert stats["program_store"]["active"] is False
    assert stats["loaded"] == {}
    assert stats["compiles"] != {}
    assert not os.path.exists(store)


def test_forced_serialization_warns_once(model, tmp_path, monkeypatch):
    """Both force paths share ONE per-process warning naming the
    corruption class, so the two policies cannot drift apart."""
    monkeypatch.setattr(pdevice, "serialization_unsafe_backend",
                        lambda: True)
    monkeypatch.setattr(pdevice, "_force_warned", False)
    monkeypatch.setattr(pdevice.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(_build, "_dir", None)
    assert pdevice.enable_compilation_cache(
        path=str(tmp_path / "cc")) is None      # unforced: gate refuses
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        ProgramStore(str(tmp_path / "s1"), {"k": 1}, force=True)
        ProgramStore(str(tmp_path / "s2"), {"k": 2}, force=True)
        assert pdevice.enable_compilation_cache(
            path=str(tmp_path / "cc"), force=True) == str(tmp_path / "cc")
    msgs = [str(x.message) for x in w
            if issubclass(x.category, RuntimeWarning)
            and "corruption class" in str(x.message)]
    assert len(msgs) == 1 and "aliasing-drop" in msgs[0]
    assert ProgramStore(str(tmp_path / "s3"), {"k": 3}).refused
    assert not ProgramStore(str(tmp_path / "s4"), {"k": 4},
                            force=True).refused
    # a forced engine serves through the store, token-identical
    store = tmp_path / "store"
    _build_store(model, store, program_store_force=True)
    with _engine(model, program_store=str(store),
                 program_store_force=True) as eng:
        outs = _serve(eng, _prompts())
        assert eng.stats()["compiles"] == {}
    _same(outs, _store_off(model))


# -- the kernel build cache ---------------------------------------------------

def test_compilation_cache_points_the_kernel_build(tmp_path, monkeypatch):
    """No CUDA device: nothing to cache (None, as the JAX package's with
    no backend). With one, the cache directory is where `ops/_build.py`
    writes and looks up its nvcc libraries; the flag is read at the
    first build."""
    monkeypatch.setattr(_build, "_dir", None)
    monkeypatch.setattr(pdevice, "_cache_decision_pending", True)
    assert pdevice.enable_compilation_cache(str(tmp_path / "a")) is None
    assert pdevice.compilation_cache_dir() is None
    assert _build.build_dir() == _build.default_build_dir()

    monkeypatch.setattr(pdevice.torch.cuda, "is_available", lambda: True)
    assert pdevice.compilation_cache_dir() == str(_build.default_build_dir())
    d = pdevice.enable_compilation_cache(str(tmp_path / "a"))
    assert d == str(tmp_path / "a") and os.path.isdir(d)
    assert pdevice.compilation_cache_dir() == d
    assert _build.build_dir() == tmp_path / "a"
    assert str(_build._lib_path("flash_fwd.cu")).startswith(d)

    # the flag, resolved at the first build
    monkeypatch.setattr(_build, "_dir", None)
    monkeypatch.setattr(pdevice, "_cache_decision_pending", True)
    old = get_flags(["FLAGS_xla_compilation_cache_dir"])
    set_flags({"FLAGS_xla_compilation_cache_dir": str(tmp_path / "b")})
    try:
        assert _build.build_dir() == tmp_path / "b"
        assert pdevice.compilation_cache_dir() == str(tmp_path / "b")
    finally:
        set_flags(old)
    # off: the flag opts out
    monkeypatch.setattr(_build, "_dir", None)
    monkeypatch.setattr(pdevice, "_cache_decision_pending", True)
    set_flags({"FLAGS_xla_compilation_cache": False,
               "FLAGS_xla_compilation_cache_dir": str(tmp_path / "c")})
    try:
        assert _build.build_dir() == _build.default_build_dir()
    finally:
        set_flags({"FLAGS_xla_compilation_cache": True, **old})


def test_config_resolves_the_store_flags(tmp_path):
    old = get_flags(["FLAGS_gen_program_store_dir",
                     "FLAGS_gen_program_store_force"])
    assert GenerationConfig().program_store is None
    assert GenerationConfig(program_store="").program_store is None
    assert GenerationConfig(program_store=str(tmp_path)).program_store \
        == str(tmp_path)
    set_flags({"FLAGS_gen_program_store_dir": str(tmp_path),
               "FLAGS_gen_program_store_force": True})
    try:
        cfg = GenerationConfig()
        assert cfg.program_store == str(tmp_path)
        assert cfg.program_store_force is True
        assert pdevice.program_store_dir() == str(tmp_path)
        assert GenerationConfig(program_store_force=False) \
            .program_store_force is False
    finally:
        set_flags(old)


def test_tp_lane_refuses_the_store(model, tmp_path):
    with pytest.raises(InvalidArgumentError, match="C46"):
        _engine(model, tp=2, program_store=str(tmp_path))


def test_export_failure_raises(model, tmp_path, monkeypatch):
    """A program whose export fails raises: nothing quietly runs the
    eager path instead."""
    def boom(*a, **k):
        raise RuntimeError("export refused")
    monkeypatch.setattr(torch.export, "export", boom)
    with pytest.raises(RuntimeError, match="export refused"):
        _engine(model, program_store=str(tmp_path))


def test_program_module_runs_the_eager_function(model, tmp_path):
    """`_Program` wraps an engine program for torch.export: the exported
    prefill gives the eager logits on the same inputs."""
    with _engine(model, warmup=False) as eng:
        pt = eng._t(np.zeros(eng._cfg.pages_per_seq, np.int32))
        ids = eng._t(_prompts(1, 8), torch.long)
        n = eng._t(np.int64(5))
        with torch.inference_mode():
            want = eng._prefill_prog(eng._W, eng._pools(), pt, ids, n)
            ep = torch.export.export(_Program(eng._prefill_prog),
                                     (eng._W, eng._pools(), pt, ids, n),
                                     strict=False)
            got = ep.module()(eng._W, eng._pools(), pt, ids, n)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    buf = io.BytesIO(pjit.serialize_compiled(ep))
    assert buf.getbuffer().nbytes > 0


# -- supervisor: rebuilds prefer the store --------------------------------------

def test_supervised_restart_keeps_zero_compiles(model, tmp_path):
    """A supervised engine over a warm store resurrects without a trace:
    the replacement engine takes over the loaded programs, so the ledger
    stays empty."""
    store = tmp_path / "store"
    _build_store(model, store)
    failpoints.reset()
    old = get_flags(["FLAGS_failpoints"])
    set_flags({"FLAGS_failpoints": "decode_step_raise@2"})
    try:
        sup = EngineSupervisor(model, device="cpu", program_store=str(store),
                               **_KW)
        try:
            outs = _serve(sup, _prompts())
            sstats = sup.stats()
        finally:
            sup.shutdown()
    finally:
        set_flags(old)
        failpoints.reset()
    assert sstats["supervisor"]["restarts"] >= 1
    assert sstats["compiles"] == {}
    assert sstats["supervisor"]["program_store"] == str(store)
    _same(outs, _store_off(model))
