"""ROADMAP C10 (float16 pools and K1) and C11 (K2-K7 for every head dim
D % 8 == 0 up to 256), held on the CPU.

- C11: `flash_supported` and `splash_supported` agree with the JAX
  package's gates on a grid of head dims 8..264 and sequence lengths, up
  to D 256; above it (where the JAX kernels still run, up to 512) the
  port refuses and counts each refusal in
  STAT_attention_wide_head_fallback. The kernels' own check (`_check`)
  takes the same head dims. A GPT with head dim 96 serves a prompt in a
  bucket at or above FLAGS_flash_attention_min_seq token-identical to the
  JAX engine (the JAX side runs its Pallas flash forward in interpret
  mode, the port its plain version on the CPU) and to its generate().
- C10: float16 pools build (`PagedKVCache`, and the engine's "auto"
  pools under a float16 GPT), K1's argument check takes float16, and the
  float16 engine serves token-identical to the port's float16
  generate().
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import serving as jserving
from paddle_tpu.framework.flags import get_flags, set_flags
from paddle_tpu.models import GPTConfig as JConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.ops import pallas_ops as jpo
from paddle_tpu.ops import splash_ops as jso
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.framework import monitor
from paddle_tpu_torch.framework.errors import InvalidArgumentError
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     load_reference_state)
from paddle_tpu_torch.nn.functional import attention as tattn
from paddle_tpu_torch.ops import flash_ops as tfo
from paddle_tpu_torch.ops import paged_ops as tpo
from paddle_tpu_torch.ops import splash_ops as tso
from paddle_tpu_torch.serving import GenerationEngine, PagedKVCache

STAT = "STAT_attention_wide_head_fallback"


@pytest.mark.parametrize("S", [128, 256, 200])
@pytest.mark.parametrize("D", list(range(4, 268, 4)))
def test_gates_agree_with_jax_up_to_256(D, S):
    """Below 257 the port's gates are the JAX package's; at 264 the JAX
    gate passes and the port's refuses, counted once per call."""
    shape = (2, 2, S, D)
    n0 = monitor.stat_get(STAT)
    f_t = tfo.flash_supported(shape, is_causal=True, min_seq=128)
    s_t = tso.splash_supported(shape, min_seq=128)
    f_j = jpo.flash_supported(shape, is_causal=True, min_seq=128)
    s_j = jso.splash_supported(shape, min_seq=128)
    if D <= 256:
        assert (f_t, s_t) == (f_j, s_j)
        assert monitor.stat_get(STAT) == n0
        assert f_t == (D % 8 == 0 and S % 128 == 0)
    else:
        assert not f_t and not s_t
        assert (f_j, s_j) == (D % 8 == 0 and S % 128 == 0,) * 2
        assert monitor.stat_get(STAT) == n0 + 2 * int(f_j)


@pytest.mark.parametrize("D", [8, 24, 72, 96, 136, 200, 256, 264, 100])
def test_kernel_check_takes_the_gated_head_dims(D):
    q = torch.zeros(1, 2, 128, D)
    if D % 8 == 0 and D <= 256:
        tfo._check(q, q, q, None)
        tfo._check(q, q, q, None, dtypes=tso._DTYPES)
    else:
        with pytest.raises(InvalidArgumentError, match="head_dim"):
            tfo._check(q, q, q, None)


def test_sdpa_wide_head_falls_back_counted():
    """F.sdpa at head dim 264 (the JAX package's kernels take it) runs
    the plain path and counts the fallback; it matches the JAX sdpa."""
    from paddle_tpu.nn import functional as JF
    rng = np.random.RandomState(0)
    q = rng.standard_normal((1, 1, 128, 264)).astype(np.float32)
    old = tflags.get_flags("FLAGS_flash_attention_min_seq")
    tflags.set_flags({"FLAGS_flash_attention_min_seq": 128})
    try:
        n0 = monitor.stat_get(STAT)
        out = tattn.scaled_dot_product_attention(
            torch.from_numpy(q), torch.from_numpy(q), torch.from_numpy(q),
            is_causal=True, training=False)
        assert monitor.stat_get(STAT) == n0 + 1
    finally:
        tflags.set_flags(old)
    ref = JF.scaled_dot_product_attention(
        paddle.to_tensor(q), paddle.to_tensor(q), paddle.to_tensor(q),
        is_causal=True, training=False).numpy()
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.fixture
def flash_at_128():
    old = get_flags(["FLAGS_flash_attention_interpret",
                     "FLAGS_use_flash_attention",
                     "FLAGS_flash_attention_min_seq"])
    set_flags({"FLAGS_flash_attention_interpret": True,
               "FLAGS_use_flash_attention": True,
               "FLAGS_flash_attention_min_seq": 128})
    old_t = tflags.get_flags("FLAGS_flash_attention_min_seq")
    tflags.set_flags({"FLAGS_flash_attention_min_seq": 128})
    yield
    set_flags(old)
    tflags.set_flags(old_t)


def test_head_dim_96_prefill_through_flash_identical_to_jax(flash_at_128):
    """A GPT with head dim 96 (hidden 768, 8 heads, 2 layers) serves a
    100-token prompt in bucket 128 >= the min-seq flag: its prefill takes
    the flash path in both packages (the port counts it in
    STAT_flash_attention_fwd only on the card; here the gate is checked),
    and the output is token-identical to the JAX engine and to the port's
    generate()."""
    paddle.seed(5)
    kw = dict(hidden_size=768, num_heads=8, intermediate_size=3072,
              dropout=0.0)
    ref = JGPT(JConfig.tiny(**kw))
    ref.eval()
    port = GPTForCausalLM(GPTConfig.tiny(**kw), device="cpu").eval()
    load_reference_state(port, {k: np.asarray(v.numpy())
                                for k, v in ref.state_dict().items()})
    assert tfo.flash_supported((1, 8, 128, 96), is_causal=True)
    assert jpo.flash_supported((1, 8, 128, 96), is_causal=True)
    ids = np.random.RandomState(4).randint(0, 512, size=(2, 100)) \
        .astype("int64")
    cfg = dict(max_slots=2, page_size=4, num_pages=64,
               prefill_buckets=(16, 128), max_new_tokens=5,
               request_timeout_ms=0)
    with jserving.GenerationEngine(ref, **cfg) as jeng:
        want = [f.result(timeout=300)
                for f in [jeng.submit(p, max_new_tokens=5) for p in ids]]
    with GenerationEngine(port, device="cpu", **cfg) as eng:
        got = [f.result(timeout=300)
               for f in [eng.submit(p, max_new_tokens=5) for p in ids]]
        stats = eng.stats()
    assert stats["compiles"]["prefill[b=128]"] == 1
    for g, w, p in zip(got, want, ids):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(
            g, port.generate(p[None], max_new_tokens=5).numpy()[0])


def test_float16_pools_and_kernel_check():
    c = PagedKVCache(2, 2, 8, 4, 8, 2, dtype="float16", device="cpu")
    assert c.k_pages.dtype == torch.float16 and not c.quantized
    assert c.hbm_bytes() == 2 * 2 * 2 * 8 * 4 * 8 * 2
    assert PagedKVCache.page_hbm_bytes(2, 2, 8, 4, "float16") == \
        PagedKVCache.page_hbm_bytes(2, 2, 8, 4, "bfloat16")
    q = torch.zeros(1, 2, 8, dtype=torch.float16)
    kp = torch.zeros(2, 8, 4, 8, dtype=torch.float16)
    pt = torch.ones(1, 2, dtype=torch.int32)
    pos = torch.zeros(1, dtype=torch.int32)
    tpo._check_kernel_args(q, kp, kp, pt, pos)
    with pytest.raises(InvalidArgumentError, match="float16"):
        tpo._check_kernel_args(q.double(), kp.double(), kp.double(), pt,
                               pos)
    with pytest.raises(InvalidArgumentError):
        tpo._check_kernel_args(q, kp.float(), kp, pt, pos)


def test_float16_engine_identical_to_generate():
    """C10: a float16 GPT's engine takes float16 pools ("auto") and serves
    token-identical to the port's float16 generate() (on the CPU both run
    the plain paths in float16)."""
    port = GPTForCausalLM(GPTConfig.tiny(dropout=0.0), device="cpu",
                          seed=3).eval().half()
    ids = np.random.RandomState(8).randint(0, 512, size=(2, 7)) \
        .astype("int64")
    with GenerationEngine(port, device="cpu", max_slots=2, page_size=4,
                          num_pages=32, prefill_buckets=(8,),
                          max_new_tokens=6, request_timeout_ms=0) as eng:
        assert eng.stats()["pages"]["dtype"] == "float16"
        outs = [f.result(timeout=120) for f in [
            eng.submit(p, max_new_tokens=6) for p in ids]]
    for o, p in zip(outs, ids):
        np.testing.assert_array_equal(
            o, port.generate(p[None], max_new_tokens=6).numpy()[0])
