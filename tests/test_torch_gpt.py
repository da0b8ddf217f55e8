"""paddle_tpu_torch GPT held to paddle_tpu's on bridged weights.

A seeded `paddle_tpu` tiny GPTForCausalLM (2 layers, 64 wide) is copied
into the port through `load_reference_state` (numpy state dict, Linear
weights transposed). float32 on the CPU: full-forward logits to atol
1e-4, prefill K/V to atol 1e-5, greedy generate() token-identical."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPTConfig as JConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch.framework.errors import InvalidArgumentError
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM, gpt as tgpt
from paddle_tpu_torch.models import load_reference_state


def _arrays(net):
    return {k: np.asarray(v.numpy()) for k, v in net.state_dict().items()}


@pytest.fixture(scope="module")
def pair():
    paddle.seed(11)
    ref = JGPT(JConfig.tiny(dropout=0.0))
    ref.eval()
    port = GPTForCausalLM(GPTConfig.tiny(dropout=0.0), device="cpu").eval()
    load_reference_state(port, _arrays(ref))
    return ref, port


def _prompt(B=2, S=7, seed=0, vocab=512):
    return np.random.RandomState(seed).randint(
        0, vocab, size=(B, S)).astype("int64")


@pytest.mark.parametrize("S", [7, 64])
def test_full_forward_logits_match(pair, S):
    ref, port = pair
    ids = _prompt(S=S, seed=S)
    want = ref(paddle.to_tensor(ids)).numpy()
    with torch.inference_mode():
        got = port(torch.from_numpy(ids)).numpy()
    assert got.shape == want.shape == (2, S, 512)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_gpt_prefill_kv_match(pair):
    ref, port = pair
    ids = _prompt(seed=4)
    cfg = ref.gpt.config
    H = cfg.num_heads
    scale = 1.0 / (cfg.hidden_size // H) ** 0.5
    import jax.numpy as jnp
    h_j, ks_j, vs_j = jgpt.gpt_prefill(
        ref.decode_weights(), jnp.asarray(ids, jnp.int32), num_heads=H,
        scale=scale)
    with torch.inference_mode():
        h_t, ks_t, vs_t = tgpt.gpt_prefill(
            port.decode_weights(), torch.from_numpy(ids), num_heads=H,
            scale=scale)
    np.testing.assert_allclose(ks_t.numpy(), np.asarray(ks_j), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(vs_t.numpy(), np.asarray(vs_j), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("S,new", [(7, 5), (3, 40)])
def test_generate_greedy_token_identical(pair, S, new):
    ref, port = pair
    ids = _prompt(S=S, seed=S + new)
    want = ref.generate(paddle.to_tensor(ids), max_new_tokens=new).numpy()
    got = port.generate(ids, max_new_tokens=new).numpy()
    assert got.shape == (2, S + new)
    np.testing.assert_array_equal(got, want)


def test_generate_matches_repeated_full_forward(pair):
    """The port's own oracle: greedy decode over the dense cache equals
    argmax of repeated full forwards."""
    _, port = pair
    ids = _prompt(seed=8)
    out = port.generate(ids, max_new_tokens=5).numpy()
    cur = ids.copy()
    with torch.inference_mode():
        for _ in range(5):
            nxt = port(torch.from_numpy(cur))[:, -1].argmax(-1).numpy()
            cur = np.concatenate([cur, nxt[:, None]], axis=1)
    np.testing.assert_array_equal(out, cur)


def test_generate_sampling_seeded_and_position_limit(pair):
    _, port = pair
    ids = _prompt(seed=3)
    kw = dict(max_new_tokens=6, do_sample=True, top_k=8, temperature=0.9)
    a = port.generate(ids, seed=42, **kw).numpy()
    b = port.generate(ids, seed=42, **kw).numpy()
    c = port.generate(ids, seed=7, **kw).numpy()
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    with pytest.raises(ValueError, match="max_position_embeddings"):
        port.generate(_prompt(S=126), max_new_tokens=10)


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_bridge_raises_on_bad_state(pair, fault):
    ref, _ = pair
    arrays = _arrays(ref)
    if fault == "missing":
        arrays.pop("gpt.blocks.1.mlp.2.bias")
    elif fault == "extra":
        arrays["gpt.lm_head.weight"] = arrays["gpt.wte.weight"]
    else:
        arrays["gpt.blocks.0.attn.q_proj.weight"] = np.zeros((64, 32),
                                                             np.float32)
    fresh = GPTForCausalLM(GPTConfig.tiny(dropout=0.0), device="cpu")
    before = fresh.gpt.wte.weight.clone()
    with pytest.raises(InvalidArgumentError):
        load_reference_state(fresh, arrays)
    # nothing was copied by a refused bridge
    assert torch.equal(fresh.gpt.wte.weight, before)


def test_bridge_transposes_linear_weights(pair):
    ref, port = pair
    w = np.asarray(ref.gpt.blocks[0].mlp[0].weight.numpy())   # [in, out]
    assert w.shape == (64, 128)
    np.testing.assert_array_equal(port.gpt.blocks[0].mlp[0].weight
                                  .detach().numpy(), w.T)


def test_moe_is_not_ported():
    with pytest.raises(InvalidArgumentError):
        GPTForCausalLM(GPTConfig.tiny(use_moe=True), device="cpu")


def test_seeded_init_is_deterministic():
    a = GPTForCausalLM(GPTConfig.tiny(), device="cpu", seed=5)
    b = GPTForCausalLM(GPTConfig.tiny(), device="cpu", seed=5)
    c = GPTForCausalLM(GPTConfig.tiny(), device="cpu", seed=6)
    for (n, p), (_, q), (_, r) in zip(a.named_parameters(),
                                      b.named_parameters(),
                                      c.named_parameters()):
        assert torch.equal(p, q), n
    assert not torch.equal(a.gpt.wte.weight, c.gpt.wte.weight)
