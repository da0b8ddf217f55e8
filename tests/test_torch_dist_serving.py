"""Tensor-parallel serving lanes of paddle_tpu_torch held to paddle_tpu's.

The port's tp = 2 and tp = 4 `GenerationEngine`s run in gloo ranks
(`torch_dist_ranks.py`: rank 0 schedules, the others run its programs on
their heads); the JAX package's tp engine runs on the 8-virtual-device
CPU mesh, and the port's tp = 1 engine in this process, all from the
same weights. Every case of `tests/test_tp_identity.py` the port carries
is token-identical across the three: fp32 greedy (tp 2 and 4), int8 KV
pages, a prefix-cache hit's tail prefill, a speculative verify step; a
sampled lane, and one over weight-only int8 projections (the port
quantizes its own model; the JAX tp contract has no such case), are
identical to the port's tp = 1 (no bits cross the two packages'
generators, ROADMAP C2). The exactly-once ledger,
`STAT_tp_kv_shard_bytes`, `pressure()`, the page arithmetic and the
validation errors as `test_tp_identity.py:176-215`. The host tier under
tp (`test_tp_identity.py:144-173`), fp32 and int8 pools: its gathers,
uploads and scatters run as lane programs on every rank, and a lane
demotes, promotes and evicts what tp = 1 does. Supervised lanes, lanes
over part of the world, the router over tp replicas and lanes on shared
ranks are in `test_torch_dist_serving_lanes.py`.
"""
import json

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu import serving as jserving
from paddle_tpu.models import GPTConfig as JConfig
from paddle_tpu.models import GPTForCausalLM as JGPT

from torch_dist_ranks import SERVE_KW, launch_ranks, serve_cases, \
    serve_one, tiny_gpt


@pytest.fixture(scope="module")
def weights():
    paddle.seed(11)
    net = JGPT(JConfig.tiny(dropout=0.0))   # 4 heads: tp in {1, 2, 4}
    net.eval()
    return net, {f"gpt.{k}": v.numpy() for k, v in net.state_dict().items()}


def _jax_outs(net, tp, kw, reqs):
    with jserving.GenerationEngine(net, tp=tp, name=f"jtp{tp}",
                                   **{**SERVE_KW, **kw}) as eng:
        return [eng.generate(p, **{"max_new_tokens": 6, **g}).tolist()
                for p, g in reqs]


@pytest.fixture(scope="module")
def ranks(weights, tmp_path_factory):
    out = {}
    for world in (2, 4):
        wd = tmp_path_factory.mktemp(f"serve{world}")
        np.savez(wd / "in.npz", **weights[1])
        got = launch_ranks(f"serve{world}", world, str(wd))
        out[world] = json.loads(str(got[0]["json"]))
        # the other ranks ran rank 0's programs and answered nothing
        for g in got[1:]:
            other = json.loads(str(g["json"]))
            assert all(v is None for v in other.values())
    return out


@pytest.mark.parametrize("tp,case", [(2, "fp32"), (4, "fp32"),
                                     (2, "sampled"), (2, "int8"),
                                     (2, "prefix"), (2, "spec"),
                                     (2, "wint8")])
def test_tp_engine_token_identity(weights, ranks, tp, case):
    net, w = weights
    name, kw, reqs = next(c for c in serve_cases(tp) if c[0] == case)
    got = ranks[tp][case]
    one = serve_one(tiny_gpt(w), 1, case, kw, reqs)
    assert got["outs"] == one["outs"]
    if case not in ("sampled", "wint8"):
        # sampled tokens cannot match across the two packages' generators
        # (ROADMAP C2): the sampled lane is held to the port's tp = 1
        assert got["outs"] == _jax_outs(net, tp, kw, reqs)
    # the same warmed, exactly-once ledger as tp = 1
    assert got["compiles"] == one["compiles"]
    assert all(v == 1 for v in got["compiles"].values())
    assert got["tp"] == got["pages_tp"] == tp and one["tp"] == 1
    if case == "int8":
        assert got["quantized"]
    if case == "prefix":
        assert got["hits"] >= 1
    if case == "spec":
        assert got["compiles"]["verify[k=2]"] == 1
        assert not any(k.startswith("decode") for k in got["compiles"])


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_shard_bytes_gauge_and_pressure(ranks, tp):
    got = ranks[tp]["fp32"]
    assert got["shard"] * tp == got["hbm"]
    # the live per-shard gauge carried exactly this cache's share
    assert got["gauge"] == got["shard"]
    assert got["pressure_tp"] == tp
    assert got["pressure_shard"] == got["shard"]


@pytest.mark.parametrize("kv", ["fp32", "int8"])
def test_tp_tier_demote_promote_token_identity(weights, ranks, kv):
    """As `test_tp_identity.py::test_tp_tier_demote_promote_token_identity`
    (there fp32 only): the lane's host pages are whole in the budget, so
    it demotes, promotes and evicts exactly what tp = 1 does, and the raw
    bytes round-trip, so its tokens are tp = 1's and the JAX lane's."""
    net, w = weights
    name, kw, reqs = next(c for c in serve_cases(2) if c[0] == f"tier_{kv}")
    got = ranks[2][name]
    one = serve_one(tiny_gpt(w), 1, name, kw, reqs)
    assert got["outs"] == one["outs"] == _jax_outs(net, 2, kw, reqs)
    assert got["tier"]["demotions"] >= 2 and got["tier"]["promotions"] >= 2
    for k in ("demotions", "promotions", "tier_evictions", "host_bytes"):
        assert got["tier"][k] == one["tier"][k], k
    # a rank's slots hold its heads: its slab is about half of tp 1's
    assert got["tier"]["rank_slab_bytes"] < one["tier"]["rank_slab_bytes"]
    assert got["compiles"] == one["compiles"]
    assert got["compiles"]["tier_gather"] == 1
    assert got["quantized"] == (kv == "int8")


def test_tp_page_arithmetic_per_shard():
    """As `test_tp_identity.py::test_tp_page_arithmetic_per_shard`: one
    card's budget admits tp x the pages."""
    from paddle_tpu.serving.kv_cache import PagedKVCache as J
    from paddle_tpu_torch.framework.errors import InvalidArgumentError
    from paddle_tpu_torch.serving import PagedKVCache as T
    kw = dict(num_layers=2, num_heads=4, head_dim=16, page_size=4)
    for tp in (1, 2, 4):
        for dt in ("float32", "int8"):
            assert (T.page_hbm_bytes(**kw, dtype=dt, tp=tp)
                    == J.page_hbm_bytes(**kw, dtype=dt, tp=tp))
        assert (T.pages_for_budget(1 << 20, **kw, tp=tp)
                == J.pages_for_budget(1 << 20, **kw, tp=tp))
    with pytest.raises(InvalidArgumentError):
        T.page_hbm_bytes(**kw, tp=3)   # 4 heads % 3 != 0


def test_tp_validation(weights):
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.framework.errors import InvalidArgumentError
    model = tiny_gpt(weights[1])
    with pytest.raises(InvalidArgumentError, match="not divisible"):
        serving.GenerationEngine(model, device="cpu", tp=3, name="tpbad",
                                 **SERVE_KW)
    with pytest.raises(InvalidArgumentError):
        serving.GenerationConfig(tp=0)
    # no process group: a clear error, never a tp = 1 engine
    with pytest.raises(InvalidArgumentError, match="init_parallel_env"):
        serving.GenerationEngine(model, device="cpu", tp=2, name="tpnopg",
                                 **SERVE_KW)
