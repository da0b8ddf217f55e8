"""Tensor-parallel serving lanes of paddle_tpu_torch beyond "the whole
world is one lane", held to paddle_tpu's.

The port's lanes run in gloo ranks (`torch_dist_ranks.py`: a world of 2,
`job_lanes2`, and one of 4, `job_lanes4`, each launched once for the
module); the JAX package's run on the 8-virtual-device CPU mesh in this
process while the ranks work, all from the same weights:
- `EngineSupervisor(tp=2)` under `decode_step_raise@3` and
  `prefill_raise@1`: the tokens, the streams' tokens exactly once, the
  restart counts, the audit reasons and the ledger are the JAX
  supervisor's; both ranks reach incarnation 1 on the lane and groups
  they started with;
- `GenerationEngine(mesh=create_mesh({"dp": 2, "tp": 2}))`: ranks 0 and
  2 each lead their dp row's lane;
- a lane over `tp_mesh(2, devices=[2, 3])`, which ranks 0 and 1 refuse
  to join while they build a lane of their own beside it;
- `Router(tp=2, num_replicas=2)` (two lanes on ranks 0-1; a follower rank
  refuses requests);
- two lanes on the same ranks with interleaved requests;
- a follower that raises inside a program, unsupervised and under a
  supervisor: both ranks end the lane with a `LaneFault` naming rank 1
  within the tp group's bound, and a supervised lane is not rebuilt;
- a mesh without a 'tp' axis is refused with the reference's message.
Greedy outputs are also held to the port's tp = 1 engine.
"""
import json

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu import parallel as jparallel
from paddle_tpu import serving as jserving
from paddle_tpu.models import GPTConfig as JConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.serving import failpoints as jfailpoints

from torch_dist_ranks import (LANE_FAULTS, LANE_KW, LANE_TIMEOUT_S,
                              lane_prompts, start_ranks,
                              supervised_scenario, tiny_gpt)


@pytest.fixture(scope="module")
def weights():
    paddle.seed(11)
    net = JGPT(JConfig.tiny(dropout=0.0))
    net.eval()
    return net, {f"gpt.{k}": v.numpy() for k, v in net.state_dict().items()}


def _serve(front, prompts):
    futs = [front.submit(p, max_new_tokens=5) for p in prompts]
    return [np.asarray(f.result(timeout=120)).tolist() for f in futs]


def _jax_refs(net):
    """The JAX package's side of every case, on its CPU mesh."""
    prompts = lane_prompts(seed=5)
    refs = {"sup": {}}
    try:
        for arm, fp in LANE_FAULTS:
            jfailpoints.reset()
            paddle.set_flags({"FLAGS_failpoints": fp,
                              "FLAGS_gen_restart_backoff_ms": 5.0})
            sup = jserving.EngineSupervisor(net, tp=2, name=f"jlane_{arm}",
                                            **LANE_KW)
            try:
                refs["sup"][arm] = supervised_scenario(sup)
            finally:
                sup.shutdown()
    finally:
        paddle.set_flags({"FLAGS_failpoints": ""})
        jfailpoints.reset()
    prev = jparallel.get_mesh()
    try:
        mesh = jparallel.create_mesh({"dp": 2, "tp": 2})
        with jserving.GenerationEngine(net, mesh=mesh, name="jlmesh",
                                       **LANE_KW) as eng:
            refs["mesh"] = _serve(eng, prompts)
        import jax
        sub = jparallel.tp_mesh(2, devices=jax.devices()[2:4])
        with jserving.GenerationEngine(net, mesh=sub, name="jlsub",
                                       **LANE_KW) as eng:
            refs["sub"] = _serve(eng, prompts)
        try:
            jserving.GenerationEngine(net, name="jlnotp", **LANE_KW,
                                      mesh=jparallel.create_mesh({"dp": 2}))
        except Exception as e:  # noqa: BLE001 — compared below
            refs["no_tp"] = (type(e).__name__, str(e))
    finally:
        jparallel.set_mesh(prev)
    router = jserving.Router(net, tp=2, num_replicas=2, name="jlrouter",
                             pressure_ttl_ms=0.0, **LANE_KW)
    try:
        refs["router"] = _serve(router, prompts)
    finally:
        router.shutdown()
    return refs


@pytest.fixture(scope="module")
def lanes(weights, tmp_path_factory):
    """Both worlds' ranks start at once; the JAX references and the
    port's tp = 1 outputs are computed while they run."""
    net, w = weights
    runs = {}
    for world in (2, 4):
        wd = tmp_path_factory.mktemp(f"lanes{world}")
        np.savez(wd / "in.npz", **w)
        runs[world] = start_ranks(f"lanes{world}", world, str(wd),
                                  timeout=240)
    try:
        refs = _jax_refs(net)
        from paddle_tpu_torch import serving
        with serving.GenerationEngine(tiny_gpt(w), device="cpu",
                                      name="lone", **LANE_KW) as eng:
            refs["tp1"] = _serve(eng, lane_prompts(seed=5))
            refs["tp1_sup"] = _serve(eng, lane_prompts())
        got = {world: [json.loads(str(g["json"])) for g in run.wait()]
               for world, run in runs.items()}
    finally:
        for run in runs.values():
            run.close()
    return refs, got


@pytest.mark.parametrize("arm", [a for a, _ in LANE_FAULTS])
def test_supervised_lane_matches_jax(lanes, arm):
    refs, got = lanes
    mine, jax_ = got[2][0][arm], refs["sup"][arm]
    for k in ("outs", "streamed", "counts", "reasons", "ledger"):
        assert mine[k] == jax_[k], k
    assert mine["outs"] == refs["tp1_sup"]
    # each stream's tokens exactly once: the generated part of its result
    for toks, full in zip(mine["streamed"], mine["outs"][2:]):
        assert toks == full[7:]
    assert mine["counts"]["restarts"] == 1
    assert mine["reasons"]["ENGINE_RESTART"] == 1
    assert mine["reasons"]["REPLAY_ADMIT"] == \
        mine["counts"]["replayed_requests"] >= 1
    assert "ENGINE_DIED" not in mine["reasons"]


@pytest.mark.parametrize("arm", [a for a, _ in LANE_FAULTS])
def test_supervised_lane_rebuild_keeps_lane_and_groups(lanes, arm):
    _, got = lanes
    for rank in got[2]:
        r = rank[arm]
        assert r["incarnation"] == 1 and r["restarts"] == 1
        # the rebuilt engines follow the lane built at incarnation 0: its
        # tp and control groups (and the mesh's), and no other
        assert r["same_lane"] and r["lane_groups"] == 3
        assert r["rebuild_groups"] == 0


def test_mesh_dp2_tp2_each_row_leads_its_lane(lanes):
    refs, got = lanes
    ranks = got[4]
    assert [r["mesh_lane"] for r in ranks] == [[0, 1], [0, 1], [2, 3],
                                               [2, 3]]
    assert ranks[0]["mesh"] == ranks[2]["mesh"] == refs["mesh"] \
        == refs["tp1"]
    assert ranks[1]["mesh"] is None and ranks[3]["mesh"] is None


def test_tp_mesh_devices_lane_beside_another(lanes):
    refs, got = lanes
    ranks = got[4]
    assert [r["sub_lane"] for r in ranks] == [[0, 1], [0, 1], [2, 3],
                                              [2, 3]]
    # the [2, 3] lane is led by rank 2; ranks 0-1 served their own lane
    # at the same time
    assert ranks[2]["sub"] == refs["sub"] == refs["tp1"]
    assert ranks[0]["sub"] == refs["tp1"]


def test_rank_outside_the_mesh_refuses(lanes):
    _, got = lanes
    for r in got[4][:2]:
        assert "is in no lane of Mesh({'tp': 2}) over ranks [2, 3]" \
            in r["outside"]


def test_router_over_tp_replicas(lanes):
    refs, got = lanes
    lead = got[2][0]
    assert lead["router"] == refs["router"] == refs["tp1"]
    assert sum(lead["placements"].values()) == 4
    # the same router on ranks 0-1 of a world of 4, ranks 2-3 idle
    assert got[4][0]["router"] == refs["tp1"]


def test_router_refuses_on_a_follower_rank(lanes):
    _, got = lanes
    msg = got[2][1]["router_refused"]
    assert "rank 1 of a tp lane" in msg and "first rank, 0" in msg


def test_two_lanes_on_shared_ranks(lanes):
    refs, got = lanes
    lead = got[2][0]
    a, b = lead["shared_lanes"]
    assert a != b
    assert lead["one"] == refs["tp1"]
    # interleaved over both lanes, each answer is the one lane's
    assert lead["shared"] == lead["one"] + lead["one"]


@pytest.mark.parametrize("arm", ["fault", "fault_sup"])
def test_lane_fault_ends_typed_within_timeout(lanes, arm):
    _, got = lanes
    for rank in got[2]:
        f = rank[arm]
        assert f["error"] == "LaneFault" and f["rank"] == 1
        assert "rank 1 faulted inside" in f["msg"]
        # rank 0 waits out the tp group's bound; rank 1 ends as rank 0
        # ends the lane
        assert f["ended_s"] < LANE_TIMEOUT_S + 5.0
    assert got[2][0][arm]["ended_s"] >= LANE_TIMEOUT_S * 0.9
    if arm == "fault_sup":
        # not rebuilt: the supervisor stays down, naming the lane's end
        assert got[2][0][arm]["health"].startswith("tp lane ended")


def test_mesh_without_tp_refused_as_the_reference(lanes, weights):
    refs, _ = lanes
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.framework.errors import InvalidArgumentError
    from paddle_tpu_torch.parallel import create_mesh, get_mesh, set_mesh
    prev = get_mesh()
    try:
        with pytest.raises(InvalidArgumentError) as e:
            serving.GenerationEngine(tiny_gpt(weights[1]), device="cpu",
                                     name="lnotp", **LANE_KW,
                                     mesh=create_mesh({"dp": 1}))
    finally:
        set_mesh(prev)
    assert (type(e.value).__name__, str(e.value)) == refs["no_tp"]
