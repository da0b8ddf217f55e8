"""Rank processes of the port's multi-process tests (`test_torch_dist_*`).

Imports only numpy, torch and paddle_tpu_torch, as
`tests/dist_train_script.py` does for the JAX package's cluster test.
`launch_ranks(job, world, workdir)` (called by a test) starts `world`
processes of this file, each with the PADDLE_* env of its rank and a
file store under `workdir` for the rendezvous (no port to race for),
joins them under a timeout, kills them on expiry and raises with their
logs. Each rank runs on the CPU over gloo with one thread, reads its
inputs from `workdir/in.npz` and writes `workdir/{job}.r{rank}.npz`.

    python tests/torch_dist_ranks.py JOB WORKDIR

`launch_train` is the script of the launcher test: it takes its rank and
rendezvous from `python -m paddle_tpu_torch.distributed.launch`.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def launch_ranks(job, world, workdir, timeout=150):
    """Run `job` in `world` rank processes; raises (with the ranks' logs)
    if one fails or the timeout expires, after killing them all."""
    return start_ranks(job, world, workdir, timeout).wait()


class start_ranks:
    """`launch_ranks` in two halves: the ranks start here, `wait()` joins
    them and returns their outputs (the test computes its reference
    meanwhile)."""

    def __init__(self, job, world, workdir, timeout=150):
        env = dict(os.environ, PYTHONPATH=REPO,
                   TORCH_DIST_STORE=os.path.join(workdir, f"store.{job}"),
                   OMP_NUM_THREADS="1")
        for k in list(env):
            if k.startswith("PADDLE_"):
                env.pop(k)
        self.job, self.world, self.workdir = job, world, workdir
        self.procs = []
        for r in range(world):
            log = open(os.path.join(workdir, f"{job}.log{r}"), "w")
            e = dict(env, PADDLE_TRAINER_ID=str(r),
                     PADDLE_TRAINERS_NUM=str(world),
                     PADDLE_LOCAL_RANK=str(r))
            self.procs.append((subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), job, workdir],
                env=e, stdout=log, stderr=subprocess.STDOUT, cwd=REPO),
                log))
        self.deadline = time.monotonic() + timeout
        self.timeout = timeout
        self.result = None

    def wait(self):
        if self.result is None:
            self.result = _join(self.job, self.world, self.workdir,
                                self.procs, self.deadline, self.timeout)
        return self.result

    def close(self):
        """Kill the ranks a failed test left running (`wait` did not)."""
        for p, log in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()


def _join(job, world, workdir, procs, deadline, timeout):
    failed = None
    try:
        for p, _ in procs:
            left = deadline - time.monotonic()
            try:
                rc = p.wait(max(left, 0.1))
            except subprocess.TimeoutExpired:
                failed = f"timed out after {timeout} s"
                break
            if rc != 0:
                failed = f"a rank exited with {rc}"
                break
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    if failed:
        logs = ""
        for r in range(world):
            with open(os.path.join(workdir, f"{job}.log{r}")) as f:
                logs += f"--- rank {r}\n{f.read()[-3000:]}\n"
        raise AssertionError(f"{job}: {failed}\n{logs}")
    return [dict(np.load(os.path.join(workdir, f"{job}.r{r}.npz"),
                         allow_pickle=True)) for r in range(world)]


# -- jobs ----------------------------------------------------------------------

def job_collective(wd, r, n, inp):
    import torch
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed import ReduceOp
    out = {}
    x = np.arange(8, dtype=np.float32) + 10 * r
    for name, op, base in (("sum", ReduceOp.SUM, x), ("max", ReduceOp.MAX,
                                                      x),
                           ("min", ReduceOp.MIN, x),
                           ("prod", ReduceOp.PROD, x / 10 + 1)):
        t = torch.tensor(base)
        D.all_reduce(t, op)
        out[f"ar_{name}"] = t.numpy()
    ti = torch.tensor(np.arange(8, dtype=np.int32) * (r + 1))
    D.all_reduce(ti)
    out["ar_int"] = ti.numpy()
    lst = []
    out["ag"] = D.all_gather(lst, torch.tensor(x)).numpy()
    assert len(lst) == n
    if n == 2:
        t = torch.tensor(x)
        D.broadcast(t, src=1)
        out["bc"] = t.numpy()
        t = torch.tensor(x)
        D.reduce(t, dst=0)
        out["red"] = t.numpy()
        parts = [torch.arange(4, dtype=torch.float32) + 100 * i
                 for i in range(n)]
        t = torch.empty(4)
        D.scatter(t, parts, src=0)
        out["sc"] = t.numpy()
        t = torch.empty(8 // n)
        D.reduce_scatter(t, list(torch.tensor(x).chunk(n)))
        out["rs"] = t.numpy()
        rows = []
        out["a2a"] = D.alltoall(list(torch.tensor(x).reshape(n, 8 // n)),
                                rows).numpy()
        assert len(rows) == n
        t = torch.tensor(x)
        if r == 0:
            D.send(t, dst=1)
        else:
            D.recv(t, src=0)
        out["p2p"] = t.numpy()
        D.barrier()
    else:
        from paddle_tpu_torch.parallel import create_mesh
        mesh = create_mesh({"dp": 2, "tp": 2})
        out["coords"] = np.asarray(mesh.coords)
        for ax in ("dp", "tp"):
            t = torch.tensor(x)
            with D.shard_ctx(ax):
                D.all_reduce(t)
            out[f"ar_{ax}"] = t.numpy()
    return out


def _mlp(inp, prefix):
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.models import load_reference_state
    net = nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 4))
    load_reference_state(net, {k[len(prefix):]: v for k, v in inp.items()
                               if k.startswith(prefix)})
    return net


def _params(net):
    return {n: p.detach().numpy().copy() for n, p in net.named_parameters()}


def job_train(wd, r, n, inp):
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import distributed as D, nn
    from paddle_tpu_torch.framework.sharded_checkpoint import (
        AsyncCheckpointer, load_sharded, save_sharded)
    from paddle_tpu_torch.parallel import make_sharded_train_step
    out = {}
    X, Y = inp["x"], inp["y"]
    ce = nn.CrossEntropyLoss()

    def loss_fn(o, labels):
        return ce(o, labels[0])

    def run(tag, opt_cls, lr, **kw):
        net = _mlp(inp, "w.")
        opt = opt_cls(lr, parameters=net.parameters())
        level = kw.pop("level", None)
        if level:
            net, opt = D.group_sharded_parallel(net, opt, level)
        step, st = make_sharded_train_step(net, opt, loss_fn, **kw)
        losses = []
        for _ in range(3):
            st, lv = step(st, (X,), (Y,))
            losses.append(float(lv))
        out[f"{tag}.losses"] = np.asarray(losses)
        # the state dict: ZeRO-3's blocks gathered
        for k, v in net.state_dict().items():
            out[f"{tag}.{k}"] = v.numpy()
        return step, st
    for z in (0, 1, 2):
        run(f"zero{z}", paddle.optimizer.Momentum, 0.1, zero_stage=z)
    # recompute: the checkpointed forward trains to the same values
    run("recompute", paddle.optimizer.Momentum, 0.1, zero_stage=1,
        recompute=True)
    for level in ("os", "os_g", "p_g_os"):
        step, st = run(level, paddle.optimizer.Adam, 0.01, level=level)
        if level == "os":
            # ZeRO-1's state saved at world 2, its blocks kept for the
            # test, then a world-1 checkpoint loaded under this rank's
            # blocks
            for k, v in st["opt_state"].items():
                for s, t in v.items():
                    out[f"os.opt.{k}.{s}"] = t.numpy()
            save_sharded(st, os.path.join(wd, "ck2"),
                         shardings=step.state_sharding)
            back = load_sharded(os.path.join(wd, "ck1"),
                                shardings=step.state_sharding)
            for k, v in back["opt_state"].items():
                for s, t in v.items():
                    out[f"ck1.opt.{k}.{s}"] = t.numpy()
            out["ck1.step_no"] = np.asarray(back["step_no"])
            # the async writer: files written off the caller's thread
            ck = AsyncCheckpointer()
            ck.save(os.path.join(wd, "ck2a"), st, step.state_sharding)
            ck.wait()
            again = load_sharded(os.path.join(wd, "ck2a"),
                                 shardings=step.state_sharding)
            out["async_equal"] = np.asarray(all(
                torch.equal(again["opt_state"][k][s], t)
                for k, v in st["opt_state"].items() for s, t in v.items()))
            out["zero_axes"] = np.asarray(json.dumps(step.zero_axes))
    # DataParallel on this rank's half of the rows
    torch.manual_seed(0)
    net = _mlp(inp, "w.")
    dp = D.DataParallel(net)
    opt = paddle.optimizer.Momentum(0.1, parameters=net.parameters())
    rows = slice(r * len(X) // n, (r + 1) * len(X) // n)
    for _ in range(3):
        lv = ce(dp(torch.tensor(X[rows])), torch.tensor(Y[rows]))
        dp.scale_loss(lv).backward()
        opt.step()
        opt.clear_grad()
    for k, v in _params(net).items():
        out[f"dp.{k}"] = v
    # a parameter no loss reaches: refused without find_unused_parameters,
    # reduced as a zero gradient with it
    for flag in (False, True):
        two = torch.nn.ModuleDict({"used": nn.Linear(8, 4),
                                   "unused": nn.Linear(8, 4)})
        dpu = D.DataParallel(two, find_unused_parameters=flag)
        try:
            dpu._layers["used"](torch.tensor(X[rows])).sum().backward()
            out[f"unused.{flag}"] = np.asarray(
                float(two["unused"].weight.grad.abs().sum()))
        except RuntimeError as e:
            out[f"unused.{flag}"] = np.asarray(
                "find_unused_parameters" in str(e))
    return out


def tp_net():
    import torch
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed import (ColumnParallelLinear,
                                              RowParallelLinear,
                                              VocabParallelEmbedding)

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = VocabParallelEmbedding(32, 16)
            self.up = ColumnParallelLinear(16, 32, gather_output=False)
            self.down = RowParallelLinear(32, 16, input_is_parallel=True)

        def forward(self, ids):
            return self.down(torch.relu(self.up(self.emb(ids))))
    return Net()


def job_tp_train(wd, r, n, inp):
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed.tensor_parallel import shard_tensor
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.parallel import create_mesh, make_sharded_train_step
    mesh = create_mesh({"dp": 2, "mp": 2})
    net = tp_net()
    with torch.no_grad():
        for name, p in net.named_parameters():
            p.copy_(shard_tensor(torch.from_numpy(inp[f"w.{name}"]),
                                 getattr(p, "partition_spec", None), mesh))
    opt = paddle.optimizer.Adam(0.01, parameters=net.parameters())
    step, st = make_sharded_train_step(
        net, opt, lambda o, labels: F.mse_loss(o, labels[0]), zero_stage=1)
    losses = []
    for _ in range(3):
        st, lv = step(st, (inp["ids"],), (inp["y"],))
        losses.append(float(lv))
    out = {"losses": np.asarray(losses), "coords": np.asarray(mesh.coords)}
    for k, v in _params(net).items():
        out[f"p.{k}"] = v
    return out


def job_attention(wd, r, n, inp):
    import torch
    from paddle_tpu_torch.ops import paged_ops as po
    from paddle_tpu_torch.ops import splash_ops as so
    from paddle_tpu_torch.parallel import (create_mesh,
                                           sharded_splash_attention)
    out = {}
    rows = slice(r * 2, r * 2 + 2)
    t = {k: torch.tensor(inp[k][rows]) for k in ("q", "k", "v", "dout")}
    seg = torch.tensor(inp["seg"][rows])
    for k in ("q", "k", "v"):
        t[k].requires_grad_(True)
    f = sharded_splash_attention(causal=True)
    o = f(t["q"], t["k"], t["v"], seg, seg)
    (o * t["dout"]).sum().backward()
    out["out"] = o.detach().numpy()
    for k in ("q", "k", "v"):
        out[f"d{k}"] = t[k].grad.numpy()
    # dropout: both ranks get the SAME rows; the folded seed must give
    # each its own keep mask, equal to the plain version's at seed + r
    q, k, v = (torch.tensor(inp[x][0:2]) for x in ("q", "k", "v"))
    s0 = torch.tensor(inp["seg"][0:2])
    fd = sharded_splash_attention(causal=True, dropout_p=0.5)
    out["drop"] = fd(q, k, v, s0, s0, seed=7).numpy()
    scale = 1.0 / q.shape[-1] ** 0.5
    out["drop_plain"] = so._splash_fwd_reference(
        q, k, v, s0.int(), s0.int(), True, scale, 0.5, seed=7 + r)[0].numpy()
    # K1 over this rank's heads of a tp = 2 mesh
    mesh = create_mesh({"tp": 2})
    h = slice(r * 2, r * 2 + 2)
    pq = torch.tensor(inp["pq"][:, h])
    pt, pos = torch.tensor(inp["pt"]), torch.tensor(inp["pos"])
    scale = 1.0 / pq.shape[-1] ** 0.5
    fk = po.sharded_paged_attention(mesh, scale)
    out["paged"] = fk(pq, torch.tensor(inp["kp"][h]),
                      torch.tensor(inp["vp"][h]), pt, pos).numpy()
    fq = po.sharded_paged_attention(mesh, scale, quantized=True)
    out["paged_q8"] = fq(pq, torch.tensor(inp["kq"][h]),
                         torch.tensor(inp["vq"][h]),
                         torch.tensor(inp["ks"][h]),
                         torch.tensor(inp["vs"][h]), pt, pos).numpy()
    out["launches"] = np.asarray(po.paged_attention.launches)
    return out


SERVE_KW = dict(max_slots=2, page_size=4, num_pages=64, prefill_buckets=(8,),
                max_new_tokens=6, request_timeout_ms=0)


def serve_cases(tp):
    """(name, engine overrides, [(prompt, generate kwargs)]) of the JAX
    package's tp identity contract (`tests/test_tp_identity.py`)."""
    def prompts(seed, n=3, S=7):
        return [np.random.RandomState(seed + i).randint(
            0, 512, size=(S,)).astype("int64") for i in range(n)]
    cases = [("fp32", {}, [(p, {}) for p in prompts(0)])]
    if tp == 2:
        rng = np.random.RandomState(9)
        prefix = rng.randint(0, 512, size=(8,)).astype("int64")
        tails = [rng.randint(0, 512, size=(3,)).astype("int64")
                 for _ in range(2)]
        cases += [
            ("sampled", {}, [(p, dict(do_sample=True, temperature=0.8))
                             for p in prompts(3)]),
            ("int8", {"kv_cache_dtype": "int8"},
             [(p, {}) for p in prompts(5)]),
            ("prefix", {"prefix_cache": True, "prefill_buckets": (4, 16)},
             [(np.concatenate([prefix, t]), {}) for t in tails]),
            ("spec", {"spec_k": 2},
             [(np.array([7, 8, 9, 7, 8, 9, 7], np.int64), {}),
              (np.array([5, 5, 5, 5, 5, 5, 5], np.int64), {})]),
            # weight-only int8 projections: each rank keeps its slice of
            # the integers and of the scales of its output columns
            ("wint8", {"_quantize": 8}, [(p, {}) for p in prompts(7)]),
        ]
        # the host tier under tp (`test_tp_identity.py:144-173`): a flood
        # of shared-prefix prompts through 12 pages demotes, the revisit
        # of the first promotes
        rng = np.random.RandomState(31)
        flood = [np.concatenate([rng.randint(0, 512, size=(8,)),
                                 rng.randint(0, 512, size=(3,))])
                 .astype("int64") for _ in range(8)]
        for kv in ("fp32", "int8"):
            cases.append((f"tier_{kv}", dict(TIER_KW, kv_cache_dtype=(
                "int8" if kv == "int8" else "auto")),
                [(p, {"max_new_tokens": 4}) for p in flood + flood[:1]]))
    return cases


TIER_KW = dict(num_pages=12, prefill_buckets=(16,), max_new_tokens=4,
               prefix_cache=True, kv_tier=True, kv_tier_host_bytes=64 << 20,
               kv_tier_chunk_pages=2)


def tiny_gpt(inp):
    from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                         load_reference_state)
    m = GPTForCausalLM(GPTConfig.tiny(dropout=0.0), device="cpu").eval()
    load_reference_state(m, {k[4:]: v for k, v in inp.items()
                             if k.startswith("gpt.")})
    return m


def serve_one(model, tp, name, kw, reqs):
    """Outputs and stats of one engine over `reqs` (rank 0's; None on the
    other ranks)."""
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.framework import monitor
    kw = dict(kw)
    bits = kw.pop("_quantize", None)
    if bits:
        import copy
        from paddle_tpu_torch.quantization import quantize_weights
        model = quantize_weights(copy.deepcopy(model), bits)
    base = monitor.stat_get("STAT_tp_kv_shard_bytes") or 0
    with serving.GenerationEngine(model, device="cpu", tp=tp,
                                  name=f"tp{tp}{name}",
                                  **{**SERVE_KW, **kw}) as eng:
        if tp > 1 and eng._lane is not None and not eng._lane.leader:
            return None
        outs = [eng.generate(p, **{"max_new_tokens": 6, **g})
                for p, g in reqs]
        st = eng.stats()
        pr = eng.pressure()
        gauge = (monitor.stat_get("STAT_tp_kv_shard_bytes") or 0) - base
    return {"outs": [o.tolist() for o in outs], "compiles": st["compiles"],
            "tp": st["tp"], "pages_tp": st["pages"]["tp"],
            "quantized": st["pages"]["quantized"],
            "hbm": st["pages"]["hbm_bytes"],
            "shard": st["pages"]["shard_hbm_bytes"], "gauge": gauge,
            "pressure_tp": pr["tp"], "pressure_shard": pr["kv_shard_bytes"],
            "hits": st["kv"]["prefix"].get("hits", 0),
            "tier": {k: st["kv"]["prefix"].get(k, 0) for k in (
                "demotions", "promotions", "tier_evictions", "host_bytes",
                "rank_slab_bytes")},
            "pages_in_use": st["pages"]["pages_in_use"],
            "cached": st["kv"]["prefix"].get("cached_pages", 0)}


def job_serve(wd, r, n, inp):
    model = tiny_gpt(inp)
    res = {}
    for name, kw, reqs in serve_cases(n):
        res[name] = serve_one(model, n, name, kw, reqs)
    return {"json": np.asarray(json.dumps(res))}


# -- tp lanes: supervised, over part of the world, routed, on shared ranks ----

LANE_KW = dict(max_slots=2, page_size=4, num_pages=64, prefill_buckets=(8,),
               max_new_tokens=5, request_timeout_ms=0)
LANE_FAULTS = (("decode", "decode_step_raise@3"),
               ("prefill", "prefill_raise@1"))
LANE_COUNTS = ("incarnation", "restarts", "replayed_requests",
               "retry_exhausted", "replay_impossible")
# the lane-fault arm's bound on its tp group's collectives, seconds
LANE_TIMEOUT_S = 3.0


def lane_prompts(n=4, seed=0):
    return list(np.random.RandomState(seed).randint(
        0, 512, size=(n, 7)).astype("int64"))


def supervised_scenario(sup):
    """Two futures and two streams submitted under the engine's lock (one
    admission pass), as `test_torch_resurrection.py` does; works on either
    package's `EngineSupervisor`. Returns what the parity compares."""
    import collections
    prompts = lane_prompts()
    with sup.engine._cv:
        futs = [sup.submit(p, max_new_tokens=5) for p in prompts[:2]]
        streams = [sup.submit_stream(p, max_new_tokens=5)
                   for p in prompts[2:]]
    outs = [np.asarray(f.result(timeout=120)).tolist() for f in futs]
    streamed = [[int(t) for t in st] for st in streams]
    outs += [np.asarray(st.result(timeout=120)).tolist() for st in streams]
    st = sup.supervisor_stats()
    return {"outs": outs, "streamed": streamed,
            "counts": {k: st[k] for k in LANE_COUNTS},
            "reasons": dict(collections.Counter(
                e["reason"] for e in sup.engine._audit.tail(4096))),
            "ledger": sorted(sup.engine._ledger)}


def _groups():
    """Process groups this rank belongs to (the default one included)."""
    import torch.distributed as dist
    return len(dist.distributed_c10d._world.pg_names)


def _serve(front, prompts, new=5):
    """Greedy outputs of `prompts` through an engine, supervisor or
    router, submitted together."""
    futs = [front.submit(p, max_new_tokens=new) for p in prompts]
    return [np.asarray(f.result(timeout=120)).tolist() for f in futs]


def job_lanes2(wd, r, n, inp):
    """World 2: supervised lanes under the JAX contract's deaths, two
    lanes on shared ranks, the router over tp replicas, and a follower
    that raises inside a program (last: its lane's tp group is done)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.framework.errors import InvalidArgumentError
    from paddle_tpu_torch.serving import failpoints
    model = tiny_gpt(inp)
    res = {}
    for arm, fp in LANE_FAULTS:
        failpoints.reset()
        paddle.set_flags({"FLAGS_failpoints": fp,
                          "FLAGS_gen_restart_backoff_ms": 5.0})
        g0 = _groups()
        sup = serving.EngineSupervisor(model, device="cpu", tp=2,
                                       name=f"lane_{arm}", **LANE_KW)
        lane, g1 = sup.engine._lane, _groups()
        out = supervised_scenario(sup) if sup.leads else {}
        sup.shutdown()
        out.update(incarnation=sup.incarnation, restarts=sup.restarts,
                   same_lane=sup.engine._lane is lane,
                   lane_groups=g1 - g0, rebuild_groups=_groups() - g1)
        res[arm] = out
    paddle.set_flags({"FLAGS_failpoints": ""})
    failpoints.reset()
    prompts = lane_prompts(seed=5)
    # one lane, then two lanes on the same two ranks with their requests
    # interleaved
    one = serving.GenerationEngine(model, device="cpu", tp=2, name="one",
                                   **LANE_KW)
    res["one"] = _serve(one, prompts) if one._lane.leader else None
    one.shutdown()
    a = serving.GenerationEngine(model, device="cpu", tp=2, name="laneA",
                                 **LANE_KW)
    b = serving.GenerationEngine(model, device="cpu", tp=2, name="laneB",
                                 **LANE_KW)
    if a._lane.leader:
        futs = [(a if i % 2 else b).submit(p, max_new_tokens=5)
                for i, p in enumerate(prompts + prompts)]
        res["shared"] = [np.asarray(f.result(timeout=120)).tolist()
                         for f in futs]
        res["shared_lanes"] = [a._lane.name, b._lane.name]
    a.shutdown()
    b.shutdown()
    # the router over two tp 2 replicas on ranks 0-1
    router = serving.Router(model, tp=2, num_replicas=2, name="lrouter",
                            device="cpu", pressure_ttl_ms=0.0, **LANE_KW)
    if r == 0:
        res["router"] = _serve(router, prompts)
        res["placements"] = {k: v["placements"] for k, v in
                             router.stats()["router"]["replicas"].items()}
    else:
        try:
            router.submit(prompts[0])
            res["router_refused"] = None
        except InvalidArgumentError as e:
            res["router_refused"] = str(e)
    router.shutdown()
    res["fault"] = lane_fault_arm(model, r, supervised=False)
    res["fault_sup"] = lane_fault_arm(model, r, supervised=True)
    return {"json": np.asarray(json.dumps(res))}


def lane_fault_arm(model, r, supervised):
    """Rank 1's decode program raises at its first decode step after the
    warmup's: rank 0 waits in that step's all-reduce until the group's
    bound, and both ranks end the lane with a LaneFault naming rank 1 (a
    supervised lane too: it is not rebuilt)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.serving.tp_lane import LaneFault
    paddle.set_flags({"FLAGS_gen_tp_timeout_s": LANE_TIMEOUT_S})
    cls = serving.GenerationEngine
    orig, calls, t_fault = cls._decode_call, [0], []

    def faulty(self, *a, **k):
        calls[0] += 1
        if calls[0] == 2:
            t_fault.append(time.monotonic())
            raise RuntimeError("injected fault inside the decode program")
        return orig(self, *a, **k)
    if r == 1:
        cls._decode_call = faulty
    out = {}
    t0 = time.monotonic()
    try:
        eng = (serving.EngineSupervisor if supervised else cls)(
            model, device="cpu", tp=2, name=f"lanefault{int(supervised)}",
            **LANE_KW)
        t0 = time.monotonic()
        if r == 0:
            eng.generate(lane_prompts()[0], max_new_tokens=5)
        else:
            eng.shutdown()
        out["error"] = None
    except LaneFault as e:
        out.update(error=type(e).__name__, rank=e.rank, msg=str(e))
    finally:
        cls._decode_call = orig
    out["ended_s"] = time.monotonic() - (t_fault[0] if t_fault else t0)
    if r == 0:
        if supervised:
            out["health"] = eng.health()["reason"]
        eng.shutdown()
    return out


def job_lanes4(wd, r, n, inp):
    """World 4: a dp 2 x tp 2 mesh (ranks 0 and 2 lead), then a lane over
    ranks [2, 3] built while ranks 0 and 1 refuse it and build a lane of
    their own, then the router over tp replicas on ranks 0-1 while ranks
    2 and 3 stay idle."""
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.framework.errors import InvalidArgumentError
    from paddle_tpu_torch.parallel import create_mesh, set_mesh, tp_mesh
    model = tiny_gpt(inp)
    prompts = lane_prompts(seed=5)
    res = {"rank": r}
    mesh = create_mesh({"dp": 2, "tp": 2})
    eng = serving.GenerationEngine(model, device="cpu", mesh=mesh,
                                   name="lmesh", **LANE_KW)
    res["mesh_lane"] = eng._lane.ranks
    res["mesh"] = _serve(eng, prompts) if eng._lane.leader else None
    eng.shutdown()
    set_mesh(None)
    sub = tp_mesh(2, devices=[2, 3])
    if r >= 2:
        eng = serving.GenerationEngine(model, device="cpu", mesh=sub,
                                       name="lsub", **LANE_KW)
    else:
        try:
            serving.GenerationEngine(model, device="cpu", mesh=sub,
                                     name="lsub", **LANE_KW)
            res["outside"] = None
        except InvalidArgumentError as e:
            res["outside"] = str(e)
        # a lane of their own beside it
        eng = serving.GenerationEngine(model, device="cpu", tp=2,
                                       name="lown", **LANE_KW)
    res["sub_lane"] = eng._lane.ranks
    res["sub"] = _serve(eng, prompts) if eng._lane.leader else None
    eng.shutdown()
    if r < 2:
        router = serving.Router(model, tp=2, num_replicas=2,
                                name="lrouter4", device="cpu",
                                pressure_ttl_ms=0.0, **LANE_KW)
        res["router"] = _serve(router, prompts) if r == 0 else None
        router.shutdown()
    return {"json": np.asarray(json.dumps(res))}


# -- the strategies' slice (sequence parallel, pipeline, fleet) ---------------

def tiny_lm(inp, prefix="gpt."):
    """The tests' tiny GPT (`tests/test_pipeline_hetero.py:33`'s config) with
    the JAX model's weights."""
    from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                         load_reference_state)
    cfg = GPTConfig.tiny(vocab_size=128, num_layers=4, hidden_size=32,
                         num_heads=2, intermediate_size=64,
                         max_position_embeddings=32, dropout=0.0)
    m = GPTForCausalLM(cfg, device="cpu")
    load_reference_state(m, {k[len(prefix):]: v for k, v in inp.items()
                             if k.startswith(prefix)})
    return m


def lm_loss(out, labels):
    from paddle_tpu_torch import nn
    b, s, v = out.shape
    return nn.functional.cross_entropy(out.reshape(b * s, v),
                                       labels[0].reshape(b * s))


def _ring_gpt(m):
    import torch

    class Ring(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.m = m

        def forward(self, ids):
            return self.m(ids, use_ring=True)
    return Ring()


def job_sp(wd, r, n, inp):
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework.errors import InvalidArgumentError
    from paddle_tpu_torch.parallel import (create_mesh,
                                           make_sharded_train_step,
                                           shard_map_ring_attention)
    mesh = create_mesh({"sp": 2})
    out = {}
    for impl in ("ring", "ulysses"):
        for causal in (False, True):
            for dt in ("float32", "bfloat16"):
                qkv = [torch.tensor(inp[x]).to(getattr(torch, dt))
                       .requires_grad_() for x in ("q", "k", "v")]
                o = shard_map_ring_attention(*qkv, mesh, causal=causal,
                                             impl=impl)
                (o.float() * torch.tensor(inp["dout"])).sum().backward()
                tag = f"{impl}.{causal}.{dt}"
                out[f"{tag}.dtype"] = np.asarray(str(o.dtype))
                out[f"{tag}.out"] = o.detach().float().numpy()
                for x, t in zip("qkv", qkv):
                    out[f"{tag}.d{x}"] = t.grad.float().numpy()
    # the sp train step of the GPT with use_ring=True
    m = tiny_lm(inp)
    opt = paddle.optimizer.SGD(0.1, parameters=m.parameters())
    step, st = make_sharded_train_step(_ring_gpt(m), opt, lm_loss,
                                       sp_axis="sp", zero_stage=0)
    losses = []
    for _ in range(2):
        st, lv = step(st, (inp["ids"],), (inp["tgt"],))
        losses.append(float(lv))
    out["sp.losses"] = np.asarray(losses)
    for k, v in _params(m).items():
        out[f"sp.p.{k}"] = v
    # a model whose attention is not sequence-parallel is refused
    m2 = tiny_lm(inp)
    step, st = make_sharded_train_step(
        m2, paddle.optimizer.SGD(0.1, parameters=m2.parameters()), lm_loss,
        sp_axis="sp", zero_stage=0)
    try:
        step(st, (inp["ids"],), (inp["tgt"],))
        out["refused"] = np.asarray("")
    except InvalidArgumentError as e:
        out["refused"] = np.asarray(str(e))
    return out


def _pipeline_cases():
    return (("gpipe_recompute", "gpipe", True), ("gpipe", "gpipe", False),
            ("1f1b", "1f1b", False))


def job_pipeline(wd, r, n, inp):
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.parallel import (create_mesh, gpipe_spmd,
                                           make_pipeline_train_step,
                                           pipeline_write_back)
    mesh = create_mesh({"dp": n // 2, "pp": 2})
    out = {"coords": np.asarray(mesh.coords)}
    for tag, sched, rc in _pipeline_cases():
        m = tiny_lm(inp)
        opt = paddle.optimizer.SGD(0.1, parameters=m.parameters())
        step, st = make_pipeline_train_step(m, opt, lm_loss, n_micro=4,
                                            schedule=sched, recompute=rc)
        losses = []
        for _ in range(3):
            st, lv = step(st, (inp["ids"],), (inp["tgt"],))
            losses.append(float(lv))
        out[f"{tag}.losses"] = np.asarray(losses)
        out[f"{tag}.held"] = np.asarray(sorted(st["params"]))
        pipeline_write_back(m)
        for k, v in _params(m).items():
            out[f"{tag}.p.{k}"] = v
    if n == 2:
        # the homogeneous GPipe helper and its gradient
        W = torch.tensor(inp["W"], requires_grad=True)
        fwd = gpipe_spmd(lambda w, mx: torch.tanh(mx @ w), mesh, n_micro=4)
        y = fwd(W, torch.tensor(inp["x"]))[-1]
        (y * torch.tensor(inp["dy"])).sum().backward()
        out["gpipe_spmd.y"] = y.detach().numpy()
        out["gpipe_spmd.dW"] = W.grad.numpy()
    return out


def _mlp_tok(inp, prefix):
    """The fleet tests' MLP (8 -> 16 -> tanh -> out features, token-wise
    on [B, S, 8]) with the JAX model's weights under `prefix`."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.models import load_reference_state
    out_f = inp[f"{prefix}2.weight"].shape[1]
    net = nn.Sequential(nn.Linear(8, 16), nn.Tanh(), nn.Linear(16, out_f))
    load_reference_state(net, {k[len(prefix):]: v for k, v in inp.items()
                               if k.startswith(prefix)})
    return net


def mse(out, labels):
    d = out - labels[0]
    return (d * d).mean()


# batch leaves whose placement `Fleet.batch_placement` gives: even, a
# sequence that does not split, a 1-D leaf, an odd batch
PLACED_SHAPES = ((8, 6, 8), (8, 5), (8,), (7, 6))

FLEET_BRANCHES = ("sharded", "zero1", "recompute", "fp16_allreduce", "dgc",
                  "sequence_parallel", "localsgd", "adaptive_localsgd",
                  "pipeline")


def fleet_strategy(D, branch):
    """The strategy of one branch of `Fleet.build_sharded_train_step`, at
    the degrees of a world of 2 (`D`: either package's fleet)."""
    s = D.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 1 if branch == "pipeline" else 2}
    if branch == "zero1":
        s.sharding = True
        s.sharding_configs = {"stage": 1}
    elif branch == "recompute":
        s.recompute = True
    elif branch == "fp16_allreduce":
        s.fp16_allreduce = True
    elif branch == "dgc":
        s.dgc = True
        s.dgc_configs = {"momentum": 0.9, "sparsity": 0.75}
    elif branch == "sequence_parallel":
        s.sequence_parallel = True
        s.sequence_parallel_configs = {"degree": 2}
        s.hybrid_configs = {"dp_degree": 1, "sp_degree": 2}
    elif branch == "localsgd":
        s.localsgd = True
        s.localsgd_configs = {"k_steps": 2, "begin_step": 1}
    elif branch == "adaptive_localsgd":
        s.adaptive_localsgd = True
        s.adaptive_localsgd_configs = {"init_k_steps": 2, "begin_step": 1}
    elif branch == "pipeline":
        s.pipeline = True
        s.pipeline_configs = {"accumulate_steps": 4}
    return s


def _which_step(step, state):
    if hasattr(step, "stage"):
        return "pipeline"
    if "since_sync" in state:
        return "local"
    return "sharded" + ("+dgc" if "dgc" in state else "")


def job_fleet(wd, r, n, inp):
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import io, nn
    from paddle_tpu_torch.distributed import fleet as F
    from paddle_tpu_torch.parallel import set_mesh
    out = {}
    # each branch of the strategy dispatch, 2 steps
    for br in FLEET_BRANCHES:
        F.init(is_collective=True, strategy=fleet_strategy(F, br))
        if br == "pipeline":
            net = tiny_lm(inp)
            data, lf = (inp["ids"],), (lm_loss, (inp["tgt"],))
        else:
            net = _mlp_tok(inp, "tok.")
            data, lf = (inp["tx"],), (mse, (inp["ty"],))
        opt = F.distributed_optimizer(
            paddle.optimizer.SGD(0.1, parameters=net.parameters()))
        step, st = F.fleet.build_sharded_train_step(net, opt, lf[0])
        out[f"{br}.which"] = np.asarray(_which_step(step, st))
        losses = []
        for _ in range(2):
            st, lv = step(st, data, lf[1])
            losses.append(float(lv))
        out[f"{br}.losses"] = np.asarray(losses)
        out[f"{br}.mesh"] = np.asarray(json.dumps(
            paddle.parallel.get_mesh().shape))
        place = F.fleet.batch_placement()
        out[f"{br}.placement"] = np.asarray(json.dumps(
            [None if place(np.zeros(sh)) is None else
             list(place(np.zeros(sh))) for sh in PLACED_SHAPES]))
    # the eight fleet metrics over the two ranks
    mv = {k[len(f"m{r}."):]: v for k, v in inp.items()
          if k.startswith(f"m{r}.")}
    met = F.metrics
    out["metrics"] = np.asarray(json.dumps({
        "sum": met.sum(mv["a"]).tolist(), "max": met.max(mv["a"]).tolist(),
        "min": met.min(mv["a"]).tolist(), "mean": met.mean(mv["a"]).tolist(),
        "acc": met.acc(mv["c"], mv["t"]), "mae": met.mae(mv["e"], mv["t"]),
        "rmse": met.rmse(mv["e"], mv["t"]),
        "auc": met.auc(mv["pos"], mv["neg"]),
        "util_sum": F.UtilBase().all_reduce(mv["a"]).tolist(),
        "util_max": F.UtilBase().all_reduce(mv["a"], "max").tolist(),
        "util_gather": [x.tolist() for x in F.UtilBase().all_gather(
            mv["a"])]}))
    # hapi Model.fit through fleet (a default strategy), a padded tail
    set_mesh(None)
    F.init(is_collective=True)

    class DS(io.Dataset):
        def __len__(self):
            return len(inp["fx"])

        def __getitem__(self, i):
            return inp["fx"][i], inp["fy"][i]

    net = _mlp_tok(inp, "fit.")
    model = paddle.Model(net)
    model.prepare(paddle.optimizer.SGD(0.1, parameters=net.parameters()),
                  nn.CrossEntropyLoss())
    got = []

    class Rec(paddle.callbacks.Callback):
        def on_train_batch_end(self, step, logs=None):
            got.append(float(logs["loss"]))

    model.fit(DS(), batch_size=8, epochs=2, shuffle=False, verbose=0,
              log_freq=1, callbacks=[Rec()])
    out["fit.routed"] = np.asarray(model._sharded_step is not None)
    out["fit.losses"] = np.asarray(got)
    for k, v in _params(net).items():
        out[f"fit.p.{k}"] = v
    # the same fit at ZeRO-3 (sharding stage 3): Model.save and evaluate
    # after it read the whole weights
    from paddle_tpu_torch.framework import io_state
    set_mesh(None)
    s3 = F.DistributedStrategy()
    s3.sharding = True
    s3.sharding_configs = {"stage": 3}
    F.init(is_collective=True, strategy=s3)
    net = _mlp_tok(inp, "fit.")
    model = paddle.Model(net)
    model.prepare(paddle.optimizer.SGD(0.1, parameters=net.parameters()),
                  nn.CrossEntropyLoss())
    got3 = []

    class Rec3(paddle.callbacks.Callback):
        def on_train_batch_end(self, step, logs=None):
            got3.append(float(logs["loss"]))

    model.fit(DS(), batch_size=8, epochs=2, shuffle=False, verbose=0,
              log_freq=1, callbacks=[Rec3()])
    out["fit3.blocks"] = np.asarray(sum(
        getattr(v, "_zero_gather", None) is not None
        for v in model._sharded_state["params"].values()))
    out["fit3.losses"] = np.asarray(got3)
    path = os.path.join(wd, f"fit3_r{r}")
    model.save(path)
    for k, v in io_state.load(path + ".pdparams").items():
        out[f"fit3.saved.{k}"] = np.asarray(v)
    out["fit3.eval"] = np.asarray(
        model.evaluate(DS(), batch_size=8, verbose=0)["loss"])
    set_mesh(None)
    return out


def job_localsgd(wd, r, n, inp):
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.parallel import (create_mesh, local_write_back,
                                           make_local_train_step,
                                           make_sharded_train_step)
    out = {}
    create_mesh({"dp": 2})
    X, Y = inp["x"], inp["y"]
    # LocalSGD k = 1 against synchronous dp (SGD: averaging commutes)
    for tag, mk in (("sync", lambda net, opt: make_sharded_train_step(
            net, opt, mse, zero_stage=0)),
                    ("local1", lambda net, opt: make_local_train_step(
                        net, opt, mse, k_steps=1, begin_step=0))):
        net = _mlp_tok(inp, "mlp.")
        step, st = mk(net, paddle.optimizer.SGD(0.1,
                                                parameters=net.parameters()))
        losses = []
        for _ in range(4):
            st, lv = step(st, (X,), (Y,))
            losses.append(float(lv))
        out[f"{tag}.losses"] = np.asarray(losses)
    # k = 4: the replicas differ between syncs and agree right after one
    net = _mlp_tok(inp, "mlp.")
    step, st = make_local_train_step(
        net, paddle.optimizer.SGD(0.1, parameters=net.parameters()),
        mse, k_steps=4)
    w = []
    for _ in range(8):
        st, _ = step(st, (X,), (Y,))
        w.append(st["params"]["0.weight"].detach().numpy().copy())
    out["k4.w"] = np.stack(w)
    out["k4.since"] = np.asarray(st["since_sync"])
    local_write_back(net, st)
    out["k4.written"] = net[0].weight.detach().numpy()
    # adaptive k
    net = _mlp_tok(inp, "mlp.")
    step, st = make_local_train_step(
        net, paddle.optimizer.SGD(0.1, parameters=net.parameters()),
        mse, k_steps=2, adaptive=True)
    ks, losses = [], []
    for _ in range(12):
        st, lv = step(st, (X,), (Y,))
        ks.append(st["k"])
        losses.append(float(lv))
    out["adaptive.k"] = np.asarray(ks)
    out["adaptive.loss0"] = np.asarray(st["loss0"])
    out["adaptive.losses"] = np.asarray(losses)
    # dgc = True steps
    net = _mlp_tok(inp, "mlp.")
    step, st = make_sharded_train_step(
        net, paddle.optimizer.SGD(0.1, parameters=net.parameters()), mse,
        zero_stage=0, dgc=True, dgc_sparsity=0.75)
    losses = []
    for _ in range(3):
        st, lv = step(st, (X,), (Y,))
        losses.append(float(lv))
    out["dgc.losses"] = np.asarray(losses)
    for k, v in st["dgc"].items():
        out[f"dgc.v.{k}"] = v["v"].numpy()
    return out


def job_dist_chip(wd, r, n, inp):
    """C35 on the card (the chip test): gloo ranks send and receive CUDA
    tensors and take a ppermute hop of one."""
    import torch
    from paddle_tpu_torch import distributed as D
    x = torch.arange(12, dtype=torch.float32, device="cuda") * (r + 1.5)
    t = x.clone()
    if r == 0:
        D.send(t, dst=1)
    else:
        D.recv(t, src=0)
    y = D.ppermute(x.requires_grad_(), [(0, 1), (1, 0)])
    y.sum().backward()
    return {"p2p": t.cpu().numpy(), "hop": y.detach().cpu().numpy(),
            "grad": x.grad.cpu().numpy()}


# -- the hybrid slice (tp_annotate, MoE over ep, ZeRO-3, the global views) ---

def ernie_cls(inp, cfg_kw):
    """The tests' tiny ERNIE classifier with the JAX model's weights (full,
    before `tp_annotate` cuts them)."""
    from paddle_tpu_torch.models import (ErnieConfig,
                                         ErnieForSequenceClassification,
                                         load_reference_state)
    cfg = ErnieConfig.tiny()
    for k, v in cfg_kw.items():
        setattr(cfg, k, v)
    m = ErnieForSequenceClassification(cfg, num_classes=4, device="cpu")
    load_reference_state(m, {k[6:]: v for k, v in inp.items()
                             if k.startswith("ernie.")})
    return m


def moe_gpt(inp, prefix="moe."):
    """The tests' tiny MoE GPT (`__graft_entry__.py` phase 3's, 4
    experts), built on the live mesh, with the JAX model's weights (the
    experts cut to the rank's block)."""
    from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                         load_reference_state)
    m = GPTForCausalLM(GPTConfig.tiny(use_moe=True, num_experts=4,
                                      max_position_embeddings=32,
                                      dropout=0.0), device="cpu")
    load_reference_state(m, {k[len(prefix):]: v for k, v in inp.items()
                             if k.startswith(prefix)})
    return m


def _specs(net):
    return json.dumps({n: list(p.partition_spec)
                       for n, p in net.named_parameters()
                       if getattr(p, "partition_spec", None)})


def job_hybrid(wd, r, n, inp):
    """4 ranks: ERNIE dp 2 x mp 2 through tp_annotate with ZeRO-1 and
    recompute (phase 1 of `__graft_entry__.py`), then the MoE GPT at
    dp 2 x ep 2 (its phase 3), 3 steps each; and a tp 2 dropout arm."""
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.models import tp_annotate
    from paddle_tpu_torch.parallel import (create_mesh,
                                           make_sharded_train_step, set_mesh)
    out = {}
    ce = nn.CrossEntropyLoss()
    mesh = create_mesh({"dp": 2, "mp": 2})
    out["coords"] = np.asarray(mesh.coords)
    net = ernie_cls(inp, dict(hidden_dropout_prob=0.0,
                              attention_probs_dropout_prob=0.0))
    tp_annotate(net)
    opt = paddle.optimizer.AdamW(1e-4, parameters=net.parameters())
    step, st = make_sharded_train_step(
        net, opt, lambda o, lb: ce(o, lb[0]), zero_stage=1, recompute=True)
    losses = []
    for _ in range(3):
        st, lv = step(st, (inp["e_ids"],), (inp["e_labels"],))
        losses.append(float(lv))
    out["ernie.losses"] = np.asarray(losses)
    out["ernie.specs"] = np.asarray(_specs(net))
    out["ernie.local_heads"] = np.asarray(
        net.ernie.encoder.layers[0].self_attn.local_heads)
    for k, v in _params(net).items():
        out[f"ernie.p.{k}"] = v
    set_mesh(None)
    mesh = create_mesh({"dp": 2, "ep": 2})
    m = moe_gpt(inp)
    opt = paddle.optimizer.Adam(1e-4, parameters=m.parameters())
    step, st = make_sharded_train_step(m, opt, lm_loss)
    losses = []
    for _ in range(3):
        st, lv = step(st, (inp["m_ids"],), (inp["m_tgt"],))
        losses.append(float(lv))
    out["moe.coords"] = np.asarray(mesh.coords)
    out["moe.losses"] = np.asarray(losses)
    out["moe.specs"] = np.asarray(_specs(m))
    out["moe.zero_axes"] = np.asarray(json.dumps(step.zero_axes))
    for k, v in _params(m).items():
        out[f"moe.p.{k}"] = v
    set_mesh(None)
    return out


def job_tp_dropout(wd, r, n, inp):
    """2 ranks at mp 2 (or world 1 here at mp 1 where n == 1 is asked by
    the test): the tiny ERNIE with attention and hidden dropout at S 128
    through the flash path's plain versions, 2 SGD steps from one rng;
    and the keep masks each rank's attention draws."""
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.models import tp_annotate
    from paddle_tpu_torch.ops import flash_ops
    from paddle_tpu_torch.parallel import create_mesh, make_sharded_train_step
    set_flags({"FLAGS_flash_attention_min_seq": 128})
    out = {}
    create_mesh({"mp": 2})
    ce = nn.CrossEntropyLoss()
    for tag, p in (("p0", 0.0), ("p1", 0.1)):
        net = ernie_cls(inp, dict(hidden_dropout_prob=p,
                                  attention_probs_dropout_prob=p))
        tp_annotate(net)
        step, st = make_sharded_train_step(
            net, paddle.optimizer.SGD(0.1, parameters=net.parameters()),
            lambda o, lb: ce(o, lb[0]), zero_stage=0)
        losses = []
        for i in range(2):
            st, lv = step(st, (inp["d_ids"],), (inp["d_labels"],),
                          rng=5 + i)
            losses.append(float(lv))
        out[f"{tag}.losses"] = np.asarray(losses)
        for k, v in _params(net).items():
            out[f"{tag}.p.{k}"] = v
    # the keep mask rank r's heads draw: heads [2r, 2r + 2) of 4
    with flash_ops.head_shard(2 * r, 4):
        seed = flash_ops.head_keyed_seed(1234)
    out["mask"] = flash_ops._keep_mask(seed, 2, 2, 128, 128, 0.3,
                                       "cpu").numpy()
    out.update(_megatron_cases(r))
    return out


def _megatron_cases(r):
    """`shard_megatron` at mp 2: what it refuses (the message, "" where
    it cut), whether a refused layer kept its whole weights, and an
    unmarked attention beside a marked Linear (left whole: its output
    before and after)."""
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed.tensor_parallel import (mark_megatron,
                                                              shard_megatron)
    from paddle_tpu_torch.framework.errors import InvalidArgumentError
    from paddle_tpu_torch.models import tp_annotate
    out = {}

    def attempt(tag, m, cut=shard_megatron):
        before = {k: tuple(v.shape) for k, v in m.state_dict().items()}
        try:
            cut(m)
            out[f"mt.{tag}"] = np.asarray("")
        except InvalidArgumentError as e:
            out[f"mt.{tag}"] = np.asarray(str(e))
        out[f"mt.{tag}.whole"] = np.asarray(before == {
            k: tuple(v.shape) for k, v in m.state_dict().items()})
    attempt("vocab", mark_megatron(nn.Embedding(11, 4), "vocab"))
    attempt("column", mark_megatron(nn.Linear(4, 5), "column"))
    attempt("row", mark_megatron(nn.Linear(5, 4), "row"))
    partial = nn.MultiHeadAttention(8, 2)
    mark_megatron(partial.q_proj, "column")
    attempt("partial", partial)
    attempt("act_dropout",
            nn.TransformerEncoderLayer(8, 2, 16, dropout=0.1), tp_annotate)
    attempt("act_dropout0",
            nn.TransformerEncoderLayer(8, 2, 16, dropout=0.1,
                                       act_dropout=0.0), tp_annotate)
    paddle.seed(11)
    attn = nn.MultiHeadAttention(8, 2)
    mixed = torch.nn.ModuleDict({"attn": attn, "fc": mark_megatron(
        nn.Linear(8, 4), "column")})
    x = torch.as_tensor(np.random.RandomState(2).randn(2, 5, 8)
                        .astype("float32"))
    y0 = attn(x).detach()
    shard_megatron(mixed)
    out["mt.plain_attn.tp"] = np.asarray(repr(attn.tp))
    out["mt.plain_attn.err"] = np.asarray(
        float((attn(x).detach() - y0).abs().max()))
    out["mt.plain_attn.fc_out"] = np.asarray(mixed["fc"].weight.shape[0])
    return out


def job_zero_global(wd, r, n, inp):
    """2 ranks at dp 2: the MLP under ClipGradByGlobalNorm at ZeRO-2 and
    real ZeRO-3, Lamb and LarsMomentum at ZeRO-1 and ZeRO-2, DGC at
    ZeRO-2, 3 steps each; ZeRO-3's storage between steps; the MoE GPT's
    ep shards and ZeRO-3's blocks through the sharded checkpoint."""
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import distributed as D, nn
    from paddle_tpu_torch.framework.sharded_checkpoint import (
        load_sharded, save_sharded)
    from paddle_tpu_torch.parallel import (create_mesh,
                                           make_sharded_train_step, set_mesh,
                                           write_back)
    out = {}
    create_mesh({"dp": 2})
    X, Y = inp["x"], inp["y"]
    ce = nn.CrossEntropyLoss()

    def run(tag, opt_cls, lr, clip=None, level=None, **kw):
        net = _mlp(inp, "w.")
        opt = opt_cls(lr, parameters=net.parameters(),
                      grad_clip=None if clip is None
                      else nn.ClipGradByGlobalNorm(clip), **kw.pop("okw",
                                                                  {}))
        if level:
            net, opt = D.group_sharded_parallel(net, opt, level)
        step, st = make_sharded_train_step(
            net, opt, lambda o, lb: ce(o, lb[0]), **kw)
        losses = []
        for _ in range(3):
            st, lv = step(st, (X,), (Y,))
            losses.append(float(lv))
        out[f"{tag}.losses"] = np.asarray(losses)
        if level == "p_g_os":
            # between steps: the layer's tensors hold nothing, the state
            # this rank's blocks
            out[f"{tag}.layer_bytes"] = np.asarray(sum(
                p.untyped_storage().nbytes() for p in net.parameters()))
            out[f"{tag}.state_bytes"] = np.asarray(sum(
                v.numel() * v.element_size()
                for v in st["params"].values()))
            save_sharded(st, os.path.join(wd, "z3ck2"),
                         shardings=step.state_sharding)
            back = load_sharded(os.path.join(wd, "z3ck1"),
                                shardings=step.state_sharding)
            for k, v in back["params"].items():
                out[f"z3ck1.{k}"] = v.numpy()
            # the state dict gathers the blocks and leaves the layer empty
            for k, v in net.state_dict().items():
                out[f"{tag}.sd.{k}"] = v.numpy()
            out[f"{tag}.layer_bytes_after_sd"] = np.asarray(sum(
                p.untyped_storage().nbytes() for p in net.parameters()))
        write_back(net, st)     # ZeRO-3's blocks gathered into the layer
        for k, v in _params(net).items():
            out[f"{tag}.{k}"] = v
        return step, st
    for z in (2, 3):
        run(f"clip{z}", paddle.optimizer.Momentum, 0.1, clip=0.1,
            zero_stage=z)
    run("z3", paddle.optimizer.Adam, 0.01, level="p_g_os")
    for name in ("Lamb", "LarsMomentum"):
        for z in (1, 2):
            run(f"{name}{z}", getattr(paddle.optimizer, name), 0.1,
                zero_stage=z)
    step, st = run("dgc2", paddle.optimizer.SGD, 0.1, zero_stage=2,
                   dgc=True, dgc_sparsity=0.75)
    for k, v in st["dgc"].items():
        out[f"dgc2.v.{k}"] = v["v"].numpy()
    out["zero_axes"] = np.asarray(json.dumps(step.zero_axes))
    # the MoE GPT's ep shards through the sharded checkpoint
    set_mesh(None)
    create_mesh({"ep": 2})
    m = moe_gpt(inp)
    step, st = make_sharded_train_step(
        m, paddle.optimizer.Adam(1e-3, parameters=m.parameters()), lm_loss)
    st, _ = step(st, (inp["m_ids"][:4],), (inp["m_tgt"][:4],))
    save_sharded(st, os.path.join(wd, "epck2"),
                 shardings=step.state_sharding)
    for k, v in _params(m).items():
        out[f"epck2.{k}"] = v
    back = load_sharded(os.path.join(wd, "epck1"),
                        shardings=step.state_sharding)
    for k, v in back["params"].items():
        out[f"epck1.{k}"] = v.numpy()
    return out


def job_pipeline_clip(wd, r, n, inp):
    """2 ranks at pp 2: GPipe of the pipeline tests' GPT with
    ClipGradByGlobalNorm, 3 SGD steps in fp32 and under O1."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import amp, nn
    from paddle_tpu_torch.ops import flash_ops as fo
    from paddle_tpu_torch.parallel import (create_mesh,
                                           make_pipeline_train_step,
                                           pipeline_write_back)
    create_mesh({"pp": 2})
    out = {}
    for tag, level in (("fp32", None), ("o1", "O1")):
        m = tiny_lm(inp)
        opt = paddle.optimizer.SGD(
            0.1, parameters=m.parameters(),
            grad_clip=nn.ClipGradByGlobalNorm(float(inp["clip"])))
        step, st = make_pipeline_train_step(m, opt, lm_loss, n_micro=4,
                                            recompute=False)
        losses = []
        for _ in range(3):
            if level:
                with amp.auto_cast(level=level):
                    st, lv = step(st, (inp["ids"],), (inp["tgt"],))
            else:
                st, lv = step(st, (inp["ids"],), (inp["tgt"],))
            losses.append(float(lv))
        out[f"{tag}.losses"] = np.asarray(losses)
        pipeline_write_back(m)
        for k, v in _params(m).items():
            out[f"{tag}.p.{k}"] = v
    return out


JOBS = {"sp": job_sp, "pipeline": job_pipeline, "pipeline4": job_pipeline,
        "fleet": job_fleet, "localsgd": job_localsgd,
        "dist_chip": job_dist_chip,
        "collective": job_collective, "collective4": job_collective,
        "train": job_train, "tp_train": job_tp_train,
        "attention": job_attention, "serve2": job_serve,
        "serve4": job_serve, "hybrid": job_hybrid,
        "lanes2": job_lanes2, "lanes4": job_lanes4,
        "tp_dropout": job_tp_dropout, "zero_global": job_zero_global,
        "pipeline_clip": job_pipeline_clip}


def launch_train():
    """The launcher test's script: dp training over the launcher's world,
    rank 0 writing the losses to argv[2]."""
    import torch
    torch.set_num_threads(1)
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import distributed as D, nn
    from paddle_tpu_torch.parallel import make_sharded_train_step
    paddle.set_device("cpu")
    env = D.init_parallel_env()
    torch.manual_seed(1234)
    net = nn.Sequential(nn.Linear(16, 32), nn.Tanh(), nn.Linear(32, 4))
    opt = paddle.optimizer.Momentum(0.05, parameters=net.parameters())
    ce = nn.CrossEntropyLoss()
    step, st = make_sharded_train_step(net, opt,
                                       lambda o, labels: ce(o, labels[0]))
    rng = np.random.RandomState(0)
    losses = []
    for _ in range(5):
        x = rng.standard_normal((8, 16)).astype(np.float32)
        y = rng.randint(0, 4, size=(8,)).astype(np.int64)
        st, lv = step(st, (x,), (y,))
        losses.append(float(lv))
    if env.rank == 0:
        with open(sys.argv[2], "w") as f:
            json.dump({"losses": losses, "world": env.world_size}, f)
    D.destroy_process_group()


def spawn_probe(path, fail_rank=-1):
    """`distributed.spawn`'s target in the launcher test: join the world
    from the env spawn set, all-reduce the ranks, write the sum."""
    import torch
    torch.set_num_threads(1)
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import distributed as D
    paddle.set_device("cpu")
    env = D.init_parallel_env()
    if env.rank == fail_rank:
        sys.exit(3)
    t = torch.tensor([float(env.rank + 1)])
    D.all_reduce(t)
    with open(f"{path}.{env.rank}", "w") as f:
        json.dump({"sum": float(t), "world": env.world_size}, f)
    D.destroy_process_group()


def elastic_hang():
    """The elastic launcher test's script: rank 1 hangs before it joins
    (it never beats); rank 0 joins, beating, and waits for it."""
    if os.environ["PADDLE_TRAINER_ID"] == "1":
        time.sleep(300)
        return
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import distributed as D
    paddle.set_device("cpu")
    D.init_parallel_env()


def main():
    job, wd = sys.argv[1], sys.argv[2]
    if job == "launch_train":
        return launch_train()
    if job == "elastic_hang":
        return elastic_hang()
    import torch
    torch.set_num_threads(1)
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import distributed as D
    if job.endswith("_chip"):
        env = D.init_parallel_env(
            backend="gloo",
            init_method="file://" + os.environ["TORCH_DIST_STORE"])
    else:
        paddle.set_device("cpu")
        env = D.init_parallel_env(
            init_method="file://" + os.environ["TORCH_DIST_STORE"])
    inp = dict(np.load(os.path.join(wd, "in.npz")))
    out = JOBS[job](wd, env.rank, env.world_size, inp)
    np.savez(os.path.join(wd, f"{job}.r{env.rank}.npz"), **out)
    D.destroy_process_group()


if __name__ == "__main__":
    main()
