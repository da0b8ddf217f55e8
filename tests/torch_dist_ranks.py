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
    env = dict(os.environ, PYTHONPATH=REPO, TORCH_DIST_STORE=os.path.join(
        workdir, f"store.{job}"), OMP_NUM_THREADS="1")
    for k in list(env):
        if k.startswith("PADDLE_"):
            env.pop(k)
    procs = []
    for r in range(world):
        log = open(os.path.join(workdir, f"{job}.log{r}"), "w")
        e = dict(env, PADDLE_TRAINER_ID=str(r),
                 PADDLE_TRAINERS_NUM=str(world), PADDLE_LOCAL_RANK=str(r))
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), job, workdir],
            env=e, stdout=log, stderr=subprocess.STDOUT, cwd=REPO), log))
    deadline = time.monotonic() + timeout
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
        for k, v in _params(net).items():
            out[f"{tag}.{k}"] = v
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
    return cases


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
        outs = [eng.generate(p, max_new_tokens=6, **g) for p, g in reqs]
        st = eng.stats()
        pr = eng.pressure()
        gauge = (monitor.stat_get("STAT_tp_kv_shard_bytes") or 0) - base
    return {"outs": [o.tolist() for o in outs], "compiles": st["compiles"],
            "tp": st["tp"], "pages_tp": st["pages"]["tp"],
            "quantized": st["pages"]["quantized"],
            "hbm": st["pages"]["hbm_bytes"],
            "shard": st["pages"]["shard_hbm_bytes"], "gauge": gauge,
            "pressure_tp": pr["tp"], "pressure_shard": pr["kv_shard_bytes"],
            "hits": st["kv"]["prefix"].get("hits", 0)}


def job_serve(wd, r, n, inp):
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.framework.errors import InvalidArgumentError
    model = tiny_gpt(inp)
    res = {}
    for name, kw, reqs in serve_cases(n):
        res[name] = serve_one(model, n, name, kw, reqs)
    # modes the lane does not carry yet refuse on every rank, before any
    # collective
    try:
        serving.GenerationEngine(model, device="cpu", tp=n, name="tier",
                                 prefix_cache=True, kv_tier=True,
                                 **{**SERVE_KW})
        res["tier_refused"] = False
    except InvalidArgumentError as e:
        res["tier_refused"] = "not yet ported" in str(e)
    return {"json": np.asarray(json.dumps(res))}


JOBS = {"collective": job_collective, "collective4": job_collective,
        "train": job_train, "tp_train": job_tp_train,
        "attention": job_attention, "serve2": job_serve,
        "serve4": job_serve}


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


def main():
    job, wd = sys.argv[1], sys.argv[2]
    if job == "launch_train":
        return launch_train()
    import torch
    torch.set_num_threads(1)
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import distributed as D
    paddle.set_device("cpu")
    env = D.init_parallel_env(
        init_method="file://" + os.environ["TORCH_DIST_STORE"])
    inp = dict(np.load(os.path.join(wd, "in.npz")))
    out = JOBS[job](wd, env.rank, env.world_size, inp)
    np.savez(os.path.join(wd, f"{job}.r{env.rank}.npz"), **out)
    D.destroy_process_group()


if __name__ == "__main__":
    main()
