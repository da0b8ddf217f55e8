"""Pipeline parallelism (port of `paddle_tpu.parallel.pipeline`; reference
PipelineOptimizer `fluid/optimizer.py:3718`, `fleet/meta_optimizers/
pipeline_optimizer.py` and the F-then-B schedule of
`framework/section_worker.cc:49-105`).

The JAX package stacks the stages' parameters on a 'pp'-sharded leading
axis under `shard_map` and differentiates through its schedule. The port
runs one process a rank: a pp rank holds its stage's k = L / pp blocks as
modules (`partition_blocks`) and activations take ring hops with the
differentiable `distributed.collective.ppermute` (i -> i + 1 forward,
i -> i - 1 for cotangents), the hops every rank runs in one order.

`pipeline_forward` / `gpipe_spmd` (homogeneous stages) follow
`:32-110` literally: every step every stage runs, an inactive one's output
is zeroed (kept in the graph by `torch.where`), and autograd through the
loop is the backward schedule: every rank's graph has the same shape and
needs every hop, so the hops' transposes run in one order on all ranks.

`make_pipeline_train_step(model, optimizer, loss_fn, n_micro=...)` trains
a model with `pipeline_sections() -> (pre, blocks, post)` (the GPT's
embedding, block list and head) over pp x dp:
- the global batch is cut into `n_micro` microbatches and each
  microbatch's rows over dp (the JAX package's `P(None, dp)`);
- `schedule="gpipe"` (`:170-217`): n_micro + pp - 1 steps; at step t
  stage d runs microbatch t - d, stage 0 on the embedding's output; the
  last stage's outputs reach every pp rank by a masked all-reduce (the
  JAX package's masked psum) and every rank runs the head and the loss on
  them; the head's cotangent goes back the same way (the psum's
  transpose: summed over pp and divided by pp, to the last stage only)
  and the stages' backward runs the forward's steps in reverse, each hop
  transposed. The port skips an inactive step's compute, so a stage runs
  n_micro forwards (and with `recompute`, `torch.utils.checkpoint` of
  the stage, n_micro more in the backward);
- `schedule="1f1b"` (`:424-565`): 2 (n_micro + pp - 1) half-steps, the
  forward of microbatch m at tau = d + 2m and its backward at
  tau = 2pp - 1 - d + 2m; a stash of pp stage inputs; the backward
  recomputes the stage from the stash and takes `torch.autograd.grad`
  of it; the last stage runs the head and the loss a microbatch (its
  cotangent / n_micro), stage 0 replays the embedding's backward; two
  hops every half-step on every rank;
- the embedding and head parameters (pre and post) are replicated: their
  gradients are summed over pp (stage 0 holds the embedding's, the head's
  come from the last stage, or from every rank's identical head under
  GPipe, counted once), the stage blocks' are the rank's own; all are
  averaged over dp, then each rank updates what it holds;
- dropout: a stage block's draws are seeded by (step seed, pp rank,
  microbatch, block) folded as `:161, 199, 455` fold theirs;
- the optimizer's gradient clip reads the global norm over every stage's
  gradients (`spmd.clip_sharded`: summed over pp, the replicated
  embedding and head counted once), as the JAX package clips the
  stacked state through `optimizer.apply`;
- AMP: a step called under `amp.auto_cast` runs every stage's forward
  and backward (and the head's) under it; the activations cross the
  stages in the type the stage gives them.

`pipeline_write_back(model, state)` broadcasts each stage's blocks from
its pp rank, so every rank's model holds the trained whole.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable

import torch
import torch.distributed as dist
from torch import nn

from ..distributed.collective import ppermute
from ..framework import random as frandom
from .mesh import get_mesh
from .spmd import _as_tensor, _mean_over, _ShardGather, clip_sharded

__all__ = ["gpipe_spmd", "pipeline_forward", "partition_blocks",
           "make_pipeline_train_step", "pipeline_write_back"]


def _pp(mesh, axis_name):
    mesh = mesh or get_mesh()
    if mesh is None:
        return 1, 0
    return mesh.axis_size(axis_name), mesh.axis_rank(axis_name)


def pipeline_forward(stage_fn: Callable, x, *, axis_name="pp",
                     n_micro: int, mesh=None):
    """GPipe forward of a homogeneous stage, on each pp rank.

    stage_fn(micro_x) -> micro_y: this rank's stage; x [n_micro, mb, ...]
    (only stage 0's is read). Returns [1, n_micro, mb, ...]: the last
    stage's outputs there, zeros elsewhere (the JAX layout, which the
    caller indexes with [-1] after gathering)."""
    pp, d = _pp(mesh, axis_name)
    steps = n_micro + pp - 1
    perm = [(i, (i + 1) % pp) for i in range(pp)]
    first = torch.tensor(d == 0, device=x.device)
    store = torch.tensor(d == pp - 1, device=x.device)
    buf = torch.zeros_like(x[0])
    outs = [torch.zeros_like(x[0]) for _ in range(n_micro)]
    for t in range(steps):
        cur = torch.where(first, x[min(t, n_micro - 1)], buf)
        m = t - d
        active = 0 <= m < n_micro
        y = stage_fn(cur)
        y = torch.where(torch.tensor(active, device=x.device), y,
                        torch.zeros_like(y))
        if active:
            # the last stage stores; every rank keeps the same graph
            outs[m] = torch.where(store, y, outs[m])
        buf = ppermute(y, perm, axis_name)
    # the last hop's output joins the result with weight 0, so that every
    # hop's transpose runs on every rank (a hop whose output no rank
    # needed would be skipped by some ranks' backward only)
    anchor = torch.where(torch.tensor(False, device=x.device), buf.sum(),
                         torch.zeros((), dtype=buf.dtype, device=x.device))
    return (torch.stack(outs) + anchor)[None]


def gpipe_spmd(stage_fn: Callable, mesh, n_micro: int, axis_name="pp"):
    """`fwd = gpipe_spmd(stage_fn, mesh, n_micro)`; `fwd(stacked_params,
    x)` -> [pp, n_micro, ...] (index [-1] is the last stage's result),
    `stage_fn(params, micro_x)` with this rank's slice of the leaves of
    `stacked_params` ([pp, ...], whole on every rank). Differentiable."""
    pp, d = _pp(mesh, axis_name)

    def wrapper(stacked_params, x):
        if torch.is_tensor(stacked_params):
            mine = stacked_params[d]
        elif isinstance(stacked_params, dict):
            mine = {k: v[d] for k, v in stacked_params.items()}
        else:
            mine = [v[d] for v in stacked_params]
        y = pipeline_forward(lambda mx: stage_fn(mine, mx), x,
                             axis_name=axis_name, n_micro=n_micro,
                             mesh=mesh)
        return _ShardGather.apply(y, 0, d, pp, mesh.group(axis_name)
                                  if pp > 1 else None)
    return wrapper


def partition_blocks(blocks, pp):
    """The pp stages of a list of L homogeneous blocks, k = L / pp each:
    ([nn.ModuleList of stage s's blocks for s in range(pp)], k). Raises
    ValueError where pp does not divide L, or where the blocks hold
    buffers (running statistics belong to the pre / post sections)."""
    L = len(blocks)
    if L % pp != 0:
        raise ValueError(f"{L} blocks not divisible into pp={pp} stages")
    if any(True for _ in blocks[0].buffers()):
        raise ValueError(
            "pipelined blocks must be buffer-free (running-stat layers "
            "like BatchNorm belong in the pre/post sections)")
    k = L // pp
    return [nn.ModuleList(blocks[s * k:(s + 1) * k]) for s in range(pp)], k


class _Sections(nn.Module):
    def __init__(self, pre, post):
        super().__init__()
        self.pre = pre
        self.post = post


def make_pipeline_train_step(model, optimizer, loss_fn, *, n_micro,
                             mesh=None, pp_axis="pp", dp_axis="dp",
                             recompute=True, schedule="gpipe",
                             donate=True):
    """Returns (step, state) with `make_sharded_train_step`'s contract:
      state = {params, buffers, opt_state, step_no}
      step(state, inputs, labels, lr=None, rng=None) -> (state, loss)
    on the global batch. `state["params"]` holds what this rank updates,
    under the model's names: the embedding and head parameters and its
    stage's blocks. `loss` is the global batch's mean. See the module
    docstring for the schedules; `donate` is accepted and not read."""
    if schedule not in ("gpipe", "1f1b"):
        raise ValueError(f"unknown pipeline schedule {schedule!r}")
    mesh = mesh or get_mesh()
    pp = mesh.axis_size(pp_axis) if mesh is not None else 1
    d = mesh.axis_rank(pp_axis) if mesh is not None else 0
    dp = mesh.axis_size(dp_axis) if mesh is not None else 1
    r_dp = mesh.axis_rank(dp_axis) if mesh is not None else 0
    pp_group = mesh.group(pp_axis) if pp > 1 else None
    dp_group = mesh.group(dp_axis) if dp > 1 else None
    pre, blocks, post = model.pipeline_sections()
    outer = _Sections(pre, post)
    if schedule == "1f1b" and any(True for _ in outer.buffers()):
        raise ValueError(
            "schedule='1f1b' requires buffer-free pre/post sections "
            f"(found buffers: {sorted(n for n, _ in outer.named_buffers())})"
            "; use schedule='gpipe' or move running-stat layers out of the "
            "pipelined model")
    stages, k = partition_blocks(blocks, pp)
    mine = stages[d]
    names = {id(p): n for n, p in model.named_parameters()}
    outer_ps = OrderedDict()
    for p in outer.parameters():
        if p.requires_grad:
            outer_ps[names[id(p)]] = p
    stage_ps = OrderedDict((names[id(p)], p) for p in mine.parameters()
                           if p.requires_grad)
    params = OrderedDict(list(outer_ps.items()) + list(stage_ps.items()))
    bufs = OrderedDict((n, b) for n, b in model.named_buffers()
                       if any(b is ob for ob in outer.buffers()))
    state = {"params": params, "buffers": bufs,
             "opt_state": {n: optimizer._init_state(p.detach())
                           for n, p in params.items()},
             "step_no": 0}
    perm_f = [(i, (i + 1) % pp) for i in range(pp)]
    perm_b = [(i, (i - 1) % pp) for i in range(pp)]
    last = pp - 1

    def run_stage(h, key):
        for i, blk in enumerate(mine):
            with frandom.rng_scope(frandom.fold_seed(key, i)):
                h = blk(h)
        return h

    def stage(h, key):
        if recompute:
            from torch.utils.checkpoint import checkpoint
            return checkpoint(run_stage, h, key, use_reentrant=False)
        return run_stage(h, key)

    def micro(xs, device):
        """Each leaf [b, ...] -> [n_micro, b / n_micro / dp, ...]: this dp
        rank's block of every microbatch's rows."""
        out = []
        for x in xs:
            t = _as_tensor(x, device)
            b = t.shape[0]
            if b % (n_micro * dp) != 0:
                raise ValueError(
                    f"global batch {b} must be divisible by "
                    f"n_micro*dp = {n_micro}*{dp}")
            mb = b // n_micro
            t = t.reshape((n_micro, mb) + tuple(t.shape[1:]))
            loc = mb // dp
            out.append(t[:, r_dp * loc:(r_dp + 1) * loc])
        return out

    def head_loss(y, lbs):
        return loss_fn(post(y), list(lbs)).float().mean()

    def act_shape(ids, key):
        """The stage activations' (shape, type): the embedding of one
        microbatch, without its graph."""
        with torch.no_grad(), frandom.rng_scope(key):
            h = pre(*[x[0] for x in ids])
        return h.shape, h.dtype

    def gpipe(ids, lbs, base):
        device = ids[0].device
        steps = n_micro + pp - 1
        shape, dtype = act_shape(ids, base)
        zeros = torch.zeros(shape, dtype=dtype, device=device)
        h = None
        if d == 0:
            flat = [x.reshape((-1,) + tuple(x.shape[2:])) for x in ids]
            with frandom.rng_scope(base):
                h = pre(*flat)
            h = h.reshape((n_micro, -1) + tuple(h.shape[1:]))
        xs, ys = {}, {}
        buf = zeros
        for t in range(steps):
            m = t - d
            if 0 <= m < n_micro:
                x = (h[m] if d == 0 else buf).detach().requires_grad_()
                xs[m] = x
                ys[m] = stage(x, frandom.fold_seed(base, d, m))
                send = ys[m].detach()
            else:
                send = zeros
            buf = ppermute(send, perm_f, pp_axis)
        outs = (torch.stack([ys[m].detach() for m in range(n_micro)])
                if d == last else
                torch.zeros((n_micro,) + tuple(shape), dtype=dtype,
                            device=device))
        if pp_group is not None:
            dist.all_reduce(outs, group=pp_group)
        y_rep = outs.reshape((-1,) + tuple(shape[1:])).requires_grad_()
        flat_l = [x.reshape((-1,) + tuple(x.shape[2:])) for x in lbs]
        with frandom.rng_scope(base):
            lv = head_loss(y_rep, flat_l)
        post_ps = [p for p in outer_ps.values()]
        g_all = torch.autograd.grad(lv, [y_rep] + post_ps,
                                    allow_unused=True)
        g_rep = g_all[0].reshape(outs.shape)
        if pp_group is not None:
            g_rep = g_rep.contiguous()
            dist.all_reduce(g_rep, group=pp_group)
            g_rep = g_rep / pp
        g_post = {n: g for n, g in zip(outer_ps, g_all[1:])}
        g_buf = zeros
        dh = [None] * n_micro
        for t in reversed(range(steps)):
            g_send = ppermute(g_buf, perm_b, pp_axis)
            m = t - d
            if 0 <= m < n_micro:
                g_y = g_send + g_rep[m] if d == last else g_send
                torch.autograd.backward(ys[m], g_y)
                gx = xs[m].grad
                if d == 0:
                    dh[m] = gx
                    g_buf = zeros
                else:
                    g_buf = gx
                del ys[m], xs[m]
            else:
                g_buf = zeros
        if d == 0:
            torch.autograd.backward(h, torch.stack(dh))
        # the head ran on every rank: its gradient is counted once, here
        grads = OrderedDict()
        for n, p in outer_ps.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            if pp_group is not None:
                g = g.contiguous()
                dist.all_reduce(g, group=pp_group)
            if g_post[n] is not None:
                g = g + g_post[n]
            grads[n] = g
        for n, p in stage_ps.items():
            grads[n] = p.grad if p.grad is not None else torch.zeros_like(p)
        return lv.detach(), grads

    def one_f_one_b(ids, lbs, base):
        device = ids[0].device
        steps = 2 * (n_micro + pp - 1)
        shape, dtype = act_shape(ids, frandom.fold_seed(base, 0))
        zeros = torch.zeros(shape, dtype=dtype, device=device)
        stash = [None] * pp
        ring_f = ring_b = zeros
        y_prev = zeros
        g_stage = OrderedDict((n, torch.zeros_like(p))
                              for n, p in stage_ps.items())
        g_outer = OrderedDict((n, torch.zeros_like(p))
                              for n, p in outer_ps.items())
        loss_acc = torch.zeros((), dtype=torch.float32, device=device)
        o_names, o_ps = list(outer_ps), list(outer_ps.values())
        s_names, s_ps = list(stage_ps), list(stage_ps.values())

        def pre_of(m, grad):
            with torch.set_grad_enabled(grad), \
                    frandom.rng_scope(frandom.fold_seed(base, m)):
                return pre(*[x[m] for x in ids])

        for tau in range(steps):
            mf2, mb2 = tau - d, tau - (2 * pp - 1 - d)
            y_send, dx_send = zeros, zeros
            if mf2 % 2 == 0 and 0 <= mf2 < 2 * n_micro:
                m = mf2 // 2
                x_in = pre_of(m, False) if d == 0 else ring_f
                with torch.no_grad():
                    y = run_stage(x_in, frandom.fold_seed(base, d, m))
                stash[m % pp] = x_in
                if d == last:
                    y_prev = y
                y_send = y
            elif mb2 % 2 == 0 and 0 <= mb2 < 2 * n_micro:
                m = mb2 // 2
                if d == last:
                    yl = y_prev.detach().requires_grad_()
                    with frandom.rng_scope(frandom.fold_seed(base, m)):
                        lv_m = head_loss(yl, [x[m] for x in lbs])
                    gs = torch.autograd.grad(lv_m, [yl] + o_ps,
                                             allow_unused=True)
                    dy = gs[0] / n_micro
                    for n, g in zip(o_names, gs[1:]):
                        if g is not None:
                            g_outer[n] += g / n_micro
                    loss_acc = loss_acc + lv_m.detach() / n_micro
                else:
                    dy = ring_b
                x_in = stash[m % pp].detach().requires_grad_()
                with torch.enable_grad():
                    y = run_stage(x_in, frandom.fold_seed(base, d, m))
                gs = torch.autograd.grad(y, [x_in] + s_ps, dy,
                                         allow_unused=True)
                dx = gs[0]
                for n, g in zip(s_names, gs[1:]):
                    if g is not None:
                        g_stage[n] += g
                if d == 0:
                    h = pre_of(m, True)
                    gp = torch.autograd.grad(h, o_ps, dx, allow_unused=True)
                    for n, g in zip(o_names, gp):
                        if g is not None:
                            g_outer[n] += g
                dx_send = dx
            ring_f = ppermute(y_send, perm_f, pp_axis)
            ring_b = ppermute(dx_send, perm_b, pp_axis)
        if pp_group is not None:
            for g in list(g_outer.values()) + [loss_acc]:
                dist.all_reduce(g, group=pp_group)
        return loss_acc, OrderedDict(list(g_outer.items())
                                     + list(g_stage.items()))

    def step(state, inputs, labels, lr=None, rng=None):
        device = next(iter(params.values())).device
        ids, lbs = micro(inputs, device), micro(labels, device)
        lr = float(optimizer.get_lr() if lr is None else lr)
        base = int(rng) if rng is not None else frandom.next_seed("cpu")
        model.train()
        for p in params.values():
            p.grad = None
        run = one_f_one_b if schedule == "1f1b" else gpipe
        lv, grads = run(ids, lbs, base)
        if dp_group is not None:
            lv = lv.clone()
            _mean_over({**grads, "\0loss": lv}, dp_group, dp)
        if optimizer._grad_clip is not None:
            # the global norm over every stage's gradients: a stage's
            # blocks split over pp, the embedding and head counted once
            grads = OrderedDict(zip(grads, clip_sharded(
                optimizer._grad_clip, list(grads.values()),
                [set() if n in outer_ps else {pp_axis} for n in grads],
                mesh)))
        step_no = state["step_no"] + 1
        with torch.no_grad():
            for n, p in params.items():
                new_p, state["opt_state"][n] = optimizer._update(
                    grads[n], p.detach(), state["opt_state"][n], lr,
                    step_no)
                p.copy_(new_p)
                p.grad = None
        state["step_no"] = step_no
        return state, lv

    step.write_back = lambda st: pipeline_write_back(model, st, mesh,
                                                     pp_axis)
    step.stage = d
    step.blocks_per_stage = k
    return step, state


def pipeline_write_back(model, state=None, mesh=None, pp_axis="pp"):
    """Broadcast each stage's blocks from the pp rank that trains them,
    so every rank's `model` holds the whole trained model."""
    mesh = mesh or get_mesh()
    pp = mesh.axis_size(pp_axis) if mesh is not None else 1
    if pp == 1:
        return
    _, blocks, _ = model.pipeline_sections()
    stages, _ = partition_blocks(blocks, pp)
    group, ranks = mesh.group(pp_axis), mesh.group_ranks(pp_axis)
    with torch.no_grad():
        for s_, st in enumerate(stages):
            for p in st.parameters():
                dist.broadcast(p.detach(), ranks[s_], group=group)
