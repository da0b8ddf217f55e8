"""paddle_tpu_torch.amp held to paddle_tpu.amp on the same numpy inputs.

- Cast policy: every op the port gives an AMP name, for an fp32 and a
  bf16 input, with AMP off, under O1 in bfloat16 and in float16, and
  with the op in a custom white or black list: the output's dtype is
  the JAX package's, and its values agree within a limit set by the
  lowest precision on the op's path (float32 1e-5, float16 4e-3,
  bfloat16 2e-2, each times max(1, max |ref|): one or two roundings in
  the 16-bit type, placed differently by the two frameworks).
- The thread-local state: nesting, restore, `amp_guard`, the lists.
- GradScaler: a scripted finite/inf/nan sequence, in float16 and
  bfloat16, inside and outside `auto_cast`: scale, state and the
  unscaled gradients match the JAX package's step for step.
- O2: `decorate` casts a small network to bfloat16, AdamW keeps float32
  moments, and one `train_batch` under `amp_configs="O2"` matches the
  JAX package's.
- The tiny GPT under `amp_configs="O1"`: `ln_f`'s output and the logits
  are bfloat16 and within 2e-2 x max |logit| of the JAX package's; one
  `train_batch` gives the JAX package's loss and gradients (read off a
  JAX step with SGD at lr 1, p_before - p_after) within the limits
  stated at `test_gpt_train_batch_matches_jax`; the same in float16, and
  through flash attention (the JAX package's Pallas kernels in
  interpret mode, the port's FlashAttention on its plain versions).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.amp as jamp
import paddle_tpu.nn.functional as JF
from paddle_tpu.framework.flags import get_flags, set_flags
from paddle_tpu.models import GPTConfig as JConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.ops import linalg as JL
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import hapi, nn, optimizer
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.models import load_reference_state
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import flash_ops
from paddle_tpu_torch.ops import linalg as TL

TOL = {"float32": 1e-5, "float16": 4e-3, "bfloat16": 2e-2}


def _j(a, dtype="float32"):
    return paddle.to_tensor(a).astype(dtype)


def _t(a, dtype="float32"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(getattr(torch, dtype))


def _np(x):
    """A reference Tensor or a torch tensor as float32 numpy, and its
    dtype's name."""
    if torch.is_tensor(x):
        return x.float().numpy(), str(x.dtype).replace("torch.", "")
    v = x._value
    return np.asarray(v.astype(jnp.float32)), str(v.dtype)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _matmul_shapes(tx, ty):
    return ((2, 6, 4) if tx else (2, 4, 6)), ((2, 5, 6) if ty else (2, 6, 5))


# op -> (arrays(rng), ref(args, dt), port(args, dt)); `dt` is the input
# type of the activation argument(s); weights stay float32
def _ops():
    ops = {}

    def lin(rng):
        return [_rand(rng, 2, 3, 8), _rand(rng, 8, 5), _rand(rng, 5)]
    ops["linear"] = (lin,
                     lambda a, dt: JF.linear(_j(a[0], dt), _j(a[1]),
                                             _j(a[2])),
                     lambda a, dt: TF.linear(_t(a[0], dt), _t(a[1]),
                                             _t(a[2])))
    for tx in (False, True):
        for ty in (False, True):
            sx, sy = _matmul_shapes(tx, ty)

            def mm_in(rng, sx=sx, sy=sy):
                return [_rand(rng, *sx), _rand(rng, *sy)]
            ops[f"matmul_tx{int(tx)}_ty{int(ty)}"] = (
                mm_in,
                lambda a, dt, tx=tx, ty=ty: JL.matmul(
                    _j(a[0], dt), _j(a[1]), tx, ty),
                lambda a, dt, tx=tx, ty=ty: TL.matmul(
                    _t(a[0], dt), _t(a[1]), tx, ty))
    ops["mm"] = (lambda rng: [_rand(rng, 4, 6), _rand(rng, 6, 5)],
                 lambda a, dt: JL.mm(_j(a[0], dt), _j(a[1])),
                 lambda a, dt: TL.mm(_t(a[0], dt), _t(a[1])))
    ops["bmm"] = (lambda rng: [_rand(rng, 2, 4, 6), _rand(rng, 2, 6, 5)],
                  lambda a, dt: JL.bmm(_j(a[0], dt), _j(a[1])),
                  lambda a, dt: TL.bmm(_t(a[0], dt), _t(a[1])))
    ops["einsum"] = (lambda rng: [_rand(rng, 2, 4, 6), _rand(rng, 2, 6, 5)],
                     lambda a, dt: JL.einsum("bij,bjk->bik", _j(a[0], dt),
                                             _j(a[1])),
                     lambda a, dt: TL.einsum("bij,bjk->bik", _t(a[0], dt),
                                             _t(a[1])))
    ops["layer_norm"] = (
        lambda rng: [_rand(rng, 2, 3, 8), 1 + _rand(rng, 8), _rand(rng, 8)],
        lambda a, dt: JF.layer_norm(_j(a[0], dt), 8, _j(a[1]), _j(a[2])),
        lambda a, dt: TF.layer_norm(_t(a[0], dt), 8, _t(a[1]), _t(a[2])))
    for name in ("softmax", "log_softmax", "gelu"):
        ops[name] = (lambda rng: [2 * _rand(rng, 2, 3, 8)],
                     lambda a, dt, n=name: getattr(JF, n)(_j(a[0], dt)),
                     lambda a, dt, n=name: getattr(TF, n)(_t(a[0], dt)))
    ops["dropout"] = (lambda rng: [_rand(rng, 4, 64)],
                      lambda a, dt: JF.dropout(_j(a[0], dt), 0.25),
                      lambda a, dt: TF.dropout(_t(a[0], dt), 0.25))
    ops["embedding"] = (
        lambda rng: [rng.randint(0, 10, (2, 5)), _rand(rng, 10, 8)],
        lambda a, dt: JF.embedding(paddle.to_tensor(a[0]), _j(a[1], dt),
                                   padding_idx=3),
        lambda a, dt: TF.embedding(torch.from_numpy(a[0]), _t(a[1], dt),
                                   padding_idx=3))
    ops["sdpa"] = (
        lambda rng: [_rand(rng, 1, 2, 16, 8) for _ in range(3)],
        lambda a, dt: JF.scaled_dot_product_attention(
            *[_j(x, dt) for x in a], is_causal=True),
        lambda a, dt: TF.scaled_dot_product_attention(
            *[_t(x, dt) for x in a], is_causal=True))
    ops["cross_entropy"] = (
        lambda rng: [2 * _rand(rng, 6, 10), rng.randint(0, 10, (6,))],
        lambda a, dt: JF.cross_entropy(_j(a[0], dt),
                                       paddle.to_tensor(a[1])),
        lambda a, dt: TF.cross_entropy(_t(a[0], dt), torch.from_numpy(a[1])))
    return ops


OPS = _ops()
MODES = ["off", "O1_bf16", "O1_fp16", "custom_white", "custom_black"]


def _ctx(module, mode, op):
    base = op.split("_tx")[0]
    if mode == "off":
        return module.auto_cast(enable=False)
    if mode == "O1_bf16":
        return module.auto_cast(level="O1")
    if mode == "O1_fp16":
        return module.auto_cast(level="O1", dtype="float16")
    if mode == "custom_white":
        return module.auto_cast(custom_white_list={base})
    return module.auto_cast(custom_black_list={base})


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", sorted(OPS))
def test_cast_policy_matches_jax(op, in_dtype, mode):
    arrays, ref_fn, port_fn = OPS[op]
    a = arrays(np.random.RandomState(sorted(OPS).index(op)))
    with _ctx(jamp, mode, op):
        ref = ref_fn(a, in_dtype)
    with _ctx(tamp, mode, op):
        got = port_fn(a, in_dtype)
    want, want_dt = _np(ref)
    out, out_dt = _np(got)
    assert out_dt == want_dt
    assert out.shape == want.shape
    if op == "dropout":
        # statistics, not values: every element zero or x / (1 - p)
        x = _np(_t(a[0], in_dtype))[0]
        for v in (out, want):
            kept = v != 0
            np.testing.assert_allclose(v[kept], (x / 0.75)[kept],
                                       rtol=TOL[out_dt])
            assert 0.6 < kept.mean() < 0.9
        return
    low = {in_dtype, out_dt}
    if mode == "O1_fp16":
        low.add("float16")
    elif mode != "off":
        low.add("bfloat16")
    tol = max(TOL[d] for d in low)
    np.testing.assert_allclose(out, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


def test_state_nesting_restore_and_lists():
    assert tamp.white_list() == jamp.white_list()
    assert tamp.black_list() == jamp.black_list()
    tamp.white_list().add("gelu")   # a copy
    assert "gelu" not in tamp.white_list()
    assert tamp.STREAM_CAST_OUT == jamp.STREAM_CAST_OUT
    assert tamp.amp_guard is tamp.auto_cast
    st = tamp._state
    assert not tamp.amp_active()
    with tamp.auto_cast(level="O2", dtype="float16",
                        custom_white_list=["gelu"]):
        assert tamp.amp_active() and st.dtype == "float16"
        assert st.level == "O2" and st.custom_white == {"gelu"}
        with tamp.amp_guard(enable=False):
            assert not tamp.amp_active() and st.dtype == "bfloat16"
            assert st.custom_white == set()
        assert tamp.amp_active() and st.dtype == "float16"
        with pytest.raises(RuntimeError):
            with tamp.auto_cast(custom_black_list=["linear"]):
                raise RuntimeError
        assert st.custom_black == set() and st.custom_white == {"gelu"}
    assert not tamp.amp_active() and st.dtype == "bfloat16"
    x = torch.ones(2, 3)
    with tamp.auto_cast():
        # integer tensors and non-tensors pass through
        i = torch.arange(3)
        assert tamp.cast_args("linear", x, i, 2.0)[1:] == (i, 2.0)
        assert tamp.cast_args("linear", x)[0].dtype == torch.bfloat16
        assert tamp.cast_args("gelu", x)[0] is x


class _P:
    """A parameter for GradScaler: the port reads `.grad`, the JAX
    package `._grad`."""

    def __init__(self, g, port):
        if port:
            self.grad = torch.tensor(g)
        else:
            self._grad = jnp.asarray(g)


class _Opt:
    def __init__(self, grads, port):
        self._parameter_list = [_P(g, port) for g in grads]
        self.steps = 0

    def step(self):
        self.steps += 1


@pytest.mark.parametrize("dtype,inside", [("float16", True),
                                          ("bfloat16", True),
                                          ("float16", False)])
def test_grad_scaler_matches_jax(dtype, inside):
    """A scripted sequence of gradients (finite, inf, nan) through
    scale/step with dynamic scaling (incr every 2 good steps, decr every
    bad one): the scale, the state dict, the optimizer steps taken and the
    unscaled gradients match the JAX package's step for step. Outside
    `auto_cast`, or in bfloat16, both are identities (ROADMAP C9)."""
    kw = dict(init_loss_scaling=8.0, incr_every_n_steps=2,
              decr_every_n_nan_or_inf=1)
    js, ts = jamp.GradScaler(**kw), tamp.GradScaler(**kw)
    seq = [1.0, 2.0, np.inf, 3.0, 4.0, np.nan, -1.0, 5.0, 6.0]
    cj = jamp.auto_cast(dtype=dtype) if inside else jamp.auto_cast(False)
    ct = tamp.auto_cast(dtype=dtype) if inside else tamp.auto_cast(False)
    with cj, ct:
        for i, v in enumerate(seq):
            grads = [np.float32([v, 0.5]), np.float32([[1.0, -2.0]])]
            jo, to = _Opt(grads, False), _Opt(grads, True)
            loss = np.float32(1.5 + i)
            np.testing.assert_allclose(
                float(ts.scale(torch.tensor(loss))),
                float(np.asarray(js.scale(jnp.asarray(loss)))))
            js.step(jo)
            ts.step(to)
            assert to.steps == jo.steps
            assert ts.get_scale() == js.get_scale()
            assert ts.state_dict() == js.state_dict()
            for pj, pt in zip(jo._parameter_list, to._parameter_list):
                np.testing.assert_array_equal(pt.grad.numpy(),
                                              np.asarray(pj._grad))
    active = inside and dtype == "float16"
    assert (ts.get_scale() != 8.0) == active
    ts2 = tamp.GradScaler()
    ts2.load_state_dict(ts.state_dict())
    assert ts2.state_dict() == ts.state_dict()


def _mlp_pair(seed):
    """The same small network in both packages: Linear, GELU, LayerNorm,
    Linear (the port's weights loaded from the JAX package's)."""
    paddle.seed(seed)
    jnet = paddle.nn.Sequential(paddle.nn.Linear(8, 32), paddle.nn.GELU(),
                                paddle.nn.LayerNorm(32),
                                paddle.nn.Linear(32, 4))
    tnet = torch.nn.Sequential(nn.Linear(8, 32), nn.GELU(),
                               nn.LayerNorm(32), nn.Linear(32, 4))
    load_reference_state(tnet, {k: np.asarray(v.numpy()) for k, v in
                                jnet.state_dict().items()})
    return jnet, tnet


def test_o2_decorate_adamw_step_matches_jax():
    """decorate(level="O2") casts every parameter to bfloat16; AdamW keeps
    float32 moments; one train_batch under amp_configs="O2" gives the JAX
    package's loss (rtol 2e-2) and first moments (0.1 x the gradient,
    float32: within 5e-2 x each one's max). The parameters then agree
    within one bfloat16 rounding wherever the gradient is clear of zero
    (|m1| > 5e-2 x its max, so both signs agree and the first Adam step
    moves each by lr), and within 2 lr plus a rounding elsewhere."""
    jnet, tnet = _mlp_pair(3)
    rng = np.random.RandomState(4)
    x = _rand(rng, 16, 8)
    y = rng.randint(0, 4, (16,)).astype(np.int64)
    jnet = jamp.decorate(jnet, level="O2")
    assert tamp.decorate(tnet, level="O2") is tnet
    assert {p.dtype for p in tnet.parameters()} == {torch.bfloat16}
    lr = 1e-2
    jopt = paddle.optimizer.AdamW(lr, parameters=jnet.parameters(),
                                  weight_decay=0.01)
    topt = optimizer.AdamW(lr, weight_decay=0.01)
    jm = paddle.Model(jnet)
    jm.prepare(jopt, paddle.nn.CrossEntropyLoss(), amp_configs="O2")
    jm._dist_ctx = None  # another file's fleet.init may be live
    tm = hapi.Model(tnet).prepare(topt, nn.CrossEntropyLoss(),
                                  amp_configs={"level": "O2"})
    jl = float(np.asarray(jm.train_batch([x], [y])[0][0]))
    tl = float(tm.train_batch([x], [y])[0][0])
    np.testing.assert_allclose(tl, jl, rtol=2e-2)
    jm._sync_carry()
    want = {k: np.asarray(v._value.astype(jnp.float32))
            for k, v in jnet.state_dict().items()}
    for name, p in tnet.named_parameters():
        assert p.dtype == torch.bfloat16
        st = topt._accumulators[id(p)]
        assert {v.dtype for v in st.values()} == {torch.float32}
        tr = (lambda a: a.T) if name.endswith("weight") and p.dim() == 2 \
            else (lambda a: a)
        m1 = tr(st["moment1"].numpy())
        jm1 = np.asarray(jm._opt_state[name]["moment1"])
        assert jm1.dtype == np.float32
        np.testing.assert_allclose(m1, jm1, rtol=0,
                                   atol=5e-2 * np.abs(jm1).max(),
                                   err_msg=name)
        got, w = tr(p.detach().float().numpy()), want[name]
        ulp = 2.0 ** -8 * np.abs(w)
        clear = np.abs(jm1) > 5e-2 * np.abs(jm1).max()
        assert np.all(np.abs(got - w)[clear] <= ulp[clear] + 1e-6), name
        assert np.all(np.abs(got - w) <= 2 * lr + 2 * ulp), name


@pytest.fixture
def flash_flags():
    old = get_flags(["FLAGS_flash_attention_interpret",
                     "FLAGS_flash_attention_min_seq"])
    old_t = tflags.get_flags("FLAGS_flash_attention_min_seq")
    yield
    set_flags(old)
    tflags.set_flags(old_t)


def _gpt_pair(hidden):
    cfg_kw = dict(hidden_size=hidden, intermediate_size=2 * hidden,
                  dropout=0.0)
    paddle.seed(7)
    ref = JGPT(JConfig.tiny(**cfg_kw))
    port = GPTForCausalLM(GPTConfig.tiny(**cfg_kw), device="cpu")
    load_reference_state(port, {k: np.asarray(v.numpy())
                                for k, v in ref.state_dict().items()})
    return ref, port


def test_gpt_forward_under_o1_matches_jax():
    """`ln_f`'s output and the logits are bfloat16 under O1 on both sides
    (the residual stream stays float32), the logits within 2e-2 x max
    |logit| of the JAX package's; outside auto_cast they are float32."""
    ref, port = _gpt_pair(64)
    ids = np.random.RandomState(0).randint(0, 512, (2, 64))
    with jamp.auto_cast(level="O1"):
        jh = ref.gpt(paddle.to_tensor(ids))
        jl = ref(paddle.to_tensor(ids))
    seen = {}
    port.gpt.ln_f.register_forward_hook(
        lambda m, i, o: seen.update(ln_f=o.dtype))
    port.gpt.blocks[-1].register_forward_hook(
        lambda m, i, o: seen.update(resid=o.dtype))
    with torch.no_grad(), tamp.auto_cast(level="O1"):
        tl = port(torch.from_numpy(ids))
    assert _np(jh)[1] == "bfloat16" and _np(jl)[1] == "bfloat16"
    assert seen == {"ln_f": torch.bfloat16, "resid": torch.float32}
    assert tl.dtype == torch.bfloat16
    want = _np(jl)[0]
    err = np.abs(tl.float().numpy() - want).max()
    assert err <= 2e-2 * np.abs(want).max(), err
    with torch.no_grad():
        assert port(torch.from_numpy(ids)).dtype == torch.float32


def _jax_grads(ref, ids, amp_level):
    """Loss and gradients of one JAX train_batch: SGD at lr 1 makes
    p_before - p_after the gradient (float32 parameters)."""
    before = {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}
    jm = paddle.Model(ref)
    jm.prepare(paddle.optimizer.SGD(1.0, parameters=ref.parameters()),
               paddle.nn.CrossEntropyLoss(), amp_configs=amp_level)
    jm._dist_ctx = None  # another file's fleet.init may be live
    loss = float(np.asarray(jm.train_batch([ids[:, :-1]],
                                           [ids[:, 1:]])[0][0]))
    jm._sync_carry()
    after = {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}
    return loss, {k: before[k] - after[k] for k in before}


@pytest.mark.parametrize("attn,dtype", [("sdpa", "bfloat16"),
                                        ("sdpa", "float16"),
                                        ("flash", "bfloat16")])
def test_gpt_train_batch_matches_jax(attn, dtype, flash_flags, monkeypatch):
    """One train_batch (update=False) of the tiny GPT under
    amp_configs="O1" against the JAX package's Model.train_batch on the
    same weights and tokens. float16: both packages' hapi enter
    `auto_cast(level=...)` in bfloat16, so here their `auto_cast` is
    patched to float16. "flash": hidden 128 (head dim 32) at S 128 with
    the flash minimum at 128, so the JAX side runs its Pallas kernels in
    interpret mode on bfloat16 q/k/v and the port FlashAttention's plain
    versions. Limits: the loss rtol 1e-3; each parameter's gradient
    within 5e-2 x its largest |gradient| + 2e-3 x the model's largest
    (the floor is for the key biases, whose exact gradient is 0, and for
    the position rows the 16-bit products reach with the least weight)."""
    if dtype == "float16":
        monkeypatch.setattr(jamp, "auto_cast", functools.partial(
            jamp.auto_cast, dtype="float16"))
        monkeypatch.setattr(tamp, "auto_cast", functools.partial(
            tamp.auto_cast, dtype="float16"))
    hidden, S = (128, 128) if attn == "flash" else (64, 64)
    if attn == "flash":
        set_flags({"FLAGS_flash_attention_interpret": True,
                   "FLAGS_flash_attention_min_seq": S})
        tflags.set_flags({"FLAGS_flash_attention_min_seq": S})
    ref, port = _gpt_pair(hidden)
    ids = np.random.RandomState(1).randint(0, 512, (2, S + 1))
    jloss, jgrads = _jax_grads(ref, ids, "O1")
    model = hapi.Model(port).prepare(optimizer.SGD(1.0),
                                     nn.CrossEntropyLoss(),
                                     amp_configs="O1")
    seen = []
    port.register_forward_hook(lambda m, i, o: seen.append(o.dtype))
    fwd0 = flash_ops.flash_attention_fwd.launches
    calls = []
    real = flash_ops.FlashAttention.apply
    monkeypatch.setattr(flash_ops.FlashAttention, "apply",
                        lambda *a: calls.append(a[0].dtype) or real(*a))
    (lv,), _ = model.train_batch([ids[:, :-1]], [ids[:, 1:]], update=False)
    assert seen == [getattr(torch, dtype)]
    assert lv.dtype == torch.float32
    want_calls = [getattr(torch, dtype)] * 2 if attn == "flash" else []
    assert calls == want_calls
    assert flash_ops.flash_attention_fwd.launches == fwd0   # CPU: plain
    np.testing.assert_allclose(float(lv), jloss, rtol=1e-3)
    top = max(np.abs(g).max() for g in jgrads.values())
    linear = {f"{n}.weight" for n, m in port.named_modules()
              if isinstance(m, torch.nn.Linear)}
    for name, p in port.named_parameters():
        assert p.grad is not None and p.grad.dtype == torch.float32, name
        got = p.grad.numpy()
        want = jgrads[name]
        if name in linear:
            got = got.T
        lim = 5e-2 * np.abs(want).max() + 2e-3 * top
        assert np.abs(got - want).max() <= lim, (
            name, np.abs(got - want).max(), lim)


@pytest.mark.parametrize("dtypes", [("float32",) * 3, ("bfloat16",) * 3,
                                    ("float16",) * 3, ("float64",) * 3,
                                    ("bfloat16", "float16", "float16")])
def test_flash_gate_agrees_with_the_kernels_check(dtypes):
    """ROADMAP C8: `flash_supported` passes exactly the types `_check`
    takes (float32, bfloat16, float16, one type for q, k and v), so no
    type reaches a kernel that raises; the splash kernels' check takes
    the same types (float16 included since C8's repair)."""
    from paddle_tpu_torch.framework.errors import InvalidArgumentError
    from paddle_tpu_torch.ops import splash_ops
    q, k, v = (torch.zeros(1, 2, 128, 32, dtype=getattr(torch, d))
               for d in dtypes)
    gate = flash_ops.flash_supported(tuple(q.shape), dtype={
        q.dtype, k.dtype, v.dtype}, min_seq=128)
    try:
        flash_ops._check(q, k, v, None)
        took = True
    except InvalidArgumentError:
        took = False
    assert gate == took == (dtypes[0] in ("float32", "bfloat16", "float16")
                            and len(set(dtypes)) == 1)
    try:
        flash_ops._check(q, k, v, None, dtypes=splash_ops._DTYPES)
        splash_took = True
    except InvalidArgumentError:
        splash_took = False
    assert splash_took == took


def test_sdpa_under_float16_amp_takes_flash(flash_flags, monkeypatch):
    """Under auto_cast(dtype="float16") the white cast gives float16 q/k/v
    and the gate sends them to FlashAttention (its plain versions on the
    CPU); the plain branch's "sdpa" casts the same way."""
    tflags.set_flags({"FLAGS_flash_attention_min_seq": 128})
    calls = []
    real = flash_ops.FlashAttention.apply
    monkeypatch.setattr(flash_ops.FlashAttention, "apply",
                        lambda *a: calls.append(a[0].dtype) or real(*a))
    q = torch.randn(1, 2, 128, 32)
    with tamp.auto_cast(dtype="float16"):
        out = TF.scaled_dot_product_attention(q, q, q, is_causal=True)
        short = TF.scaled_dot_product_attention(q[:, :, :64], q[:, :, :64],
                                                q[:, :, :64])
    assert calls == [torch.float16]
    assert out.dtype == short.dtype == torch.float16
