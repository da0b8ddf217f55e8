"""AMP (port of `paddle_tpu.amp`; reference `python/paddle/amp/
auto_cast.py`, `grad_scaler.py`; static lists `fluid/contrib/
mixed_precision/fp16_lists.py:20`).

The JAX package casts at its one dispatch point, `apply_op`, by op name.
PyTorch has no such point, so each op of the port that carries a name
of the lists calls the two hooks itself, where `apply_op` would:

    x, w, b = amp.cast_args("linear", x, w, b)    # maybe_cast_inputs
    out = amp.cast_out("layer_norm", out)          # maybe_wrap_op

- An op in WHITE_LIST (the tensor-core ops) gets its float32 arguments
  cast to the autocast type; an op in BLACK_LIST gets its autocast-type
  arguments cast up to float32; the custom lists of `auto_cast` extend
  both, and a custom black entry wins over white. Every other op runs in
  whatever type reaches it.
- The STREAM_CAST_OUT ops (layer_norm, softmax) compute in float32 and
  emit the autocast type, so the activation stream between the
  tensor-core ops stays 16-bit.
- Only floating tensors are cast; integer tensors and non-tensors pass
  through. A white op casts its float32 weight at every call, as the JAX
  package does: there is no cast cache.

This is not `torch.autocast`: the lists, the op names and the points of
the casts are the JAX package's. Level O2 casts whole models' parameters
(not their buffers) through `decorate`; under `auto_cast` the level
changes nothing else. The state
is thread-local.

`GradScaler` is an identity unless the thread's autocast type is
float16 at the time of the call (`_active`, the JAX package's rule: a
`scale()` called outside the `auto_cast` block is an identity even for
float16; ROADMAP C9); then it runs the dynamic loss-scaling state
machine over the optimizer's `_parameter_list` and their `.grad`.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from ..framework import static_hook

__all__ = ["auto_cast", "amp_guard", "decorate", "GradScaler",
           "white_list", "black_list", "amp_active", "cast_args",
           "cast_out"]

# the JAX package's lists (amp/__init__.py:22-31), op names as its ops
WHITE_LIST = {"matmul", "mm", "bmm", "linear", "weight_only_linear",
              "conv1d", "conv2d", "conv3d",
              "conv1d_transpose", "conv2d_transpose", "conv3d_transpose",
              "einsum", "sdpa", "flash_attention"}
BLACK_LIST = {"exp", "log", "softmax", "log_softmax", "cross_entropy",
              "bce", "bce_with_logits", "mse_loss", "l1_loss", "nll_loss",
              "kl_div", "layer_norm", "batch_norm", "group_norm",
              "instance_norm", "reduce_sum", "reduce_mean", "cumsum",
              "logsumexp", "norm", "softmax_with_cross_entropy"}
# black ops that compute in float32 and emit the autocast type
STREAM_CAST_OUT = {"layer_norm", "softmax"}

def white_list():
    return set(WHITE_LIST)


def black_list():
    return set(BLACK_LIST)


def _torch_dtype(dtype):
    """A torch dtype from a torch dtype or its name ("bfloat16")."""
    if isinstance(dtype, torch.dtype):
        return dtype
    dt = getattr(torch, str(dtype), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"amp: unknown dtype {dtype!r}")
    return dt


class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False
        self.dtype = "bfloat16"
        self.level = "O1"
        self.custom_white = set()
        self.custom_black = set()


_state = _AmpState()


def amp_active():
    return _state.enabled


def _is_float(t):
    return torch.is_tensor(t) and t.is_floating_point()


def cast_args(op_name, *args):
    """The JAX package's `maybe_cast_inputs` for op `op_name`: returns
    `args` as a tuple, with float32 tensors cast to the autocast type for
    a white op and autocast-type tensors cast to float32 for a black op;
    `args` unchanged when AMP is off or the op is in neither list. It
    also names the op to the static-graph recorder
    (`framework.static_hook.announce`)."""
    if static_hook._installed:
        static_hook.announce(op_name)
    if not _state.enabled:
        return args
    in_white = (op_name in WHITE_LIST or op_name in _state.custom_white) \
        and op_name not in _state.custom_black
    in_black = op_name in BLACK_LIST or op_name in _state.custom_black
    if in_white:
        src, dst = torch.float32, _torch_dtype(_state.dtype)
    elif in_black:
        src, dst = _torch_dtype(_state.dtype), torch.float32
    else:
        return args
    return tuple(a.to(dst) if _is_float(a) and a.dtype == src else a
                 for a in args)


def cast_out(op_name, out):
    """The JAX package's `maybe_wrap_op`: a STREAM_CAST_OUT op's float32
    output cast to the autocast type while AMP is on; anything else
    unchanged."""
    if not _state.enabled or op_name not in STREAM_CAST_OUT:
        return out
    if _is_float(out) and out.dtype == torch.float32:
        return out.to(_torch_dtype(_state.dtype))
    return out


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16"):
    dtype = str(dtype).replace("torch.", "")
    _torch_dtype(dtype)
    prev = (_state.enabled, _state.dtype, _state.level, _state.custom_white,
            _state.custom_black)
    _state.enabled = enable
    _state.dtype = dtype
    _state.level = level
    _state.custom_white = set(custom_white_list or ())
    _state.custom_black = set(custom_black_list or ())
    try:
        yield
    finally:
        (_state.enabled, _state.dtype, _state.level, _state.custom_white,
         _state.custom_black) = prev


amp_guard = auto_cast


def decorate(models=None, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """O2: cast the models' floating parameters to `dtype`, in place (each
    stays the same Parameter object). Buffers keep their type, as the JAX
    package's `Layer.to(dtype=)` touches only `parameters()`: BatchNorm's
    running mean and variance stay float32. The port's Adam-family
    optimizers keep float32 moments and compute the update in float32
    whatever the parameter's type, as the JAX package's do, so no master
    copy is made. Returns the models (and the optimizers, when given) as
    passed."""
    if level == "O2" and models is not None:
        single = not isinstance(models, (list, tuple))
        ms = [models] if single else list(models)
        dt = _torch_dtype(dtype)
        with torch.no_grad():
            for m in ms:
                for p in m.parameters():
                    if p.is_floating_point():
                        p.data = p.data.to(dt)
        models = ms[0] if single else ms
    if optimizers is None:
        return models
    return models, optimizers


class GradScaler:
    """Dynamic loss scaling (the JAX package's `GradScaler`, reference
    `amp/grad_scaler.py:20`). An identity unless the thread's autocast
    type is float16 when a method is called."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False

    def _active(self):
        return self._enable and _state.dtype == "float16"

    def scale(self, loss):
        if not self._active():
            return loss
        return loss * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer):
        """Divide every gradient by the scale in place; note whether any
        is not finite. One wait for the card, for all gradients."""
        if not self._active():
            return
        inv = 1.0 / self._scale
        bad = []
        for p in (optimizer._parameter_list or []):
            if p.grad is not None:
                p.grad.mul_(inv)
                bad.append(~torch.isfinite(p.grad).all())
        self._found_inf = bool(torch.stack(bad).any()) if bad else False

    def step(self, optimizer):
        if not self._active():
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self.update()

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)

    def update(self):
        if not (self._active() and self._dynamic):
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False

    def is_enable(self):
        return self._enable

    def get_scale(self):
        return self._scale

    def state_dict(self):
        return {"scale": self._scale, "good_steps": self._good_steps,
                "bad_steps": self._bad_steps}

    def load_state_dict(self, d):
        self._scale = d.get("scale", self._scale)
        self._good_steps = d.get("good_steps", 0)
        self._bad_steps = d.get("bad_steps", 0)
