"""paddle.static.amp — mixed precision for static Programs (port of
`paddle_tpu.static.amp`; reference `fluid/contrib/mixed_precision/`:
`decorate` wraps the optimizer in OptimizerWithMixedPrecision,
`fp16_utils.rewrite_program` walks the ops inserting casts per the
black/white lists, `fp16_lists.AutoMixedPrecisionLists`).

The rewrite wraps each recorded op's callable with casts BY OP NAME:
white-listed ops (`linear`, `matmul`, `sdpa`, the convolutions) compute
in bfloat16 (or float16), black-listed ops (`softmax`, `layer_norm`,
`cross_entropy`, the reductions) in float32, as dygraph `amp.auto_cast`
does at each named op. The `sdpa` op thus reaches the flash kernels in
the 16-bit type. bfloat16 needs no loss scaling (float32's exponent
range), so `decorate` accepts and ignores the loss-scaling knobs.
"""
from __future__ import annotations

import warnings
from typing import Optional, Sequence

import torch

__all__ = ["decorate", "rewrite_program", "AutoMixedPrecisionLists",
           "CustomOpLists", "OptimizerWithMixedPrecision"]


class AutoMixedPrecisionLists:
    """reference `fp16_lists.py:20`."""

    def __init__(self, custom_white_list: Optional[Sequence[str]] = None,
                 custom_black_list: Optional[Sequence[str]] = None):
        from ..amp import BLACK_LIST, WHITE_LIST
        cw = set(custom_white_list or ())
        cb = set(custom_black_list or ())
        if cw & cb:
            raise ValueError(f"ops in both custom lists: {cw & cb}")
        # custom entries override the defaults (reference fp16_lists)
        self.white_list = (set(WHITE_LIST) | cw) - cb
        self.black_list = (set(BLACK_LIST) | cb) - self.white_list


CustomOpLists = AutoMixedPrecisionLists


def _cast_wrap(fn, to):
    def wrapped(*args, _fn=fn, _to=to):
        return _fn(*[a.to(_to) if torch.is_tensor(a) and
                     a.is_floating_point() else a for a in args])
    return wrapped


def rewrite_program(program, amp_lists: Optional[
        AutoMixedPrecisionLists] = None, dest_dtype: str = "bfloat16"):
    """reference `fp16_utils.py:468` rewrite_program: wrap each op so
    white-listed ones compute in `dest_dtype` and black-listed ones in
    float32. In place; bumps the program version so Executor caches
    refresh."""
    lists = amp_lists or AutoMixedPrecisionLists()
    dt = torch.bfloat16 if dest_dtype in ("bfloat16", "bf16") \
        else torch.float16
    for op in program.ops:
        if op.attrs.get("amp_dtype"):
            continue
        if op.name in lists.white_list:
            op.fn = _cast_wrap(op.fn, dt)
            op.attrs["amp_dtype"] = str(dest_dtype)
        elif op.name in lists.black_list:
            op.fn = _cast_wrap(op.fn, torch.float32)
            op.attrs["amp_dtype"] = "float32"
    program._version = getattr(program, "_version", 0) + 1
    return program


class OptimizerWithMixedPrecision:
    """reference `decorator.py:36`: delegates to the inner optimizer and
    rewrites the main program after backward is appended."""

    def __init__(self, optimizer, amp_lists, dest_dtype):
        self._opt = optimizer
        self._lists = amp_lists
        self._dest = dest_dtype

    def __getattr__(self, name):
        return getattr(self._opt, name)

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        ret = self._opt.minimize(loss, startup_program, parameters,
                                 no_grad_set)
        from .program import default_main_program
        rewrite_program(default_main_program(), self._lists, self._dest)
        return ret

    def amp_init(self, place=None, scope=None, test_program=None,
                 use_fp16_test=False):
        """reference decorator.amp_init — master-weight setup; the
        optimizer state and the scope keep float32 master weights."""


def decorate(optimizer, amp_lists=None, init_loss_scaling=2.0 ** 15,
             use_dynamic_loss_scaling=True, dest_dtype="bfloat16",
             **kwargs):
    """reference `decorator.py` decorate()."""
    if dest_dtype == "float16":
        warnings.warn("float16 static AMP uses the bf16 path's cast "
                      "rewrite; GradScaler-based loss scaling is the "
                      "dygraph API (paddle.amp.GradScaler)")
    return OptimizerWithMixedPrecision(
        optimizer, amp_lists or AutoMixedPrecisionLists(), dest_dtype)
