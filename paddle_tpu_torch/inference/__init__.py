"""Inference (port of `paddle_tpu.inference`; reference
`paddle/fluid/inference/`: AnalysisPredictor, AnalysisConfig, zero-copy
tensors).

The artifact is the `torch.export` program written by `jit.save`
(`.pdmodel`) with its params and manifest. A `Predictor` loads it once,
places it on one device (the CUDA card unless the `Config` says
`disable_gpu()`), validates every feed against the saved signature, and
runs it. API as `paddle.inference`: Config / create_predictor /
get_input_handle / run / get_output_handle.

- `compile_count` counts the first run of each distinct input signature
  on a replica, and `STAT_predictor_compiles` sums them: the port's
  counterpart of the JAX package's per-shape trace (PyTorch runs the
  program eagerly, so nothing compiles), as `STAT_gen_compiles` is in
  the port's `GenerationEngine`.
- `run_device` returns device tensors without waiting for the card (the
  serving engine's lanes run it on their own CUDA streams); `run` copies
  the outputs to the host.
- A `.pdmodel` that is not a `torch.export` artifact is read as a
  reference ProgramDesc (`pd_format`, a protobuf wire parser of its own)
  with its combined `.pdiparams`, and run op by op on the predictor's
  device (`pd_import.LegacyInferenceModel`); a file that is neither
  raises UnimplementedError. `analysis` holds the Analyzer and its
  engine ops over static Programs.
"""
from __future__ import annotations

import copy
import os
import threading
import warnings
import weakref
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import jit
from ..framework import monitor
from ..framework.errors import UnavailableError, UnimplementedError
from ..framework.place import resolve_device

__all__ = ["Config", "create_predictor", "Predictor", "PredictorTensor",
           "AnalysisConfig", "format_input_sig", "check_fed_input",
           "as_device", "resolve_devices", "Analyzer", "Argument",
           "compile_subgraph_engine", "pd_format", "pd_import",
           "analysis", "capi"]


def _note_quant_bytes(delta: int) -> None:
    """Move STAT_quant_weight_hbm_bytes, the device-resident integer
    weight and scale bytes of live artifacts and replicas."""
    monitor.stat_gauge_add("STAT_quant_weight_hbm_bytes", delta)


def _note_quant_bytes_later(delta: int) -> None:
    # a weakref.finalize callback: may run inside a locked monitor call
    monitor.stat_gauge_add_later("STAT_quant_weight_hbm_bytes", delta)


def quant_resident(owner, tensors) -> None:
    """Count `tensors` (integer weights and scales placed on a device) in
    STAT_quant_weight_hbm_bytes while `owner` lives: a TranslatedLayer's
    own copy, and a replica's on another device."""
    total = sum(t.numel() * t.element_size() for t in tensors)
    if total:
        _note_quant_bytes(total)
        weakref.finalize(owner, _note_quant_bytes_later, -total)


class Config:
    """reference `api/paddle_analysis_config.h`. The card is the default
    (`enable_use_gpu(device_id=)`); `disable_gpu()` asks for the CPU. The
    other knobs are accepted and change nothing, as in the JAX package."""

    def __init__(self, prog_file: Optional[str] = None,
                 params_file: Optional[str] = None):
        self._use_accel = True
        self._device_id = 0
        self._threads = 1
        self._enable_profile = False
        self._memory_pool_mb = 0
        self.set_model(prog_file, params_file)

    def set_model(self, prog_file, params_file=None):
        """Update only the model/params paths (the other options stay,
        as reference AnalysisConfig::SetModel)."""
        if prog_file and prog_file.endswith(".pdmodel"):
            prog_file = prog_file[:-len(".pdmodel")]
        self.model_path = prog_file
        self.params_file = params_file

    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        self._use_accel = True
        self._memory_pool_mb = memory_pool_init_size_mb
        self._device_id = int(device_id)

    def disable_gpu(self):
        self._use_accel = False

    def use_gpu(self):
        return self._use_accel

    def gpu_device_id(self):
        return self._device_id

    def device(self) -> torch.device:
        """The device the options name: CUDA card `device_id`, or the CPU
        after `disable_gpu()`. Raises UnavailableError where there is no
        card, or no card of that id."""
        if not self._use_accel:
            return resolve_device("cpu")
        dev = resolve_device(f"cuda:{self._device_id}")
        n = torch.cuda.device_count()
        if not 0 <= self._device_id < n:
            raise UnavailableError(
                f"Config.enable_use_gpu(device_id={self._device_id}): this "
                f"machine has {n} CUDA device(s)")
        return dev

    def set_cpu_math_library_num_threads(self, n):
        self._threads = n

    def enable_profile(self):
        self._enable_profile = True

    def switch_ir_optim(self, flag=True):
        pass  # the exported program runs as saved

    def enable_memory_optim(self):
        pass

    def enable_tensorrt_engine(self, *a, **k):
        warnings.warn("TensorRT is not used: the exported program runs "
                      "the port's own kernels")

    def summary(self):
        return f"Config(model={self.model_path}, accel={self._use_accel})"


AnalysisConfig = Config


class PredictorTensor:
    """Zero-copy handle (reference zero-copy PaddleTensor) on a
    predictor's device."""

    def __init__(self, name, device=None):
        self.name = name
        self._device = device
        self._value = None

    def reshape(self, shape):
        pass

    def copy_from_cpu(self, arr):
        self._value = torch.as_tensor(np.asarray(arr)).to(self._device)

    def copy_to_cpu(self) -> np.ndarray:
        """The value as a numpy array (bfloat16 widened to float32: numpy
        has no bfloat16)."""
        v = self._value.detach()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.cpu().numpy()

    def shape(self):
        return list(self._value.shape) if self._value is not None else []


def format_input_sig(name, dims, dtype):
    """'name: dtype[b,8]' rendering of one saved-signature entry (symbolic
    dims print as 'b')."""
    if dims is None:
        return str(name)
    ds = ",".join("b" if d is None else str(d) for d in dims)
    return f"{name}: {np.dtype(dtype).name if dtype is not None else '?'}[{ds}]"


def check_fed_input(arr, name, dims, dtype, *, skip_batch_dim=False,
                    ctx="Predictor.run", expect=""):
    """Shared rank/dim/dtype check for one fed array, used by both
    Predictor.run and serving.InferenceEngine.submit so validation and
    error wording never drift apart. Returns the array (same-kind-cast to
    the saved dtype when needed) or raises a ValueError naming the
    expected signature."""
    note = f"; model signature is [{expect}]" if expect else ""
    if dims is not None:
        if arr.ndim != len(dims):
            raise ValueError(
                f"{ctx}: input {name!r} expects rank {len(dims)} "
                f"({format_input_sig(name, dims, dtype)}) but got rank "
                f"{arr.ndim} with shape {tuple(arr.shape)}{note}")
        for axis, (want, got) in enumerate(zip(dims, arr.shape)):
            if skip_batch_dim and axis == 0:
                continue
            if want is not None and int(want) != int(got):
                raise ValueError(
                    f"{ctx}: input {name!r} dim {axis} must be {want} but "
                    f"got {got} (shape {tuple(arr.shape)}; expected "
                    f"{format_input_sig(name, dims, dtype)}){note}")
    if dtype is not None and np.dtype(arr.dtype) != np.dtype(dtype):
        if not np.can_cast(arr.dtype, dtype, casting="same_kind"):
            raise ValueError(
                f"{ctx}: input {name!r} expects dtype "
                f"{np.dtype(dtype).name} but got {np.dtype(arr.dtype).name}"
                f" (not safely castable){note}")
        arr = np.asarray(arr, dtype=dtype)
    return arr


def as_device(dev) -> torch.device:
    """Canonicalize one device spec: an int is a CUDA device index; a
    string or torch.device passes through (a CUDA one must exist)."""
    if isinstance(dev, (int, np.integer)):
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if not 0 <= int(dev) < n:
            raise ValueError(f"device index {dev} out of range; host has "
                             f"{n} local device(s)")
        return torch.device("cuda", int(dev))
    return resolve_device(dev)


def resolve_devices(devices) -> List[torch.device]:
    """Expand a device-set spec into a list of torch devices: 'all' (every
    CUDA device; raises where there is none), 'cpu', an int count (the
    first N CUDA devices), a comma-separated index string ('0,2'), or a
    sequence of indices / devices. The serving engine builds one Predictor
    replica (and one dispatch lane) per entry."""
    n_cuda = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if isinstance(devices, str):
        spec = devices.strip().lower()
        if spec == "all":
            if not n_cuda:
                resolve_device("cuda")   # raises UnavailableError
            return [torch.device("cuda", i) for i in range(n_cuda)]
        if spec == "cpu" or spec.startswith("cuda"):
            return [as_device(spec)]
        devices = [int(x) for x in devices.split(",") if x.strip()]
    elif isinstance(devices, (int, np.integer)):
        n = int(devices)
        if not 1 <= n <= n_cuda:
            raise ValueError(f"asked for {n} serving device(s) but host "
                             f"has {n_cuda}")
        return [torch.device("cuda", i) for i in range(n)]
    elif isinstance(devices, torch.device):
        devices = [devices]
    out = [as_device(d) for d in devices]
    if not out:
        raise ValueError("empty device list")
    return out


def _np_dtype(dtype: torch.dtype):
    """numpy's dtype for a torch dtype (None for bfloat16, which numpy
    lacks: such an input is not type-checked)."""
    if dtype == torch.bfloat16:
        return None
    return torch.empty((), dtype=dtype).numpy().dtype


def _host(a):
    if torch.is_tensor(a):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class Predictor:
    def __init__(self, config: Config, device=None):
        if config.model_path is None:
            raise ValueError("Config has no model path")
        self._config = config
        self._device = (as_device(device) if device is not None
                        else config.device())
        path = config.model_path
        self._legacy = None
        try:
            self._translated = jit.load(path, device=self._device)
        except FileNotFoundError:
            raise
        except Exception as e:  # noqa: BLE001 — not a torch.export artifact
            if not os.path.exists(path + ".pdmodel"):
                raise
            self._legacy = self._load_legacy(path, config.params_file, e)
        if self._legacy is not None:
            self._translated = None
            self._quant, self._qargs = None, []
            self._input_names = list(self._legacy.feed_names)
            self._init_replica()
            return
        self._quant = self._translated._quant
        self._qargs = self._translated._qargs
        if self._quant:
            monitor.stat_add("STAT_quant_weights_loaded",
                             len(self._quant["entries"]))
        nin = len(self._translated.user_inputs())
        self._input_names = [f"input_{i}" for i in range(nin)]
        self._init_replica()

    def _load_legacy(self, path, params_file, export_err):
        """The reference ProgramDesc `{path}.pdmodel` (+ combined params)
        on this predictor's device, or UnimplementedError for a file that
        is neither format."""
        from .pd_import import load_legacy_inference_model
        if params_file is None and os.path.exists(path + ".pdiparams"):
            params_file = path + ".pdiparams"
        try:
            return load_legacy_inference_model(path + ".pdmodel",
                                               params_file,
                                               device=self._device)
        except Exception as e:  # noqa: BLE001
            raise UnimplementedError(
                f"{path}.pdmodel is not a torch.export artifact of "
                f"jit.save ({export_err!r}) nor a parseable reference "
                f"ProgramDesc ({e!r})") from e

    def _init_replica(self):
        self._inputs: Dict[str, PredictorTensor] = {
            n: PredictorTensor(n, self._device) for n in self._input_names}
        self._outputs: List[PredictorTensor] = []
        self._sig = None
        self._sig_str = ""
        self._lock = threading.Lock()
        self._seen = set()
        # first runs of each distinct input signature on this replica
        self.compile_count = 0

    @property
    def device(self) -> torch.device:
        """The device this predictor runs on."""
        return self._device

    # -- quantized artifacts ------------------------------------------------

    def quant_info(self) -> Optional[dict]:
        """None for float artifacts; else {bits histogram, device-resident
        integer bytes, tensor count}, surfaced by engine.stats()."""
        if not self._quant:
            return None
        bits = {}
        for e in self._quant["entries"]:
            bits[str(e["bits"])] = bits.get(str(e["bits"]), 0) + 1
        return {"weight_tensors": len(self._quant["entries"]),
                "bits": bits,
                "resident_bytes": sum(t.numel() * t.element_size()
                                      for t in self._qargs)}

    def clone_for_device(self, device) -> "Predictor":
        """Replica on another device sharing the loaded artifact (no disk
        re-load) with its OWN input handles, lock and first-run counter.
        A replica on another device than the artifact's places its own
        copy of the quantized weights there (counted in
        STAT_quant_weight_hbm_bytes while the replica lives); one on the
        same device shares them."""
        p = copy.copy(self)
        p._device = as_device(device)
        p._init_replica()
        if self._legacy is not None:
            p._legacy = self._legacy.to(p._device)
        if self._quant:
            p._qargs = [q.to(p._device) for q in self._translated._qargs]
            monitor.stat_add("STAT_quant_weights_loaded",
                             len(self._quant["entries"]))
            if p._device != self._translated.device:
                quant_resident(p, p._qargs)
        return p

    def get_input_names(self):
        return list(self._input_names)

    def get_input_handle(self, name):
        return self._inputs[name]

    # -- saved signature -----------------------------------------------------

    def input_signature(self):
        """[(name, dims, dtype)] of the saved program's caller inputs;
        symbolic dims are None, dtypes numpy's."""
        if self._sig is not None:
            return self._sig
        if self._legacy is not None:
            sig = self._legacy.input_signature()
        else:
            sig = [(n, dims, _np_dtype(dt)) for n, (dims, dt) in
                   zip(self._input_names, self._translated.user_inputs())]
        self._sig = sig
        self._sig_str = ", ".join(format_input_sig(*s) for s in sig)
        return sig

    def _validate_feed(self, arrays):
        """Check fed arrays against the saved signature; raise a ValueError
        naming the expected inputs instead of failing deep inside the
        program."""
        sig = self.input_signature()
        expect = self._sig_str
        if len(arrays) != len(sig):
            raise ValueError(
                f"Predictor.run: model expects {len(sig)} input(s) "
                f"[{expect}] but {len(arrays)} were fed")
        out = []
        for a, (name, dims, dtype) in zip(arrays, sig):
            if a is None:
                raise ValueError(
                    f"Predictor.run: input {name!r} was never fed "
                    f"(expected [{expect}]; use get_input_handle"
                    f"({name!r}).copy_from_cpu(...) or pass inputs=)")
            arr = _host(a)
            out.append(check_fed_input(arr, name, dims, dtype,
                                       ctx="Predictor.run", expect=expect))
        return out

    # -- execution -----------------------------------------------------------

    def _note_run(self, tensors):
        """Count the first run of this input signature on this replica."""
        key = tuple((tuple(t.shape), t.dtype) for t in tensors)
        with self._lock:
            if key in self._seen:
                return
            self._seen.add(key)
            self.compile_count += 1
        monitor.stat_add("STAT_predictor_compiles")

    def run_device(self, arrays):
        """Run on already-validated inputs (tensors on this predictor's
        device, or host arrays, uploaded here); returns the output leaves
        as device tensors, without waiting for the card. The program's
        kernels go on the calling thread's current CUDA stream."""
        xs = [a if torch.is_tensor(a) and a.device == self._device
              else torch.as_tensor(a).to(self._device) for a in arrays]
        self._note_run(xs)
        if self._legacy is not None:
            return self._legacy.run_device(xs)
        with torch.no_grad():
            out = self._translated.program(self._device)(*self._qargs, *xs)
        if isinstance(out, (tuple, list)):
            return list(torch.utils._pytree.tree_leaves(out))
        return [out]

    def run(self, inputs: Optional[List[np.ndarray]] = None):
        if inputs is not None:
            # validate BEFORE touching the handles: a rejected call leaves
            # no half-fed state behind
            args = self._validate_feed(list(inputs))
            for n, a in zip(self._input_names, args):
                self._inputs[n].copy_from_cpu(a)
            args = [self._inputs[n]._value for n in self._input_names]
        else:
            args = self._validate_feed([self._inputs[n]._value
                                        for n in self._input_names])
        leaves = self.run_device(args)
        self._outputs = []
        for i, leaf in enumerate(leaves):
            t = PredictorTensor(f"output_{i}", self._device)
            t._value = leaf
            self._outputs.append(t)
        if inputs is not None:
            return [o.copy_to_cpu() for o in self._outputs]
        return True

    def get_output_names(self):
        return [t.name for t in self._outputs] or ["output_0"]

    def get_output_handle(self, name):
        idx = int(name.rsplit("_", 1)[1])
        return self._outputs[idx]


def create_predictor(config: Config, device=None) -> Predictor:
    """Build a Predictor on `device` (a torch device, index or string),
    else on the device the config names; `serving.InferenceEngine`
    passes a different device per dispatch lane."""
    return Predictor(config, device=device)


from . import analysis, capi, pd_format, pd_import  # noqa: E402,F401
from .analysis import Analyzer, Argument, compile_subgraph_engine  # noqa
