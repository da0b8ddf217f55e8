"""The port's C inference API (`paddle_tpu_torch/csrc/pd_c_api.h`,
`inference_capi.cc`), held to `inference.create_predictor`.

The library builds with `g++` at first use (`inference.capi.build()`);
a C driver built with `gcc` links it, creates a predictor on the CPU
through `PD_NewPredictorWithDevice(prefix, -1)` (the card is the
default, as `inference.Config`'s), runs float32 rows and writes the
output, which must equal the in-process predictor on the same artifact
(rtol 1e-6, atol 1e-7: one program on one CPU, the embedded interpreter's
thread count may differ). Models: a saved MLP and a 2-layer
`nn.TransformerEncoder` (d 64, 4 heads, ff 128) at [2, 128, 64]. Where
there is no card, `PD_NewPredictor` fails with the port's
UnavailableError in `PD_GetLastError` and the process goes on.

The Go binding (`go/paddle/*.go`) calls `C.PD_*` symbols: each must be
exported by the port's library and declared in its header. The R shim
(`r/paddle_infer.R`) drives `Config`, `create_predictor` and
`Predictor.run`, which `paddle_tpu_torch.inference` must have.

Skipped only where the toolchain is missing (`gcc`, `g++`,
`python3-config`), as `tests/test_capi.py` skips.
"""
import os
import re
import shutil
import subprocess
import textwrap

import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch import inference, jit, nn
from paddle_tpu_torch.inference import capi
from paddle_tpu_torch.static import InputSpec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

C_DRIVER = r"""
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include "pd_c_api.h"

int main(int argc, char** argv) {
  /* argv: model_prefix device_id in_file out_file ndim dims... */
  const char* prefix = argv[1];
  int device = atoi(argv[2]);
  int ndim = atoi(argv[5]);
  int64_t shape[8];
  int64_t n = 1;
  for (int i = 0; i < ndim; ++i) {
    shape[i] = atoll(argv[6 + i]);
    n *= shape[i];
  }
  float* in = (float*)malloc(n * sizeof(float));
  FILE* f = fopen(argv[3], "rb");
  if (fread(in, sizeof(float), n, f) != (size_t)n) return 10;
  fclose(f);

  PD_Predictor* card = PD_NewPredictor(prefix);
  printf("DEFAULT %s %s\n", card ? "ok" : "failed",
         card ? "" : PD_GetLastError());
  if (card) PD_DeletePredictor(card);
  PD_Predictor* bad = PD_NewPredictorWithDevice(prefix, 7);
  printf("DEVICE7 %s %s\n", bad ? "ok" : "failed",
         bad ? "" : PD_GetLastError());
  if (bad) PD_DeletePredictor(bad);

  PD_Predictor* p = PD_NewPredictorWithDevice(prefix, device);
  if (!p) { fprintf(stderr, "new: %s\n", PD_GetLastError()); return 11; }
  float* out = NULL;
  int64_t oshape[8];
  int ondim = 0;
  if (PD_PredictorRun(p, in, shape, ndim, &out, oshape, &ondim) != 0) {
    fprintf(stderr, "run: %s\n", PD_GetLastError());
    return 12;
  }
  int64_t total = 1;
  for (int i = 0; i < ondim; ++i) total *= oshape[i];
  f = fopen(argv[4], "wb");
  fwrite(&ondim, sizeof(int), 1, f);
  fwrite(oshape, sizeof(int64_t), ondim, f);
  fwrite(out, sizeof(float), total, f);
  fclose(f);
  PD_FreeBuffer(out);
  PD_DeletePredictor(p);
  printf("CAPI_OK\n");
  return 0;
}
"""

_READY = None


def _capi_ready():
    """(library path or None, skip reason), built once a session."""
    global _READY
    if _READY is None:
        missing = [t for t in ("gcc", "g++") if shutil.which(t) is None]
        try:
            capi.python_config()
        except RuntimeError:
            missing.append("python3-config")
        if missing:
            _READY = (None, f"C toolchain absent: no {'/'.join(missing)}")
        else:
            _READY = (capi.build(), "")
    return _READY


@pytest.fixture
def lib():
    path, why = _capi_ready()
    if path is None:
        pytest.skip(why)
    return path


@pytest.fixture(autouse=True)
def on_the_cpu():
    before = ptt.framework.place.default_place()
    ptt.set_device("cpu")
    yield
    ptt.set_device(before)


def _driver(tmp_path, lib):
    c = tmp_path / "driver.c"
    c.write_text(textwrap.dedent(C_DRIVER))
    exe = str(tmp_path / "driver")
    r = subprocess.run(
        ["gcc", str(c), "-o", exe, f"-I{capi.CSRC}", f"-L{lib.parent}",
         "-lpd_infer_capi", f"-Wl,-rpath,{lib.parent}"],
        capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    return exe


def _run_c(tmp_path, lib, prefix, x):
    """The C driver's output on `x` through the CPU (device -1), and its
    stdout."""
    exe = _driver(tmp_path, lib)
    in_file, out_file = str(tmp_path / "in.bin"), str(tmp_path / "out.bin")
    np.ascontiguousarray(x, np.float32).tofile(in_file)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([exe, prefix, "-1", in_file, out_file,
                        str(x.ndim), *map(str, x.shape)],
                       env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, (r.stdout, r.stderr[-2000:])
    assert "CAPI_OK" in r.stdout
    with open(out_file, "rb") as f:
        ondim = np.fromfile(f, dtype=np.int32, count=1)[0]
        oshape = np.fromfile(f, dtype=np.int64, count=ondim)
        out = np.fromfile(f, dtype=np.float32).reshape(oshape)
    return out, r.stdout


def _in_process(prefix, x):
    cfg = inference.Config(prefix)
    cfg.disable_gpu()
    return inference.create_predictor(cfg).run([x])[0]


def _mlp(prefix):
    torch.manual_seed(4)
    net = nn.Sequential(nn.Linear(8, 16), nn.Tanh(), nn.Linear(16, 3))
    jit.save(net, prefix, input_spec=[InputSpec([None, 8], "float32")])
    x = np.random.RandomState(5).standard_normal((2, 8)).astype("float32")
    return net, x


def _encoder(prefix):
    torch.manual_seed(6)
    layer = nn.TransformerEncoderLayer(64, 4, 128, dropout=0.0)
    net = nn.TransformerEncoder(layer, 2).eval()
    jit.save(net, prefix,
             input_spec=[InputSpec([None, 128, 64], "float32")])
    x = np.random.RandomState(7).standard_normal(
        (2, 128, 64)).astype("float32")
    return net, x


@pytest.mark.parametrize("model", ["mlp", "encoder"])
def test_c_program_runs_saved_model(tmp_path, lib, model):
    prefix = str(tmp_path / model)
    net, x = {"mlp": _mlp, "encoder": _encoder}[model](prefix)
    out, stdout = _run_c(tmp_path, lib, prefix, x)
    ref = _in_process(prefix, x)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-7)
    with torch.no_grad():
        eager = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, eager, rtol=1e-5, atol=1e-6)
    if not torch.cuda.is_available():
        # the card is PD_NewPredictor's default: no fallback to the CPU
        assert "DEFAULT failed UnavailableError:" in stdout
    assert "DEVICE7 failed UnavailableError:" in stdout


def _cgo_symbols():
    syms = set()
    go_dir = os.path.join(REPO, "go", "paddle")
    for fn in os.listdir(go_dir):
        if fn.endswith(".go"):
            with open(os.path.join(go_dir, fn)) as f:
                # function calls only — C.PD_Predictor is a type
                syms |= set(re.findall(r"C\.(PD_\w+)\(", f.read()))
    return syms


def test_go_symbols_exist_in_library(lib):
    out = subprocess.run(["nm", "-D", str(lib)], capture_output=True,
                         text=True, check=True).stdout
    exported = {line.split()[-1] for line in out.splitlines()
                if " T " in line}
    syms = _cgo_symbols()
    assert syms, "no C.PD_* references found in go/paddle"
    assert not syms - exported, f"unexported: {syms - exported}"
    assert "PD_NewPredictorWithDevice" in exported


def test_header_declares_all_symbols():
    with open(capi.CSRC / "pd_c_api.h") as f:
        header = f.read()
    for sym in _cgo_symbols() | {"PD_NewPredictorWithDevice"}:
        assert f"{sym}(" in header, f"{sym} missing from pd_c_api.h"


def test_r_binding_targets_real_api():
    """The R shim's calls (through reticulate) exist on the port's
    inference module."""
    with open(os.path.join(REPO, "r", "paddle_infer.R")) as f:
        src = f.read()
    calls = set(re.findall(r"inference\$(\w+)\(", src))
    assert calls == {"Config", "create_predictor"}
    for name in calls:
        assert hasattr(inference, name)
    assert "predictor$run(" in src
    assert callable(getattr(inference.Predictor, "run", None))


def test_config_refuses_a_card_it_does_not_have():
    cfg = inference.Config("unused")
    cfg.enable_use_gpu(device_id=torch.cuda.device_count() + 3)
    with pytest.raises(ptt.framework.errors.UnavailableError):
        cfg.device()
    cfg.disable_gpu()
    assert cfg.device().type == "cpu"
