"""The port stands alone: no jax, no paddle_tpu, no silent CPU fallback.

- An AST scan: no module under paddle_tpu_torch/ and no line of
  chip_smoke.py or kernel_ab.py imports jax or paddle_tpu.
- Importing every module of the package builds no kernel.
- With no CUDA device, an entry point left on its default device raises.
- A kernel wrapper handed CPU tensors takes its plain version: its launch
  counter stays 0 and nothing is built.
"""
import ast
import importlib
import pkgutil
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu_torch
from paddle_tpu_torch.framework.errors import UnavailableError
from paddle_tpu_torch.framework.place import resolve_device
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.models.gpt import GPTModel
from paddle_tpu_torch.models.seq2seq import seq2seq_attn
from paddle_tpu_torch.ops import _build, flash_ops, paged_ops, splash_ops
from paddle_tpu_torch.serving import GenerationEngine
from paddle_tpu_torch.serving.kv_cache import PagedKVCache

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


def _port_files():
    files = sorted((ROOT / "paddle_tpu_torch").rglob("*.py"))
    assert len(files) >= 15
    return files + [ROOT / "chip_smoke.py", ROOT / "kernel_ab.py"]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_paddle_tpu_imports(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path} imports {mod}"


def test_importing_every_module_builds_nothing():
    names = [m.name for m in pkgutil.walk_packages(
        paddle_tpu_torch.__path__, "paddle_tpu_torch.")]
    for sub in ("hapi.model", "hapi.callbacks", "io.dataloader",
                "io.sampler", "io.dataset", "optimizer.lr",
                "optimizer.optimizers", "nn.clip", "nn.functional.loss",
                "nn.layer.loss", "framework.random", "ops.splash_ops",
                "io.packing", "static.input_spec", "amp", "ops.linalg",
                "nn.functional.common", "nn.functional.norm",
                "nn.functional.activation", "nn.layer.common",
                "nn.layer.norm", "nn.layer.activation",
                "serving.prefix_cache", "serving.spec_decode",
                "nn.quant", "quantization", "jit", "inference",
                "serving.engine", "ops.math", "ops.creation",
                "ops.manipulation", "ops.logic", "ops.reduction",
                "ops.search", "ops.random_ops", "ops.tensor_methods",
                "framework.dtype", "framework.io_state",
                "framework.param_attr", "autograd", "autograd.functional",
                "device", "nn.layer.layers", "nn.layer.rnn", "nn.decode",
                "nn.utils", "ops.extra_ops", "models.seq2seq"):
        assert f"paddle_tpu_torch.{sub}" in names
    for name in names:
        importlib.import_module(name)
    assert _build._libs == {}


def test_package_location_is_beside_the_reference():
    assert Path(paddle_tpu_torch.__file__).parent == ROOT / "paddle_tpu_torch"


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(UnavailableError):
        resolve_device(None)
    with pytest.raises(UnavailableError):
        GPTForCausalLM(GPTConfig.tiny())
    with pytest.raises(UnavailableError):
        GPTModel(GPTConfig.tiny())
    with pytest.raises(UnavailableError):
        PagedKVCache(num_layers=1, num_heads=1, head_dim=4, page_size=4,
                     num_pages=2, pages_per_seq=1)
    model = GPTForCausalLM(GPTConfig.tiny(), device="cpu")
    with pytest.raises(UnavailableError):
        GenerationEngine(model, max_slots=1, page_size=4, num_pages=8,
                         prefill_buckets=(8,))
    with pytest.raises(UnavailableError):
        GPTForCausalLM(GPTConfig.tiny(use_moe=True, num_experts=2))
    # nn.Layer.create_parameter (the recurrent layers) and the seq2seq
    with pytest.raises(UnavailableError):
        paddle_tpu_torch.nn.LSTM(2, 2)
    with pytest.raises(UnavailableError):
        seq2seq_attn(src_vocab=8, trg_vocab=8, hidden=4, num_layers=1)
    # the top-level API: every op that makes a tensor from nothing
    for fn in (lambda: paddle_tpu_torch.to_tensor([1.0]),
               lambda: paddle_tpu_torch.zeros([2]),
               lambda: paddle_tpu_torch.full([2], 1.0),
               lambda: paddle_tpu_torch.arange(3),
               lambda: paddle_tpu_torch.eye(2),
               lambda: paddle_tpu_torch.linspace(0, 1, 3),
               lambda: paddle_tpu_torch.tril_indices(3, 3),
               lambda: paddle_tpu_torch.rand([2]),
               lambda: paddle_tpu_torch.randint(0, 3, [2]),
               lambda: paddle_tpu_torch.randperm(3),
               lambda: paddle_tpu_torch.uniform([2]),
               lambda: paddle_tpu_torch.normal(0.0, 1.0, [2]),
               lambda: paddle_tpu_torch.device.cuda.synchronize()):
        with pytest.raises(UnavailableError):
            fn()


def test_cpu_tensors_take_the_plain_path_and_build_nothing():
    paged0 = paged_ops.paged_attention.launches
    flash0 = flash_ops.flash_attention_fwd.launches
    rng = np.random.RandomState(0)
    q = torch.from_numpy(rng.standard_normal((2, 2, 32)).astype(np.float32))
    kp = torch.from_numpy(rng.standard_normal((2, 5, 4, 32))
                          .astype(np.float32))
    pt = torch.tensor([[1, 2], [3, 0]], dtype=torch.int32)
    pos = torch.tensor([6, 1], dtype=torch.int32)
    out = paged_ops.paged_attention(q, kp, kp, pt, pos, 0.2)
    np.testing.assert_array_equal(
        out.numpy(), paged_ops.paged_attention_plain(q, kp, kp, pt, pos,
                                                     0.2).numpy())
    x = torch.from_numpy(rng.standard_normal((1, 2, 128, 32))
                         .astype(np.float32)).requires_grad_()
    o, lse = flash_ops.flash_attention_fwd(x, x, x, None, True, None, 0.1, 3)
    assert o.shape == x.shape and lse.shape == (2, 128)
    delta = flash_ops._delta(o, o)
    dq = flash_ops.flash_attention_dq(x, x, x, None, o, lse, delta, True,
                                      0.2, 0.1, 3)
    dk, dv = flash_ops.flash_attention_dkv(x, x, x, None, o, lse, delta,
                                           True, 0.2, 0.1, 3)
    assert dq.shape == dk.shape == dv.shape == x.shape
    out = flash_ops.flash_attention(x, x, x, causal=True, dropout_p=0.1)
    out.sum().backward()
    assert x.grad is not None
    seg = torch.zeros(1, 128, dtype=torch.int32)
    seg[:, 70:] = 1
    out = splash_ops.splash_attention(x, x, x, seg, seg, causal=True,
                                      dropout_p=0.1)
    out.sum().backward()
    assert paged_ops.paged_attention.launches == paged0 == 0
    assert flash_ops.flash_attention_fwd.launches == flash0 == 0
    assert flash_ops.flash_attention_dq.launches == 0
    assert flash_ops.flash_attention_dkv.launches == 0
    assert splash_ops.splash_attention_fwd.launches == 0
    assert splash_ops.splash_attention_dq.launches == 0
    assert splash_ops.splash_attention_dkv.launches == 0
    assert _build._libs == {}


def test_kernel_sources_and_build_key():
    for src in _build.SOURCES:
        text = (_build.CSRC / src).read_text()
        assert "extern \"C\"" in text and "cudaGetLastError" in text
        path = _build._lib_path(src)
        assert path.parent == _build.build_dir()
        assert path.name.startswith(Path(src).stem + "-")
    assert "build/" in (ROOT / ".gitignore").read_text().split()
