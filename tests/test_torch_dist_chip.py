"""Point-to-point over gloo on the card (ROADMAP C35), marked `chip`: two
gloo ranks that share the CUDA card send and receive a CUDA tensor, and
take a `ppermute` hop of one and its gradient, bit for bit. Gloo reads
host memory only; the port stages such a tensor through a host copy.
Skips without a CUDA device; on the GPU

    python -m pytest --noconftest -m chip tests/test_torch_dist_chip.py
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.chip


def test_gloo_send_recv_and_ppermute_of_cuda_tensors(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: gloo ranks sharing the card")
    from torch_dist_ranks import launch_ranks
    np.savez(tmp_path / "in.npz", unused=np.zeros(1))
    r0, r1 = launch_ranks("dist_chip", 2, str(tmp_path), timeout=120)
    x = [np.arange(12, dtype=np.float32) * (r + 1.5) for r in range(2)]
    np.testing.assert_array_equal(r1["p2p"], x[0])
    np.testing.assert_array_equal(r0["p2p"], x[0])
    np.testing.assert_array_equal(r0["hop"], x[1])
    np.testing.assert_array_equal(r1["hop"], x[0])
    for r in (r0, r1):
        np.testing.assert_array_equal(r["grad"], np.ones(12, np.float32))
