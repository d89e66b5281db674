"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: without a CUDA device every test here skips (the CUDA
kernels have no CPU mode).  On a machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: as ``chip_smoke.py`` states them, atol 1e-6 for both kernels
and zero quantization level flips.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import era_kernel, ops, quant_kernel

pytestmark = pytest.mark.cuda

ATOL = 1e-6


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _probs(seed, shape, dev):
    rng = np.random.default_rng(seed)
    z = rng.dirichlet(np.ones(shape[-1]), size=int(np.prod(shape[:-1])))
    return torch.from_numpy(z.astype(np.float32).reshape(shape)).to(dev)


@pytest.mark.parametrize("K,B,N", [(1, 9, 10), (100, 1000, 10), (3, 33, 130),
                                   (5, 7, 1), (2, 3, 4000)])
@pytest.mark.parametrize("beta", [0.5, 1.5, 4.0])
def test_era_kernel_matches_plain(dev, K, B, N, beta):
    z = _probs(K + B + N, (K, B, N), dev)
    ops.reset_launches()
    got = era_kernel.enhanced_era_fused(z, beta)
    torch.cuda.synchronize()
    assert ops.launches()["enhanced_era_fused"] == 1
    want = era_kernel.enhanced_era_fused_plain(z, beta)
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("bits", [1, 4, 8])
def test_qdq_kernel_matches_plain_on_residual_view(dev, bits):
    z = _probs(bits, (20, 300, 10), dev)
    base = _probs(bits + 1, (300, 10), dev)
    r = (z - base)[..., :-1]
    ops.reset_launches()
    got = quant_kernel.quantize_dequantize(r, bits)
    torch.cuda.synchronize()
    assert ops.launches()["quantize_dequantize"] == 1
    want = quant_kernel.quantize_dequantize_plain(r, bits)
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
    levels = 2 ** bits - 1
    scale = torch.clamp_min(r.amax(-1, keepdim=True) - r.amin(-1, keepdim=True), 1e-9)
    assert int(((got - want).abs() >= 0.5 * scale / levels).sum()) == 0


def test_kernels_reject_wrong_dtype(dev):
    with pytest.raises(TypeError):
        era_kernel.enhanced_era_fused(torch.ones(2, 3, 4, device=dev,
                                                 dtype=torch.float64), 1.5)
    with pytest.raises(TypeError):
        quant_kernel.quantize_dequantize(torch.ones(3, 4, device=dev,
                                                    dtype=torch.float16), 8)
