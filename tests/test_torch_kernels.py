"""The port's kernel modules against the JAX package's Pallas kernels.

The Pallas kernels run in interpret mode on the CPU, as
``tests/test_kernels.py`` runs them; the port's wrappers take their plain
PyTorch versions for CPU tensors.  Inputs are made with numpy from a
fixed seed and handed to both.

Tolerances: atol 1e-6 on probabilities for Enhanced ERA (the two sides
sum the client axis and the row in other orders, float32 rounding only;
see ``_check_era`` for the Pallas kernel's pad lanes, which the port
does not copy);
quantize-dequantize is the same elementwise arithmetic on both sides, so
atol 1e-6 and zero level flips.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import era_kernel as jera
from repro.kernels import quant_kernel as jquant
from repro.kernels import ref as jref
from repro_torch.core import prng
from repro_torch.kernels import era_kernel, ops, quant_kernel, round_kernel

ATOL = 1e-6
PADDED_ATOL = 1e-5


def _probs(seed, shape):
    rng = np.random.default_rng(seed)
    z = rng.dirichlet(np.ones(shape[-1]), size=int(np.prod(shape[:-1])))
    return z.astype(np.float32).reshape(shape)


def _flips(got, want, z, bits):
    """Values whose quantization level differs (off by half a step)."""
    levels = float(2 ** bits - 1)
    scale = np.maximum(z.max(-1, keepdims=True) - z.min(-1, keepdims=True), 1e-9)
    return int((np.abs(got - want) >= 0.5 * scale / levels).sum())


# ---------------------------------------------------------------------------
# Enhanced ERA (fused client mean + sharpening)
# ---------------------------------------------------------------------------

def _check_era(z, beta):
    """The port against the Pallas kernel, and against Eq. 4.

    The Pallas wrapper zero-pads N to 128 lanes and sharpens the padded
    row, so each pad lane keeps ``exp(beta*ln(1e-12) - rowmax)`` of the
    mass: below float32 resolution for beta >= 1, but 1.2e-4 of the row
    at N=1, beta=0.5.  The port sharpens the N real classes only, which
    is Eq. 4 and the package's own oracle (``kernels/ref.py``).  So the
    port is held against the Pallas kernel on the same zero-padded input,
    against ``ref.py`` on the real input, and against the Pallas kernel
    directly where the pad lanes vanish.

    The padded comparison alone takes atol 1e-5: at beta < 1 its row sum
    adds up to 127 pad terms of ~1e-6 to a sum near 1, where the float32
    spacing is 1.2e-7, so two summation orders differ by up to 127 half
    spacings (7.6e-6)."""
    N = z.shape[-1]
    pallas = np.asarray(jera.enhanced_era_fused(jnp.asarray(z), beta))
    zp = np.pad(z, ((0, 0), (0, 0), (0, (-N) % 128)))
    got_padded = era_kernel.enhanced_era_fused(torch.from_numpy(zp), beta)
    np.testing.assert_allclose(got_padded.numpy()[..., :N], pallas,
                               rtol=0, atol=PADDED_ATOL)
    got = era_kernel.enhanced_era_fused(torch.from_numpy(z), beta).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jref.enhanced_era_fused(jnp.asarray(z), beta)),
        rtol=0, atol=ATOL)
    if beta >= 1.0:
        np.testing.assert_allclose(got, pallas, rtol=0, atol=ATOL)
    return got


@pytest.mark.parametrize("K,B,N", [(1, 9, 10), (3, 33, 10), (16, 50, 5),
                                   (4, 7, 1), (2, 5, 130), (100, 24, 10)])
@pytest.mark.parametrize("beta", [0.5, 1.0, 1.5, 4.0])
def test_era_fused_plain_matches_pallas(K, B, N, beta):
    _check_era(_probs(K * 1000 + B * 10 + N, (K, B, N)), beta)


@pytest.mark.parametrize("beta", [1.0, 1.5, 4.0])
def test_era_fused_plain_matches_pallas_past_the_row_block_limit(beta):
    """N = 12289, one class past what the port's row-block layout holds
    (the card takes a cluster layout there): the reference's kernel takes
    it as any N.  At beta >= 1 its pad lanes carry no mass, so the plain
    version matches it directly."""
    _check_era(_probs(12289, (2, 3, 12289)), beta)


@pytest.mark.parametrize("beta", [0.5, 1.5, 4.0])
def test_era_fused_constant_rows(beta):
    got = _check_era(np.full((5, 17, 10), 0.1, np.float32), beta)
    np.testing.assert_allclose(got, 0.1, rtol=0, atol=ATOL)


def test_pallas_era_pad_lanes_leak_mass_below_beta_one():
    """Pins the reference fault the port does not copy: at N=1 Eq. 4 is
    exactly 1, but the 127 zero pad lanes of the Pallas kernel keep
    127 * exp(0.5 * ln 1e-12) of the mass at beta=0.5."""
    z = np.full((2, 3, 1), 1.0, np.float32)
    pallas = np.asarray(jera.enhanced_era_fused(jnp.asarray(z), 0.5))
    leak = 127 * np.exp(0.5 * np.log(1e-12))
    np.testing.assert_allclose(pallas, 1.0 / (1.0 + leak), rtol=1e-5)
    got = era_kernel.enhanced_era_fused(torch.from_numpy(z), 0.5).numpy()
    np.testing.assert_array_equal(got, 1.0)


def _subset_client_mean(z, groups):
    """``csrc/era_fused.cu``'s client mean in numpy float32: the clients s,
    s + G, ... of each subset s summed in k order from 0.0, the subsets'
    sums added in order s = 0..G-1, the total divided by K."""
    total = np.zeros(z.shape[1:], np.float32)
    for s in range(groups):
        acc = np.zeros(z.shape[1:], np.float32)
        for k in range(s, z.shape[0], groups):
            acc = acc + z[k]
        total = total + acc
    return total / np.float32(z.shape[0])


@pytest.mark.parametrize("K", [1, 7, 8, 100, 1000])
@pytest.mark.parametrize("N", [1, 10, 130, 12289])
def test_era_fused_client_split_depends_on_k_and_n_alone(K, N):
    """The kernel's client subsets and their order come from K alone, its
    layout from N alone: the plan function gives the same G whatever B,
    each B's launches take the same kernels, and the subset sum is the
    client mean to float32 rounding (so the kernel stays within ERA's atol
    of the plain version's other order), bit for bit the same on any split
    of rows."""
    from repro_torch.analysis.traceutil import tensor_spec, trace

    G = era_kernel.client_subsets(K)
    assert G == min(K, era_kernel.CLIENT_SPLIT)
    kernels = {tuple(x.plan.kernel for x in trace(lambda z: era_kernel.enhanced_era_fused(z, 1.5),
                                                  tensor_spec((K, B, N))).launches)
               for B in (1, 37, 1000)}
    assert len(kernels) == 1
    if N <= 130:
        z = _probs(K + N, (K, 4, N))
        mean = _subset_client_mean(z, G)
        np.testing.assert_allclose(mean, z.astype(np.float64).mean(0), rtol=1e-6, atol=0)
        halves = np.concatenate([_subset_client_mean(z[:, :1], G),
                                 _subset_client_mean(z[:, 1:], G)])
        assert np.array_equal(mean, halves)


def test_era_fused_wrapper_checks_shapes():
    with pytest.raises(ValueError):
        era_kernel.enhanced_era_fused(torch.zeros(4, 10), 1.5)
    with pytest.raises(ValueError):
        era_kernel.enhanced_era_fused(torch.zeros(0, 4, 10), 1.5)


# ---------------------------------------------------------------------------
# Quantize-dequantize
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,N", [(64, 10), (33, 9), (200, 130), (37, 1)])
@pytest.mark.parametrize("bits", [1, 4, 8])
def test_qdq_plain_matches_pallas(B, N, bits):
    z = _probs(B * 100 + N, (B, N))
    want = np.asarray(jquant.quantize_dequantize(jnp.asarray(z), bits))
    got = quant_kernel.quantize_dequantize(torch.from_numpy(z), bits).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert _flips(got, want, z, bits) == 0


@pytest.mark.parametrize("bits", [1, 4, 8])
def test_qdq_signed_residual_rows(bits):
    """Cache-delta residuals are signed; the [0, 1] level clamp and the
    half-to-even rounding must match the Pallas kernel."""
    rng = np.random.default_rng(bits)
    z = _probs(7, (6, 20, 10))
    base = _probs(8, (20, 10))
    r = (z - base)[..., :-1].reshape(-1, 9)
    r = np.concatenate([r, -rng.random((16, 9), dtype=np.float32)])
    want = np.asarray(jquant.quantize_dequantize(jnp.asarray(r), bits))
    got = quant_kernel.quantize_dequantize(torch.from_numpy(r), bits).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert _flips(got, want, r, bits) == 0


@pytest.mark.parametrize("bits", [1, 8])
def test_qdq_constant_rows(bits):
    z = np.full((12, 10), 0.1, np.float32)
    want = np.asarray(jquant.quantize_dequantize(jnp.asarray(z), bits))
    got = quant_kernel.quantize_dequantize(torch.from_numpy(z), bits).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, z)


def test_qdq_half_levels_round_to_even():
    """Values that land exactly on a half level: jnp.round (half to even)
    and the port agree; half-away-from-zero would move them a step."""
    # one level at 1 bit: each middle value sits exactly half way
    z = np.array([[0.0, 0.5, 1.0], [0.0, 0.25, 0.5]], np.float32)
    want = np.asarray(jquant.quantize_dequantize(jnp.asarray(z), 1))
    got = quant_kernel.quantize_dequantize(torch.from_numpy(z), 1).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [[0.0, 0.0, 1.0], [0.0, 0.0, 0.5]])


def test_qdq_strided_view_equals_contiguous():
    z = torch.from_numpy(_probs(3, (4, 30, 10)))
    view = (z - z.mean(0))[..., :-1]
    assert not view.is_contiguous()
    np.testing.assert_array_equal(
        quant_kernel.quantize_dequantize(view, 8).numpy(),
        quant_kernel.quantize_dequantize(view.contiguous(), 8).numpy())


def test_qdq_rejects_zero_bits():
    with pytest.raises(ValueError):
        quant_kernel.quantize_dequantize(torch.zeros(3, 4), 0)


# ---------------------------------------------------------------------------
# Wrappers: plain version on the CPU, no launch counted there
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    ops.reset_launches()
    z = torch.from_numpy(_probs(5, (3, 8, 10)))
    assert torch.equal(ops.enhanced_era_fused(z, 1.5),
                       era_kernel.enhanced_era_fused_plain(z, 1.5))
    assert torch.equal(ops.quantize_dequantize(z, 8),
                       quant_kernel.quantize_dequantize_plain(z, 8))
    w = torch.ones(3)
    assert torch.equal(ops.fused_round(z, w, 1.5, mode="quant", bits=8),
                       round_kernel.fused_round_plain(z, w, 1.5, mode="quant", bits=8))
    keys = torch.tensor([[0, 7], [3, 2 ** 32 - 1]], dtype=torch.int64)
    assert torch.equal(ops.threefry(keys, 5, 9, "bits"), prng.counter_hash(keys, 5, 9, "bits"))
    assert ops.launches() == {"enhanced_era_fused": 0, "quantize_dequantize": 0,
                              "fused_round": 0, "flash_attention": 0,
                              "enhanced_era": 0, "distill_loss": 0,
                              "copy_vec4": 0, "scale": 0, "copy_smem": 0, "threefry": 0}
