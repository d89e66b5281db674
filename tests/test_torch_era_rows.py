"""The port's per-row Enhanced ERA (``core.era`` with ``impl="kernel"``)
against the JAX package's Pallas-routed seam (``impl="pallas"``).

The Pallas kernel runs in interpret mode on the CPU, as
``tests/test_kernels.py`` runs it; the port's wrapper takes its plain
PyTorch version for CPU tensors.  Inputs are made with numpy from a fixed
seed and handed to both.

Tolerances:

- float32 outputs: atol 1e-6 on probabilities.  Both sides compute
  ``log(max(z, 1e-12)) * beta``, the row max, ``exp`` and the division in
  float32; the row sums run in other orders and ``log``/``exp`` may
  differ by an ulp (measured: at most 3e-7).
- bfloat16 outputs: both sides compute in float32 and round once, so they
  agree to one bfloat16 step (rtol 2**-7) where the two float32 values
  straddle a rounding boundary, and exactly elsewhere (measured: exactly).
- At beta < 1 the Pallas kernel leaks mass into the 128-lane padding
  (ROADMAP, Queue C); the port is held against ``repro.kernels.ref`` there
  (atol 1e-6) and the leak is pinned on its own.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.core import era as jera
from repro.kernels import ref as jref
import repro_torch.core as pcore
from repro_torch.core import era as pera
from repro_torch.kernels import era_kernel, ops

ATOL = 1e-6
BF16_RTOL = 2.0 ** -7

_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _probs(seed, shape):
    rng = np.random.default_rng(seed)
    z = rng.dirichlet(np.ones(shape[-1]), size=int(np.prod(shape[:-1])))
    return z.astype(np.float32).reshape(shape)


def _pair(z, dtype):
    """The same values as a torch tensor and a jax array of ``dtype``."""
    return torch.from_numpy(z).to(dtype), jnp.asarray(z, _JDT[dtype])


def _assert_close(got: torch.Tensor, want) -> None:
    assert got.dtype in (torch.float32, torch.bfloat16)
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    rtol = BF16_RTOL if got.dtype == torch.bfloat16 else 0.0
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol, atol=ATOL)


# ---------------------------------------------------------------------------
# enhanced_era(impl="kernel") against the Pallas-routed seam
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N", [1, 10, 131])
@pytest.mark.parametrize("beta", [1.0, 1.5, 4.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_impl_matches_pallas_at_beta_one_and_above(N, beta, dtype):
    zt, zj = _pair(_probs(N * 10 + int(beta * 4), (2, 3, N)), dtype)
    want = jera.enhanced_era(zj, beta, impl="pallas")
    got = pera.enhanced_era(zt, beta, impl="kernel")
    assert got.dtype == dtype and want.dtype == _JDT[dtype]
    assert got.shape == zt.shape
    _assert_close(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_impl_takes_beta_as_a_tensor(dtype):
    """beta as a 0-d tensor (SCARLET's adaptive beta is one), against the
    Pallas seam jitted with beta as a traced array."""
    zt, zj = _pair(_probs(3, (5, 10)), dtype)
    want = jax.jit(lambda z, b: jera.enhanced_era(z, b, impl="pallas"))(
        zj, jnp.float32(2.5))
    got = pera.enhanced_era(zt, torch.tensor(2.5), impl="kernel")
    _assert_close(got, want)
    assert torch.equal(got, pera.enhanced_era(zt, 2.5, impl="kernel"))


@pytest.mark.parametrize("N", [1, 10, 131])
@pytest.mark.parametrize("beta", [0.25, 0.5, 0.9])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_impl_matches_the_oracle_below_beta_one(N, beta, dtype):
    zt, zj = _pair(_probs(N + 7, (2, 3, N)), dtype)
    got = pera.enhanced_era(zt, beta, impl="kernel")
    _assert_close(got, jref.enhanced_era(zj, beta))


def test_pallas_era_rows_pad_lanes_leak_mass_below_beta_one():
    """Pins the reference fault the port does not copy: the Pallas kernel
    sharpens rows zero-padded to 128 lanes.  At N=1 and beta=0.5 Eq. 4 is
    exactly 1, but the 127 pad lanes keep 127 * exp(0.5 * ln 1e-12) of the
    mass; an all-zero row is uniform over the 128 lanes (1/128 each, at
    any beta), where Eq. 4 gives 1/N."""
    one = np.ones((3, 1), np.float32)
    pallas = np.asarray(jera.enhanced_era(jnp.asarray(one), 0.5, impl="pallas"))
    leak = 127 * np.exp(0.5 * np.log(1e-12))
    np.testing.assert_allclose(pallas, 1.0 / (1.0 + leak), rtol=1e-5)
    got = pera.enhanced_era(torch.from_numpy(one), 0.5, impl="kernel").numpy()
    np.testing.assert_array_equal(got, 1.0)

    zero = np.zeros((2, 10), np.float32)
    for beta in (0.5, 1.5):
        pallas = np.asarray(jera.enhanced_era(jnp.asarray(zero), beta, impl="pallas"))
        np.testing.assert_allclose(pallas, 1.0 / 128, rtol=1e-6)
        got = pera.enhanced_era(torch.from_numpy(zero), beta, impl="kernel").numpy()
        np.testing.assert_allclose(got, 1.0 / 10, rtol=0, atol=ATOL)


def test_kernel_impl_beside_the_torch_impl():
    """The default ``impl="torch"`` (the reference's jnp path) and the
    kernel's plain version agree to float32 rounding on the same input."""
    z = torch.from_numpy(_probs(11, (4, 6, 10)))
    torch.testing.assert_close(pera.enhanced_era(z, 1.5, impl="kernel"),
                               pera.enhanced_era(z, 1.5), rtol=0, atol=ATOL)


# ---------------------------------------------------------------------------
# aggregate_soft_labels, softmax_with_temperature, log_prob_ratio
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["mean", "era", "enhanced_era"])
@pytest.mark.parametrize("weighted", [False, True])
def test_aggregate_soft_labels_matches_reference(method, weighted):
    z = _probs(21, (6, 9, 10))
    w = np.random.default_rng(22).random(6).astype(np.float32)
    kw = dict(beta=1.5, T=0.1)
    want = jera.aggregate_soft_labels(jnp.asarray(z), method, impl="pallas",
                                      weights=jnp.asarray(w) if weighted else None, **kw)
    got = pera.aggregate_soft_labels(torch.from_numpy(z), method, impl="kernel",
                                     weights=torch.from_numpy(w) if weighted else None,
                                     **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    # the default impl ("torch" / "jnp") too
    want = jera.aggregate_soft_labels(jnp.asarray(z), method,
                                      weights=jnp.asarray(w) if weighted else None, **kw)
    got = pera.aggregate_soft_labels(torch.from_numpy(z), method,
                                     weights=torch.from_numpy(w) if weighted else None,
                                     **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_aggregate_soft_labels_rejects_what_the_reference_rejects():
    with pytest.raises(ValueError):
        pera.aggregate_soft_labels(torch.ones(10), "mean")
    with pytest.raises(ValueError):
        pera.aggregate_soft_labels(torch.ones(2, 3, 10), "median")


@pytest.mark.parametrize("T", [0.05, 1.0, 3.0])
def test_softmax_with_temperature_matches_reference(T):
    x = np.random.default_rng(31).normal(size=(7, 12)).astype(np.float32)
    np.testing.assert_allclose(
        pera.softmax_with_temperature(torch.from_numpy(x), T).numpy(),
        np.asarray(jera.softmax_with_temperature(jnp.asarray(x), T)), rtol=0, atol=ATOL)


@pytest.mark.parametrize("dim", [-1, 0])
def test_log_prob_ratio_matches_reference(dim):
    p = _probs(41, (8, 10))
    p[0, 3] = 0.0  # clamped at 1e-12 on both sides
    want = jera.log_prob_ratio(jnp.asarray(p), 3, 5, axis=dim)
    got = pera.log_prob_ratio(torch.from_numpy(p), 3, 5, dim=dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-5)


# ---------------------------------------------------------------------------
# The seam's contract
# ---------------------------------------------------------------------------

def test_kernel_impl_raises_when_a_gradient_is_required():
    """The reference's Pallas seam has no gradient (``jax.grad`` fails);
    the kernel impl raises rather than return a detached result.  The
    default impl stays differentiable, and the kernel impl runs under
    ``torch.no_grad()``."""
    z = torch.from_numpy(_probs(51, (4, 10))).requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        pera.enhanced_era(z, 1.5, impl="kernel")
    with pytest.raises(RuntimeError, match="no backward"):
        pera.enhanced_era(z.detach(), torch.tensor(1.5, requires_grad=True), impl="kernel")
    with pytest.raises(RuntimeError, match="no backward"):
        pera.aggregate_soft_labels(z[None], beta=1.5, impl="kernel")
    pera.enhanced_era(z, 1.5)[:, 0].sum().backward()
    assert z.grad is not None and bool(torch.isfinite(z.grad).all())
    with torch.no_grad():
        out = pera.enhanced_era(z, 1.5, impl="kernel")
    assert not out.requires_grad


def test_unknown_impl_and_a_non_last_dim_raise():
    z = torch.from_numpy(_probs(52, (4, 10)))
    with pytest.raises(ValueError, match="impl"):
        pera.enhanced_era(z, 1.5, impl="pallas")
    with pytest.raises(ValueError, match="impl"):
        pera.aggregate_soft_labels(z[None], impl="cuda")
    with pytest.raises(ValueError, match="last dim"):
        pera.enhanced_era(z, 1.5, dim=0, impl="kernel")
    # the last dim named by its index is the last dim
    assert torch.equal(pera.enhanced_era(z, 1.5, dim=1, impl="kernel"),
                       pera.enhanced_era(z, 1.5, impl="kernel"))


def test_wrapper_checks_dtype_shape_and_beta():
    with pytest.raises(TypeError):
        era_kernel.enhanced_era(torch.ones(2, 3, dtype=torch.float64), 1.5)
    with pytest.raises(TypeError):
        era_kernel.enhanced_era(torch.ones(2, 3, dtype=torch.float16), 1.5)
    with pytest.raises(ValueError):
        era_kernel.enhanced_era(torch.ones(2, 3, 4), 1.5)
    with pytest.raises(ValueError):
        era_kernel.enhanced_era(torch.ones(2, 0), 1.5)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    ops.reset_launches()
    z = torch.from_numpy(_probs(53, (3, 8, 10)))
    assert torch.equal(ops.enhanced_era(z, 1.5),
                       era_kernel.enhanced_era_plain(z.reshape(-1, 10), 1.5).reshape(z.shape))
    assert torch.equal(pera.aggregate_soft_labels(z, beta=1.5, impl="kernel"),
                       era_kernel.enhanced_era_plain(z.mean(0), 1.5))
    assert ops.launches()["enhanced_era"] == 0


def test_empty_input_returns_an_empty_result():
    for dtype in (torch.float32, torch.bfloat16):
        out = pera.enhanced_era(torch.zeros(0, 10, dtype=dtype), 1.5, impl="kernel")
        assert out.shape == (0, 10) and out.dtype == dtype
        out = pera.enhanced_era(torch.zeros(2, 0, 10, dtype=dtype), 1.5, impl="kernel")
        assert out.shape == (2, 0, 10)


def test_core_exports_the_reference_names():
    for name in ("cache", "cache_sim", "comm", "era", "losses", "aggregate_soft_labels",
                 "enhanced_era", "entropy", "cross_entropy", "kl_divergence",
                 "soft_cross_entropy"):
        assert hasattr(jcore, name) and hasattr(pcore, name), name
    assert pcore.enhanced_era is pera.enhanced_era
