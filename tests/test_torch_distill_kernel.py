"""The port's distillation loss (``core.losses.soft_cross_entropy`` with
``impl="kernel"``, and the per-row kernel module) against the JAX
package's Pallas-routed seam (``impl="pallas"``).

The Pallas kernel runs in interpret mode on the CPU, as
``tests/test_kernels.py`` runs it; the port's wrapper takes its plain
PyTorch version for CPU tensors.  Inputs are made with numpy from a fixed
seed and handed to both.

Tolerance: atol 1e-5 on losses near 10, per row and on their mean.  Both
sides cast the inputs to float32 and compute ``lse(l) * sum(t) -
sum(t * l)``; the Pallas kernel sums over vocab blocks of up to 2048 with
an online max, the plain version in PyTorch's order (measured: at most
3e-6).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import losses as jlosses
from repro.kernels import distill_kernel as jdistill
from repro.kernels import ref as jref
from repro_torch.core import losses as plosses
from repro_torch.kernels import distill_kernel, ops

ATOL = 1e-5

_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
DTYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
          (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)]


def _inputs(seed, shape, scale=3.0):
    """Student logits and a teacher's probability rows."""
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=shape) * scale).astype(np.float32)
    teacher = rng.dirichlet(np.ones(shape[-1]), size=int(np.prod(shape[:-1])))
    return logits, teacher.astype(np.float32).reshape(shape)


def _pair(x, dtype):
    return torch.from_numpy(x).to(dtype), jnp.asarray(x, _JDT[dtype])


@pytest.mark.parametrize("B,V", [(8, 100), (3, 131), (32, 777), (16, 5000)])
@pytest.mark.parametrize("ldt,tdt", DTYPES)
def test_kernel_impl_matches_pallas(B, V, ldt, tdt):
    logits, teacher = _inputs(B * V, (B, V))
    lt, lj = _pair(logits, ldt)
    tt, tj = _pair(teacher, tdt)
    want = jlosses.soft_cross_entropy(lj, tj, impl="pallas")
    got = plosses.soft_cross_entropy(lt, tt, impl="kernel")
    assert got.dtype == torch.float32 and want.dtype == jnp.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), float(want), rtol=0, atol=ATOL)
    # per row, against the Pallas kernel itself
    rows = distill_kernel.distill_loss(lt, tt)
    assert rows.shape == (B,) and rows.dtype == torch.float32
    np.testing.assert_allclose(rows.numpy(), np.asarray(jdistill.distill_loss(lj, tj)),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("ldt,tdt", DTYPES)
def test_kernel_impl_flattens_leading_dims(ldt, tdt):
    logits, teacher = _inputs(7, (2, 3, 300))
    lt, lj = _pair(logits, ldt)
    tt, tj = _pair(teacher, tdt)
    want = jlosses.soft_cross_entropy(lj, tj, impl="pallas")
    got = plosses.soft_cross_entropy(lt, tt, impl="kernel")
    np.testing.assert_allclose(float(got), float(want), rtol=0, atol=ATOL)


def test_the_parity_target_is_the_pallas_seam_not_the_jnp_path():
    """On bfloat16 logits the reference's two paths differ: the Pallas
    kernel computes in float32 on the upcast values, the jnp path in
    bfloat16.  The port's kernel impl follows the Pallas seam."""
    logits, teacher = _inputs(0, (6, 300), scale=1.0)
    lt, lj = _pair(logits, torch.bfloat16)
    pallas = float(jlosses.soft_cross_entropy(lj, jnp.asarray(teacher), impl="pallas"))
    jnp_path = float(jlosses.soft_cross_entropy(lj, jnp.asarray(teacher), impl="jnp"))
    got = float(plosses.soft_cross_entropy(lt, torch.from_numpy(teacher), impl="kernel"))
    assert abs(pallas - jnp_path) > 1e-3
    assert abs(got - pallas) <= ATOL


def test_plain_version_matches_the_oracle():
    """``distill_loss_plain`` is the kernel's formula; the oracle
    (``kernels/ref.py``) is ``-sum t * log_softmax(l)``: the same value."""
    logits, teacher = _inputs(9, (16, 2048))
    got = distill_kernel.distill_loss_plain(torch.from_numpy(logits), torch.from_numpy(teacher))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jref.distill_loss(jnp.asarray(logits), jnp.asarray(teacher))),
        rtol=0, atol=ATOL)


def test_teacher_rows_need_not_sum_to_one():
    """The formula weights lse by sum(t), as the Pallas kernel does."""
    logits, teacher = _inputs(10, (5, 257))
    teacher[0] *= 3.0
    teacher[1] = 0.0
    want = np.asarray(jdistill.distill_loss(jnp.asarray(logits), jnp.asarray(teacher)))
    got = distill_kernel.distill_loss(torch.from_numpy(logits), torch.from_numpy(teacher))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    assert got[1] == 0.0


# ---------------------------------------------------------------------------
# The seam's contract
# ---------------------------------------------------------------------------

def test_kernel_impl_raises_when_a_gradient_is_required():
    """The reference's Pallas seam has no gradient (``jax.grad`` fails
    there); the kernel impl raises rather than return a detached loss.
    The default impl stays differentiable."""
    logits, teacher = (torch.from_numpy(a) for a in _inputs(11, (4, 50)))
    with pytest.raises(RuntimeError, match="no backward"):
        plosses.soft_cross_entropy(logits.clone().requires_grad_(), teacher, impl="kernel")
    with pytest.raises(RuntimeError, match="no backward"):
        plosses.soft_cross_entropy(logits, teacher.clone().requires_grad_(), impl="kernel")
    x = logits.clone().requires_grad_()
    plosses.soft_cross_entropy(x, teacher).backward()
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())
    with torch.no_grad():
        loss = plosses.soft_cross_entropy(x, teacher, impl="kernel")
    np.testing.assert_allclose(float(loss), float(plosses.soft_cross_entropy(logits, teacher)),
                               rtol=0, atol=ATOL)


def test_unknown_impl_raises():
    logits, teacher = (torch.from_numpy(a) for a in _inputs(12, (4, 50)))
    with pytest.raises(ValueError, match="impl"):
        plosses.soft_cross_entropy(logits, teacher, impl="pallas")


def test_wrapper_checks_dtype_and_shape():
    x = torch.zeros(2, 8)
    for bad in (torch.float64, torch.float16):
        with pytest.raises(TypeError):
            distill_kernel.distill_loss(x.to(bad), x)
        with pytest.raises(TypeError):
            distill_kernel.distill_loss(x, x.to(bad))
    with pytest.raises(ValueError):
        distill_kernel.distill_loss(x, torch.zeros(2, 9))
    with pytest.raises(ValueError):
        distill_kernel.distill_loss(torch.zeros(2, 3, 8), torch.zeros(2, 3, 8))
    with pytest.raises(ValueError):
        distill_kernel.distill_loss(torch.zeros(2, 0), torch.zeros(2, 0))


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    ops.reset_launches()
    logits, teacher = (torch.from_numpy(a) for a in _inputs(13, (2, 3, 40)))
    got = ops.distill_loss(logits, teacher)
    want = distill_kernel.distill_loss_plain(logits.reshape(-1, 40),
                                             teacher.reshape(-1, 40)).mean()
    assert torch.equal(got, want)
    assert ops.launches()["distill_loss"] == 0


def test_empty_input_returns_an_empty_result():
    for dtype in (torch.float32, torch.bfloat16):
        out = distill_kernel.distill_loss(torch.zeros(0, 30, dtype=dtype),
                                          torch.zeros(0, 30, dtype=dtype))
        assert out.shape == (0,) and out.dtype == torch.float32
