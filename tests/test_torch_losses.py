"""The port's ``core.losses`` (default impl) and ``core.cache_sim`` against
the JAX package's.

Inputs are made with numpy from a fixed seed and handed to both.  Losses
and gradients are float32 on both sides, the same operations in other
summation orders: atol 1e-5 on losses near 1-10, 1e-6 on gradients.  The
cache simulator is numpy on both sides with the same seed: equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cache_sim as jsim
from repro.core import losses as jlosses
from repro_torch.core import cache_sim as psim
from repro_torch.core import losses as plosses

ATOL = 1e-5
GRAD_ATOL = 1e-6


def _logits(seed, shape, scale=2.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _probs(seed, shape):
    rng = np.random.default_rng(seed)
    z = rng.dirichlet(np.ones(shape[-1]), size=int(np.prod(shape[:-1])))
    return z.astype(np.float32).reshape(shape)


@pytest.mark.parametrize("shape", [(16, 10), (3, 5, 7)])
def test_cross_entropy_ignores_negative_labels(shape):
    logits = _logits(1, shape)
    rng = np.random.default_rng(2)
    labels = rng.integers(-1, shape[-1], size=shape[:-1]).astype(np.int32)
    labels.flat[0] = -1
    want = jlosses.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    got = plosses.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=0, atol=ATOL)


def test_cross_entropy_of_no_labels_is_zero():
    logits = _logits(3, (4, 6))
    labels = np.full(4, -1, np.int32)
    want = jlosses.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    got = plosses.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    assert float(want) == 0.0 and float(got) == 0.0


@pytest.mark.parametrize("shape", [(8, 10), (2, 3, 100)])
def test_soft_cross_entropy_default_impl_matches_reference(shape):
    logits, teacher = _logits(4, shape), _probs(5, shape)
    want = jlosses.soft_cross_entropy(jnp.asarray(logits), jnp.asarray(teacher))
    got = plosses.soft_cross_entropy(torch.from_numpy(logits), torch.from_numpy(teacher))
    np.testing.assert_allclose(float(got), float(want), rtol=0, atol=ATOL)


def test_soft_cross_entropy_gradient_matches_reference():
    """The default impl is differentiable, with the reference's gradient."""
    logits, teacher = _logits(6, (6, 20)), _probs(7, (6, 20))
    want = jax.grad(jlosses.soft_cross_entropy)(jnp.asarray(logits), jnp.asarray(teacher))
    x = torch.from_numpy(logits).requires_grad_()
    plosses.soft_cross_entropy(x, torch.from_numpy(teacher)).backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), rtol=0, atol=GRAD_ATOL)


def test_kl_divergence_matches_reference():
    """The teacher is clamped at 1e-12, so zero entries add nothing."""
    logits, teacher = _logits(8, (9, 12)), _probs(9, (9, 12))
    teacher[0, :6] = 0.0
    teacher[0] /= teacher[0].sum()
    want = jlosses.kl_divergence(jnp.asarray(teacher), jnp.asarray(logits))
    got = plosses.kl_divergence(torch.from_numpy(teacher), torch.from_numpy(logits))
    np.testing.assert_allclose(float(got), float(want), rtol=0, atol=ATOL)
    # KL of a distribution with itself is 0
    same = plosses.kl_divergence(torch.softmax(torch.from_numpy(logits), -1),
                                 torch.from_numpy(logits))
    assert abs(float(same)) < 1e-6


@pytest.mark.parametrize("public_size,per_round,D,rounds,seed", [
    (100, 10, 5, 40, 0), (1000, 100, 25, 30, 3), (50, 50, 2, 10, 1), (80, 8, 0, 5, 2)])
def test_simulate_hit_rate_equals_reference(public_size, per_round, D, rounds, seed):
    for name in ("simulate_hit_rate", "simulate_hit_rate_probabilistic"):
        want = getattr(jsim, name)(public_size, per_round, D, rounds, seed=seed)
        got = getattr(psim, name)(public_size, per_round, D, rounds, seed=seed)
        assert got.dtype == want.dtype and got.shape == (rounds,)
        np.testing.assert_array_equal(got, want)
    assert (psim.expected_steady_state_hit_rate(public_size, per_round, D)
            == jsim.expected_steady_state_hit_rate(public_size, per_round, D))


def test_simulate_hit_rate_rejects_too_many_per_round():
    for name in ("simulate_hit_rate", "simulate_hit_rate_probabilistic"):
        with pytest.raises(ValueError):
            getattr(psim, name)(10, 11, 3, 5)
