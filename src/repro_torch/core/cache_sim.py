"""Lightweight cache hit-rate simulation (paper Appendix A, Alg. 3; Fig. 3).

The port's own copy of ``repro.core.cache_sim``: it models only the random
sampling of the public subset and the expiry logic (no FL training) to
predict the per-round cache hit ratio for a given duration ``D``, used to
pick ``D`` before running full FL.  Pure numpy, so the same seed gives the
reference's draws.
"""
from __future__ import annotations

import numpy as np

__all__ = ["simulate_hit_rate", "simulate_hit_rate_probabilistic",
           "expected_steady_state_hit_rate"]


def simulate_hit_rate(public_size: int, per_round: int, D: int, rounds: int,
                      seed: int = 0) -> np.ndarray:
    """Per-round cache hit ratios, length ``rounds``.

    Alg. 3: an index hits when it is present and ``t - ts <= D``;
    otherwise it misses and is (re)cached at ``t``.
    """
    if per_round > public_size:
        raise ValueError("per_round must be <= public_size")
    rng = np.random.default_rng(seed)
    if D == 0:
        return np.zeros(rounds, dtype=np.float64)
    ts = np.full(public_size, -(2**30), dtype=np.int64)
    out = np.empty(rounds, dtype=np.float64)
    for t in range(1, rounds + 1):
        idx = rng.choice(public_size, size=per_round, replace=False)
        hit = t - ts[idx] <= D
        ts[idx[~hit]] = t
        out[t - 1] = hit.mean()
    return out


def simulate_hit_rate_probabilistic(public_size: int, per_round: int, D: int,
                                    rounds: int, seed: int = 0) -> np.ndarray:
    """Per-sample stochastic expiry (hazard ``clip((age - 1) / D, 0, 1)``),
    the paper's §V 'probabilistic or selective per-sample expiration'
    direction: the same expected refresh budget as the hard cutoff, but no
    synchronized mass-refresh waves."""
    if per_round > public_size:
        raise ValueError("per_round must be <= public_size")
    rng = np.random.default_rng(seed)
    if D == 0:
        return np.zeros(rounds, dtype=np.float64)
    ts = np.full(public_size, -(2**30), dtype=np.int64)
    out = np.empty(rounds, dtype=np.float64)
    for t in range(1, rounds + 1):
        idx = rng.choice(public_size, size=per_round, replace=False)
        hazard = np.clip((t - ts[idx] - 1.0) / D, 0.0, 1.0)
        miss = rng.random(per_round) < hazard
        ts[idx[miss]] = t
        out[t - 1] = 1.0 - miss.mean()
    return out


def expected_steady_state_hit_rate(public_size: int, per_round: int, D: int) -> float:
    """Renewal approximation of the steady-state hit rate: a sample is
    selected each round with probability ``s = per_round / public_size``;
    after a refresh, its ``s * D`` expected selections within D rounds hit
    and the next one misses, so the rate is ``s D / (s D + 1)``."""
    s = per_round / public_size
    return (s * D) / (s * D + 1.0)
