"""Client scenarios: participation sampling, outage windows and per-client
schedule heterogeneity (counterpart of ``repro.fl.scenarios``).

Two streams, as in the reference.  ``sample`` and ``participation_mask``
draw from a numpy Generator owned by the engine (``rng_backend="numpy"``);
``sample_device`` and ``participation_mask_device`` from the reference's
jax key stream (:mod:`repro_torch.core.prng`, ``rng_backend="jax"``), on
a batch of keys and offline masks in one go (the device engines draw a
leg's rounds at once).  Either way a port run and a reference run with
the same seed draw the same participation masks bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import prng

__all__ = ["Participation", "Outage", "Heterogeneity", "Scenario",
           "full_participation", "fixed_fraction", "bernoulli_participation"]


@dataclass(frozen=True)
class Participation:
    """Per-round client-sampling policy.

    kind:
      ``full``       every client, every round (no RNG consumed).
      ``fraction``   exactly ``max(round(rate*K), 1)`` clients, sampled
                     uniformly without replacement (paper Alg. 1).
      ``bernoulli``  each client independently with probability ``rate``.
    """

    kind: str = "full"
    rate: float = 1.0

    def sample(self, n_clients: int, rng: np.random.Generator) -> np.ndarray:
        if self.kind == "full":
            return np.ones(n_clients, bool)
        if self.kind == "fraction":
            n = min(max(int(round(self.rate * n_clients)), 1), n_clients)
            mask = np.zeros(n_clients, bool)
            mask[rng.choice(n_clients, n, replace=False)] = True
            return mask
        if self.kind == "bernoulli":
            return rng.random(n_clients) < self.rate
        raise ValueError(f"unknown participation kind: {self.kind!r}")

    def sample_device(self, key: torch.Tensor, n_clients: int) -> torch.Tensor:
        """The twin of :meth:`sample` on the jax key stream (reference
        ``sample_device``): ``key`` is a ``(..., 2)`` batch of keys, the
        result ``(..., n_clients)`` bool on their device."""
        shape = key.shape[:-1] + (n_clients,)
        if self.kind == "full":
            return torch.ones(shape, dtype=torch.bool, device=key.device)
        if self.kind == "fraction":
            n = min(max(int(round(self.rate * n_clients)), 1), n_clients)
            sel = prng.choice(key, n_clients, n)
            return torch.zeros(shape, dtype=torch.bool, device=key.device).scatter_(
                -1, sel, True)
        if self.kind == "bernoulli":
            rate = torch.full((), self.rate, dtype=torch.float32, device=key.device)
            return prng.uniform(key, (n_clients,)) < rate
        raise ValueError(f"unknown participation kind: {self.kind!r}")


def full_participation() -> Participation:
    return Participation("full")


def fixed_fraction(rate: float) -> Participation:
    return Participation("fraction", rate)


def bernoulli_participation(rate: float) -> Participation:
    return Participation("bernoulli", rate)


@dataclass(frozen=True)
class Outage:
    """Client ``client`` is offline for rounds ``start..end`` (1-based,
    inclusive).  Overrides any participation draw for those rounds."""

    client: int
    start: int
    end: int

    def covers(self, t: int) -> bool:
        return self.start <= t <= self.end


@dataclass(frozen=True)
class Heterogeneity:
    """Per-client local-training schedules.

    ``local_steps[k]``: client k's local step count E_k (default: the
    config's ``local_steps``).  ``lr_scale[k]`` multiplies the config lr
    for client k.  ``lr_decay`` applies a global ``decay**(t-1)`` factor
    in round t.  A field left ``None`` falls back to the config value.
    """

    local_steps: Optional[Tuple[int, ...]] = None
    lr_scale: Optional[Tuple[float, ...]] = None
    lr_decay: float = 1.0

    def resolve(self, n_clients: int, base_lr: float,
                base_steps: int) -> Tuple[np.ndarray, np.ndarray, int]:
        """-> (lr_k (K,) float32, steps_k (K,) int32, max_steps)."""
        steps = (np.full(n_clients, base_steps, np.int32)
                 if self.local_steps is None
                 else np.asarray(self.local_steps, np.int32))
        scale = (np.ones(n_clients, np.float32)
                 if self.lr_scale is None
                 else np.asarray(self.lr_scale, np.float32))
        if steps.shape != (n_clients,) or scale.shape != (n_clients,):
            raise ValueError("heterogeneity schedules must have one entry "
                             f"per client ({n_clients})")
        return base_lr * scale, steps, int(steps.max())


@dataclass(frozen=True)
class Scenario:
    """Participation sampling composed with outage windows and per-client
    schedule heterogeneity.

    ``min_participants`` guards aggregation: if a round's draw comes up
    empty while some client is available, the lowest-indexed available
    clients are conscripted.  If every client is offline the round
    proceeds with zero participants.
    """

    participation: Participation = field(default_factory=Participation)
    outages: Tuple[Outage, ...] = ()
    heterogeneity: Optional[Heterogeneity] = None
    min_participants: int = 1

    @classmethod
    def from_participation_rate(cls, rate: float) -> "Scenario":
        """``FLConfig.participation`` semantics (Alg. 1)."""
        if rate >= 1.0:
            return cls(participation=full_participation())
        return cls(participation=fixed_fraction(rate))

    def offline_mask(self, t: int, n_clients: int) -> np.ndarray:
        off = np.zeros(n_clients, bool)
        for o in self.outages:
            if o.covers(t):
                off[o.client] = True
        return off

    def offline_masks(self, n_rounds: int, n_clients: int,
                      start: int = 1) -> np.ndarray:
        """``(T, K)`` stacked offline masks for rounds
        ``start..start+n_rounds-1`` (``(0, K)`` for a zero-round leg)."""
        if n_rounds == 0:
            return np.zeros((0, n_clients), bool)
        return np.stack([self.offline_mask(t, n_clients)
                         for t in range(start, start + n_rounds)])

    def participation_mask_device(self, key: torch.Tensor,
                                  offline: torch.Tensor) -> torch.Tensor:
        """The twin of :meth:`participation_mask` on the jax key stream
        (reference ``participation_mask_device``): ``key`` a ``(..., 2)``
        batch of round keys, ``offline`` their ``(..., K)`` bool offline
        masks (the async engine's blocked clients folded in) on the keys'
        device.  When the draw comes up short the lowest-indexed available
        clients are conscripted up to ``min_participants``."""
        mask = self.participation.sample_device(key, offline.shape[-1]) & ~offline
        deficit = (self.min_participants - mask.sum(-1, keepdim=True)).to(torch.int32)
        candidates = ~mask & ~offline
        # 1-based rank among candidates, int32 as the reference's (4 bytes a client)
        rank = torch.cumsum(candidates, dim=-1, dtype=torch.int32)
        return mask | (candidates & (rank <= deficit))

    def participation_mask(self, t: int, n_clients: int, rng: np.random.Generator,
                           blocked: Optional[np.ndarray] = None) -> np.ndarray:
        """Round ``t``'s participants.  ``blocked`` (``(K,)`` bool, the
        async engine's unreachable and in-flight clients) is folded in with
        the offline mask, as the reference's async engine folds it into
        ``participation_mask_device``: conscription picks only clients that
        are neither.  The sample is taken first and conscription draws
        nothing, so ``rng`` advances alike whatever is blocked."""
        mask = self.participation.sample(n_clients, rng)
        off = self.offline_mask(t, n_clients)
        if blocked is not None:
            off = off | np.asarray(blocked, bool)
        mask &= ~off
        if mask.sum() < self.min_participants:
            avail = np.nonzero(~off)[0]
            need = self.min_participants - int(mask.sum())
            for k in avail:
                if need <= 0:
                    break
                if not mask[k]:
                    mask[k] = True
                    need -= 1
        return mask
