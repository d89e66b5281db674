"""Synchronized soft-label caching (SCARLET Alg. 1 + Alg. 2, Alg.-3 expiry).

Counterpart of ``repro.core.cache`` for the round engines: the server's
global cache over the public dataset as dense tensors indexed by public
sample id, the request list (miss mask), teacher assembly, the cache
update with its per-sample signals, and the catch-up packages sent to
clients that skipped rounds (as packages for the host loop, as a byte
count on the device for the device engine).  Nothing here that the
device engine calls waits for the card: no boolean-mask indexing, no
``nonzero``, no reads back to the host.  Expiry is checked at request
time (an index misses when absent or older than ``D``), as in the
reference; see its module docstring for why.

The functions are functional like the reference's: an update returns new
tensors and leaves its input untouched, so the round loop can still read
the pre-round cache for catch-up accounting after updating it.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

__all__ = ["NEWLY_CACHED", "CACHED", "EXPIRED", "CacheState", "init_cache",
           "normalize_cache_duration", "miss_mask", "cached_at",
           "signals_for_round", "assemble_teacher", "update_global_cache",
           "CatchUpPackage", "make_catch_up", "catch_up_bytes",
           "catch_up_bytes_device"]

NEWLY_CACHED = 0
CACHED = 1
EXPIRED = 2

_NEVER = -(2 ** 30)


class CacheState(NamedTuple):
    """Dense soft-label cache over the public dataset.

    values:  (|P|, N) float32 — cached soft-labels.
    ts:      (|P|,)   int32   — round at which the entry was cached.
    present: (|P|,)   bool    — whether the entry exists.
    """

    values: torch.Tensor
    ts: torch.Tensor
    present: torch.Tensor

    @property
    def size(self) -> int:
        return self.values.shape[0]

    @property
    def num_classes(self) -> int:
        return self.values.shape[1]


def init_cache(public_size: int, num_classes: int,
               device="cpu", dtype=torch.float32) -> CacheState:
    return CacheState(
        values=torch.zeros((public_size, num_classes), dtype=dtype, device=device),
        ts=torch.full((public_size,), _NEVER, dtype=torch.int32, device=device),
        present=torch.zeros((public_size,), dtype=torch.bool, device=device),
    )


def normalize_cache_duration(D) -> int:
    """Validate a cache duration at the config boundary: a non-negative
    integer (python/numpy int or integral float), returned as ``int``."""
    if isinstance(D, bool):
        raise TypeError("cache duration must be an integer, not a bool")
    if isinstance(D, (int, np.integer)):
        val = int(D)
    elif isinstance(D, float) and float(D).is_integer():
        val = int(D)
    else:
        raise TypeError(f"cache duration must be an integer, got {D!r}")
    if val < 0:
        raise ValueError(f"cache duration must be >= 0, got {val}")
    return val


def miss_mask(cache: CacheState, idx: torch.Tensor, t: int, D: int, *,
              probabilistic: bool = False) -> torch.Tensor:
    """True where a request must be issued (absent or expired); Alg. 3
    test.  ``D == 0`` disables caching (every sample misses).  ``D`` is
    a static python integer; probabilistic expiry is not ported yet."""
    if probabilistic:
        raise NotImplementedError("probabilistic expiry is not yet ported")
    D = normalize_cache_duration(D)
    if D == 0:
        return torch.ones(idx.shape, dtype=torch.bool, device=idx.device)
    present = cache.present[idx]
    age = t - cache.ts[idx]
    return ~(present & (age <= D))


def cached_at(cache: CacheState, idx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, present) at request positions: the shared prediction
    base both ends use for cache-delta uplink coding (stale values of
    EXPIRED entries included)."""
    return cache.values[idx], cache.present[idx]


def signals_for_round(cache: CacheState, idx: torch.Tensor,
                      miss: torch.Tensor) -> torch.Tensor:
    """Per-sample signal gamma^t (int32) for the selected indices."""
    present = cache.present[idx]
    sig = torch.where(present, EXPIRED, NEWLY_CACHED).to(torch.int32)
    return torch.where(miss, sig, torch.full_like(sig, CACHED))


def assemble_teacher(cache: CacheState, idx: torch.Tensor, fresh: torch.Tensor,
                     miss: torch.Tensor) -> torch.Tensor:
    """Teacher z-hat^t for ``idx``: ``fresh`` (laid out at the positions
    of ``idx``) where the sample missed, the cached value elsewhere."""
    return torch.where(miss[:, None], fresh, cache.values[idx])


def update_global_cache(cache: CacheState, idx: torch.Tensor,
                        teacher: torch.Tensor, miss: torch.Tensor,
                        t: int) -> Tuple[CacheState, torch.Tensor]:
    """UpdateGlobalCache (Alg. 2 with Alg.-3 expiry): store fresh entries
    for missed indices (``idx`` holds distinct ids); returns the new
    cache and the signals."""
    sig = signals_for_round(cache, idx, miss)
    values = cache.values.clone()
    values[idx] = torch.where(miss[:, None], teacher, cache.values[idx])
    ts = cache.ts.clone()
    ts[idx] = torch.where(miss, torch.full_like(ts[idx], t), cache.ts[idx])
    present = cache.present.clone()
    present[idx] = miss | cache.present[idx]
    return CacheState(values, ts, present), sig


# ---------------------------------------------------------------------------
# Partial participation: catch-up packages (Section III-D).
# ---------------------------------------------------------------------------

class CatchUpPackage(NamedTuple):
    """Differential cache sync for a client that skipped rounds: every
    global-cache entry newer than the client's last-synced round."""

    idx: torch.Tensor     # (M,) indices to overwrite
    values: torch.Tensor  # (M, N)
    ts: torch.Tensor      # (M,)


def make_catch_up(cache_g: CacheState, last_sync: int) -> CatchUpPackage:
    """Entries cached strictly after ``last_sync``."""
    newer = cache_g.present & (cache_g.ts > last_sync)
    idx = torch.nonzero(newer).flatten()
    return CatchUpPackage(idx=idx, values=cache_g.values[idx], ts=cache_g.ts[idx])


def catch_up_bytes(pkg: CatchUpPackage, bytes_per_value: float = 4.0) -> float:
    """Downlink cost of a catch-up package (values + indices + ts)."""
    m, n = pkg.values.shape
    return m * n * bytes_per_value + m * 4 + m * 4


def catch_up_bytes_device(cache_g: CacheState, last_sync: torch.Tensor,
                          part: torch.Tensor, t: int,
                          bytes_per_value: float = 4.0) -> torch.Tensor:
    """Total catch-up downlink bytes of round ``t``, as a 0-dim float32
    tensor on the cache's device: :func:`make_catch_up` +
    :func:`catch_up_bytes` summed over the returning stragglers (clients
    in ``part`` whose ``last_sync`` predates round ``t - 1``), without a
    host sync.  ``last_sync`` (int32) and ``part`` (bool) are ``(K,)``.

    It compares every client's sync point with every entry, a ``(K, |P|)``
    mask: the reference's ``"dense"`` method, the one its scan engine
    uses.  The ``"sorted"`` method, for the active engine's K, is not
    ported yet."""
    returning = part & (last_sync < t - 1)                              # (K,)
    newer = cache_g.present[None, :] & (cache_g.ts[None, :] > last_sync[:, None])
    counts = newer.sum(1).to(torch.float32)
    per_client = counts * (cache_g.num_classes * bytes_per_value + 8.0)
    return torch.where(returning, per_client, 0.0).sum()
