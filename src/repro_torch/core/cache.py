"""Synchronized soft-label caching (SCARLET Alg. 1 + Alg. 2, Alg.-3 expiry).

Counterpart of ``repro.core.cache`` for the round engines: the server's
global cache over the public dataset as dense tensors indexed by public
sample id, the request list (miss mask), teacher assembly, the cache
update with its per-sample signals, and the catch-up packages sent to
clients that skipped rounds (as packages for the host loop, as a byte
count on the device for the device engine), and the clients' mirrored
local caches (Alg. 2's UpdateLocalCache, the host loop's
``track_local_caches`` mode).  Nothing here that the device engine calls
waits for the card: no boolean-mask indexing, no ``nonzero``, no reads
back to the host.  Expiry is checked at request time (an index misses
when absent or older than ``D``, or, probabilistically, with hazard
``(age - 1) / D``), as in the reference; see its module docstring for
why.

The functions are functional like the reference's: an update returns new
tensors and leaves its input untouched, so the round loop can still read
the pre-round cache for catch-up accounting after updating it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.kernels.runtime import divide

__all__ = ["NEWLY_CACHED", "CACHED", "EXPIRED", "CacheState", "init_cache",
           "normalize_cache_duration", "miss_mask", "request_list", "cached_at",
           "signals_for_round", "assemble_teacher", "update_global_cache",
           "update_local_cache", "pack_queue", "unpack_queue",
           "CatchUpPackage", "make_catch_up", "apply_catch_up",
           "catch_up_bytes", "catch_up_bytes_device", "catch_up_bytes_async"]

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
              probabilistic: bool = False, key: Optional[torch.Tensor] = None,
              u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """True where a request must be issued (absent or expired); Alg. 3
    test.  ``D == 0`` disables caching (every sample misses).  ``D`` is
    a static python integer.

    ``probabilistic=True`` is the paper's stochastic expiry (reference
    ``miss_mask``): a present entry expires where ``u < hazard``, with
    ``hazard = clip((age - 1) / D, 0, 1)`` in float32 and ``u`` the
    round's uniforms, ``uniform(key, idx.shape)`` of the reference's key
    stream (:mod:`repro_torch.core.prng`; the engines' key is
    ``fold_in(key(seed), t)``), or given as ``u`` (shape ``idx.shape``, on
    ``idx``'s device; the device engines draw a leg's rows at once).  The
    division is an IEEE division on every device (``runtime.divide``): a
    hazard one ulp off flips ``u < hazard`` on a tie."""
    D = normalize_cache_duration(D)
    if D == 0:
        return torch.ones(idx.shape, dtype=torch.bool, device=idx.device)
    present = cache.present[idx]
    age = t - cache.ts[idx]
    if probabilistic:
        if u is None:
            if key is None:
                raise ValueError("probabilistic expiry needs a PRNG key or the uniforms u")
            u = prng.uniform(key, tuple(idx.shape))
        hazard = torch.clamp(divide(age.to(torch.float32) - 1.0, D), 0.0, 1.0)
        return ~(present & ~(u < hazard))
    return ~(present & (age <= D))


def request_list(cache: CacheState, idx: torch.Tensor, t: int,
                 D: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(miss_mask, I_req) for round t (Alg. 3's request list): the mask of
    :func:`miss_mask` and ``I_req = idx[miss]``, the requested sample ids
    in ``idx``'s order.  ``I_req``'s length depends on the data (a host
    sync on the card): the engines consume the mask."""
    m = miss_mask(cache, idx, t, D)
    return m, idx[m]


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


def update_local_cache(cache_k: CacheState, idx: torch.Tensor,
                       signals: torch.Tensor, z_req_dense: torch.Tensor,
                       t: int) -> Tuple[CacheState, torch.Tensor]:
    """UpdateLocalCache (Alg. 2): a client rebuilds the teacher from the
    signals, its local cache and the broadcast queue (``z_req_dense``:
    ``(len(idx), N)``, fresh labels at miss positions; see
    :func:`pack_queue` / :func:`unpack_queue` for the wire form) and
    syncs its cache.  Returns (new cache, teacher)."""
    is_miss = signals != CACHED
    teacher = torch.where(is_miss[:, None], z_req_dense, cache_k.values[idx])
    values = cache_k.values.clone()
    values[idx] = teacher
    ts = cache_k.ts.clone()
    ts[idx] = torch.where(is_miss, torch.full_like(ts[idx], t), cache_k.ts[idx])
    present = cache_k.present.clone()
    present[idx] = True
    return CacheState(values, ts, present), teacher


def pack_queue(z_dense: torch.Tensor, miss: torch.Tensor) -> torch.Tensor:
    """Wire form: the FIFO queue transmitted, fresh labels at miss
    positions in idx order (a dynamic size; host loop only)."""
    return z_dense[miss]


def unpack_queue(queue: torch.Tensor, miss: torch.Tensor,
                 num_classes: int) -> torch.Tensor:
    """Inverse of :func:`pack_queue`: the queue scattered back to a dense
    ``(len(idx), N)`` tensor, zeros at cached positions."""
    n = miss.shape[0]
    if queue.shape[0] == 0:
        return torch.zeros((n, num_classes), dtype=queue.dtype, device=queue.device)
    pos = torch.clamp(torch.cumsum(miss.to(torch.int64), 0) - 1, 0, queue.shape[0] - 1)
    return torch.where(miss[:, None], queue[pos], 0.0)


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


def apply_catch_up(cache_k: CacheState, pkg: CatchUpPackage) -> CacheState:
    """A returning client's local cache with ``pkg`` applied."""
    values, ts, present = (a.clone() for a in cache_k)
    values[pkg.idx] = pkg.values
    ts[pkg.idx] = pkg.ts
    present[pkg.idx] = True
    return CacheState(values, ts, present)


def catch_up_bytes(pkg: CatchUpPackage, bytes_per_value: float = 4.0) -> float:
    """Downlink cost of a catch-up package (values + indices + ts)."""
    m, n = pkg.values.shape
    return m * n * bytes_per_value + m * 4 + m * 4


def catch_up_bytes_device(cache_g: CacheState, last_sync: torch.Tensor,
                          part: torch.Tensor, t: int,
                          bytes_per_value: float = 4.0, *,
                          method: str = "dense") -> torch.Tensor:
    """Total catch-up downlink bytes of round ``t``, as a 0-dim float32
    tensor on the cache's device: :func:`make_catch_up` +
    :func:`catch_up_bytes` summed over the returning stragglers (clients
    in ``part`` whose ``last_sync`` predates round ``t - 1``), without a
    host sync.  ``last_sync`` (int32) and ``part`` (bool) are ``(K,)``.

    ``method`` selects how each client's count of newer entries is taken;
    both give the same exact small-integer counts, times the same
    constant, summed over the same ``(K,)`` vector, so their totals are
    equal bit for bit:

    - ``"dense"`` (the device engine's) compares every client's sync point
      with every entry, a ``(K, |P|)`` mask;
    - ``"sorted"`` (the active engine's, where K may be 10^6) sorts the
      ``|P|`` timestamps once, absent entries sunk to ``_NEVER - 1``, below
      any ``last_sync`` a client can hold, and counts by
      ``torch.searchsorted``: O(K + |P|) memory.  ``last_sync`` is taken
      in the timestamps' dtype (int32)."""
    returning = part & (last_sync < t - 1)                              # (K,)
    if method == "dense":
        newer = cache_g.present[None, :] & (cache_g.ts[None, :] > last_sync[:, None])
        counts = newer.sum(1).to(torch.float32)
    elif method == "sorted":
        ts_eff = torch.where(cache_g.present, cache_g.ts,
                             torch.full_like(cache_g.ts, _NEVER - 1))
        ts_sorted = torch.sort(ts_eff).values                           # (|P|,)
        pos = torch.searchsorted(ts_sorted, last_sync.to(ts_sorted.dtype),
                                 right=True, out_int32=True)            # (K,)
        counts = (ts_sorted.shape[0] - pos).to(torch.float32)
    else:
        raise ValueError(f"unknown catch-up method {method!r}")
    per_client = counts * (cache_g.num_classes * bytes_per_value + 8.0)
    return torch.where(returning, per_client, 0.0).sum()


def catch_up_bytes_async(cache_g: CacheState, last_sync: torch.Tensor,
                         dispatch: torch.Tensor, arrive: torch.Tensor, t: int,
                         bytes_per_value: float = 4.0, *,
                         method: str = "dense") -> Tuple[torch.Tensor, torch.Tensor]:
    """Catch-up bytes of an async round (reference ``catch_up_bytes_async``):
    ``(total, dispatch_bytes)``, 0-dim float32 tensors, each side charged
    against the cache the bytes flow from.

    - dispatch side: every dispatched client whose ``last_sync`` predates
      ``t - 1`` gets the usual package, :func:`catch_up_bytes_device` over
      ``dispatch``; the dispatch then marks it synced through ``t - 1``;
    - arrival side: a report landing in round ``t`` after ``d`` rounds in
      flight is sent the entries cached since its dispatch (``ts > t_d -
      1``), counted with the dispatch-updated sync points over ``arrive``.
      A zero-delay arrival has sync point ``t - 1`` and is charged nothing.

    When every delay is zero, ``arrive`` equals ``dispatch``, every
    arrival-side term is an exact 0.0 and ``total`` is bit for bit
    ``catch_up_bytes_device(cache_g, last_sync, dispatch, t)``.  ``method``
    as there ("sorted" takes ``last_sync`` in the timestamps' dtype)."""
    disp = catch_up_bytes_device(cache_g, last_sync, dispatch, t, bytes_per_value,
                                 method=method)
    ls_mid = torch.where(dispatch, t - 1, last_sync)
    arr = catch_up_bytes_device(cache_g, ls_mid, arrive, t, bytes_per_value,
                                method=method)
    return disp + arr, disp
