"""Device-plane telemetry: the ``RoundTelemetry`` row and its math
(counterpart of ``repro.obs.device``).

The device engine's rounds never wait for the card: nothing crosses back
to the host until the leg's one read-back at its end.  Telemetry
therefore cannot be a Python-side logger: every counter and gauge here is
a fixed-shape tensor computed *inside* the round body from tensors the
round already holds, kept with the round's other results, and summed into
running totals in the engine state.  No host read, no dynamic shape: the
static analyzer (``repro_torch.analysis``) traces the instrumented round
code on fake CUDA tensors and flags any host read or copy.

Parity contract: every integer counter is computed from the full-width
inputs (the round's participation draw, the pre-update cache presence
and miss masks, ``last_sync``) with the same expression on both engines,
so host-loop and device-engine counter stacks are equal, and equal to the
reference's.  Float gauges that average over participants reduce in
another order on each engine and are held allclose, not equal.

The reference's ``axis_name`` arguments (a ``psum`` over the client mesh
axis) belong to its sharded engine, which the port has not yet; they are
left out here.

Every helper takes tensors on any device.  ``t`` is a host int (the
engines pass it so) and enters only through tensor arithmetic; a count
given as a Python number becomes a device fill, never a copy.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import era as era_lib

__all__ = [
    "STALENESS_BUCKETS",
    "RoundTelemetry",
    "EXACT_FIELDS",
    "GAUGE_FIELDS",
    "TelemetryLog",
    "zeros",
    "gate",
    "accumulate",
    "participants_per_cohort",
    "cache_signal_counts",
    "returning_client_count",
    "staleness_histogram",
    "participant_mean",
    "mean_entropy",
    "codec_error_mean",
    "as_f32",
]

# staleness histogram width: bucket b counts participants whose last
# participation was b rounds before the previous round (b = t-1 -
# last_sync, clipped into the top bucket).  Fixed so the row's shape is
# static.
STALENESS_BUCKETS = 8

_I32, _F32 = torch.int32, torch.float32


class RoundTelemetry(NamedTuple):
    """One round's device-resident metrics (13 tensors).

    Integer counters (int32, equal across engines):

    - ``participants``: (n_cohorts,) participating clients per cohort;
    - ``cache_hits`` / ``cache_miss_new`` / ``cache_expired``: the
      Alg. 3 signal census over the round's public subset P^t —
      CACHED / NEWLY_CACHED / EXPIRED counts (hits + new + expired
      == |P^t| on active rounds; cache-off runs count every request
      as new);
    - ``catch_up_clients``: returning stragglers (participating with
      ``last_sync < t-1``) served a catch-up package this round;
    - ``staleness_hist``: (STALENESS_BUCKETS,) histogram of
      ``t - 1 - last_sync`` over participants (bucket 0 = was present
      last round; top bucket clips).

    Byte counters (float32, still equal: every input is an exact small
    integer, so float32 and float64 arithmetic agree):

    - ``uplink_bytes`` / ``downlink_bytes``: the ledger's per-round
      payloads; ``catch_up_bytes``: the catch-up share of downlink.

    Float gauges (float32, allclose across engines):

    - ``teacher_entropy_pre``: mean Shannon entropy (nats) of the
      participant-mean soft labels as the server sees them (post
      uplink codec), BEFORE strategy sharpening/aggregation;
    - ``teacher_entropy_post``: mean entropy of the aggregated teacher
      after sharpening and the downlink codec;
    - ``beta``: the resolved sharpening knob
      (:meth:`repro_torch.fl.strategies.base.Strategy.sharpen_gauge`);
    - ``codec_quant_error``: mean |decode(encode(z)) - z| over
      participating clients' uplink entries (0 for identity codecs).
    """

    participants: torch.Tensor
    cache_hits: torch.Tensor
    cache_miss_new: torch.Tensor
    cache_expired: torch.Tensor
    catch_up_clients: torch.Tensor
    staleness_hist: torch.Tensor
    uplink_bytes: torch.Tensor
    downlink_bytes: torch.Tensor
    catch_up_bytes: torch.Tensor
    teacher_entropy_pre: torch.Tensor
    teacher_entropy_post: torch.Tensor
    beta: torch.Tensor
    codec_quant_error: torch.Tensor


# field partition: EXACT fields must be equal across engines (and to the
# reference's); GAUGE fields are allclose only.
EXACT_FIELDS = ("participants", "cache_hits", "cache_miss_new",
                "cache_expired", "catch_up_clients", "staleness_hist",
                "uplink_bytes", "downlink_bytes", "catch_up_bytes")
GAUGE_FIELDS = ("teacher_entropy_pre", "teacher_entropy_post", "beta",
                "codec_quant_error")


def zeros(n_cohorts: int, device="cpu") -> RoundTelemetry:
    """The all-zero telemetry row (outage rounds, initial totals)."""
    def i0(*shape):
        return torch.zeros(shape, dtype=_I32, device=device)

    def f0():
        return torch.zeros((), dtype=_F32, device=device)

    return RoundTelemetry(
        participants=i0(n_cohorts),
        cache_hits=i0(), cache_miss_new=i0(), cache_expired=i0(),
        catch_up_clients=i0(),
        staleness_hist=i0(STALENESS_BUCKETS),
        uplink_bytes=f0(), downlink_bytes=f0(), catch_up_bytes=f0(),
        teacher_entropy_pre=f0(), teacher_entropy_post=f0(), beta=f0(),
        codec_quant_error=f0())


def gate(tel: RoundTelemetry, keep: torch.Tensor) -> RoundTelemetry:
    """Zero the whole row unless ``keep`` (a 0-d bool tensor): total-outage
    rounds must match the host loop's early return, which records the
    zero row."""
    return RoundTelemetry(*(torch.where(keep, a, torch.zeros_like(a)) for a in tel))


def accumulate(total: RoundTelemetry, tel: RoundTelemetry) -> RoundTelemetry:
    """Running totals (element-wise sum)."""
    return RoundTelemetry(*(a + b for a, b in zip(total, tel)))


def as_f32(x, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a float32 tensor on ``like``'s device: a tensor is cast, a
    Python number filled in (a fill, never a host-to-device copy)."""
    if isinstance(x, torch.Tensor):
        return x.to(_F32)
    return torch.full((), float(x), dtype=_F32, device=like.device)


# ---------------------------------------------------------------------------
# counter math (full-width inputs -> equal everywhere)
# ---------------------------------------------------------------------------

def participants_per_cohort(part: torch.Tensor, offsets: Sequence[int],
                            sizes: Sequence[int]) -> torch.Tensor:
    """(n_cohorts,) int32 participant counts from the full-width mask;
    ``offsets``/``sizes`` are the static cohort blocks
    (:class:`repro_torch.fl.cohorts.ClientModels`)."""
    p = part.to(_I32)
    return torch.stack([p[off:off + n].sum(dtype=_I32)
                        for off, n in zip(offsets, sizes)])


def cache_signal_counts(present: torch.Tensor, miss: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(hits, newly_cached, expired) int32 over the round's request list.

    Mirrors :func:`repro_torch.core.cache.signals_for_round`: a non-miss
    is a CACHED hit; a miss splits into EXPIRED (was present) vs
    NEWLY_CACHED (never cached).  ``present``/``miss`` are the
    *pre-update* masks every engine already computes (``cached_at`` /
    ``miss_mask``).  Cache-off runs (all-miss, none present) count every
    request as newly cached.
    """
    p, m = present.to(_I32), miss.to(_I32)
    return ((1 - m).sum(dtype=_I32), (m * (1 - p)).sum(dtype=_I32),
            (m * p).sum(dtype=_I32))


def returning_client_count(part: torch.Tensor, last_sync: torch.Tensor,
                           t: int) -> torch.Tensor:
    """Participants whose last participation predates round ``t - 1``:
    exactly the clients :func:`repro_torch.core.cache.catch_up_bytes_device`
    bills a catch-up package for.  Must see the PRE-update
    ``last_sync``."""
    back = part.to(torch.bool) & (last_sync.to(_I32) < t - 1)
    return back.sum(dtype=_I32)


def staleness_histogram(part: torch.Tensor, last_sync: torch.Tensor, t: int,
                        n_buckets: int = STALENESS_BUCKETS) -> torch.Tensor:
    """(n_buckets,) int32 histogram of ``t - 1 - last_sync`` over this
    round's participants (pre-update ``last_sync``; top bucket clips).
    Bucket 0 therefore counts clients that were present last round.  A
    comparison with ``arange(n_buckets)``, masked and summed: the output
    size never depends on the data."""
    stale = torch.clamp(t - 1 - last_sync.to(_I32), 0, n_buckets - 1)
    one_hot = stale[:, None] == torch.arange(n_buckets, dtype=_I32,
                                             device=stale.device)[None, :]
    return (one_hot & part.to(torch.bool)[:, None]).sum(dim=0, dtype=_I32)


# ---------------------------------------------------------------------------
# gauge math (participant reductions)
# ---------------------------------------------------------------------------

def participant_mean(z: torch.Tensor, part_f: torch.Tensor, n_part) -> torch.Tensor:
    """Mean of ``z`` (clients, ...) over participating clients; ``n_part``
    (a tensor or a number) is the participant count.  The division is by
    a float32 tensor on ``z``'s device, a true division on every
    device."""
    zs = torch.tensordot(part_f.to(_F32), z.to(_F32), dims=([0], [0]))
    return zs / torch.clamp_min(as_f32(n_part, zs), 1.0)


def mean_entropy(p: torch.Tensor) -> torch.Tensor:
    """Mean Shannon entropy (nats) over a (..., n_classes) batch of soft
    labels: the ERA pre/post sharpening gauge."""
    return torch.mean(era_lib.entropy(p.to(_F32)))


def codec_error_mean(z_post: torch.Tensor, z_pre: torch.Tensor,
                     part_f: torch.Tensor, n_part) -> torch.Tensor:
    """Mean absolute uplink quantization error |decoded - transmitted| over
    participating clients' entries (0 for identity codecs).  The entries a
    client sends, ``prod(shape[1:])``, are a host count multiplied into
    the participant count on the device, as in the reference; the
    division is then by a tensor, so no ``tensor / number`` (which the
    card computes as a multiply by the reciprocal) enters."""
    z_post, z_pre = z_post.to(_F32), z_pre.to(_F32)
    w = part_f.to(_F32).reshape((-1,) + (1,) * (z_post.dim() - 1))
    err = torch.sum(torch.abs(z_post - z_pre) * w)
    m = float(np.prod(z_post.shape[1:]))
    return err / torch.clamp_min(as_f32(n_part, err) * m, 1.0)


# ---------------------------------------------------------------------------
# host-side container
# ---------------------------------------------------------------------------

def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


class TelemetryLog:
    """Host-side per-round telemetry record (numpy).

    The host loop ``append``s one :class:`RoundTelemetry` per round; the
    device engine builds one from the leg's stacked rows with
    :meth:`from_stacked`.  Either way the log exposes the same
    ``stacks()`` / ``summary()`` / ``as_dict()`` views as the
    reference's, dtype for dtype.
    """

    def __init__(self, rounds: Optional[Iterable[RoundTelemetry]] = None):
        self._rounds: List[RoundTelemetry] = []
        for r in (rounds or []):
            self.append(r)

    def append(self, tel: RoundTelemetry) -> None:
        self._rounds.append(RoundTelemetry(*[_host(leaf) for leaf in tel]))

    @classmethod
    def from_stacked(cls, stacked: RoundTelemetry) -> "TelemetryLog":
        """Rebuild from stacked leaves (leading round axis)."""
        leaves = [_host(leaf) for leaf in stacked]
        n = leaves[0].shape[0]
        return cls(RoundTelemetry(*[leaf[i] for leaf in leaves])
                   for i in range(n))

    def __len__(self) -> int:
        return len(self._rounds)

    def stacks(self) -> Dict[str, np.ndarray]:
        """field -> (T, ...) numpy stack, one row per round."""
        return {f: np.stack([np.asarray(getattr(r, f))
                             for r in self._rounds])
                for f in RoundTelemetry._fields}

    def totals(self) -> RoundTelemetry:
        acc = [np.zeros_like(np.asarray(leaf)) for leaf in self._rounds[0]]
        for r in self._rounds:
            acc = [a + np.asarray(leaf) for a, leaf in zip(acc, r)]
        return RoundTelemetry(*acc)

    def summary(self) -> Dict[str, Any]:
        """Scalar digest for reports and run records."""
        if not self._rounds:
            return {"rounds": 0}
        s = self.stacks()
        active = s["participants"].sum(axis=1) > 0
        n_active = int(active.sum())
        requests = int(s["cache_hits"].sum() + s["cache_miss_new"].sum()
                       + s["cache_expired"].sum())

        def _mean_active(field):
            return float(s[field][active].mean()) if n_active else 0.0

        return {
            "rounds": len(self._rounds),
            "active_rounds": n_active,
            "participants_total": int(s["participants"].sum()),
            "cache_hits": int(s["cache_hits"].sum()),
            "cache_miss_new": int(s["cache_miss_new"].sum()),
            "cache_expired": int(s["cache_expired"].sum()),
            "cache_hit_rate": (float(s["cache_hits"].sum()) / requests
                               if requests else 0.0),
            "catch_up_clients": int(s["catch_up_clients"].sum()),
            "catch_up_bytes": float(s["catch_up_bytes"].sum()),
            "uplink_bytes": float(s["uplink_bytes"].sum()),
            "downlink_bytes": float(s["downlink_bytes"].sum()),
            "staleness_hist": [int(x) for x in
                               s["staleness_hist"].sum(axis=0)],
            "teacher_entropy_pre_mean": _mean_active("teacher_entropy_pre"),
            "teacher_entropy_post_mean": _mean_active("teacher_entropy_post"),
            "beta_mean": _mean_active("beta"),
            "beta_last": (float(s["beta"][active][-1]) if n_active else 0.0),
            "codec_quant_error_mean": _mean_active("codec_quant_error"),
        }

    def as_dict(self) -> Dict[str, Any]:
        """JSON-ready record (run records)."""
        return {
            "schema": 1,
            "rounds": len(self._rounds),
            "summary": self.summary(),
            "per_round": {f: np.asarray(v).tolist()
                          for f, v in self.stacks().items()},
        }
