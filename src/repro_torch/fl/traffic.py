"""Traffic models: arrival processes, report latency and churn
(counterpart of ``repro.fl.traffic``; pure numpy, a copy of the
reference's draws).

:mod:`repro_torch.fl.scenarios` answers *who is willing* each round:
participation draws, outage windows, schedule heterogeneity.  This module
answers *when work happens*: whether a client is reachable inside a given
aggregation window (arrival process and membership churn), and how many
windows later its soft-label report lands (report latency).  It is the
input layer of the async engine (:mod:`repro_torch.fl.async_engine`): a
client dispatched in round ``t_d`` trains against the cache as of ``t_d``
and its report arrives, and is aggregated, at ``t_d + delay``.

Everything is drawn on the host into fixed-shape ``(T, K)`` numpy arrays
(:meth:`TrafficModel.compile`), as ``Scenario.offline_masks`` is: the
async engine plans a leg's dispatches and arrivals from them on the host
before any round runs.

Time model: one *round* is one aggregation window of ``window_ticks``
abstract ticks.  Arrival intensities are per tick; latencies are drawn in
ticks and floored to whole windows (``delay = ticks // window_ticks``).
Once ``window_ticks`` exceeds every possible latency, all delays are zero
("full windows") and the async engine's ledger equals the device
engine's bit for bit.

Determinism: all draws of round ``t`` come from
``np.random.default_rng([seed, TRAFFIC_SALT, t])``, keyed by the
*absolute* round, so chained ``run()`` legs and restored runs see the
traffic a single uninterrupted run sees; the arrays equal the reference's
bit for bit.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import NamedTuple, Optional, Tuple

import numpy as np

__all__ = [
    "ArrivalProcess",
    "LatencyModel",
    "ChurnEvent",
    "TrafficModel",
    "CompiledTraffic",
    "TRAFFIC_SALT",
]

# rng stream namespace: keeps traffic draws disjoint from the engine's
# [seed, 17]/[seed, 29] numpy streams for any seed
TRAFFIC_SALT = 911


@dataclass(frozen=True)
class ArrivalProcess:
    """Per-window client-availability process.

    kind:
      ``always``   every client is reachable every window (no RNG).
      ``poisson``  each client contacts the server as a Poisson process
                   of intensity ``rate`` per tick; it is available in a
                   window iff at least one contact lands inside it,
                   i.e. with probability ``1 - exp(-rate * window)``.
      ``diurnal``  Poisson with sinusoidally modulated intensity
                   ``rate * (1 + amplitude * sin(2*pi*t / period))`` —
                   day/night load, ``period`` in windows.
    """

    kind: str = "always"
    rate: float = 1.0
    period: int = 24
    amplitude: float = 0.5

    def window_probability(self, t: int, window_ticks: int) -> float:
        """P(client available in window ``t``)."""
        if self.kind == "always":
            return 1.0
        lam = self.rate
        if self.kind == "diurnal":
            lam *= 1.0 + self.amplitude * math.sin(2.0 * math.pi * t / self.period)
            lam = max(lam, 0.0)
        elif self.kind != "poisson":
            raise ValueError(f"unknown arrival kind: {self.kind!r}")
        return 1.0 - math.exp(-lam * window_ticks)

    def sample(self, t: int, n_clients: int, window_ticks: int,
               rng: np.random.Generator) -> np.ndarray:
        p = self.window_probability(t, window_ticks)
        if p >= 1.0:
            return np.ones(n_clients, bool)
        return rng.random(n_clients) < p


@dataclass(frozen=True)
class LatencyModel:
    """Dispatch-to-arrival report latency, in ticks.

    kind:
      ``zero``       every report lands inside its dispatch window.
      ``fixed``      exactly ``ticks`` every time.
      ``uniform``    integer ticks uniform on ``[lo, hi]``.
      ``geometric``  ``P(ticks = n) = p * (1-p)**n`` for ``n >= 0`` —
                     a heavy straggler tail (unbounded support).
    """

    kind: str = "zero"
    ticks: int = 0
    lo: int = 0
    hi: int = 0
    p: float = 0.5

    def sample_ticks(self, n_clients: int,
                     rng: np.random.Generator) -> np.ndarray:
        if self.kind == "zero":
            return np.zeros(n_clients, np.int64)
        if self.kind == "fixed":
            if self.ticks < 0:
                raise ValueError(f"latency must be >= 0, got {self.ticks}")
            return np.full(n_clients, int(self.ticks), np.int64)
        if self.kind == "uniform":
            if not 0 <= self.lo <= self.hi:
                raise ValueError(
                    f"need 0 <= lo <= hi, got [{self.lo}, {self.hi}]")
            return rng.integers(self.lo, self.hi + 1, n_clients)
        if self.kind == "geometric":
            # numpy's geometric counts trials (support >= 1); shift to
            # the "number of failures" convention with support >= 0
            return rng.geometric(self.p, n_clients).astype(np.int64) - 1
        raise ValueError(f"unknown latency kind: {self.kind!r}")

    @property
    def max_ticks(self) -> Optional[int]:
        """Largest possible latency, or ``None`` when unbounded."""
        return {"zero": 0, "fixed": int(self.ticks),
                "uniform": int(self.hi)}.get(self.kind)


@dataclass(frozen=True)
class ChurnEvent:
    """Client ``client`` is a population member for rounds
    ``join..leave`` (1-based, inclusive; ``leave=None`` means forever).

    A client with at least one event exists only inside its windows —
    join/leave churn, the complement of :class:`repro_torch.fl.scenarios.Outage`
    (which subtracts windows from an always-present client).  Clients
    with no events at all are members throughout.
    """

    client: int
    join: int = 1
    leave: Optional[int] = None

    def covers(self, t: int) -> bool:
        return self.join <= t and (self.leave is None or t <= self.leave)


class CompiledTraffic(NamedTuple):
    """Fixed-shape traffic of one batch of rounds.

    available: (T, K) bool  — client reachable in that window.
    delay:     (T, K) int32 — whole-window report delay if dispatched
                              in that window (drawn for every client;
                              the dispatch mask selects which are used).
    """

    available: np.ndarray
    delay: np.ndarray


@dataclass(frozen=True)
class TrafficModel:
    """Arrival process x latency x churn, compiled to ``(T, K)`` arrays.

    The default model (always available, zero latency, no churn,
    unit window) is the synchronous regime: the async engine under it
    draws and charges exactly what ``engine="scan"`` does.
    """

    arrivals: ArrivalProcess = field(default_factory=ArrivalProcess)
    latency: LatencyModel = field(default_factory=LatencyModel)
    churn: Tuple[ChurnEvent, ...] = ()
    window_ticks: int = 1
    seed: int = 0

    def __post_init__(self):
        if int(self.window_ticks) < 1:
            raise ValueError(
                f"window_ticks must be >= 1, got {self.window_ticks}")

    @property
    def is_synchronous(self) -> bool:
        """True when every report provably lands in its dispatch window
        (max latency fits the aggregation window): the regime where the
        async ledger equals ``engine="scan"``'s bit for bit."""
        mt = self.latency.max_ticks
        return mt is not None and mt // int(self.window_ticks) == 0

    def member_mask(self, t: int, n_clients: int) -> np.ndarray:
        """(K,) population membership at round ``t`` under churn."""
        has_event = np.zeros(n_clients, bool)
        member = np.zeros(n_clients, bool)
        for e in self.churn:
            has_event[e.client] = True
            if e.covers(t):
                member[e.client] = True
        return member | ~has_event

    def compile(self, n_rounds: int, n_clients: int,
                start: int = 1) -> CompiledTraffic:
        """``(T, K)`` availability + delay arrays for rounds
        ``start..start+n_rounds-1`` (``start > 1`` for chained or
        checkpoint-resumed runs — absolute-round keying makes the
        result a row slice of the full-run compile)."""
        available = np.zeros((n_rounds, n_clients), bool)
        delay = np.zeros((n_rounds, n_clients), np.int32)
        w = int(self.window_ticks)
        for i, t in enumerate(range(start, start + n_rounds)):
            rng = np.random.default_rng([int(self.seed), TRAFFIC_SALT, int(t)])
            arr = self.arrivals.sample(t, n_clients, w, rng)
            available[i] = arr & self.member_mask(t, n_clients)
            ticks = self.latency.sample_ticks(n_clients, rng)
            delay[i] = (ticks // w).astype(np.int32)
        return CompiledTraffic(available=available, delay=delay)
