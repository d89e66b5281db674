"""Async-engine contracts (counterpart of ``repro.analysis.async_checks``).

The async engine (:mod:`repro_torch.fl.async_engine`) adds flight
bookkeeping to the device round and an open extension point,
``Strategy.staleness_weight``, that experiments override to decay late
reports.  Two things must stay true, and no run checks either:

1. **Round safety**: the bookkeeping (the dispatch-updated sync points, the
   staleness weights through the hook, both sides' catch-up bytes, the
   dispatch-time request counts and the uplink mean:
   ``_flight_books`` and ``_uplink_books``) must not read the card on the
   host, copy to the host or draw from a host RNG.  One ``.item()`` in an
   overridden hook and every round waits for the card (on the card the sync
   guard raises there).  The traffic model is host numpy by design: the
   engine plans a leg's dispatches and arrivals before its rounds, so
   nothing of it may appear inside them.  The bookkeeping is traced on fake
   CUDA tensors (:func:`repro_torch.analysis.traceutil.trace`) at the
   engine's shapes; with telemetry on, the round's telemetry code too, with
   the arrival mask as the participants (the obs pass's trace).
2. **Hook reachability**: at ``staleness_decay != 1`` the hook must be
   called inside the traced bookkeeping; the engine skips it statically at
   unit decay, so a trace that never reaches it would prove any override
   safe.  The decayed variants put it on the path.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch.analysis.report import Finding
from repro_torch.analysis.traceutil import tensor_spec, trace

__all__ = ["ANALYSIS_VARIANTS", "analysis_config", "build_engine", "check_engine", "run"]

# (label, strategy, strategy kwargs, engine kwargs, uplink codec, telemetry),
# the reference's: the decayed hook on the path, the unit-decay skip, cache
# on and off, the delta+quant codec path and a telemetry-instrumented round
ANALYSIS_VARIANTS = (
    ("scarlet", "scarlet", {}, {"cache_duration": 2}, "identity", False),
    ("scarlet+decay", "scarlet", {"staleness_decay": 0.5},
     {"cache_duration": 2}, "identity", False),
    ("scarlet+cache_delta+quant8", "scarlet", {}, {"cache_duration": 2},
     "cache_delta+quant8", False),
    ("scarlet+decay+telemetry", "scarlet", {"staleness_decay": 0.5},
     {"cache_duration": 2}, "identity", True),
    ("dsfl", "dsfl", {}, {}, "identity", False),
)


def analysis_config(codec: str = "identity", telemetry: bool = False):
    """The reference's configuration for this pass: K = 4, m = 8 of
    |P| = 32, N = 4."""
    from repro_torch.fl.config import FLConfig

    return FLConfig(n_clients=4, rounds=2, public_size=32, public_per_round=8,
                    n_classes=4, dim=8, hidden=8, private_size=32,
                    local_steps=1, distill_steps=1, seed=0,
                    uplink_codec=codec, telemetry=telemetry)


def build_engine(strategy: str, strat_kw: dict, eng_kw: dict, codec: str,
                 telemetry: bool = False):
    """One variant's async engine on the CPU, under the reference's
    genuinely asynchronous traffic: Poisson arrivals, 0-2 windows of
    latency."""
    from repro_torch.fl.async_engine import AsyncFederatedDistillation
    from repro_torch.fl.strategies import STRATEGIES
    from repro_torch.fl.traffic import ArrivalProcess, LatencyModel, TrafficModel

    traffic = TrafficModel(arrivals=ArrivalProcess("poisson", rate=1.5),
                           latency=LatencyModel("uniform", lo=0, hi=2))
    return AsyncFederatedDistillation(
        analysis_config(codec, telemetry), STRATEGIES[strategy](**strat_kw),
        traffic=traffic, device="cpu", **eng_kw)


def _trace_books(eng):
    """Trace one round's bookkeeping (round 3: both sides' catch-up on the
    path) on fake CUDA tensors, counting the hook's calls."""
    from repro_torch.core.cache import CacheState

    c = eng.cfg
    K, n_pub, N = c.n_clients, c.public_size, c.n_classes
    calls: List[tuple] = []
    hook = eng.strategy.staleness_weight

    def counted(staleness):
        calls.append(tuple(staleness.shape))
        return hook(staleness)

    def books(values, ts, present, last_sync, flight_nreq, dispatch, arrive, n_req):
        b = eng._flight_books(CacheState(values, ts, present), last_sync, dispatch, arrive, 3)
        return b, eng._uplink_books(flight_nreq, dispatch, b["arrive_f"], n_req)

    own = vars(eng.strategy).get("staleness_weight")  # an instance override, if any
    eng.strategy.staleness_weight = counted
    try:
        tr = trace(books, tensor_spec((n_pub, N)), tensor_spec((n_pub,), torch.int32),
                   tensor_spec((n_pub,), torch.bool), tensor_spec((K,), torch.int32),
                   tensor_spec((K,)), tensor_spec((K,), torch.bool),
                   tensor_spec((K,), torch.bool), tensor_spec(()))
    finally:
        if own is None:
            del eng.strategy.staleness_weight
        else:
            eng.strategy.staleness_weight = own
    return tr, calls


def check_engine(subject: str, eng, plans: Optional[List] = None) -> List[Finding]:
    """Round safety of one async engine's bookkeeping (and, with telemetry
    on, its telemetry round code) on fake CUDA tensors; the hook reached
    when the decay is not 1."""
    from repro_torch.analysis import obs_checks

    tr, calls = _trace_books(eng)
    findings = [Finding("error", "async", subject, v) for v in tr.scan_safety_violations()]
    decayed = not eng._unit_staleness
    if decayed and not calls:
        findings.append(Finding(
            "error", "async", subject,
            "staleness_decay != 1 but the traced bookkeeping never called "
            "Strategy.staleness_weight: the hook is off the path and the trace "
            "proves nothing about it"))
    if eng._telemetry:
        findings.extend(f for f in obs_checks.check_round_body(subject + "/telemetry", eng,
                                                               plans)
                        if f.level != "ok")
    if not findings:
        hook = (f"staleness hook reached at {calls[0]}" if calls
                else "staleness hook statically skipped (unit decay)")
        findings.append(Finding(
            "ok", "async", subject,
            "async round bookkeeping is host-sync free (no host read, no copy to the "
            f"host, no host RNG){' with its telemetry' if eng._telemetry else ''}; "
            + hook))
    return findings


def run(plans: Optional[List] = None) -> List[Finding]:
    findings: List[Finding] = []
    for label, strategy, strat_kw, eng_kw, codec, tel in ANALYSIS_VARIANTS:
        eng = build_engine(strategy, strat_kw, eng_kw, codec, telemetry=tel)
        findings.extend(check_engine(f"async[{label}]", eng, plans))
    return findings
