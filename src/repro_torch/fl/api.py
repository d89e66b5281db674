"""Front door: run one FL method end-to-end (counterpart of
``repro.fl.api``; the host and device (``"scan"``) engines so far)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from repro_torch.fl.cohorts import CohortSpec
from repro_torch.fl.config import FLConfig
from repro_torch.fl.rounds import FederatedDistillation, History
from repro_torch.fl.scan_engine import ScannedFederatedDistillation
from repro_torch.fl.scenarios import Scenario
from repro_torch.fl.strategies import STRATEGIES

__all__ = ["run_method"]

_ENGINES = {"host": FederatedDistillation,
            "scan": ScannedFederatedDistillation}
_NOT_PORTED_ENGINES = ("shard", "active", "async")
_NOT_PORTED_METHODS = ("comet", "fedavg", "individual")


def run_method(
    method: str,
    cfg: FLConfig,
    *,
    cache_duration: int = 0,
    use_cache: Optional[bool] = None,
    rounds: Optional[int] = None,
    probabilistic_expiry: bool = False,
    scenario: Optional[Scenario] = None,
    track_local_caches: bool = False,
    engine: str = "host",
    rng_backend: Optional[str] = None,
    codec: Optional[str] = None,
    downlink_codec: Optional[str] = None,
    cohorts: Optional[Sequence[CohortSpec]] = None,
    fused_round: Optional[bool] = None,
    telemetry: Optional[bool] = None,
    traffic=None,
    device="cuda",
    **strategy_kw,
) -> History:
    """Run one FL method end-to-end and return its History.

    ``method`` in {scarlet, dsfl, cfd, mean, selective_fd}, each on
    ``engine="host"`` (the round loop of :mod:`repro_torch.fl.rounds`) or
    ``"scan"`` (the device-resident engine of
    :mod:`repro_torch.fl.scan_engine`, which takes ``fused_round``; only
    scarlet with a static beta has a fused path, as in the reference, and
    any other method raises ``ValueError`` under ``fused_round=True``).
    CFD's 1-bit uplink runs the quantize-dequantize kernel once a round.
    The keywords mean what they mean in ``repro.fl.run_method``.
    ``device`` is ``"cuda"`` by default and the run raises when there is
    no CUDA device; pass ``device="cpu"`` to run on the CPU.  Methods,
    engines and options of the reference that are not ported yet (comet,
    fedavg, individual) raise ``NotImplementedError``.
    """
    if engine in _NOT_PORTED_ENGINES:
        raise NotImplementedError(f"engine={engine!r} is not yet ported")
    if engine not in _ENGINES:
        raise ValueError(f"unknown engine: {engine!r}")
    if traffic is not None:
        raise ValueError("traffic models apply to engine='async' only")
    if method in _NOT_PORTED_METHODS:
        raise NotImplementedError(f"method {method!r} is not yet ported")
    if codec is not None:
        cfg = dataclasses.replace(cfg, uplink_codec=codec)
    if downlink_codec is not None:
        cfg = dataclasses.replace(cfg, downlink_codec=downlink_codec)
    if cohorts is not None:
        cfg = dataclasses.replace(cfg, cohorts=tuple(cohorts))
    if fused_round is not None:
        cfg = dataclasses.replace(cfg, fused_round=fused_round)
    if telemetry is not None:
        cfg = dataclasses.replace(cfg, telemetry=telemetry)
    strat = STRATEGIES[method](**strategy_kw)
    kw = dict(cache_duration=cache_duration,
              use_cache=use_cache,
              probabilistic_expiry=probabilistic_expiry,
              scenario=scenario,
              track_local_caches=track_local_caches,
              device=device)
    if rng_backend is not None:
        kw["rng_backend"] = rng_backend
    return _ENGINES[engine](cfg, strat, **kw).run(rounds)
