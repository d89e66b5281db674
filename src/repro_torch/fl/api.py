"""Front door: run one FL method end-to-end (counterpart of
``repro.fl.api``; the host, device (``"scan"``), active-set
(``"active"``), async (``"async"``) and client-sharded (``"shard"``)
engines)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch.distributed as dist

from repro_torch.fl.active_engine import ActiveSetFederatedDistillation
from repro_torch.fl.async_engine import AsyncFederatedDistillation
from repro_torch.fl.baselines import FedAvg, Individual
from repro_torch.fl.cohorts import CohortSpec
from repro_torch.fl.config import FLConfig
from repro_torch.fl.rounds import FederatedDistillation, History
from repro_torch.fl.scan_engine import ScannedFederatedDistillation
from repro_torch.fl.scenarios import Scenario
from repro_torch.fl.shard_engine import ShardedFederatedDistillation
from repro_torch.fl.strategies import STRATEGIES
from repro_torch.kernels.runtime import resolve_device
from repro_torch.launch.mesh import world_of_one

__all__ = ["run_method"]

_ENGINES = {"host": FederatedDistillation,
            "scan": ScannedFederatedDistillation,
            "active": ActiveSetFederatedDistillation,
            "async": AsyncFederatedDistillation,
            "shard": ShardedFederatedDistillation}


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

    ``method`` in {scarlet, dsfl, cfd, comet, selective_fd, mean, fedavg,
    individual}.  The distillation methods run on ``engine="host"`` (the
    round loop of :mod:`repro_torch.fl.rounds`), ``"scan"`` (the
    device-resident engine of :mod:`repro_torch.fl.scan_engine`, which
    takes ``fused_round``; only scarlet with a static beta has a fused
    path, as in the reference, and any other method raises ``ValueError``
    under ``fused_round=True``) or ``"active"`` (the active-set engine of
    :mod:`repro_torch.fl.active_engine`: the device engine's round body on
    the gathered participants, the clients' state in a host store, here on
    its default RAM backing, as in the reference; it takes the device
    engine's methods and options) or ``"async"`` (the async engine of
    :mod:`repro_torch.fl.async_engine`: dispatch now, aggregate the
    reports that arrive, under ``traffic``, a
    :class:`repro_torch.fl.traffic.TrafficModel`, default the synchronous
    model; ``staleness_decay`` goes to the strategy; the device engine's
    methods and options) or ``"shard"`` (the client-sharded engine of
    :mod:`repro_torch.fl.shard_engine`: the clients split over the ranks
    of a ``torch.distributed`` process group along ``cfg.mesh_spec``'s
    "data" axis; the device engine's methods and options; in a process
    with no initialised group it starts a world of one, NCCL on a CUDA
    device and gloo on the CPU, and tears it down after the run).
    ``traffic`` applies to ``engine="async"`` only
    and raises ``ValueError`` elsewhere.  comet (host numpy k-means, per-client
    teachers) runs on the host loop only and raises ``ValueError`` on the
    device, active and async engines, as in the reference.  The baselines fedavg
    and individual (:mod:`repro_torch.fl.baselines`) run on the host and
    refuse every option that does not apply to them with the reference's
    ``ValueError``.  The keywords mean what they mean in
    ``repro.fl.run_method``: ``scenario`` (participation, outages and a
    per-client ``Heterogeneity``), ``probabilistic_expiry`` (every
    engine) and ``track_local_caches`` (host loop; the device and active
    engines refuse it with the reference's ``ValueError``) go through to
    the engine.  ``telemetry=True`` fills ``History.telemetry`` (one
    :class:`repro_torch.obs.device.RoundTelemetry` row a round) on every
    engine for the distillation methods; the baselines refuse it with
    the reference's ``ValueError``.  ``device`` is ``"cuda"`` by default
    and the run raises when there is no CUDA device; pass ``device="cpu"``
    to run on the CPU.  ``rng_backend`` picks the draws' stream, with the
    reference's defaults: ``"numpy"`` on the host loop, ``"jax"`` (the
    reference's key stream, :mod:`repro_torch.core.prng`) on every device
    engine; either stream runs on every engine (the reference's device
    engines refuse ``"numpy"``); the baselines refuse the knob with the
    reference's ``ValueError``.
    """
    if engine not in _ENGINES:
        raise ValueError(f"unknown engine: {engine!r}")
    if traffic is not None and engine != "async":
        raise ValueError("traffic models apply to engine='async' only "
                         "(the synchronous engines have no dispatch/"
                         "arrival split)")
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
    if method in ("fedavg", "individual"):
        if cfg.cohorts:
            raise ValueError(
                f"{method} assumes the homogeneous (hidden, mlp_depth) "
                "model; client-model cohorts only apply to "
                "distillation-based methods")
        if engine != "host":
            raise ValueError(f"{method} is a baseline with no scanned/sharded "
                             "path; use engine='host'")
        if rng_backend is not None:
            raise ValueError(f"{method} has no rng_backend knob (baselines "
                             "draw nothing from the round key stream)")
        if cfg.uplink_codec != "identity" or cfg.downlink_codec != "identity":
            raise ValueError(f"{method} exchanges parameters, not "
                             "soft-labels; codecs do not apply")
        if cfg.telemetry:
            raise ValueError(f"{method} has no distillation round to "
                             "instrument; telemetry applies to "
                             "distillation-based methods only")
        cls = FedAvg if method == "fedavg" else Individual
        return cls(cfg, device=device).run(rounds)
    strat = STRATEGIES[method](**strategy_kw)
    kw = dict(cache_duration=cache_duration,
              use_cache=use_cache,
              probabilistic_expiry=probabilistic_expiry,
              scenario=scenario,
              track_local_caches=track_local_caches,
              device=device)
    if rng_backend is not None:
        kw["rng_backend"] = rng_backend
    if traffic is not None:
        kw["traffic"] = traffic
    if engine == "shard" and not dist.is_initialized():
        backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
        with world_of_one(backend):
            return _ENGINES[engine](cfg, strat, **kw).run(rounds)
    return _ENGINES[engine](cfg, strat, **kw).run(rounds)
