"""Compatibility facade (counterpart of ``repro.fl.engine``): every
public name of the port's ``fl`` package from one module, so code
written against ``repro.fl.engine`` (the benchmarks import ``run_method``
and ``FLConfig`` from it) finds the same names here.  The reference's
vmapped ``*_v`` primitives have no separate form in the port: each
primitive here takes one model or a stack of them."""
from __future__ import annotations

from repro_torch.fl.active_engine import ActiveSetFederatedDistillation
from repro_torch.fl.api import run_method
from repro_torch.fl.async_engine import AsyncFederatedDistillation
from repro_torch.fl.baselines import FedAvg, Individual
from repro_torch.fl.cohorts import ClientModels, CohortSpec, resolve_cohorts
from repro_torch.fl.config import FLConfig
from repro_torch.fl.rounds import (
    FederatedDistillation,
    History,
    _ce,
    _kl,
    _select,
    accuracy,
    distill,
    local_train,
    local_train_masked,
    predict_soft,
    val_loss_hard,
    val_loss_soft,
)
from repro_torch.fl.scan_engine import ScannedFederatedDistillation
from repro_torch.fl.shard_engine import ShardedFederatedDistillation
from repro_torch.fl.traffic import (
    ArrivalProcess,
    ChurnEvent,
    LatencyModel,
    TrafficModel,
)
from repro_torch.fl.scenarios import (
    Heterogeneity,
    Outage,
    Participation,
    Scenario,
    bernoulli_participation,
    fixed_fraction,
    full_participation,
)
from repro_torch.fl.strategies import (
    STRATEGIES,
    CFDStrategy,
    COMETStrategy,
    ERAStrategy,
    EnhancedERAStrategy,
    MeanStrategy,
    SelectiveFDStrategy,
    Strategy,
)

__all__ = [
    "FLConfig",
    "CohortSpec",
    "ClientModels",
    "resolve_cohorts",
    "History",
    "FederatedDistillation",
    "ScannedFederatedDistillation",
    "ShardedFederatedDistillation",
    "ActiveSetFederatedDistillation",
    "AsyncFederatedDistillation",
    "ArrivalProcess",
    "LatencyModel",
    "ChurnEvent",
    "TrafficModel",
    "FedAvg",
    "Individual",
    "run_method",
    "Strategy",
    "MeanStrategy",
    "ERAStrategy",
    "EnhancedERAStrategy",
    "CFDStrategy",
    "COMETStrategy",
    "SelectiveFDStrategy",
    "STRATEGIES",
    "Scenario",
    "Participation",
    "Outage",
    "Heterogeneity",
    "full_participation",
    "fixed_fraction",
    "bernoulli_participation",
    "local_train",
    "local_train_masked",
    "distill",
    "predict_soft",
    "val_loss_soft",
    "val_loss_hard",
    "accuracy",
    "_ce",
    "_kl",
    "_select",
]
