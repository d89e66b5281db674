"""Federated distillation on PyTorch: the host round loop, the
device-resident engine, strategies, the FedAvg and Individual baselines
and scenarios (the ported part of ``repro.fl``)."""
from repro_torch.fl.api import run_method  # noqa: F401
from repro_torch.fl.baselines import FedAvg, Individual  # noqa: F401
from repro_torch.fl.cohorts import ClientModels, CohortSpec, resolve_cohorts  # noqa: F401
from repro_torch.fl.config import FLConfig  # noqa: F401
from repro_torch.fl.convert import params_from_numpy  # noqa: F401
from repro_torch.fl.rounds import FederatedDistillation, History  # noqa: F401
from repro_torch.fl.scan_engine import ScannedFederatedDistillation  # noqa: F401
from repro_torch.fl.scenarios import (  # noqa: F401
    Outage,
    Participation,
    Scenario,
    bernoulli_participation,
    fixed_fraction,
    full_participation,
)
from repro_torch.fl.strategies import STRATEGIES, COMETStrategy, Strategy  # noqa: F401
