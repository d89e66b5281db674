"""Run configuration for the federated-distillation engines: the fields and
defaults of ``repro.fl.config.FLConfig``, so a reference config carries
over field for field.  ``fused_round`` selects the one-kernel round of
the device engines (``engine="scan"|"active"|"async"|"shard"``); the host
loop ignores it, as the reference's host loop does.  ``mesh_spec`` is the
client-sharded engine's mesh over the ranks of its process group
(``"auto"``, ``"DATA"``, ``"DATAxMODEL"``, ``"production"``,
``"production_multipod"``; :func:`repro_torch.fl.shard_engine.resolve_mesh`)
and is ignored by the other engines.  ``telemetry=True`` records one
``repro_torch.obs.device.RoundTelemetry`` row a round in
``History.telemetry`` on every engine."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from repro_torch.fl.cohorts import CohortSpec


@dataclass(frozen=True)
class FLConfig:
    n_clients: int = 20
    n_classes: int = 10
    dim: int = 32
    rounds: int = 100
    local_steps: int = 5          # E
    distill_steps: int = 5        # E_dist
    lr: float = 0.1               # eta
    lr_dist: float = 0.1          # eta_dist
    public_size: int = 1000       # |P|
    public_per_round: int = 100   # |P^t|
    private_size: int = 2000
    alpha: float = 0.05           # Dirichlet
    participation: float = 1.0    # p
    hidden: int = 64
    mlp_depth: int = 2
    cluster_scale: float = 3.0    # class-center spread (task difficulty)
    noise: float = 1.0            # within-class noise (task difficulty)
    seed: int = 0
    eval_every: int = 10
    # wire codecs (repro_torch.compress specs, e.g. "quant8",
    # "cache_delta+quant8"); "identity" keeps dense-fp32 payloads
    uplink_codec: str = "identity"
    downlink_codec: str = "identity"
    # request-list/index entry width in bytes
    index_bytes: float = 4.0
    # heterogeneous client-model cohorts (CohortSpec tuple summing to
    # n_clients); None = one cohort from (hidden, mlp_depth)
    cohorts: Optional[Tuple[CohortSpec, ...]] = None
    mesh_spec: str = "auto"
    fused_round: bool = False
    # private/test shard assignment: "dirichlet" or "uniform"
    partition: str = "dirichlet"
    telemetry: bool = False
