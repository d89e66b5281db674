"""The roofline's hardware model (the port of ``repro.launch.roofline``'s
``HardwareSpec``, ``HW_PRESETS``, ``resolve_hw``, ``Roofline``,
``compute_roofline_from_summary`` and ``model_flops_for``).

  compute term    = dot FLOPs a device / peak FLOP/s
  memory term     = HBM bytes a device / HBM bytes/s
  collective term = collective bytes a device / link bytes/s

``HW_PRESETS`` holds the port's card alone, ``"h100_sxm"``: NVIDIA's
H100 SXM5 data sheet, dense bf16 989 TFLOP/s, HBM3 3.35 TB/s and NVLink 4
at 450 GB/s a direction (the rates assume the full 700 W limit; the card
every run of this repository has measured reads ``NVIDIA H100 80GB HBM3,
700.00 W`` from ``nvidia-smi --query-gpu=name,power.limit``).  It is the
default, and the legacy constants ``PEAK_FLOPS``, ``HBM_BW`` and
``LINK_BW`` follow it.

The reference's other half reads XLA's compiled HLO text
(``collective_bytes``, ``compute_roofline`` through
``launch/hlo_analysis.py``).  Its counterpart here is
``launch/trace_analysis.py``, which counts the same quantities on the
port's own step traced over fake tensors; its ``TraceSummary`` feeds
``compute_roofline_from_summary``, which takes any summary object with
the fields ``dot_flops``, ``collective_bytes``, ``collective_by_kind``,
``collective_counts`` and ``residual_while_loops`` (the dry run,
``launch/dryrun.py``).
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Dict, Union

__all__ = ["HardwareSpec", "HW_PRESETS", "DEFAULT_HW", "resolve_hw", "PEAK_FLOPS", "HBM_BW",
           "LINK_BW", "Roofline", "compute_roofline_from_summary", "model_flops_for"]


@dataclass(frozen=True)
class HardwareSpec:
    """Per-chip peaks the roofline terms divide by."""
    name: str
    peak_flops: float        # FLOP/s / chip (dense bf16)
    hbm_bw: float            # bytes/s / chip
    link_bw: float           # bytes/s / link, one direction


HW_PRESETS: Dict[str, HardwareSpec] = {
    # NVIDIA H100 SXM5 data sheet (NVIDIA H100 80GB HBM3, 700.00 W)
    "h100_sxm": HardwareSpec("h100_sxm", 989e12, 3.35e12, 450e9),
}

DEFAULT_HW = HW_PRESETS["h100_sxm"]


def resolve_hw(hw: Union[str, HardwareSpec, None]) -> HardwareSpec:
    """A HardwareSpec from a preset name, a spec, or None (default)."""
    if hw is None:
        return DEFAULT_HW
    if isinstance(hw, HardwareSpec):
        return hw
    if hw not in HW_PRESETS:
        raise ValueError(f"unknown hardware preset {hw!r} "
                         f"(want one of {sorted(HW_PRESETS)})")
    return HW_PRESETS[hw]


# legacy aliases: the module constants of the default card
PEAK_FLOPS = DEFAULT_HW.peak_flops
HBM_BW = DEFAULT_HW.hbm_bw
LINK_BW = DEFAULT_HW.link_bw


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    scheme: str
    chips: int
    hlo_gflops: float            # whole-fleet dot FLOPs (per-dev x chips)
    hlo_gflops_per_device: float
    hlo_gbytes_per_device: float  # HBM bytes accessed per device
    collective_gbytes_per_device: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_gflops: float          # 6*N*D (or 6*N_active*D)
    useful_flops_ratio: float    # model / hlo (whole-fleet)
    bytes_per_device: float      # peak per-device memory (args+temps)
    collective_counts: Dict[str, int]
    collective_by_kind_gb: Dict[str, float]
    residual_while_loops: int
    cost_analysis_gflops: float  # the summary's producer's own FLOP count
    hw: str = DEFAULT_HW.name    # HardwareSpec the rate terms divide by

    def as_dict(self):
        return asdict(self)


def compute_roofline_from_summary(
    *,
    arch: str,
    shape: str,
    mesh_name: str,
    scheme: str,
    chips: int,
    summary,                    # duck-typed: dot_flops, collective_bytes, ...
    bytes_accessed: float,      # per-device HBM bytes
    xla_flops: float,
    model_flops: float,
    bytes_per_device: float,
    hw: Union[str, HardwareSpec, None] = None,
) -> Roofline:
    """All rate terms are per-device over per-chip peaks; whole-fleet
    figures are x chips.  The bottleneck is the largest term."""
    hw = resolve_hw(hw)
    flops_dev = summary.dot_flops
    compute_s = flops_dev / hw.peak_flops
    memory_s = bytes_accessed / hw.hbm_bw
    coll_s = summary.collective_bytes / hw.link_bw
    terms = {"compute": compute_s, "memory": memory_s, "collective": coll_s}
    bottleneck = max(terms, key=terms.get)
    fleet_flops = flops_dev * chips
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, scheme=scheme, chips=chips,
        hlo_gflops=fleet_flops / 1e9,
        hlo_gflops_per_device=flops_dev / 1e9,
        hlo_gbytes_per_device=bytes_accessed / 1e9,
        collective_gbytes_per_device=summary.collective_bytes / 1e9,
        compute_s=compute_s, memory_s=memory_s, collective_s=coll_s,
        bottleneck=bottleneck,
        model_gflops=model_flops / 1e9,
        useful_flops_ratio=(model_flops / fleet_flops) if fleet_flops else 0.0,
        bytes_per_device=bytes_per_device,
        collective_counts=summary.collective_counts,
        collective_by_kind_gb={k: v / 1e9 for k, v in summary.collective_by_kind.items() if v},
        residual_while_loops=summary.residual_while_loops,
        cost_analysis_gflops=xla_flops / 1e9,
        hw=hw.name,
    )


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS: 6*N*D for training; 2*N*D for inference (per forward);
    MoE uses active params."""
    n = cfg.active_param_count()
    if shape.mode == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.mode == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch
