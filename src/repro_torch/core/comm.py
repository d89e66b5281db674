"""Communication-cost accounting (paper §IV-A4, Table V).

Counterpart of ``repro.core.comm``.  The ledger is an analytic function
of integer counts.  The host loop keeps it in Python floats and numpy
float64 exactly as the reference's host loop does; the device engine
evaluates the same arithmetic on 0-dim float32 tensors, as the
reference's scan engine does, and its ledger holds those float32 values
cast to float64.  Either way a port run and a reference run of the same
engine with the same draws give byte-identical summaries.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

__all__ = ["BYTES_F32", "BYTES_INDEX", "BYTES_SIGNAL", "index_bytes_for",
           "RoundCost", "CommLedger", "soft_label_bytes",
           "distillation_round_cost", "distillation_round_cost_device",
           "fedavg_round_cost"]

BYTES_F32 = 4.0
BYTES_INDEX = 4.0
BYTES_SIGNAL = 0.25  # 2 bits/sample, packed


def index_bytes_for(n_items: int) -> float:
    """Smallest standard unsigned width that can index ``n_items``
    distinct values."""
    if n_items <= 2 ** 8:
        return 1.0
    if n_items <= 2 ** 16:
        return 2.0
    return 4.0


@dataclass
class RoundCost:
    uplink: float = 0.0    # client -> server, summed over clients, bytes
    downlink: float = 0.0  # server -> client, summed over clients, bytes


@dataclass
class CommLedger:
    """Per-round uplink/downlink byte ledger."""

    rounds: List[RoundCost] = field(default_factory=list)

    def record(self, cost: RoundCost) -> None:
        self.rounds.append(cost)

    @property
    def cumulative_uplink(self) -> float:
        return sum(r.uplink for r in self.rounds)

    @property
    def cumulative_downlink(self) -> float:
        return sum(r.downlink for r in self.rounds)

    @property
    def cumulative_total(self) -> float:
        return self.cumulative_uplink + self.cumulative_downlink

    def summary(self) -> Dict[str, float]:
        """Per-direction stats over recorded rounds; an empty ledger
        reports explicit zeros (and ``rounds: 0.0``), never a phantom
        round."""
        up = np.array([r.uplink for r in self.rounds], dtype=np.float64)
        down = np.array([r.downlink for r in self.rounds], dtype=np.float64)
        empty = up.size == 0

        def _stat(arr: np.ndarray, red) -> float:
            return 0.0 if empty else float(red(arr))

        return {
            "rounds": float(len(self.rounds)),
            "uplink_mean": _stat(up, np.mean),
            "uplink_std": _stat(up, np.std),
            "uplink_max": _stat(up, np.max),
            "downlink_mean": _stat(down, np.mean),
            "downlink_std": _stat(down, np.std),
            "downlink_max": _stat(down, np.max),
            "cumulative_total": float(up.sum() + down.sum()),
        }


def soft_label_bytes(n_samples, n_classes: int, bits: float = 32.0) -> float:
    return n_samples * n_classes * bits / 8.0


def distillation_round_cost_device(
    *,
    n_clients,
    n_selected,
    n_up_samples,
    n_down_samples,
    n_classes: int,
    uplink_bits: float = 32.0,
    downlink_bits: float = 32.0,
    with_cache_signals: bool = False,
    with_request_list: bool = True,
    catch_up_down=0.0,
    bytes_index: float = BYTES_INDEX,
    uplink_codec=None,
    downlink_codec=None,
):
    """``(uplink, downlink)`` bytes for one round, as plain arithmetic.

    Every count may be a Python number or a 0-dim float32 tensor: the
    device engine passes its per-round counts as tensors on the card and
    gets a pair of float32 tensors back, with no host sync; the host loop
    passes Python numbers and gets Python floats (float64).  The
    operations run in the reference's order (``n * N * bits / 8.0``,
    then ``n_clients * per_client``), so the float32 values are the
    reference scan engine's bit for bit.

    - uplink: each client sends soft-labels for ``n_up_samples`` samples;
    - downlink: the server broadcasts aggregated soft-labels for
      ``n_down_samples`` samples (+ signals over all ``n_selected`` when
      caching) + the request list, to each client, plus
      ``catch_up_down`` bytes of catch-up packages.

    A non-identity codec replaces the flat bits-per-value payload with
    its analytic ``payload_bytes`` on that direction.
    """
    if uplink_codec is not None and not uplink_codec.is_identity:
        up_per_client = uplink_codec.payload_bytes(n_up_samples, n_classes)
    else:
        up_per_client = soft_label_bytes(n_up_samples, n_classes, uplink_bits)
    if downlink_codec is not None and not downlink_codec.is_identity:
        down_per_client = downlink_codec.payload_bytes(n_down_samples, n_classes)
    else:
        down_per_client = soft_label_bytes(n_down_samples, n_classes, downlink_bits)
    if with_request_list:
        down_per_client += n_down_samples * bytes_index + n_selected * bytes_index
    if with_cache_signals:
        down_per_client += n_selected * BYTES_SIGNAL
    return n_clients * up_per_client, n_clients * down_per_client + catch_up_down


def distillation_round_cost(
    *,
    n_clients: int,
    n_selected: int,
    n_requested: Optional[float] = None,
    n_classes: int,
    uplink_bits: float = 32.0,
    downlink_bits: float = 32.0,
    with_cache_signals: bool = False,
    with_request_list: bool = True,
    catch_up_down: float = 0.0,
    n_up_samples: Optional[float] = None,
    n_down_samples: Optional[float] = None,
    bytes_index: float = BYTES_INDEX,
    uplink_codec=None,
    downlink_codec=None,
) -> RoundCost:
    """Per-round cost for distillation-based FL, in host float64: the
    arithmetic of :func:`distillation_round_cost_device` on Python
    numbers.  ``n_requested`` is the single-count form (uplink ==
    downlink samples)."""
    if n_up_samples is None:
        n_up_samples = n_requested
    if n_down_samples is None:
        n_down_samples = n_requested
    if n_up_samples is None or n_down_samples is None:
        raise TypeError("pass n_requested or both n_up_samples/n_down_samples")
    up, down = distillation_round_cost_device(
        n_clients=n_clients,
        n_selected=n_selected,
        n_up_samples=n_up_samples,
        n_down_samples=n_down_samples,
        n_classes=n_classes,
        uplink_bits=uplink_bits,
        downlink_bits=downlink_bits,
        with_cache_signals=with_cache_signals,
        with_request_list=with_request_list,
        catch_up_down=catch_up_down,
        bytes_index=bytes_index,
        uplink_codec=uplink_codec,
        downlink_codec=downlink_codec,
    )
    return RoundCost(uplink=float(up), downlink=float(down))


def fedavg_round_cost(*, n_clients: int, n_params: int, bits: float = 32.0) -> RoundCost:
    """Parameter sharing (FedAvg): each client downloads the server model
    and uploads its own, ``n_params`` values of ``bits`` bits each way."""
    per = n_params * bits / 8.0
    return RoundCost(uplink=n_clients * per, downlink=n_clients * per)
