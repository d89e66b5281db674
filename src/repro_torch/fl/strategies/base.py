"""Strategy protocol: the distillation method's aggregation (counterpart of
``repro.fl.strategies.base``).

A Strategy owns how client soft-labels are transformed on the wire and
aggregated into a teacher, and what the method pays per value.  The host
loop calls :meth:`Strategy.aggregate` on the participants' stack; the
device engine calls the fixed-shape hooks below on the whole client
stack with a float participation vector, so its rounds keep one shape
and never wait for the card.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

__all__ = ["Strategy", "positive_or_one", "TRANSMIT_SALT"]

# Under the jax stream an engine's transmit key of round t is
# ``fold_in(fold_in(key_rounds, t), TRANSMIT_SALT)``: a fold off the round
# key, so strategies that ignore it leave the other draws as they are.
TRANSMIT_SALT = 71


def positive_or_one(wsum: torch.Tensor) -> torch.Tensor:
    """The divisor of a weighted mean: ``wsum`` where positive, else 1."""
    return torch.where(wsum > 0, wsum, torch.ones_like(wsum))


class Strategy:
    """Distillation-method-specific behavior.  Subclasses override
    :meth:`aggregate` and, for the device engine, the two-phase hooks."""

    name = "base"
    uses_cache = False
    uplink_bits = 32.0
    downlink_bits = 32.0
    # True when every hook runs in fixed shapes without a host sync: the
    # device engine requires it.  ``repro_torch.analysis`` verifies the
    # declaration by tracing every hook on fake CUDA tensors.
    scan_safe = False
    # True when codec round trip + masked aggregation can run as one
    # fused_round kernel (aggregate_masked_fused); engines check it at
    # construction.
    supports_fused_round = False

    # Constructor-kwarg variants the static analyzer instantiates when
    # tracing this class (each entry is one ``cls(**kw)`` call): the option
    # combinations that change the traced hooks.
    analysis_variants: Tuple[Dict[str, Any], ...] = ({},)

    def __init__(self, **kw):
        self.opts = kw

    def declared_contract(self) -> Dict[str, Any]:
        """The machine-checkable contract this instance claims:
        ``repro_torch.analysis`` traces the hooks and diffs the trace
        against these declarations; engines trust them at construction."""
        return {
            "name": self.name,
            "scan_safe": bool(self.scan_safe),
            "supports_fused_round": bool(self.supports_fused_round),
            "uses_cache": bool(self.uses_cache),
        }

    def aggregate(self, z_clients: torch.Tensor,
                  upload_mask: Optional[torch.Tensor], t
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Participants' ``(n_part, m, N)`` soft-labels and their
        ``(n_part, m)`` bool upload mask (None: all uploaded) -> the
        server's ``(m, N)`` teacher, and per-client teachers for
        personalized methods (None here)."""
        raise NotImplementedError

    # uplink payload transform, applied before the uplink codec: the
    # soft-labels as the server sees them (CFD quantizes; identity here).
    # ``key`` is the round's transmit key of the jax stream (None under the
    # numpy stream): a stochastic transform draws from it, never from a
    # host RNG.
    def transmit(self, z_clients: torch.Tensor,
                 key: Optional[torch.Tensor] = None) -> torch.Tensor:
        return z_clients

    # per-(client, sample) upload mask (Selective-FD); None = all uploaded
    def upload_mask(self, z_clients: torch.Tensor) -> Optional[torch.Tensor]:
        return None

    # telemetry gauge (repro_torch.obs): the resolved sharpening knob of
    # round ``t`` given the participant-mean soft labels ``zbar`` (m, N):
    # Enhanced ERA's static or adaptive beta, ERA's temperature, 0 where
    # the strategy has none.  Pure tensor code that runs inside the device
    # round when telemetry is on, and mutates nothing.
    def sharpen_gauge(self, zbar: torch.Tensor, t) -> torch.Tensor:
        return torch.zeros((), dtype=torch.float32, device=zbar.device)

    # ------------------------------------------------------------------
    # Staleness weighting (repro_torch.fl.async_engine).  A report that
    # lands ``s`` rounds after its dispatch has its aggregation weight
    # multiplied by ``staleness_weight(s)``: float32 ``decay ** s`` with
    # ``staleness_decay`` from the constructor options.  Weights multiply
    # soft-labels, never byte counts, so the ledger does not move.  At the
    # default decay 1.0 the engine skips the multiply.  Pure tensor code
    # that runs inside the device round: ``repro_torch.analysis.
    # async_checks`` flags an override that reads the card on the host.
    def staleness_weight(self, staleness: torch.Tensor) -> torch.Tensor:
        decay = torch.full((), float(self.opts.get("staleness_decay", 1.0)),
                           dtype=torch.float32, device=staleness.device)
        return decay ** staleness.to(torch.float32)

    # ------------------------------------------------------------------
    # Fixed-shape masked aggregation: the two-phase contract.
    #
    # ``partial_aggregate`` returns linear moments of a (K, m, N) stack
    # under the float participation vector ``part`` (K,), entries that
    # sum across client shards; ``finalize_aggregate`` applies the
    # method's nonlinearity once to the summed moments.
    # ``aggregate_masked`` composes the two on one device and must equal
    # ``aggregate(z[part], um[part])`` up to float rounding.  The
    # defaults give the participation-weighted mean.
    #
    # The mean divides by the weights' sum where it is positive (1 on a
    # total outage).  The reference divides by ``max(sum, 1)``, which is
    # the same for 0/1 participation but leaves a teacher of mass
    # ``sum w`` under staleness weights whose sum is below 1 (one report
    # two rounds late at decay 0.5: mass 0.25); the port does not copy
    # that.

    def partial_aggregate(self, z_clients: torch.Tensor, part: torch.Tensor,
                          upload_mask: Optional[torch.Tensor],
                          t) -> Dict[str, torch.Tensor]:
        return {"zsum": torch.tensordot(part, z_clients, dims=([0], [0])),
                "wsum": part.sum()}

    def finalize_aggregate(self, partials: Dict[str, torch.Tensor],
                           t) -> torch.Tensor:
        return partials["zsum"] / positive_or_one(partials["wsum"])

    def aggregate_masked(self, z_clients: torch.Tensor, part: torch.Tensor,
                         upload_mask: Optional[torch.Tensor],
                         t) -> torch.Tensor:
        return self.finalize_aggregate(
            self.partial_aggregate(z_clients, part, upload_mask, t), t)

    # ------------------------------------------------------------------
    # Fused round path (FLConfig.fused_round): ``codec_spec`` is
    # ``round_kernel.codec_kernel_spec`` output, ``base`` the resolved
    # delta base (None outside delta mode).

    def aggregate_masked_fused(self, z_clients: torch.Tensor,
                               part: torch.Tensor, codec_spec: Dict,
                               base: Optional[torch.Tensor],
                               t) -> torch.Tensor:
        """Fused twin of codec round trip + :meth:`aggregate_masked`."""
        raise NotImplementedError(
            f"strategy {self.name!r} has no fused round path")

    def partial_aggregate_fused(self, z_clients: torch.Tensor,
                                part: torch.Tensor, codec_spec: Dict,
                                base: Optional[torch.Tensor],
                                t) -> Dict[str, torch.Tensor]:
        """Fused twin of codec round trip + :meth:`partial_aggregate`."""
        raise NotImplementedError(
            f"strategy {self.name!r} has no fused round path")
