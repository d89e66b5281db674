"""Soft-label wire codecs: quantization, top-k sparsification and
cache-delta coding.

Counterpart of ``repro.compress.codecs``.  A :class:`Codec` models one
lossy soft-label payload format through three obligations:

- ``encode(z, base, present) -> payload`` / ``decode(payload, base,
  present) -> z_hat``: the wire forms, plain PyTorch in fixed shapes;
- ``roundtrip(z, base, present)``: what the receiver sees,
  ``decode(encode(z))``, which is what the round engines call; the quant
  codecs run it through the quantize-dequantize kernel
  (:func:`repro_torch.kernels.ops.quantize_dequantize`), the others
  through their wire forms;
- ``payload_bytes(n_samples, n_classes)``: the analytic per-client
  payload size, plain Python arithmetic so the ledger stays bit-true.

``scan_safe`` declares, as in the reference, that a codec runs in fixed
shapes without host syncs, so the device engine
(:mod:`repro_torch.fl.scan_engine`) may call it inside its rounds.
Accounting follows the reference: min-max quantizers charge the value
bits only, top-k charges k values and k indices a row, and cache-delta
drops one class on the wire (the residual sums to zero).
"""
from __future__ import annotations

import re
from typing import Callable, Dict, Optional, Union

import torch

from repro_torch.core import comm as comm_lib
from repro_torch.kernels import ops as kops
from repro_torch.kernels.runtime import divide

__all__ = ["Codec", "IdentityCodec", "QuantCodec", "TopKCodec",
           "CacheDeltaCodec", "CODECS", "get_codec"]

_EPS = 1e-9


def _simplex(z: torch.Tensor) -> torch.Tensor:
    """Project decoded labels back onto the simplex (clip + renorm)."""
    z = torch.clamp_min(z, 0.0)
    return z / torch.clamp_min(z.sum(-1, keepdim=True), _EPS)


class Codec:
    """One soft-label wire format.  ``z`` is ``(..., N)``: ``(K, m, N)``
    client stacks on the uplink, ``(m, N)`` teachers on the downlink.
    ``base``/``present`` carry the synchronized cache entry at the
    round's request positions; codecs that don't delta-code ignore
    them."""

    name = "base"
    scan_safe = True  # fixed shapes, no host sync: usable by the device engine

    @property
    def is_identity(self) -> bool:
        return False

    def encode(self, z: torch.Tensor, base: Optional[torch.Tensor] = None,
               present: Optional[torch.Tensor] = None):
        raise NotImplementedError

    def decode(self, payload, base: Optional[torch.Tensor] = None,
               present: Optional[torch.Tensor] = None) -> torch.Tensor:
        raise NotImplementedError

    def roundtrip(self, z: torch.Tensor, base: Optional[torch.Tensor] = None,
                  present: Optional[torch.Tensor] = None) -> torch.Tensor:
        """What the receiver sees; codecs with a kernel override it."""
        return self.decode(self.encode(z, base, present), base, present)

    def payload_bytes(self, n_samples, n_classes: int):
        raise NotImplementedError


class IdentityCodec(Codec):
    """Dense fp32 labels: the no-compression reference point."""

    name = "identity"

    @property
    def is_identity(self) -> bool:
        return True

    def encode(self, z, base=None, present=None):
        return z

    def decode(self, payload, base=None, present=None):
        return payload

    def roundtrip(self, z, base=None, present=None):
        return z

    def payload_bytes(self, n_samples, n_classes):
        return n_samples * n_classes * comm_lib.BYTES_F32


class QuantCodec(Codec):
    """Per-row min-max uniform quantization to ``bits`` bits (CFD's
    quantizer).  ``renormalize=True`` (top-level use on probability
    rows) re-projects the dequantized row onto the simplex; residual use
    inside :class:`CacheDeltaCodec` turns it off."""

    def __init__(self, bits: int, renormalize: bool = True):
        if bits < 1:
            raise ValueError(f"need at least 1 bit, got {bits}")
        self.bits = int(bits)
        self.renormalize = renormalize
        self.name = f"quant{self.bits}"

    def encode(self, z, base=None, present=None):
        levels = float(2 ** self.bits - 1)
        zmin = z.amin(-1, keepdim=True)
        scale = torch.clamp_min(z.amax(-1, keepdim=True) - zmin, _EPS)
        # the codes travel as float32 levels, as in the reference
        q = torch.round((z - zmin) / scale * levels)
        return {"q": q, "zmin": zmin, "scale": scale}

    def decode(self, payload, base=None, present=None):
        levels = float(2 ** self.bits - 1)
        deq = divide(payload["q"], levels) * payload["scale"] + payload["zmin"]
        return _simplex(deq) if self.renormalize else deq

    def roundtrip(self, z, base=None, present=None):
        deq = kops.quantize_dequantize(z, self.bits)
        return _simplex(deq) if self.renormalize else deq

    def payload_bytes(self, n_samples, n_classes):
        return n_samples * n_classes * self.bits / 8.0


class TopKCodec(Codec):
    """Keep the ``k`` largest entries per row, zero the rest.  The wire
    carries k fp32 values and k class indices a row, ``index_bytes``
    wide.  Top-level use renormalizes the survivors onto the simplex;
    residual use (``renormalize=False``) selects by magnitude, since
    residuals are signed.

    Ties go to the lower class index, as ``jax.lax.top_k`` breaks them:
    the selection is a stable descending sort, never ``torch.topk``,
    whose order among equal values is unspecified."""

    def __init__(self, k: int = 2, renormalize: bool = True,
                 index_bytes: float = comm_lib.BYTES_INDEX):
        if k < 1:
            raise ValueError(f"need k >= 1, got {k}")
        self.k = int(k)
        self.renormalize = renormalize
        self.index_bytes = float(index_bytes)
        self.name = f"topk{self.k}"

    def encode(self, z, base=None, present=None):
        score = z if self.renormalize else z.abs()
        idx = torch.sort(score, dim=-1, descending=True, stable=True).indices[..., :self.k]
        return {"values": z.gather(-1, idx), "indices": idx, "n_classes": z.shape[-1]}

    def decode(self, payload, base=None, present=None):
        values, idx = payload["values"], payload["indices"]
        # no position receives two values, so the scatter gives the bits
        # of the reference's one-hot sum
        dense = values.new_zeros(values.shape[:-1] + (payload["n_classes"],))
        dense = dense.scatter(-1, idx, values)
        return _simplex(dense) if self.renormalize else dense

    def payload_bytes(self, n_samples, n_classes):
        return n_samples * self.k * (comm_lib.BYTES_F32 + self.index_bytes)


class CacheDeltaCodec(Codec):
    """Residual coding against the synchronized soft-label cache.

    Both ends share a prediction base per request position: the cached
    entry where one exists (``present``, stale EXPIRED values included),
    the uniform prior ``1/N`` elsewhere.  The residual ``z - base`` sums
    to zero, so its last class is dropped on the wire and rebuilt from
    the constraint; ``inner`` codes the ``N - 1`` others in residual mode.
    """

    def __init__(self, inner: Optional[Codec] = None):
        self.inner = inner if inner is not None else IdentityCodec()
        self.name = ("cache_delta" if self.inner.is_identity
                     else f"cache_delta+{self.inner.name}")
        self.scan_safe = self.inner.scan_safe

    def _base(self, z, base, present):
        n = z.shape[-1]
        if base is None:
            return torch.full_like(z, 1.0 / n)
        if present is not None:
            base = torch.where(present[..., None], base,
                               torch.full_like(base, 1.0 / n))
        return base.expand(z.shape)

    def encode(self, z, base=None, present=None):
        b = self._base(z, base, present)
        return self.inner.encode((z - b)[..., :-1])  # last class implied by sum-zero

    def decode(self, payload, base=None, present=None):
        r = self.inner.decode(payload)
        r = torch.cat([r, -r.sum(-1, keepdim=True)], dim=-1)
        return _simplex(self._base(r, base, present) + r)

    def roundtrip(self, z, base=None, present=None):
        b = self._base(z, base, present)
        # the residual's first N-1 classes, a strided view of z - b
        r = self.inner.roundtrip((z - b)[..., :-1])
        r = torch.cat([r, -r.sum(-1, keepdim=True)], dim=-1)
        return _simplex(b + r)

    def payload_bytes(self, n_samples, n_classes):
        return self.inner.payload_bytes(n_samples, n_classes - 1)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

# Name -> zero-arg constructor; the quantB and topkK families are parsed
# by get_codec before this map is read.
CODECS: Dict[str, Callable[[], Codec]] = {
    "identity": IdentityCodec,
    "quant8": lambda: QuantCodec(8),
    "quant4": lambda: QuantCodec(4),
    "quant1": lambda: QuantCodec(1),
    "topk": TopKCodec,
    "cache_delta": CacheDeltaCodec,
}

_QUANT_RE = re.compile(r"^quant(\d+)$")
_TOPK_RE = re.compile(r"^topk(\d*)$")


def _make(spec: str, renormalize: bool = True,
          index_bytes: Optional[float] = None) -> Codec:
    m = _QUANT_RE.match(spec)
    if m:
        return QuantCodec(int(m.group(1)), renormalize=renormalize)
    m = _TOPK_RE.match(spec)
    if m:
        return TopKCodec(int(m.group(1)) if m.group(1) else 2, renormalize=renormalize,
                         index_bytes=(comm_lib.BYTES_INDEX if index_bytes is None
                                      else index_bytes))
    factory = CODECS.get(spec)
    if factory is not None:
        return factory()
    raise ValueError(f"unknown codec spec: {spec!r} "
                     f"(known: {sorted(CODECS)}, or quantB / topkK)")


def get_codec(spec: Union[str, Codec, None], *,
              index_bytes: Optional[float] = None) -> Codec:
    """Resolve a codec spec: a Codec instance (returned as-is), ``None``
    (identity), ``"quantB"`` or ``"topkK"``, a delta composition
    (``"cache_delta+quant8"``), or a ``CODECS`` registry name.
    ``index_bytes`` is the wire width of top-k's indices (the run's
    ``FLConfig.index_bytes``; default 4 bytes)."""
    if spec is None:
        return IdentityCodec()
    if isinstance(spec, Codec):
        return spec
    spec = spec.strip()
    if spec.startswith("cache_delta"):
        rest = spec[len("cache_delta"):]
        if rest == "":
            return CacheDeltaCodec()
        if rest.startswith("+"):
            return CacheDeltaCodec(inner=_make(rest[1:], renormalize=False,
                                               index_bytes=index_bytes))
        raise ValueError(f"unknown codec spec: {spec!r}")
    return _make(spec, index_bytes=index_bytes)
