"""Soft-label wire codecs: quantization and cache-delta coding.

Counterpart of ``repro.compress.codecs``.  A :class:`Codec` models one
lossy soft-label payload format through two obligations:

- ``roundtrip(z, base, present)``: what the receiver sees,
  ``decode(encode(z))``; the quant codecs run it through the
  quantize-dequantize kernel (:func:`repro_torch.kernels.ops.quantize_dequantize`);
- ``payload_bytes(n_samples, n_classes)``: the analytic per-client
  payload size, plain Python arithmetic so the ledger stays bit-true.

The round engines need nothing else, so the separate ``encode`` /
``decode`` wire forms of the reference are not ported yet, nor is the
top-k codec.  ``scan_safe`` declares, as in the reference, that a codec
runs in fixed shapes without host syncs, so the device engine
(:mod:`repro_torch.fl.scan_engine`) may call it inside its rounds.
Accounting follows the reference: min-max quantizers charge the value
bits only, and cache-delta drops one class on the wire (the residual
sums to zero).
"""
from __future__ import annotations

import re
from typing import Callable, Dict, Optional, Union

import torch

from repro_torch.core import comm as comm_lib
from repro_torch.kernels import ops as kops

__all__ = ["Codec", "IdentityCodec", "QuantCodec", "CacheDeltaCodec",
           "CODECS", "get_codec"]

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

    def roundtrip(self, z: torch.Tensor, base: Optional[torch.Tensor] = None,
                  present: Optional[torch.Tensor] = None) -> torch.Tensor:
        raise NotImplementedError

    def payload_bytes(self, n_samples, n_classes: int):
        raise NotImplementedError


class IdentityCodec(Codec):
    """Dense fp32 labels: the no-compression reference point."""

    name = "identity"

    @property
    def is_identity(self) -> bool:
        return True

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

    def roundtrip(self, z, base=None, present=None):
        deq = kops.quantize_dequantize(z, self.bits)
        return _simplex(deq) if self.renormalize else deq

    def payload_bytes(self, n_samples, n_classes):
        return n_samples * n_classes * self.bits / 8.0


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

# Name -> zero-arg constructor; the quantB family is parsed by get_codec.
CODECS: Dict[str, Callable[[], Codec]] = {
    "identity": IdentityCodec,
    "quant8": lambda: QuantCodec(8),
    "quant4": lambda: QuantCodec(4),
    "quant1": lambda: QuantCodec(1),
    "cache_delta": CacheDeltaCodec,
}

_QUANT_RE = re.compile(r"^quant(\d+)$")
_TOPK_RE = re.compile(r"^topk(\d*)$")


def _make(spec: str, renormalize: bool = True) -> Codec:
    m = _QUANT_RE.match(spec)
    if m:
        return QuantCodec(int(m.group(1)), renormalize=renormalize)
    if _TOPK_RE.match(spec):
        raise NotImplementedError(f"codec {spec!r}: top-k is not yet ported")
    factory = CODECS.get(spec)
    if factory is not None:
        return factory()
    raise ValueError(f"unknown codec spec: {spec!r} "
                     f"(known: {sorted(CODECS)}, or quantB)")


def get_codec(spec: Union[str, Codec, None]) -> Codec:
    """Resolve a codec spec: a Codec instance (returned as-is), ``None``
    (identity), ``"quantB"``, a delta composition
    (``"cache_delta+quant8"``), or a ``CODECS`` registry name."""
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
            return CacheDeltaCodec(inner=_make(rest[1:], renormalize=False))
        raise ValueError(f"unknown codec spec: {spec!r}")
    return _make(spec)
