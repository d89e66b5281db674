"""The fused SCARLET round: uplink codec round trip, participation-weighted
client sum and Enhanced-ERA sharpening in one pass.  CUDA kernel, its
plain PyTorch version, and the engine-facing plumbing.

Port of ``repro.kernels.round_kernel.fused_round`` (the Pallas
``_fused_round_kernel``).  The kernel source is ``csrc/fused_round.cu``;
its header says what bounds it on the card and how the client axis is
streamed.  :func:`fused_round` takes the plain version for a CPU tensor
and launches the kernel for a CUDA tensor; there is no other path.

Per output row, for each client k: the codec round trip of its row
(``identity``; ``quant``: min-max quantize-dequantize over the N classes,
then simplex re-projection; ``delta``: the residual against ``base`` with
the last class rebuilt from the sum-zero constraint, an optional
quantize-dequantize over the first N-1 classes, then simplex
re-projection), times ``weights[k]``, summed over k; then, if
``sharpen``, ``/K`` and Enhanced ERA.  The scan engine passes
``part * K / n_part`` as weights, so ``/K`` gives the participant mean;
``sharpen=False`` gives the linear moment of the two-phase contract.

The Pallas kernel pads N to 128 lanes and sharpens the padded row, which
leaks mass into the pad at beta < 1 (as its ERA kernel does); the port
sharpens the N real classes (Eq. 4).  It does not pad K either: the sum
runs over the real clients and ``/K`` divides by the real K.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.quant_kernel import _levels, quantize_dequantize_plain

__all__ = ["MODES", "fused_round", "fused_round_plain", "resolve_delta_base",
           "codec_kernel_spec", "launch_plan", "analysis_cases", "THREADS"]

# the reference's epsilons (round_kernel.py:66-68): one-step parity with
# the per-op chain depends on using the same ones
_EPS_ERA = 1e-12
_EPS_SIMPLEX = 1e-9

MODES = ("identity", "quant", "delta")
_MODE_ID = {m: i for i, m in enumerate(MODES)}

# Threads a block: a warp a row, 4 rows a block.
THREADS = 128


def _check(z, weights, beta, base, mode, bits, sharpen):
    """The reference's argument checks (round_kernel.py:163-171) plus the
    shapes the kernel relies on."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r} (want one of {MODES})")
    if mode == "quant" and bits is None:
        raise ValueError("mode='quant' requires bits")
    if sharpen and beta is None:
        raise ValueError("sharpen=True requires beta")
    if mode == "delta" and base is None:
        raise ValueError("mode='delta' requires a resolved base "
                         "(resolve_delta_base)")
    if z.dim() != 3:
        raise ValueError(f"expected (K, m, N), got shape {tuple(z.shape)}")
    K, m, N = z.shape
    if K < 1 or N < 1:
        raise ValueError(f"need K >= 1 and N >= 1, got shape {tuple(z.shape)}")
    if mode == "delta" and N < 2:
        raise ValueError("mode='delta' needs N >= 2 (one class is implied)")
    if tuple(weights.shape) != (K,):
        raise ValueError(f"weights must be ({K},), got {tuple(weights.shape)}")
    if mode == "delta" and tuple(base.shape) != (m, N):
        raise ValueError(f"base must be ({m}, {N}), got {tuple(base.shape)}")
    if bits is not None:
        _levels(bits)


def _sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` (kept) accumulated in float64 and rounded once to
    float32, as the kernel sums (see ``csrc/fused_round.cu``)."""
    return x.double().sum(dim, keepdim=True).float()


def _simplex(z: torch.Tensor) -> torch.Tensor:
    z = torch.clamp_min(z, 0.0)
    return z / torch.clamp_min(_sum(z, -1), _EPS_SIMPLEX)


def fused_round_plain(z: torch.Tensor, weights: torch.Tensor, beta=None,
                      base: Optional[torch.Tensor] = None, *,
                      mode: str = "identity", bits: Optional[int] = None,
                      sharpen: bool = True) -> torch.Tensor:
    """(K, m, N) -> (m, N), the kernel's steps written out in PyTorch: the
    same float32 products, quotients, logs and exps, the same
    float64-accumulated sums."""
    _check(z, weights, beta, base, mode, bits, sharpen)
    K = z.shape[0]
    if mode == "delta":
        r = (z - base)[..., :-1]
        if bits is not None:
            r = quantize_dequantize_plain(r, bits)
        r = torch.cat([r, -_sum(r, -1)], dim=-1)
        z = _simplex(base + r)
    elif mode == "quant":
        z = _simplex(quantize_dequantize_plain(z, bits))
    zsum = _sum(z * weights[:, None, None], 0)[0]
    if not sharpen:
        return zsum
    zbar = runtime.divide(zsum, float(K))
    logz = torch.log(torch.clamp_min(zbar, _EPS_ERA)) * beta
    e = torch.exp(logz - logz.amax(-1, keepdim=True))
    return e / _sum(e, -1)


def launch_plan(z: torch.Tensor, weights: torch.Tensor, base: Optional[torch.Tensor],
                out: torch.Tensor, beta_source: str = "python") -> runtime.LaunchPlan:
    """The launch of ``csrc/fused_round.cu`` over the contiguous (K, m, N)
    ``z``: a warp an output row, THREADS / 32 rows a block."""
    m = z.shape[1]
    return runtime.LaunchPlan(
        "fused_round_kernel", grid=(runtime.cdiv(m, THREADS // 32), 1, 1),
        block=(THREADS, 1, 1),
        operands=(runtime.ptr("z", z), runtime.ptr("w", weights), runtime.ptr("base", base),
                  runtime.ptr("out", out), runtime.value("k_clients", ctypes.c_int),
                  runtime.value("rows", ctypes.c_longlong), runtime.value("n", ctypes.c_int),
                  runtime.value("mode", ctypes.c_int), runtime.value("levels", ctypes.c_float),
                  runtime.value("sharpen", ctypes.c_int),
                  runtime.value("beta", ctypes.c_float, beta_source)))


def fused_round(z: torch.Tensor, weights: torch.Tensor, beta=None,
                base: Optional[torch.Tensor] = None, *,
                mode: str = "identity", bits: Optional[int] = None,
                sharpen: bool = True) -> torch.Tensor:
    """(K, m, N) float32 client soft-labels -> (m, N).

    ``weights`` is the (K,) per-client weight; ``base`` the resolved
    delta base (``(m, N)``, required for ``mode="delta"``: use
    :func:`resolve_delta_base`); ``beta`` a Python number, required when
    ``sharpen``.  ``bits`` sets the min-max code (required for
    ``"quant"``, optional for ``"delta"``)."""
    if z.device.type == "cpu":
        return fused_round_plain(z, weights, beta, base, mode=mode, bits=bits,
                                 sharpen=sharpen)
    if z.device.type != "cuda":
        raise ValueError(f"unsupported device {z.device}")
    _check(z, weights, beta, base, mode, bits, sharpen)
    operands = [z, weights] + ([base] if mode == "delta" else [])
    for t in operands:
        if t.dtype != torch.float32:
            raise TypeError(f"the kernel takes float32, got {t.dtype}")
        if t.device != z.device:
            raise ValueError(f"operands on {t.device} and {z.device}")
    K, m, N = z.shape
    z, weights = z.contiguous(), weights.contiguous()
    base = base.contiguous() if mode == "delta" else None
    out = torch.empty((m, N), dtype=z.dtype, device=z.device)
    if m == 0:
        return out
    levels = _levels(bits) if bits is not None else 0.0
    beta_val, beta_source = runtime.host_value(beta if sharpen else 0.0)
    runtime.launch("fused_round", "fused_round_launch",
                   launch_plan(z, weights, base, out, beta_source), z, weights, base, out,
                   ctypes.c_int(K), ctypes.c_longlong(m), ctypes.c_int(N),
                   ctypes.c_int(_MODE_ID[mode]), ctypes.c_float(levels),
                   ctypes.c_int(int(sharpen)), ctypes.c_float(beta_val))
    fused_round.launches += 1
    return out


fused_round.launches = 0


def analysis_cases():
    """(label, fn, args) triples for the launch-plan lint
    (:mod:`repro_torch.analysis.launch_checks`), ``args`` as (shape,
    dtype) pairs made on the fake card: the reference's cases
    (``repro.kernels.round_kernel.analysis_cases``), then the slice's
    (100, 1000, 10) stack through delta+quant8 as the fused device engine
    launches it."""
    f32 = torch.float32
    return [
        ("round/identity-sharpen-K200",
         lambda z, w: fused_round(z, w, 1.5, mode="identity", sharpen=True),
         (((200, 100, 10), f32), ((200,), f32))),
        ("round/quant8-sharpen-K1000",
         lambda z, w: fused_round(z, w, 1.5, mode="quant", bits=8, sharpen=True),
         (((1000, 64, 10), f32), ((1000,), f32))),
        ("round/delta8-linear-K50",
         lambda z, w, b: fused_round(z, w, None, b, mode="delta", bits=8, sharpen=False),
         (((50, 24, 10), f32), ((50,), f32), ((24, 10), f32))),
        ("round/delta8-sharpen-K100-M1000-N10",
         lambda z, w, b: fused_round(z, w, 1.5, b, mode="delta", bits=8, sharpen=True),
         (((100, 1000, 10), f32), ((100,), f32), ((1000, 10), f32))),
    ]


# ---------------------------------------------------------------------------
# Engine-facing plumbing
# ---------------------------------------------------------------------------

def resolve_delta_base(base: Optional[torch.Tensor],
                       present: Optional[torch.Tensor], m: int, n: int,
                       device=None) -> torch.Tensor:
    """The delta base as ``CacheDeltaCodec`` resolves it: the cached entry
    where one exists, the uniform prior ``1/N`` elsewhere."""
    if base is None:
        return torch.full((m, n), 1.0 / n, dtype=torch.float32, device=device)
    if present is not None:
        base = torch.where(present[..., None], base,
                           torch.full_like(base, 1.0 / n))
    return base


def codec_kernel_spec(codec) -> Optional[dict]:
    """``{"mode", "bits"}`` for an uplink codec, or ``None`` when the codec
    has no fused equivalent and the per-op chain must run.  Quant needs
    ``renormalize=True``; a delta codec's inner quant ``renormalize=False``
    (as ``get_codec`` builds it)."""
    from repro_torch.compress.codecs import CacheDeltaCodec, IdentityCodec, QuantCodec

    if isinstance(codec, IdentityCodec):
        return {"mode": "identity", "bits": None}
    if isinstance(codec, QuantCodec) and codec.renormalize:
        return {"mode": "quant", "bits": codec.bits}
    if isinstance(codec, CacheDeltaCodec):
        if isinstance(codec.inner, IdentityCodec):
            return {"mode": "delta", "bits": None}
        if isinstance(codec.inner, QuantCodec) and not codec.inner.renormalize:
            return {"mode": "delta", "bits": codec.inner.bits}
    return None
