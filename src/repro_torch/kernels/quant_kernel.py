"""Per-row min-max quantize-dequantize: CUDA kernel and its plain PyTorch
version.

Port of ``repro.kernels.quant_kernel.quantize_dequantize`` (the Pallas
``_qdq_kernel``).  The kernel source is ``csrc/qdq.cu``; its header says
what bounds it on the card.  :func:`quantize_dequantize` takes the plain
version for a CPU tensor and launches the kernel for a CUDA tensor;
there is no other path.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import runtime

__all__ = ["quantize_dequantize", "quantize_dequantize_plain", "launch_plan",
           "analysis_cases", "THREADS"]

_EPS_SCALE = 1e-9

# Threads a block; one thread a row.
THREADS = 256


def _levels(bits: int) -> float:
    if bits < 1:
        raise ValueError(f"need at least 1 bit, got {bits}")
    return float(2 ** int(bits) - 1)


def quantize_dequantize_plain(z: torch.Tensor, bits: int) -> torch.Tensor:
    """(..., N) -> (..., N): per-row min-max round trip over the last
    axis, operation for operation as the Pallas kernel, [0, 1] clamp of
    the levels included; ``torch.round`` rounds half to even like
    ``jnp.round``."""
    levels = _levels(bits)
    zmin = z.amin(-1, keepdim=True)
    zmax = z.amax(-1, keepdim=True)
    scale = torch.clamp_min(zmax - zmin, _EPS_SCALE)
    q = runtime.divide(torch.round((z - zmin) / scale * levels), levels)
    return torch.clamp(q, 0.0, 1.0) * scale + zmin


def launch_plan(flat: torch.Tensor, out: torch.Tensor) -> runtime.LaunchPlan:
    """The launch of ``csrc/qdq.cu`` over the (rows, N) rows ``flat`` (row
    stride ``flat.stride(0)``, unit class stride) into ``out``: one
    thread a row."""
    rows = flat.shape[0]
    return runtime.LaunchPlan(
        "qdq_kernel", grid=(runtime.cdiv(rows, THREADS), 1, 1), block=(THREADS, 1, 1),
        operands=(runtime.ptr("z", flat), runtime.ptr("out", out),
                  runtime.value("rows", ctypes.c_longlong), runtime.value("n", ctypes.c_int),
                  runtime.value("ld", ctypes.c_longlong),
                  runtime.value("levels", ctypes.c_float)))


def quantize_dequantize(z: torch.Tensor, bits: int) -> torch.Tensor:
    """(..., N) float32 -> (..., N): what a ``bits``-bit receiver sees.

    Strided rows are read in place: the leading dims are flattened with
    ``reshape``, a view whenever they merge into one row stride (the
    cache-delta residual ``(z - base)[..., :-1]`` does), and that row
    stride is passed to the kernel.  Only rows whose classes are not
    unit-strided are copied to a contiguous tensor first.  The output is
    always contiguous.
    """
    levels = _levels(bits)
    if z.dim() < 1 or z.shape[-1] < 1:
        raise ValueError(f"need (..., N) with N >= 1, got {tuple(z.shape)}")
    if z.device.type == "cpu":
        return quantize_dequantize_plain(z, bits)
    if z.device.type != "cuda":
        raise ValueError(f"unsupported device {z.device}")
    if z.dtype != torch.float32:
        raise TypeError(f"the kernel takes float32, got {z.dtype}")
    N = z.shape[-1]
    flat = z.reshape(-1, N)
    if flat.stride(1) != 1:
        flat = flat.contiguous()
    rows = flat.shape[0]
    out = torch.empty((rows, N), dtype=z.dtype, device=z.device)
    if rows == 0:
        return out.reshape(z.shape)
    runtime.launch("qdq", "qdq_launch", launch_plan(flat, out), flat, out,
                   ctypes.c_longlong(rows), ctypes.c_int(N),
                   ctypes.c_longlong(flat.stride(0)), ctypes.c_float(levels))
    quantize_dequantize.launches += 1
    return out.reshape(z.shape)


quantize_dequantize.launches = 0


def analysis_cases():
    """(label, fn, args) triples for the launch-plan lint
    (:mod:`repro_torch.analysis.launch_checks`): the reference's cases
    (``repro.kernels.quant_kernel.analysis_cases``), then the shapes the
    main path launches (the cache-delta residual view of the slice's
    (100, 1000, 10) stack).  ``args`` are (shape, dtype) pairs or
    callables making the input; the lint makes them on the fake card."""
    f32 = torch.float32
    return [
        ("quant/B1000-N10-bits8", lambda z: quantize_dequantize(z, 8),
         (((1000, 10), f32),)),
        ("quant/B10-N1-bits1", lambda z: quantize_dequantize(z, 1), (((10, 1), f32),)),
        ("quant/residual-K100-M1000-N10-bits8",
         lambda z, b: quantize_dequantize((z - b)[..., :-1], 8),
         (((100, 1000, 10), f32), ((1000, 10), f32))),
    ]
