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

__all__ = ["quantize_dequantize", "quantize_dequantize_plain"]

_EPS_SCALE = 1e-9


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


def _launcher():
    fn = runtime.load("qdq").qdq_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_float,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


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
    guard, stream = runtime.launch_args(flat)
    with guard:
        err = _launcher()(flat.data_ptr(), out.data_ptr(), rows, N,
                          flat.stride(0), levels, stream)
    runtime.check(err, "qdq")
    quantize_dequantize.launches += 1
    return out.reshape(z.shape)


quantize_dequantize.launches = 0
