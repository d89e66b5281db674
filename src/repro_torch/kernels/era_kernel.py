"""Fused client mean + Enhanced-ERA sharpening: CUDA kernel and its plain
PyTorch version.

Port of ``repro.kernels.era_kernel.enhanced_era_fused`` (the Pallas
``_era_fused_kernel``).  The kernel source is ``csrc/era_fused.cu``; its
header says what bounds it on the card and how the client axis is
streamed.  :func:`enhanced_era_fused` takes the plain version for a CPU
tensor and launches the kernel for a CUDA tensor; there is no other
path.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import runtime

__all__ = ["enhanced_era_fused", "enhanced_era_fused_plain", "MAX_CLASSES"]

_EPS = 1e-12

# One row's N log values must fit the 48 KB of shared memory a block
# gets without opting in to more.
MAX_CLASSES = 12288


def enhanced_era_fused_plain(z: torch.Tensor, beta) -> torch.Tensor:
    """(K, B, N) -> (B, N) in the Pallas kernel's order of operations:
    sum over K then ``/K``; clamp at 1e-12, log, ``*beta``; subtract the
    row max, exp; divide by the row sum."""
    zbar = runtime.divide(z.sum(0), float(z.shape[0]))
    logz = torch.log(torch.clamp_min(zbar, _EPS)) * beta
    e = torch.exp(logz - logz.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def _launcher():
    fn = runtime.load("era_fused").era_fused_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def enhanced_era_fused(z: torch.Tensor, beta) -> torch.Tensor:
    """(K, B, N) float32 client soft-labels -> aggregated + sharpened
    (B, N).  ``beta`` is a runtime scalar."""
    if z.dim() != 3:
        raise ValueError(f"expected (K, B, N), got shape {tuple(z.shape)}")
    K, B, N = z.shape
    if K < 1 or N < 1:
        raise ValueError(f"need K >= 1 and N >= 1, got shape {tuple(z.shape)}")
    if z.device.type == "cpu":
        return enhanced_era_fused_plain(z, beta)
    if z.device.type != "cuda":
        raise ValueError(f"unsupported device {z.device}")
    if z.dtype != torch.float32:
        raise TypeError(f"the kernel takes float32, got {z.dtype}")
    if N > MAX_CLASSES:
        raise ValueError(f"N={N} exceeds the kernel's {MAX_CLASSES} classes")
    z = z.contiguous()
    out = torch.empty((B, N), dtype=z.dtype, device=z.device)
    if B == 0:
        return out
    guard, stream = runtime.launch_args(z)
    with guard:
        err = _launcher()(z.data_ptr(), out.data_ptr(), K, B, N,
                          float(beta), stream)
    runtime.check(err, "era_fused")
    enhanced_era_fused.launches += 1
    return out


enhanced_era_fused.launches = 0
