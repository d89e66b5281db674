"""Enhanced-ERA sharpening (SCARLET Eq. 4): CUDA kernels and their plain
PyTorch versions.

- :func:`enhanced_era_fused`, port of
  ``repro.kernels.era_kernel.enhanced_era_fused`` (the Pallas
  ``_era_fused_kernel``): client mean + sharpening of a (K, B, N) stack,
  kernel ``csrc/era_fused.cu``;
- :func:`enhanced_era`, port of ``repro.kernels.era_kernel.enhanced_era``
  (the Pallas ``_era_kernel``): per-row sharpening of an averaged (B, N)
  input, kernel ``csrc/era_rows.cu``.

Each kernel's header says what bounds it on the card.  Both wrappers take
the plain version for a CPU tensor and launch the kernel for a CUDA
tensor; there is no other path.  Both sharpen the N real classes: the
Pallas kernels sharpen rows zero-padded to 128 lanes, whose pad lanes keep
mass at beta < 1 (ROADMAP, Queue C).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import runtime

__all__ = ["enhanced_era_fused", "enhanced_era_fused_plain", "MAX_CLASSES",
           "enhanced_era", "enhanced_era_plain", "THREADS"]

_EPS = 1e-12

# One row's N log values must fit the 48 KB of shared memory a block
# gets without opting in to more.
MAX_CLASSES = 12288

# Threads a block of the per-row kernel (a multiple of 32): 8 rows a block
# for N <= 1024, one row a block above.
THREADS = 256
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def enhanced_era_plain(z: torch.Tensor, beta) -> torch.Tensor:
    """(B, N) -> (B, N) in ``z``'s dtype, in the Pallas kernel's order of
    operations, in float32: clamp at 1e-12, log, ``*beta``; subtract the
    row max, exp; divide by the row sum."""
    logz = torch.log(torch.clamp_min(z.float(), _EPS)) * beta
    e = torch.exp(logz - logz.amax(-1, keepdim=True))
    return (e / e.sum(-1, keepdim=True)).to(z.dtype)


def enhanced_era_fused_plain(z: torch.Tensor, beta) -> torch.Tensor:
    """(K, B, N) -> (B, N) in the Pallas kernel's order of operations:
    sum over K then ``/K``; then :func:`enhanced_era_plain`."""
    return enhanced_era_plain(runtime.divide(z.sum(0), float(z.shape[0])), beta)


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


def _beta_arg(beta, z: torch.Tensor):
    """(value, float32 tensor on the card or None) for the kernel's beta.
    A number or a CPU tensor goes by value; a CUDA tensor stays on the
    card and goes by pointer, so the call makes no host sync."""
    if not isinstance(beta, torch.Tensor):
        return float(beta), None
    if beta.numel() != 1:
        raise ValueError(f"beta must be a scalar, got shape {tuple(beta.shape)}")
    if beta.device.type == "cpu":
        return float(beta), None
    if beta.device != z.device:
        raise ValueError(f"beta on {beta.device} but z on {z.device}")
    return 0.0, beta.reshape(()).to(torch.float32)


def _rows_launcher():
    fn = runtime.load("era_rows").era_rows_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def enhanced_era(z: torch.Tensor, beta) -> torch.Tensor:
    """(B, N) averaged soft-labels, float32 or bfloat16 -> sharpened (B, N)
    in the same dtype.  ``beta`` is a number or a one-element tensor (on
    the CPU, or on ``z``'s card, where the kernel reads it).  Forward only:
    raises if a gradient would be needed, as the reference's kernel has
    no gradient."""
    if z.dim() != 2:
        raise ValueError(f"expected (B, N), got shape {tuple(z.shape)}")
    B, N = z.shape
    if N < 1:
        raise ValueError(f"need N >= 1, got shape {tuple(z.shape)}")
    if z.dtype not in _DTYPE_CODE:
        raise TypeError(f"enhanced_era takes float32 or bfloat16, got {z.dtype}")
    runtime.forward_only("enhanced_era", z, beta)
    if z.device.type == "cpu":
        return enhanced_era_plain(z, beta)
    if z.device.type != "cuda":
        raise ValueError(f"unsupported device {z.device}")
    beta_val, beta_t = _beta_arg(beta, z)
    z = z.contiguous()
    out = torch.empty((B, N), dtype=z.dtype, device=z.device)
    if B == 0:
        return out
    guard, stream = runtime.launch_args(z)
    with guard:
        err = _rows_launcher()(z.data_ptr(), out.data_ptr(), _DTYPE_CODE[z.dtype], B, N,
                               beta_val, None if beta_t is None else beta_t.data_ptr(),
                               THREADS, stream)
    runtime.check(err, "era_rows")
    enhanced_era.launches += 1
    return out


enhanced_era.launches = 0
