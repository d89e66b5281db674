"""Per-row soft-target cross entropy (the distillation loss): CUDA kernel
and its plain PyTorch version.

Port of ``repro.kernels.distill_kernel.distill_loss`` (the Pallas
``_distill_kernel``).  The kernel source is ``csrc/distill.cu``; its
header says what bounds it on the card and how a row of up to an LM's
vocabulary is swept in one pass.  :func:`distill_loss` takes the plain
version for a CPU tensor and launches the kernel for a CUDA tensor; there
is no other path.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import runtime

__all__ = ["distill_loss", "distill_loss_plain", "THREADS"]

# Threads a block (a multiple of 32); one block a row.
THREADS = 256
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def distill_loss_plain(logits: torch.Tensor, teacher: torch.Tensor) -> torch.Tensor:
    """(B, V) -> (B,) float32: the kernel's formula
    ``logsumexp(l) * sum(t) - sum(t * l)`` with both inputs cast to
    float32."""
    l32, t32 = logits.float(), teacher.float()
    return torch.logsumexp(l32, -1) * t32.sum(-1) - (t32 * l32).sum(-1)


def _launcher():
    fn = runtime.load("distill").distill_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def distill_loss(logits: torch.Tensor, teacher: torch.Tensor) -> torch.Tensor:
    """Row-wise soft-target CE: logits and teacher (B, V), each float32 or
    bfloat16 -> (B,) float32.  Forward only: raises if a gradient would be
    needed, as the reference's kernel has no gradient."""
    if logits.dim() != 2 or logits.shape != teacher.shape:
        raise ValueError(f"expected logits and teacher of one (B, V) shape, got "
                         f"{tuple(logits.shape)} and {tuple(teacher.shape)}")
    B, V = logits.shape
    if V < 1:
        raise ValueError(f"need V >= 1, got shape {tuple(logits.shape)}")
    for name, t in (("logits", logits), ("teacher", teacher)):
        if t.dtype not in _DTYPE_CODE:
            raise TypeError(f"distill_loss takes float32 or bfloat16 {name}, got {t.dtype}")
    if logits.device != teacher.device:
        raise ValueError(f"logits on {logits.device} but teacher on {teacher.device}")
    runtime.forward_only("distill_loss", logits, teacher)
    if logits.device.type == "cpu":
        return distill_loss_plain(logits, teacher)
    if logits.device.type != "cuda":
        raise ValueError(f"unsupported device {logits.device}")
    logits, teacher = logits.contiguous(), teacher.contiguous()
    out = torch.empty((B,), dtype=torch.float32, device=logits.device)
    if B == 0:
        return out
    guard, stream = runtime.launch_args(logits)
    with guard:
        err = _launcher()(logits.data_ptr(), teacher.data_ptr(), out.data_ptr(),
                          _DTYPE_CODE[logits.dtype], _DTYPE_CODE[teacher.dtype], B, V,
                          THREADS, stream)
    runtime.check(err, "distill")
    distill_loss.launches += 1
    return out


distill_loss.launches = 0
