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

__all__ = ["distill_loss", "distill_loss_plain", "THREADS", "launch_plan", "analysis_cases"]

# Threads a block (a multiple of 32); one block a row.
THREADS = 256
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_DTYPE_NAME = {torch.float32: "float", torch.bfloat16: "bf16"}


def distill_loss_plain(logits: torch.Tensor, teacher: torch.Tensor) -> torch.Tensor:
    """(B, V) -> (B,) float32: the kernel's formula
    ``logsumexp(l) * sum(t) - sum(t * l)`` with both inputs cast to
    float32."""
    l32, t32 = logits.float(), teacher.float()
    return torch.logsumexp(l32, -1) * t32.sum(-1) - (t32 * l32).sum(-1)


def launch_plan(logits: torch.Tensor, teacher: torch.Tensor,
                out: torch.Tensor) -> runtime.LaunchPlan:
    """The launch of ``csrc/distill.cu`` over contiguous (B, V) inputs: one
    block of THREADS threads a row."""
    B = logits.shape[0]
    return runtime.LaunchPlan(
        f"distill_kernel<{_DTYPE_NAME[logits.dtype]},{_DTYPE_NAME[teacher.dtype]}>",
        grid=(B, 1, 1), block=(THREADS, 1, 1),
        operands=(runtime.ptr("logits", logits), runtime.ptr("teacher", teacher),
                  runtime.ptr("out", out), runtime.value("l_dtype", ctypes.c_int),
                  runtime.value("t_dtype", ctypes.c_int),
                  runtime.value("rows", ctypes.c_longlong), runtime.value("v", ctypes.c_int)))


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
    runtime.launch("distill", "distill_launch", launch_plan(logits, teacher, out), logits,
                   teacher, out, ctypes.c_int(_DTYPE_CODE[logits.dtype]),
                   ctypes.c_int(_DTYPE_CODE[teacher.dtype]), ctypes.c_longlong(B),
                   ctypes.c_int(V))
    distill_loss.launches += 1
    return out


distill_loss.launches = 0


def analysis_cases():
    """(label, fn, args) triples for the launch-plan lint
    (:mod:`repro_torch.analysis.launch_checks`), ``args`` as (shape,
    dtype) pairs made on the fake card: the reference's cases
    (``repro.kernels.distill_kernel.analysis_cases``; its odd Pallas
    blocks have no counterpart here, the shape stays), then whisper's
    prefill logits against a teacher as the main path launches them,
    (1536, 51968) float32, and a bfloat16 teacher."""
    f32, bf16 = torch.float32, torch.bfloat16
    return [
        ("distill/B100-V163840", distill_loss, (((100, 163840), f32), ((100, 163840), f32))),
        ("distill/B13-V1000-oddblocks", distill_loss, (((13, 1000), f32), ((13, 1000), f32))),
        ("distill/B1536-V51968", distill_loss, (((1536, 51968), f32), ((1536, 51968), f32))),
        ("distill/B1536-V51968-bf16-teacher", distill_loss,
         (((1536, 51968), f32), ((1536, 51968), bf16))),
    ]
