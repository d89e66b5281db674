"""The static analyzer's fixture kernels: CUDA kernels, their plain
PyTorch versions, and the launch plans that carry each fixture's fault.

Port of the Pallas fixtures of ``repro.analysis.fixtures`` (``_misaligned``,
``_vmem_scalar``, ``_vmem_hog``).  The kernels are ``csrc/fixtures.cu``;
each body is correct, and each has a valid plan and a broken one:

- :func:`copy_vec4`: a float4 copy.  Valid on a tensor whose start is
  16-byte aligned; broken on a view that starts 4 bytes into its storage
  (the card stops the kernel: ``cudaErrorMisalignedAddress``, 716).
- :func:`scale`: ``x * s`` with ``s`` a (1,) tensor on the card.  Valid
  with ``s`` read by the kernel through a pointer; broken with
  ``sync=True``, ``s`` read to the host first (a host sync a launch).
- :func:`copy_smem`: a copy staged through a (rows, cols) tile of shared
  memory in and one out, by 16-byte copies where they are aligned.  Valid
  with (32, 128) tiles; broken with a (4096, 1024) tile, 32 MiB where a
  block gets 227 KB (the card refuses the launch).

Each wrapper takes the plain version for a CPU tensor and launches its
kernel for a CUDA tensor.  The analyzer's selftest lints the broken plans
(:mod:`repro_torch.analysis.fixtures`) and, on a card, runs the valid
ones.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import runtime

__all__ = ["copy_vec4", "scale", "copy_smem", "copy_plain", "scale_plain",
           "copy_vec4_plan", "scale_plan", "copy_smem_plan", "copy_smem_vec", "VALID_TILE",
           "HOG_TILE"]

THREADS = 256
VALID_TILE = (32, 128)
HOG_TILE = (4096, 1024)


def copy_plain(x: torch.Tensor) -> torch.Tensor:
    """``x`` copied into a new contiguous tensor."""
    return x.clone(memory_format=torch.contiguous_format)


def scale_plain(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``x * s[0]``."""
    return x * s.reshape(())


def _check_f32(x: torch.Tensor) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"the fixture kernels take float32, got {x.dtype}")
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")


def copy_vec4_plan(x: torch.Tensor, out: torch.Tensor) -> runtime.LaunchPlan:
    """One float4 a thread over the contiguous ``x``."""
    n4 = x.numel() // 4
    return runtime.LaunchPlan(
        "copy_vec4_kernel", grid=(runtime.cdiv(n4, THREADS), 1, 1), block=(THREADS, 1, 1),
        operands=(runtime.ptr("x", x, 16), runtime.ptr("out", out, 16),
                  runtime.value("n4", ctypes.c_longlong)))


def copy_vec4(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of the contiguous float32 ``x`` (numel a multiple
    of 4), one float4 a thread.  Its start is not checked: a view that
    starts off a 16-byte boundary is the misaligned fixture."""
    if x.device.type == "cpu":
        return copy_plain(x)
    _check_f32(x)
    if not x.is_contiguous() or x.numel() % 4:
        raise ValueError("copy_vec4 takes a contiguous tensor of a multiple of 4 values")
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return out
    runtime.launch("fixtures", "copy_vec4_launch", copy_vec4_plan(x, out), x, out,
                   ctypes.c_longlong(x.numel() // 4))
    copy_vec4.launches += 1
    return out


copy_vec4.launches = 0


def scale_plan(x: torch.Tensor, out: torch.Tensor, s_ptr, s_source: str) -> runtime.LaunchPlan:
    """One value a thread; ``s`` by value (from ``s_source``) and, where
    ``s_ptr`` is a tensor, by pointer."""
    return runtime.LaunchPlan(
        "scale_kernel", grid=(runtime.cdiv(x.numel(), THREADS), 1, 1), block=(THREADS, 1, 1),
        operands=(runtime.ptr("x", x), runtime.ptr("out", out),
                  runtime.value("n", ctypes.c_longlong),
                  runtime.value("s_val", ctypes.c_float, s_source), runtime.ptr("s_ptr", s_ptr)))


def scale(x: torch.Tensor, s: torch.Tensor, sync: bool = False) -> torch.Tensor:
    """``x * s[0]`` for contiguous float32 ``x`` and a (1,) float32 ``s`` on
    the same card, read by the kernel through a pointer; ``sync=True`` is
    the broken plan: ``s`` read to the host and passed by value."""
    if s.numel() != 1:
        raise ValueError(f"s must hold one value, got shape {tuple(s.shape)}")
    if x.device.type == "cpu":
        return scale_plain(x, s)
    _check_f32(x)
    if not x.is_contiguous() or s.device != x.device or s.dtype != torch.float32:
        raise ValueError("scale takes a contiguous x and a float32 s on x's card")
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return out
    if sync:
        (s_val, s_source), s_ptr = runtime.host_value(s), None
    else:
        (s_val, s_source), s_ptr = (0.0, "python"), s
    runtime.launch("fixtures", "scale_launch", scale_plan(x, out, s_ptr, s_source), x, out,
                   ctypes.c_longlong(x.numel()), ctypes.c_float(s_val), s_ptr)
    scale.launches += 1
    return out


scale.launches = 0


def copy_smem_vec(x: torch.Tensor, tile: Tuple[int, int]) -> int:
    """Floats a copy of ``copy_smem`` moves: 4 (16 bytes) where the
    columns, the tile's columns and ``x``'s start are whole 16 bytes, else
    1."""
    return 4 if x.shape[1] % 4 == 0 and tile[1] % 4 == 0 and x.storage_offset() % 4 == 0 \
        else 1


def copy_smem_plan(x: torch.Tensor, out: torch.Tensor,
                   tile: Tuple[int, int]) -> runtime.LaunchPlan:
    """A block per (tile rows, tile cols) tile of the (rows, cols) ``x``,
    its tile in shared memory twice (in and out), opted in above 48 KB;
    16-byte copies where :func:`copy_smem_vec` finds them aligned."""
    rows, cols = x.shape
    tr, tc = tile
    smem = 2 * tr * tc * 4
    vb = 4 * copy_smem_vec(x, tile)
    return runtime.LaunchPlan(
        f"copy_smem_kernel<{vb // 4}>", grid=(runtime.cdiv(cols, tc), runtime.cdiv(rows, tr), 1),
        block=(THREADS, 1, 1), dyn_smem=smem, smem_optin=smem > runtime.HOPPER.smem_per_block,
        operands=(runtime.ptr("x", x, vb), runtime.ptr("out", out, vb),
                  runtime.value("rows", ctypes.c_longlong),
                  runtime.value("cols", ctypes.c_longlong),
                  runtime.value("tile_rows", ctypes.c_int),
                  runtime.value("tile_cols", ctypes.c_int), runtime.value("vec", ctypes.c_int)))


def copy_smem(x: torch.Tensor, tile: Tuple[int, int] = VALID_TILE) -> torch.Tensor:
    """A contiguous copy of the contiguous (rows, cols) float32 ``x``,
    staged through shared memory in ``tile``-sized blocks; ``HOG_TILE`` is
    the broken plan."""
    if x.dim() != 2:
        raise ValueError(f"expected (rows, cols), got shape {tuple(x.shape)}")
    if x.device.type == "cpu":
        return copy_plain(x)
    _check_f32(x)
    if not x.is_contiguous():
        raise ValueError("copy_smem takes a contiguous tensor")
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return out
    rows, cols = x.shape
    runtime.launch("fixtures", "copy_smem_launch", copy_smem_plan(x, out, tile), x, out,
                   ctypes.c_longlong(rows), ctypes.c_longlong(cols), ctypes.c_int(tile[0]),
                   ctypes.c_int(tile[1]), ctypes.c_int(copy_smem_vec(x, tile)))
    copy_smem.launches += 1
    return out


copy_smem.launches = 0
