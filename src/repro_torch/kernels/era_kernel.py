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
from typing import Optional

import torch

from repro_torch.kernels import runtime

__all__ = ["enhanced_era_fused", "enhanced_era_fused_plain", "MAX_CLASSES", "TILE_MAX_N",
           "CLIENT_SPLIT", "client_subsets", "fused_layout", "fused_tile_rows",
           "enhanced_era", "enhanced_era_plain", "THREADS", "FUSED_THREADS", "TILE_THREADS",
           "TILE_VALUES", "MEAN_PER_THREAD",
           "WARP_ROW_MAX_N", "ROW_CLUSTERS", "ROW_SLICE_MAX", "ONEPASS_THREADS",
           "fused_launch_plan", "row_slice", "onepass_threads", "rows_layout",
           "rows_launch_plan", "launch_rows", "analysis_cases"]

_EPS = 1e-12

# The fused kernel's layouts (fused_layout, from N alone): up to
# TILE_MAX_N classes a tile of rows a block, each value's clients summed by
# several threads (a warp a row sharpens, a lane a class); up to MAX_CLASSES
# a chunk of rows a block whose N log values fit the 48 KB a block gets
# without opting in; wider rows take two launches: the client mean into a
# (B, N) float32 workspace, then the per-row kernel's layout for N.
TILE_MAX_N = 32
MAX_CLASSES = 12288
# Every layout sums the K clients in client_subsets(K) fixed subsets of
# clients s, s + G, s + 2G, ..., then the subsets' sums in order: at most
# CLIENT_SPLIT (csrc/era_fused.cu's kSplit).
CLIENT_SPLIT = 8

# The fused kernel's tile layout: TILE_THREADS threads a block of the
# largest power of two of rows with at most TILE_VALUES values.  Rows
# layout: FUSED_THREADS threads a block of enough rows that one pass
# covers about FUSED_THREADS values.  The client-mean kernel of wider rows
# sums MEAN_PER_THREAD elements a thread, THREADS threads a block.
TILE_THREADS = 512
TILE_VALUES = 64
FUSED_THREADS = 128
MEAN_PER_THREAD = 4

# Threads a block of the per-row kernel's warp and multi-pass layouts (a
# multiple of 32): a warp a row, 8 rows a block, for N <= WARP_ROW_MAX_N;
# one row a block in the multi-pass layout.
THREADS = 256
WARP_ROW_MAX_N = 1024
# The one-pass layout above WARP_ROW_MAX_N: one row a cluster of C blocks
# (C in ROW_CLUSTERS, the smallest whose slice of the row fits
# ROW_SLICE_MAX float32 values), a thread for every 16 values of a slice,
# at least 128 and at most ONEPASS_THREADS / C threads a block, so that C
# blocks of a full slice fill a multiprocessor's threads.  At whisper's
# 51968 classes in float32, C = 4 (slices of 12992) measured fastest of 1,
# 2, 4 and 8 (PERF.md, tools/kernel_variants.py).  A row longer than
# ROW_CLUSTERS[-1] slices takes the multi-pass layout.
ROW_CLUSTERS = (1, 2, 4, 8)
ROW_SLICE_MAX = 13312
ONEPASS_THREADS = 1024
# Shared memory a block beside its slice: the float4 shift of the slice
# (at most 7 values) and a margin over the kernel's 140 static bytes.
_SLICE_PAD = 8
_DTYPE_NAME = {torch.float32: "float", torch.bfloat16: "bf16"}
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


def client_subsets(K: int) -> int:
    """The fixed subsets G of the client axis every layout of the fused
    kernel sums in (clients s, s + G, ... in order, then the subsets in
    order): min(K, CLIENT_SPLIT), from K alone, so zbar's bits never depend
    on N's layout, on B or on the rows of a launch."""
    return min(K, CLIENT_SPLIT)


def _fused_rows_per_block(n: int) -> int:
    return 1 if n >= FUSED_THREADS else FUSED_THREADS // n


def fused_layout(n: int):
    """(layout, cluster) of the fused kernel for rows of ``n`` classes,
    from ``n`` alone: ("tile", 1) up to TILE_MAX_N and ("rows", 1) up to
    MAX_CLASSES (one launch of ``csrc/era_fused.cu``); above, the client
    mean into a workspace, then :func:`rows_layout` of ``n`` (("onepass",
    C) or ("passes", 1))."""
    if n <= TILE_MAX_N:
        return "tile", 1
    return ("rows", 1) if n <= MAX_CLASSES else rows_layout(n)


def fused_tile_rows(n: int) -> int:
    """Rows a block of the tile layout: the largest power of two with at
    most TILE_VALUES values of ``n`` classes."""
    return 1 << (max(1, TILE_VALUES // n).bit_length() - 1)


_FUSED_CODE = {"tile": 0, "rows": 1, "mean": 2}


def _fused_args(N: int):
    """(layout, rows a block) of ``csrc/era_fused.cu``'s launcher for rows
    of N classes (0 rows for the client mean)."""
    kind = fused_layout(N)[0]
    if kind == "tile":
        return "tile", fused_tile_rows(N)
    if kind == "rows":
        return "rows", _fused_rows_per_block(N)
    return "mean", 0


def fused_launch_plan(z: torch.Tensor, out: torch.Tensor,
                      beta_source: str = "python") -> runtime.LaunchPlan:
    """The launch of ``csrc/era_fused.cu`` over the contiguous (K, B, N)
    ``z``.  Tile layout (N <= TILE_MAX_N): TILE_THREADS threads a block of
    :func:`fused_tile_rows` rows, the G subsets' sums of its values in
    dynamic shared memory.  Rows layout (N <= MAX_CLASSES):
    ``rows_per_block`` rows a block (one row when N >= 128), their N log
    values each in dynamic shared memory, never opted in (at N =
    MAX_CLASSES one row fills 48 KB).  Both write the sharpened rows.
    Above: the client mean, a block of THREADS for every THREADS *
    MEAN_PER_THREAD elements, ``out`` the (B, N) workspace."""
    K, B, N = z.shape
    kind, tile = _fused_args(N)
    if kind == "tile":
        name, grid, threads = "era_fused_kernel", runtime.cdiv(B, tile), TILE_THREADS
        smem = 4 * client_subsets(K) * tile * N
    elif kind == "rows":
        name, grid, threads, smem = "era_fused_rows", runtime.cdiv(B, tile), FUSED_THREADS, \
            tile * N * 4
    else:
        name, grid, threads, smem = "era_fused_mean", \
            runtime.cdiv(B * N, THREADS * MEAN_PER_THREAD), THREADS, 0
    return runtime.LaunchPlan(
        name, grid=(grid, 1, 1), block=(threads, 1, 1), dyn_smem=smem,
        operands=(runtime.ptr("z", z), runtime.ptr("out", out),
                  runtime.value("layout", ctypes.c_int),
                  runtime.value("k_clients", ctypes.c_int),
                  runtime.value("rows", ctypes.c_longlong), runtime.value("n", ctypes.c_int),
                  runtime.value("tile", ctypes.c_int),
                  runtime.value("beta", ctypes.c_float, beta_source)))


def _launch_fused(z: torch.Tensor, out: torch.Tensor, beta_val: float,
                  beta_source: str) -> None:
    K, B, N = z.shape
    kind, tile = _fused_args(N)
    runtime.launch("era_fused", "era_fused_launch", fused_launch_plan(z, out, beta_source), z,
                   out, ctypes.c_int(_FUSED_CODE[kind]), ctypes.c_int(K), ctypes.c_longlong(B),
                   ctypes.c_int(N), ctypes.c_int(tile), ctypes.c_float(beta_val))


def enhanced_era_fused(z: torch.Tensor, beta) -> torch.Tensor:
    """(K, B, N) float32 client soft-labels -> aggregated + sharpened
    (B, N), any N: one launch up to MAX_CLASSES, above it the client mean
    into a workspace and the per-row kernel.  ``beta`` is a number or a
    one-element tensor; the per-row kernel reads a card tensor on the
    card, the row-block kernel reads it to the host (a sync, which the
    lint reports)."""
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
    z = z.contiguous()
    out = torch.empty((B, N), dtype=z.dtype, device=z.device)
    if B == 0:
        return out
    layout = fused_layout(N)
    if N <= MAX_CLASSES:
        beta_val, beta_source = runtime.host_value(beta)
        _launch_fused(z, out, beta_val, beta_source)
    else:
        # the mean takes no beta; a card tensor's beta goes to the per-row
        # kernel by pointer
        beta_val, beta_t = _beta_arg(beta, z)
        zbar = torch.empty((B, N), dtype=z.dtype, device=z.device)
        _launch_fused(z, zbar, 0.0, "python")
        launch_rows(zbar, out, beta_val, beta_t, layout)
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


def row_slice(n: int, cluster: int) -> int:
    """Values of a row that each of a cluster's blocks holds in the
    one-pass layout: an equal share, rounded up to 8 (one bfloat16
    vector)."""
    return runtime.cdiv(runtime.cdiv(n, cluster), 8) * 8


def onepass_threads(n: int, cluster: int) -> int:
    """Threads a block of the one-pass layout: a power of two near one for
    every 16 values of the slice, from 128 to ONEPASS_THREADS / cluster."""
    want = 1 << max(0, runtime.cdiv(row_slice(n, cluster), 16) - 1).bit_length()
    return max(128, min(ONEPASS_THREADS // cluster, want))


def rows_layout(n: int):
    """(layout, cluster) of ``csrc/era_rows.cu`` for rows of ``n`` values,
    from ``n`` alone: ("warp", 1) up to WARP_ROW_MAX_N; ("onepass", C)
    with the smallest C of ROW_CLUSTERS whose slice fits ROW_SLICE_MAX;
    else ("passes", 1)."""
    if n <= WARP_ROW_MAX_N:
        return "warp", 1
    for c in ROW_CLUSTERS:
        if row_slice(n, c) <= ROW_SLICE_MAX:
            return "onepass", c
    return "passes", 1


_LAYOUT_CODE = {"warp": 0, "onepass": 1, "passes": 2}


def rows_launch_plan(z: torch.Tensor, out: torch.Tensor, beta_t: Optional[torch.Tensor],
                     layout=None) -> runtime.LaunchPlan:
    """The launch of ``csrc/era_rows.cu`` over the contiguous (B, N) ``z``
    in ``layout`` (default :func:`rows_layout` of N): a warp a row
    (THREADS / 32 rows a block); a cluster of C blocks a row, each with
    its slice of the row in dynamic shared memory, opted in above 48 KB;
    or a block a row.  beta by pointer when ``beta_t`` is given."""
    B, N = z.shape
    kind, c = layout or rows_layout(N)
    dt = _DTYPE_NAME[z.dtype]
    smem, cluster = 0, (1, 1, 1)
    if kind == "warp":
        name, grid, threads = f"era_rows_warp<{dt}>", runtime.cdiv(B, THREADS // 32), THREADS
    elif kind == "onepass":
        name, grid, threads = f"era_rows_onepass<{dt},{c}>", B * c, onepass_threads(N, c)
        smem, cluster = 4 * (row_slice(N, c) + _SLICE_PAD), (c, 1, 1)
    else:
        name, grid, threads = f"era_rows_passes<{dt}>", B, THREADS
    return runtime.LaunchPlan(
        name, grid=(grid, 1, 1), block=(threads, 1, 1), dyn_smem=smem,
        smem_optin=smem > runtime.HOPPER.smem_per_block, cluster=cluster,
        operands=(runtime.ptr("z", z), runtime.ptr("out", out),
                  runtime.value("dtype", ctypes.c_int), runtime.value("layout", ctypes.c_int),
                  runtime.value("rows", ctypes.c_longlong), runtime.value("n", ctypes.c_int),
                  runtime.value("slice", ctypes.c_int), runtime.value("beta", ctypes.c_float),
                  runtime.ptr("beta_ptr", beta_t)))


def launch_rows(z: torch.Tensor, out: torch.Tensor, beta_val: float,
                beta_t: Optional[torch.Tensor], layout) -> None:
    """One launch of ``csrc/era_rows.cu`` over contiguous (B >= 1, N) ``z``
    into ``out`` in ``layout`` ((kind, cluster), as :func:`rows_layout`
    gives it).  Counts no launch: :func:`enhanced_era` does."""
    B, N = z.shape
    kind, c = layout
    runtime.launch("era_rows", "era_rows_launch", rows_launch_plan(z, out, beta_t, layout), z,
                   out, ctypes.c_int(_DTYPE_CODE[z.dtype]), ctypes.c_int(_LAYOUT_CODE[kind]),
                   ctypes.c_longlong(B), ctypes.c_int(N),
                   ctypes.c_int(row_slice(N, c) if kind == "onepass" else 0),
                   ctypes.c_float(beta_val), beta_t)


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
    launch_rows(z, out, beta_val, beta_t, rows_layout(N))
    enhanced_era.launches += 1
    return out


enhanced_era.launches = 0


def analysis_cases():
    """(label, fn, args) triples for the launch-plan lint
    (:mod:`repro_torch.analysis.launch_checks`), ``args`` as (shape,
    dtype) pairs made on the fake card: the reference's cases
    (``repro.kernels.era_kernel.analysis_cases``), then the shapes the
    main path launches (the slice's (100, 1000, 10) stack; whisper's
    (1536, 51968) vocabulary as soft-labels, in float32 and bfloat16; beta
    on the card), each layout of the per-row kernel (one block a row,
    clusters of 2 and 8 with rows not a multiple of 4 values, the
    multi-pass rows past eight slices), and the fused kernel's layouts
    at their edges: the tile layout at K = 1, at N = 1 with a K that is
    not a multiple of CLIENT_SPLIT, at N = 3 with fewer clients than
    CLIENT_SPLIT (a subset a client); the rows layout at N = 130 and at N =
    MAX_CLASSES, which fills 48 KB exactly; and past it (the client mean,
    then the per-row kernel): one class past it (a cluster of one block a
    row), at whisper's vocabulary (clusters of 4) and one class past eight
    slices (the multi-pass layout)."""
    f32, bf16 = torch.float32, torch.bfloat16
    return [
        ("era/B1000-N10", lambda z: enhanced_era(z, 1.5), (((1000, 10), f32),)),
        ("era/B10-N10", lambda z: enhanced_era(z, 1.5), (((10, 10), f32),)),
        ("era_fused/K200-B100-N10", lambda z: enhanced_era_fused(z, 1.5),
         (((200, 100, 10), f32),)),
        ("era_fused/K1000-B1000-N100", lambda z: enhanced_era_fused(z, 1.5),
         (((1000, 1000, 100), f32),)),
        ("era_fused/K100-B1000-N10", lambda z: enhanced_era_fused(z, 1.5),
         (((100, 1000, 10), f32),)),
        ("era_fused/K1-B9-N10", lambda z: enhanced_era_fused(z, 1.5), (((1, 9, 10), f32),)),
        ("era_fused/K13-B37-N1", lambda z: enhanced_era_fused(z, 1.5), (((13, 37, 1), f32),)),
        ("era_fused/K7-B33-N3", lambda z: enhanced_era_fused(z, 1.5), (((7, 33, 3), f32),)),
        ("era_fused/K3-B33-N130", lambda z: enhanced_era_fused(z, 1.5),
         (((3, 33, 130), f32),)),
        ("era_fused/K2-B3-N12288", lambda z: enhanced_era_fused(z, 1.5),
         (((2, 3, MAX_CLASSES), f32),)),
        ("era_fused/K2-B3-N12289", lambda z: enhanced_era_fused(z, 1.5),
         (((2, 3, MAX_CLASSES + 1), f32),)),
        ("era_fused/K8-B384-N51968", lambda z: enhanced_era_fused(z, 1.5),
         (((8, 384, 51968), f32),)),
        ("era_fused/K3-B5-N106497", lambda z: enhanced_era_fused(z, 1.5),
         (((3, 5, 106497), f32),)),
        ("era/B1536-N51968", lambda z: enhanced_era(z, 1.5), (((1536, 51968), f32),)),
        ("era/B1536-N51968-bf16", lambda z: enhanced_era(z, 1.5), (((1536, 51968), bf16),)),
        ("era/B1000-N10-beta-on-card", lambda z, b: enhanced_era(z, b),
         (((1000, 10), f32), ((), f32))),
        ("era/B64-N12289", lambda z: enhanced_era(z, 1.5), (((64, 12289), f32),)),
        ("era/B9-N20001", lambda z: enhanced_era(z, 1.5), (((9, 20001), f32),)),
        ("era/B7-N100001-bf16", lambda z: enhanced_era(z, 1.5), (((7, 100001), bf16),)),
        ("era/B3-N300001", lambda z: enhanced_era(z, 1.5), (((3, 300001), f32),)),
    ]
