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

__all__ = ["quantize_dequantize", "quantize_dequantize_plain", "layout", "tile_smem",
           "launch_plan", "analysis_cases", "TILE_ROWS", "TILE_THREADS", "TILE_MAX_N",
           "WARP_MAX_N", "THREADS"]

_EPS_SCALE = 1e-9

# Layouts of csrc/qdq.cu, from n and the row stride ld (:func:`layout`):
# a tile of at most TILE_ROWS rows staged in shared memory for n <=
# TILE_MAX_N with ld <= 2n, TILE_THREADS threads a block; a warp a row up
# to WARP_MAX_N values; a block of THREADS a row above.  Every layout
# gives the same bits (csrc/qdq.cu).
TILE_ROWS = 128
TILE_THREADS = 128
TILE_MAX_N = 32
WARP_MAX_N = 1024
THREADS = 256
# A 1- to 8-bit code reads its quotients from a table of levels + 1 entries.
_TABLE_MAX = 256
_LAYOUT_CODE = {"tile": 0, "warp": 1, "block": 2}


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


def tile_smem(tile: int, n: int, ld: int) -> int:
    """Dynamic shared memory of the tile layout, bytes: the span of
    ``tile`` rows ((tile - 1) * ld + n floats, rounded up to 4, and 4 of
    shift), then the (tile, n) output tile (rounded up to 4, and 4 of
    shift); ``tile_floats`` in ``csrc/qdq.cu``."""
    return 4 * (((tile - 1) * ld + n + 3) // 4 * 4 + 4 + (tile * n + 3) // 4 * 4 + 4)


def layout(n: int, ld: int):
    """(kind, tile, vals) of ``csrc/qdq.cu`` for rows of ``n`` values at row
    stride ``ld``: ("tile", rows a block, 0) for n <= TILE_MAX_N with ld <=
    2n, the rows halved from TILE_ROWS until the block's shared memory fits
    48 KB; ("warp", 0, V) up to WARP_MAX_N, V the power of two of
    values a lane that covers n; else ("block", 0, 0)."""
    if n <= TILE_MAX_N and ld <= 2 * n:
        tile = TILE_ROWS
        while tile > 1 and tile_smem(tile, n, ld) > runtime.HOPPER.smem_per_block:
            tile //= 2
        return "tile", tile, 0
    if n <= WARP_MAX_N:
        return "warp", 0, 1 << (runtime.cdiv(n, 32) - 1).bit_length()
    return "block", 0, 0


def _row_stride(flat: torch.Tensor) -> int:
    """The row stride the kernel takes: ``flat.stride(0)``, or n for a
    single row (whose stride is never used)."""
    return flat.stride(0) if flat.shape[0] > 1 else flat.shape[1]


def launch_plan(flat: torch.Tensor, out: torch.Tensor) -> runtime.LaunchPlan:
    """The launch of ``csrc/qdq.cu`` over the (rows, N) rows ``flat`` (row
    stride ``flat.stride(0)``, unit class stride) into ``out`` in its
    :func:`layout`: a block of TILE_THREADS a tile of rows, its span and
    output tile in dynamic shared memory; THREADS / 32 rows a block, a
    warp each; or a block of THREADS a row."""
    rows, n = flat.shape
    kind, tile, vals = layout(n, _row_stride(flat))
    smem = 0
    if kind == "tile":
        name = "qdq_tile"
        grid, threads = runtime.cdiv(rows, tile), TILE_THREADS
        smem = tile_smem(tile, n, _row_stride(flat))
    elif kind == "warp":
        name, grid, threads = f"qdq_warp<{vals}>", runtime.cdiv(rows, THREADS // 32), THREADS
    else:
        name, grid, threads = "qdq_block", rows, THREADS
    return runtime.LaunchPlan(
        name, grid=(grid, 1, 1), block=(threads, 1, 1), dyn_smem=smem,
        operands=(runtime.ptr("z", flat), runtime.ptr("out", out),
                  runtime.value("layout", ctypes.c_int),
                  runtime.value("rows", ctypes.c_longlong), runtime.value("n", ctypes.c_int),
                  runtime.value("ld", ctypes.c_longlong), runtime.value("tile", ctypes.c_int),
                  runtime.value("vals", ctypes.c_int),
                  runtime.value("levels", ctypes.c_float), runtime.value("table", ctypes.c_int)))


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
    ld = _row_stride(flat)
    kind, tile, vals = layout(N, ld)
    table = int(levels) + 1 if levels < _TABLE_MAX else 0
    runtime.launch("qdq", "qdq_launch", launch_plan(flat, out), flat, out,
                   ctypes.c_int(_LAYOUT_CODE[kind]), ctypes.c_longlong(rows), ctypes.c_int(N),
                   ctypes.c_longlong(ld), ctypes.c_int(tile), ctypes.c_int(vals),
                   ctypes.c_float(levels), ctypes.c_int(table))
    quantize_dequantize.launches += 1
    return out.reshape(z.shape)


quantize_dequantize.launches = 0


def analysis_cases():
    """(label, fn, args) triples for the launch-plan lint
    (:mod:`repro_torch.analysis.launch_checks`): the reference's cases
    (``repro.kernels.quant_kernel.analysis_cases``), then the shapes the
    main path launches (the cache-delta residual view of the slice's
    (100, 1000, 10) stack, in the tile layout), and rows of 130 and 2000
    values (the warp and block layouts).  ``args`` are (shape, dtype)
    pairs or callables making the input; the lint makes them on the fake
    card."""
    f32 = torch.float32
    return [
        ("quant/B1000-N10-bits8", lambda z: quantize_dequantize(z, 8),
         (((1000, 10), f32),)),
        ("quant/B10-N1-bits1", lambda z: quantize_dequantize(z, 1), (((10, 1), f32),)),
        ("quant/residual-K100-M1000-N10-bits8",
         lambda z, b: quantize_dequantize((z - b)[..., :-1], 8),
         (((100, 1000, 10), f32), ((1000, 10), f32))),
        ("quant/B64-N130-bits8", lambda z: quantize_dequantize(z, 8), (((64, 130), f32),)),
        ("quant/B16-N2000-bits8", lambda z: quantize_dequantize(z, 8), (((16, 2000), f32),)),
    ]
