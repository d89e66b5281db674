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
           "codec_kernel_spec", "launch_plan", "launch_round", "tile_layout",
           "analysis_cases", "THREADS", "TILE_THREADS", "CHUNK_CLIENTS_MAX"]

# the reference's epsilons (round_kernel.py:66-68): one-step parity with
# the per-op chain depends on using the same ones
_EPS_ERA = 1e-12
_EPS_SIMPLEX = 1e-9

MODES = ("identity", "quant", "delta")
_MODE_ID = {m: i for i, m in enumerate(MODES)}

# The tile layout: a block of at most TILE_THREADS threads, one a (client,
# row) pair, over `tile` rows and a chunk of `kc` clients (K up to
# CHUNK_CLIENTS_MAX: all K = 100 clients of the slice in one chunk); its
# (kc, tile, N) slab, the base tile and the double sums within the 48 KB a
# block gets without opting in.  At the slice two rows a tile (224
# threads) and four (416) measured alike, eight and one slower (PERF.md,
# tools/kernel_variants.py).
TILE_THREADS = 256
CHUNK_CLIENTS_MAX = 256
_REG_CLASSES = 16  # the kernel's kChunk: classes of a pair held in registers
# The rows layout, for N whose slab does not fit at one row and 32
# clients: a warp a row, THREADS / 32 rows a block.
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


def _tile_threads(kc: int, tile: int) -> int:
    """Threads a tile block: one a pair, rounded up to whole warps."""
    return 32 * runtime.cdiv(kc * tile, 32)


def _tile_smem(kc: int, tile: int, n: int, stride: int, table: int) -> int:
    """Bytes of the tile layout's shared memory: the outputs' double sums
    and the client subsets' double sums (``groups`` of each output),
    rounded up to 16 bytes; the slab of ``kc`` clients' stretches of
    ``stride`` floats; the base tile; the ``table`` of code quotients."""
    outs = tile * n
    groups = max(1, _tile_threads(kc, tile) // outs)
    doubles = outs + groups * outs
    return 8 * (doubles + doubles % 2) + 4 * kc * stride + 4 * outs + 4 * table


def _vec(z: torch.Tensor, tile: int) -> int:
    """Floats a staging copy moves: 4 (16 bytes) when every client's tile
    of ``z`` starts and ends on a 16-byte boundary, else 1."""
    K, m, N = z.shape
    return 4 if (m * N) % 4 == 0 and (tile * N) % 4 == 0 and z.storage_offset() % 4 == 0 else 1


def _stride(tile: int, n: int, vec: int) -> int:
    """Floats of a client's stretch of the slab: its tile * n values,
    rounded up to a multiple of 4 for 16-byte copies, else to an odd count
    so consecutive clients hit distinct banks."""
    return runtime.cdiv(tile * n, 4) * 4 if vec == 4 else tile * n | 1


def _table(levels: float) -> int:
    """Entries of the kernel's table of code quotients i / levels: levels + 1
    for a code of 1 to 8 bits, else 0 (the kernel divides)."""
    return int(levels) + 1 if 1 <= levels <= 255 else 0


def tile_layout(K: int, N: int) -> Optional[tuple]:
    """(kc, tile) of the tile layout for K clients and N classes, or None
    when even one row and min(K, 32) clients do not fit a block's 48 KB
    (the rows layout then).  kc is K up to CHUNK_CLIENTS_MAX; tile fills
    TILE_THREADS; both are halved, tile first, until the block fits with
    the widest stride and table."""
    kc = min(CHUNK_CLIENTS_MAX, K)
    tile = max(1, TILE_THREADS // kc)
    while _tile_smem(kc, tile, N, tile * N + 3, 256) > runtime.HOPPER.smem_per_block:
        if tile > 1:
            tile //= 2
        elif kc > min(K, 32):
            kc = max(min(K, 32), runtime.cdiv(kc, 2))
        else:
            return None
    return kc, tile


def _resolve_layout(layout, K: int, N: int) -> Optional[tuple]:
    """(kc, tile) of the tile layout, or None for the rows layout:
    ``layout`` None is :func:`tile_layout` of K and N, ``"rows"`` the rows
    layout, a (kc, tile) pair that tile."""
    if layout is None:
        return tile_layout(K, N)
    return None if layout == "rows" else tuple(layout)


def launch_plan(z: torch.Tensor, weights: torch.Tensor, base: Optional[torch.Tensor],
                out: torch.Tensor, beta_source: str = "python", layout=None,
                levels: float = 0.0) -> runtime.LaunchPlan:
    """The launch of ``csrc/fused_round.cu`` over the contiguous (K, m, N)
    ``z`` in ``layout`` (default :func:`tile_layout`; ``"rows"`` or a (kc,
    tile) pair): in the tile layout a block of ``kc * tile`` threads
    (rounded up to whole warps) a tile of ``tile`` output rows, with the
    class row of a pair in registers for N <= 16, in a kernel compiled for
    that N; in
    the rows layout a warp an output row,
    THREADS / 32 rows a block.  Where every client's tile starts and ends
    on a 16-byte boundary the slab is staged with 16-byte copies (``z`` is
    then described to the lint as (K, m * N) rows of 16-byte accesses);
    a 1- to 8-bit code (``levels``) gets its table of quotients."""
    K, m, N = z.shape
    tl = _resolve_layout(layout, K, N)
    z_op = runtime.ptr("z", z)
    if tl is None:
        name, grid, threads, smem = "fused_round_rows", runtime.cdiv(m, THREADS // 32), THREADS, 0
    else:
        kc, tile = tl
        vec = _vec(z, tile)
        name = f"fused_round_tile<{N if N <= _REG_CLASSES else 'smem'}>"
        grid, threads = runtime.cdiv(m, tile), _tile_threads(kc, tile)
        smem = _tile_smem(kc, tile, N, _stride(tile, N, vec), _table(levels))
        if vec == 4:
            z_op = runtime.ptr("z", z.reshape(K, m * N), vector_bytes=16)
    return runtime.LaunchPlan(
        name, grid=(grid, 1, 1), block=(threads, 1, 1), dyn_smem=smem,
        operands=(z_op, runtime.ptr("w", weights), runtime.ptr("base", base),
                  runtime.ptr("out", out), runtime.value("k_clients", ctypes.c_int),
                  runtime.value("rows", ctypes.c_longlong), runtime.value("n", ctypes.c_int),
                  runtime.value("mode", ctypes.c_int), runtime.value("levels", ctypes.c_float),
                  runtime.value("sharpen", ctypes.c_int),
                  runtime.value("beta", ctypes.c_float, beta_source),
                  runtime.value("layout", ctypes.c_int), runtime.value("kc", ctypes.c_int),
                  runtime.value("tile", ctypes.c_int), runtime.value("stride", ctypes.c_int),
                  runtime.value("vec", ctypes.c_int), runtime.value("table", ctypes.c_int)))


def launch_round(z, weights, base, out, *, mode, levels, sharpen, beta_val, beta_source,
                 layout=None) -> None:
    """One launch of ``csrc/fused_round.cu`` over contiguous operands in
    ``layout`` (as :func:`launch_plan` takes it).  Counts no launch:
    :func:`fused_round` does."""
    K, m, N = z.shape
    tl = _resolve_layout(layout, K, N)
    kc, tile = tl or (0, 0)
    vec = _vec(z, tile) if tl else 1
    runtime.launch("fused_round", "fused_round_launch",
                   launch_plan(z, weights, base, out, beta_source, layout, levels), z, weights,
                   base, out, ctypes.c_int(K), ctypes.c_longlong(m), ctypes.c_int(N),
                   ctypes.c_int(_MODE_ID[mode]), ctypes.c_float(levels),
                   ctypes.c_int(int(sharpen)), ctypes.c_float(beta_val),
                   ctypes.c_int(0 if tl else 1), ctypes.c_int(kc), ctypes.c_int(tile),
                   ctypes.c_int(_stride(tile, N, vec) if tl else 0), ctypes.c_int(vec),
                   ctypes.c_int(_table(levels) if tl else 0))


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
    launch_round(z, weights, base, out, mode=mode, levels=levels, sharpen=sharpen,
                 beta_val=beta_val, beta_source=beta_source)
    fused_round.launches += 1
    return out


fused_round.launches = 0


def analysis_cases():
    """(label, fn, args) triples for the launch-plan lint
    (:mod:`repro_torch.analysis.launch_checks`), ``args`` as (shape,
    dtype) pairs made on the fake card: the reference's cases
    (``repro.kernels.round_kernel.analysis_cases``), then the slice's
    (100, 1000, 10) stack through delta+quant8 as the fused device engine
    launches it, then each other layout: 130 classes (the pair's row in
    the slab), K = 1000 in chunks with one row, and 700 classes (the rows
    layout)."""
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
        ("round/quant8-sharpen-K100-M1001-N130",
         lambda z, w: fused_round(z, w, 1.5, mode="quant", bits=8, sharpen=True),
         (((100, 1001, 130), f32), ((100,), f32))),
        ("round/delta8-sharpen-K1000-M1000-N10",
         lambda z, w, b: fused_round(z, w, 1.5, b, mode="delta", bits=8, sharpen=True),
         (((1000, 1000, 10), f32), ((1000,), f32), ((1000, 10), f32))),
        ("round/identity-sharpen-K40-M3-N700",
         lambda z, w: fused_round(z, w, 1.5, mode="identity", sharpen=True),
         (((40, 3, 700), f32), ((40,), f32))),
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
