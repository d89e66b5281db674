"""Flash attention forward (causal, GQA, sliding window): CUDA kernel and
its plain PyTorch version.

Port of ``repro.kernels.attn_kernel.flash_attention`` (the Pallas
``_flash_kernel``, ``src/repro/kernels/attn_kernel.py:80``, its
``pallas_call`` at ``:113``).  The kernel source is ``csrc/flash_attn.cu``;
its header says what bounds it on the card and how the tiles are laid out.
:func:`flash_attention` takes the plain version for a CPU tensor and
launches the kernel for a CUDA tensor; there is no other path.

- Head dims: every positive multiple of 8 (what the routing admits,
  ``models/common.flash_eligible``): the instantiations of HEAD_DIMS
  (F32_HEAD_DIMS in float32) on tiles zero past d, and column blocks of
  COL_BLOCK (F32_COL_BLOCK) output columns past the largest
  (:func:`instantiation`).
- bfloat16 (the model path: whisper's decoder self-attention): a Hopper
  kernel, a block of one consumer warpgroup (64 query rows) and one
  producer warp that keeps TMA loads of 64-key tiles of k and v in flight
  in a ring of shared-memory stages (4 at D = 32, 2 at D = 64 and 128);
  ``wgmma`` computes q.k and p.v.  The reference computes p.v in float32,
  so each probability is split exactly into three bf16 pieces and the
  three products accumulate in float32: the arithmetic stays float32 to
  rounding at three times p.v's tensor work, which stays under the
  function's byte bound.
- float32 (the reduced whisper; no model path at full width): a Hopper
  kernel of the same block shape, D = 32 or 64 output columns a block
  (column blocks of 64 past 64), that does both products on the tensor
  cores in tf32, each factor split into
  a tf32 high part and a tf32 low part (truncations) and each product
  taken as lo.hi + hi.lo + hi.hi (3xTF32), so the arithmetic stays float32
  to about 2^-21 of each product.  TMA loads 64 x 32-float boxes (one
  128-byte swizzled row each): per key tile the chunks of q and k that
  q.k runs over, 32 columns an item, then v's block columns; the
  consumers split each chunk in shared memory, and write each v tile
  transposed (wgmma's tf32 form reads its operands K-major only), its
  keys permuted so that p stays in registers as the A operand.
- TMA reads a view in place only if it starts on a 16-byte boundary and
  its strides are multiples of 16 bytes: :func:`_readable` copies any
  other view, in both dtypes.

Training goes through :func:`flash_attention_diff`, the counterpart of
the reference's ``flash_attention_diff`` (``attn_kernel.py:166-212``): a
``torch.autograd.Function`` whose forward is :func:`flash_attention` (the
kernel on the card, the plain version on the CPU) and whose backward is
the reference's recompute (:func:`flash_attention_bwd_plain`, plain
PyTorch, as the reference's is jnp).  The bare :func:`flash_attention`
raises on the card when autograd would need a gradient through it
(``runtime.forward_only``): its result would be cut from the graph.

Both follow the oracle ``repro.kernels.ref.flash_attention``: scores
``q . k`` in float32 scaled by ``1/sqrt(d)`` (the Pallas kernel scales q
before the product, the oracle divides the scores, the kernels fold the
scale into an exp2; they differ at float32 rounding), masked keys
excluded, softmax in float32, the output cast to q's type.  A query row
that no key is left to (only possible with a window) gets the oracle's
softmax of equal scores: the mean of v over all Sk keys.
"""
from __future__ import annotations

import ctypes
import math
import os
import re
import subprocess

import torch

from repro_torch.kernels import runtime

__all__ = ["flash_attention", "flash_attention_plain", "flash_attention_diff",
           "flash_attention_bwd_plain", "HEAD_DIMS", "COL_BLOCK",
           "F32_HEAD_DIMS", "F32_COL_BLOCK", "BF16_KERNELS", "F32_KERNELS", "instantiation",
           "launch_plan", "smem_bytes", "sass_opcodes", "analysis_cases"]

# The kernels' head-dim instantiations (csrc/flash_attn.cu).  bfloat16: D
# in HEAD_DIMS serves every d % 8 == 0 in (the previous D, D], on tiles
# zero past d: 8-32 take D = 32, 40-64 take 64, 72-128 take 128.  Past 128
# a block owns COL_BLOCK output columns (column blocks on the grid) and
# takes q.k over the whole d in chunks: flash_fwd_wgmma_cols_kernel<COL_BLOCK>.
# float32: q.k runs over d in 32-column chunks for every d, and a block
# owns D of F32_HEAD_DIMS output columns, D = 32 up to d = 32, else
# F32_COL_BLOCK = 64 in column blocks past 64 (measured faster at d = 96
# than D = 128, which fits one block a multiprocessor: PERF.md).  No d %
# 8 == 0 is refused.
HEAD_DIMS = (32, 64, 128)
COL_BLOCK = 128
F32_HEAD_DIMS = (32, 64)
F32_COL_BLOCK = 64
# The kernels the library holds, all wgmma + TMA kernels.
BF16_KERNELS = tuple(f"flash_fwd_wgmma_kernel<{D}>" for D in HEAD_DIMS) + (
    f"flash_fwd_wgmma_cols_kernel<{COL_BLOCK}>",)
F32_KERNELS = tuple(f"flash_fwd_tf32_kernel<{D}>" for D in F32_HEAD_DIMS)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# The kernels' tiling (csrc/flash_attn.cu): a consumer warpgroup and a
# producer warp (160 threads) per 64 query rows and 64-key tiles in both
# dtypes.  bfloat16: its q tile and STAGES[D] stages of a k and a v tile
# (128 * D bytes each) in dynamic shared memory, with 1 KB to align them
# and 8 bytes per mbarrier; its column-block kernel COL_STAGES stages of
# two 64 x 64 boxes (16 KB), the same alignment and barriers.  float32:
# F32_STAGES[D] stages of two 64 x 32-float boxes (16 KB: a q and a k
# chunk, or v's D columns), 16 KB for the low parts of a q and a k chunk,
# v^T's high and low parts (64 keys x D floats each), 16 bytes a stage for
# its two mbarriers and the same 1 KB.
THREADS = {torch.float32: 160, torch.bfloat16: 160}
BLOCK_Q = {torch.float32: 64, torch.bfloat16: 64}
BLOCK_K = {torch.float32: 64, torch.bfloat16: 64}
STAGES = {32: 4, 64: 2, 128: 2}
COL_STAGES = 4
F32_STAGES = {32: 4, 64: 3}
_F32_STAGE_BYTES = 2 * 64 * 32 * 4
# The widest access the kernels make to q, k, v and o: TMA's, which needs
# a 16-byte aligned start and strides that are multiples of 16 bytes.
_VECTOR_BYTES = {torch.float32: 16, torch.bfloat16: 16}


def instantiation(d: int, dtype: torch.dtype) -> int:
    """The instantiation that serves head dim ``d`` in ``dtype``: the
    smallest of HEAD_DIMS (F32_HEAD_DIMS in float32) at or above ``d``, or
    0 past the largest (column blocks of COL_BLOCK, F32_COL_BLOCK)."""
    dims = F32_HEAD_DIMS if dtype == torch.float32 else HEAD_DIMS
    return next((D for D in dims if d <= D), 0)


def _col_block(dtype: torch.dtype) -> int:
    return F32_COL_BLOCK if dtype == torch.float32 else COL_BLOCK


def _col_blocks(d: int, dtype: torch.dtype) -> int:
    """Column blocks on the grid: one up to the largest instantiation."""
    return runtime.cdiv(d, _col_block(dtype)) if instantiation(d, dtype) == 0 else 1


def smem_bytes(dtype: torch.dtype, d: int) -> int:
    """The dynamic shared memory of the kernel for ``dtype`` at head dim
    ``d`` (the C launchers refuse a plan with less)."""
    D = instantiation(d, dtype) or _col_block(dtype)
    if dtype == torch.float32:
        stages = F32_STAGES[D]
        return 1024 + _F32_STAGE_BYTES * (stages + 1) + 2 * 4 * BLOCK_K[dtype] * D + 16 * stages
    if instantiation(d, dtype) == 0:
        return 1024 + 2 * (BLOCK_Q[dtype] * 128) * COL_STAGES + 8 * 2 * COL_STAGES
    tiles = 1 + 2 * STAGES[D]
    return 1024 + 2 * BLOCK_Q[dtype] * D * tiles + 8 * tiles


def _mask(Sq: int, Sk: int, causal: bool, window: int, device) -> torch.Tensor:
    """The (Sq, Sk) keys each query keeps: j <= i if causal, j > i -
    window for a nonzero window."""
    qpos = torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    return mask


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, Sq, H, d), k and v (B, Sk, Hkv, d) -> (B, Sq, H, d) in q's
    type, in the oracle's order of operations."""
    _B, Sq, H, dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    kr = k.repeat_interleave(H // Hkv, dim=2).float()
    vr = v.repeat_interleave(H // Hkv, dim=2).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr)
    s = s / torch.sqrt(torch.tensor(float(dh), device=q.device))
    s = torch.where(_mask(Sq, Sk, causal, window, q.device), s,
                    torch.full((), -1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vr).to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (B, Sq, H, d) and k, v (B, Sk, Hkv, d), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, _Sq, H, d = q.shape
    Bk, Sk, Hkv, dk = k.shape
    if Bk != B or dk != d or Hkv < 1 or H % Hkv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree on "
                         "batch or head dim, or H is not a multiple of Hkv")
    if Sk < 1:
        raise ValueError("need at least one key")
    if not isinstance(window, int):
        raise TypeError(f"window must be an int, got {type(window).__name__}")
    if not (q.device == k.device == v.device and q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k and v must share device and dtype")


def _readable(t: torch.Tensor) -> torch.Tensor:
    """``t`` if the kernels, which read through TMA, can read it in place
    (d contiguous, a 16-byte aligned start and the strides of every axis
    longer than 1 positive multiples of 16 bytes: an expanded axis is
    copied too), else a contiguous copy.  The start's alignment is
    ``storage_offset()`` elements past the storage's, which PyTorch's
    caching allocator places on a boundary of at least 256 bytes."""
    vb, isz = _VECTOR_BYTES[t.dtype], t.element_size()
    ok = (t.stride(-1) == 1 and t.storage_offset() * isz % vb == 0
          and all(st > 0 and st * isz % vb == 0
                  for n, st in zip(t.shape[:3], t.stride()[:3]) if n > 1))
    return t if ok else t.clone(memory_format=torch.contiguous_format)


def _strides(t: torch.Tensor) -> tuple:
    """The element strides of ``t``'s batch, sequence and head axes as the
    kernels take them; an axis of length 1 gets its contiguous stride (its
    own stride is never multiplied by more than 0, but a tensor map needs
    every stride a multiple of 16 bytes)."""
    B, S, H, d = t.shape
    contiguous = (S * H * d, H * d, d)
    return tuple(st if n > 1 else c for n, st, c in zip((B, S, H), t.stride()[:3], contiguous))


def launch_plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                out: torch.Tensor) -> runtime.LaunchPlan:
    """The launch of ``csrc/flash_attn.cu``: a block per (head, batch row,
    query tile of BLOCK_Q rows), the tiles walked from the last so the
    longest causal tiles of every head start first, and past the largest
    instantiation per column block (folded into the head axis), with its
    dynamic shared memory (:func:`smem_bytes`), opted in above 48 KB."""
    B, Sq, H, d = q.shape
    smem = smem_bytes(q.dtype, d)
    tiles = runtime.cdiv(Sq, BLOCK_Q[q.dtype])
    D, nb = instantiation(d, q.dtype), _col_blocks(d, q.dtype)
    if q.dtype == torch.float32:
        name = f"flash_fwd_tf32_kernel<{D or F32_COL_BLOCK}>"
    else:
        name = f"flash_fwd_wgmma_kernel<{D}>" if D else BF16_KERNELS[-1]
    return runtime.LaunchPlan(
        name, grid=(H * nb, B, tiles),
        block=(THREADS[q.dtype], 1, 1),
        dyn_smem=smem, smem_optin=smem > runtime.HOPPER.smem_per_block,
        operands=tuple(runtime.ptr(n, t, _VECTOR_BYTES[q.dtype])
                       for n, t in (("q", q), ("k", k), ("v", v), ("o", out)))
        + tuple(runtime.value(n, ctypes.c_int)
                for n in ("dtype", "d", "batch", "sq", "sk", "heads", "kv_heads", "causal",
                          "window"))
        + (runtime.value("strides", ctypes.c_longlong * 9),))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, Sq, H, d), k and v (B, Sk, Hkv, d), float32 or bfloat16 ->
    (B, Sq, H, d) in q's type.  Query head h reads KV head
    ``h // (H // Hkv)``; ``causal`` keeps keys j <= i, a nonzero
    ``window`` keeps keys j > i - window.  ``Sq != Sk`` is allowed."""
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, window)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    runtime.forward_only("flash_attention", q, k, v,
                         hint="use flash_attention_diff for a differentiable result")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"the kernel takes float32 or bfloat16, got {q.dtype}")
    B, Sq, H, d = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if d < 8 or d % 8:
        raise ValueError(f"head dim {d} is not a positive multiple of 8 (the kernels take "
                         "d % 8 == 0, as the routing admits)")
    q, k, v = (_readable(t) for t in (q, k, v))
    out = torch.empty((B, Sq, H, d), dtype=q.dtype, device=q.device)
    if B == 0 or Sq == 0:
        return out
    strides = (ctypes.c_longlong * 9)(*_strides(q), *_strides(k), *_strides(v))
    ints = (_DTYPE_CODE[q.dtype], d, B, Sq, Sk, H, Hkv, int(causal), window)
    runtime.launch("flash_attn", "flash_attn_launch", launch_plan(q, k, v, out), q, k, v, out,
                   *(ctypes.c_int(i) for i in ints), strides)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              do: torch.Tensor, causal: bool = True, window: int = 0):
    """(dq, dk, dv) of :func:`flash_attention` for the output gradient
    ``do`` (B, Sq, H, d): the reference's recompute (``_flash_bwd``,
    ``attn_kernel.py:179-209``).  Float32 scores q.k / sqrt(d) over the
    keys repeated onto the H query heads, masked to -1e30, softmax, then
    dV = P^T dO, dP = dO V^T, delta = rowsum(P dP), dS = P (dP - delta)
    / sqrt(d), dQ = dS K, dK = dS^T Q; dk and dv summed back onto the Hkv
    heads, each cast to its input's type."""
    B, Sq, H, d = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    kr = k.repeat_interleave(rep, dim=2).float()
    vr = v.repeat_interleave(rep, dim=2).float()
    qf = q.float()
    scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kr) * scale
    s = torch.where(_mask(Sq, Sk, causal, window, q.device), s,
                    torch.full((), -1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    dof = do.float()
    dv_r = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vr)
    delta = (p * dp).sum(-1, keepdim=True)
    ds = p * (dp - delta) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kr)
    dk_r = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dk = dk_r.reshape(B, Sk, Hkv, rep, d).sum(3)
    dv = dv_r.reshape(B, Sk, Hkv, rep, d).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashDiff(torch.autograd.Function):
    """Forward :func:`flash_attention` (run with grad mode off, so the
    kernel launches on the card), backward :func:`flash_attention_bwd_plain`
    from the saved (q, k, v)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return flash_attention(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        return (*flash_attention_bwd_plain(q, k, v, do, ctx.causal, ctx.window), None, None)


def flash_attention_diff(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, window: int = 0) -> torch.Tensor:
    """:func:`flash_attention` that autograd differentiates: the kernel's
    forward (counted as one launch), the reference's recompute backward.
    Under activation checkpointing the forward runs again in the
    recompute, a second launch."""
    _check(q, k, v, window)
    return _FlashDiff.apply(q, k, v, causal, window)


# The instructions that say which kernel the card runs: HGMMA (wgmma),
# UTMALDG / UTMASTG (TMA loads and stores), HMMA (mma.sync), MUFU.EX2 (the
# softmax's exp2) and F2FP (float-to-bf16 conversions).
SASS_OPCODES = ("HGMMA", "UTMALDG", "UTMASTG", "HMMA", "MUFU.EX2", "F2FP")


def sass_opcodes() -> dict:
    """{kernel: {opcode: count}} over the built ``flash_attn`` library's
    machine code (``cuobjdump -sass`` from the CUDA toolkit beside
    ``nvcc``), each kernel named as its launch plan names it.  Builds the
    library first; needs the toolkit, not a card."""
    runtime.load("flash_attn")
    cuobjdump = os.path.join(os.path.dirname(runtime.nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(runtime._lib_path("flash_attn"))],
                          capture_output=True, text=True, check=True, timeout=120).stdout
    out = {}
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        m = re.search(r"(flash_fwd_\w*?kernel)ILi(\d+)E", fn.split("\n", 1)[0])
        if m:
            out[f"{m.group(1)}<{m.group(2)}>"] = {
                op: len(re.findall(r"\b" + re.escape(op) + r"\b", fn)) for op in SASS_OPCODES}
    return out


def analysis_cases():
    """(label, fn, args) triples for the launch-plan lint
    (:mod:`repro_torch.analysis.launch_checks`), ``args`` as (shape,
    dtype) pairs made on the fake card: the reference's cases
    (``repro.kernels.attn_kernel.analysis_cases``), then whisper-large-v3's
    decoder self-attention as the prefill launches it, (4, 384, 20, 64)
    bfloat16, causal, d = 128 in float32, the bfloat16 kernel at d = 32
    (GQA) and d = 128 (a key range that wraps the stage ring 16 times);
    then head dims between and past the instantiations, d = 96 (bf16: D =
    128 on zero-filled tiles; float32: two column blocks of 64) and d =
    256 (two column blocks of 128 in bf16, four of 64 in float32), in both
    dtypes; then the float32 kernel's edges: d = 8 (D = 32 on one partial
    chunk), d = 64 at whisper's decoder shape (the reduced whisper's and
    phase 6's float32 shape), d = 136 (three column blocks, the last with
    one of its two 32-column boxes of v in d).  Every float32 plan opts in
    above 48 KB."""
    f32, bf16 = torch.float32, torch.bfloat16

    def case(B, Sq, Sk, H, Hkv, d, dtype=f32, **kw):
        return (lambda q, k, v: flash_attention(q, k, v, **kw),
                (((B, Sq, H, d), dtype), ((B, Sk, Hkv, d), dtype), ((B, Sk, Hkv, d), dtype)))

    return [
        ("attn/S128-gqa-d64", *case(2, 128, 128, 4, 2, 64)),
        ("attn/small-Sq4", *case(1, 4, 4, 2, 2, 64)),
        ("attn/odd-S100-window", *case(1, 100, 100, 2, 1, 64, window=7)),
        ("attn/bf16-S64", *case(1, 64, 64, 2, 2, 64, dtype=bf16)),
        ("attn/whisper-B4-S384-H20-d64-bf16", *case(4, 384, 384, 20, 20, 64, dtype=bf16)),
        ("attn/S256-d128-f32", *case(1, 256, 256, 4, 4, 128)),
        ("attn/bf16-gqa-d32", *case(2, 130, 130, 4, 2, 32, dtype=bf16, window=7)),
        ("attn/bf16-S2048-d128", *case(1, 2048, 2048, 4, 1, 128, dtype=bf16)),
        ("attn/d96-f32", *case(1, 130, 130, 4, 2, 96)),
        ("attn/bf16-d96", *case(1, 130, 130, 4, 2, 96, dtype=bf16)),
        ("attn/d256-f32", *case(1, 200, 200, 2, 1, 256, window=64)),
        ("attn/bf16-d256", *case(1, 200, 200, 2, 1, 256, dtype=bf16, window=64)),
        ("attn/f32-d8", *case(1, 130, 130, 2, 1, 8)),
        ("attn/f32-B4-S384-H20-d64", *case(4, 384, 384, 20, 20, 64)),
        ("attn/f32-d136-window", *case(1, 200, 200, 4, 1, 136, window=33)),
    ]
