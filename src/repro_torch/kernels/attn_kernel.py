"""Flash attention forward (causal, GQA, sliding window): CUDA kernel and
its plain PyTorch version.

Port of ``repro.kernels.attn_kernel.flash_attention`` (the Pallas
``_flash_kernel``).  The kernel source is ``csrc/flash_attn.cu``: a
tensor-core kernel for bfloat16 inputs and an FMA kernel for float32,
both with float32 arithmetic; its header says what bounds them on the
card and how the tiles are laid out.  :func:`flash_attention` takes the
plain version for a CPU tensor and launches the kernel for a CUDA
tensor; there is no other path.

Both follow the oracle ``repro.kernels.ref.flash_attention``: scores
``q . k`` in float32 divided by ``sqrt(d)`` (the Pallas kernel scales q
before the product instead, which differs at float32 rounding), masked
keys excluded, softmax in float32, the output cast to q's type.  A query
row that no key is left to (only possible with a window) gets the
oracle's softmax of equal scores: the mean of v over all Sk keys.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import runtime

__all__ = ["flash_attention", "flash_attention_plain", "HEAD_DIMS", "launch_plan",
           "analysis_cases"]

# Head dims the kernel is instantiated for (csrc/flash_attn.cu).
HEAD_DIMS = (32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# The kernels' tiling (csrc/flash_attn.cu kThreads, kBQ, kBK): a block of
# 128 threads per 64 query rows; the float32 kernel stages 64 keys of k
# (rows padded to d + 4 floats) and of v in dynamic shared memory, and at
# d = 128 also its 64 rows of q (padded to d + 4), which in registers
# would spill.
THREADS = 128
BLOCK_Q = 64
BLOCK_K = 64
# The widest access the kernels make to q, k, v and o: bfloat16 in pairs,
# float32 one value at a time; 4 bytes either way.
_VECTOR_BYTES = 4


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
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, torch.full((), -1e30, device=q.device))
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
    """``t`` if the kernel can read it in place (d contiguous; for
    bfloat16, which the kernel reads in pairs, even strides and a 4-byte
    aligned start), else a contiguous copy.  The start's alignment is
    ``storage_offset() * 2`` bytes past the storage's, which PyTorch's
    caching allocator places on a boundary of at least 256 bytes."""
    ok = t.stride(-1) == 1
    if t.dtype == torch.bfloat16:
        ok = (ok and t.storage_offset() * t.element_size() % 4 == 0
              and all(st % 2 == 0 for st in t.stride()[:3]))
    return t if ok else t.clone(memory_format=torch.contiguous_format)


def launch_plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                out: torch.Tensor) -> runtime.LaunchPlan:
    """The launch of ``csrc/flash_attn.cu``: a block per (query tile of
    BLOCK_Q rows, head, batch row); bfloat16 on the tensor-core kernel
    (static shared memory only), float32 on the FMA kernel with its k and v
    tiles (at d = 128 with its q rows) in dynamic shared memory, opted in
    above 48 KB (d = 128)."""
    B, Sq, H, d = q.shape
    f32 = q.dtype == torch.float32
    q_rows = BLOCK_Q * (d + 4) if d > 64 else 0
    smem = 4 * (BLOCK_K * (2 * d + 4) + q_rows) if f32 else 0
    return runtime.LaunchPlan(
        f"flash_fwd_{'' if f32 else 'mma_'}kernel<{d}>",
        grid=(runtime.cdiv(Sq, BLOCK_Q), H, B), block=(THREADS, 1, 1), dyn_smem=smem,
        smem_optin=smem > runtime.HOPPER.smem_per_block,
        operands=tuple(runtime.ptr(n, t, _VECTOR_BYTES)
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
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"the kernel takes float32 or bfloat16, got {q.dtype}")
    B, Sq, H, d = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} is not one of the kernel's {HEAD_DIMS}")
    q, k, v = (_readable(t) for t in (q, k, v))
    out = torch.empty((B, Sq, H, d), dtype=q.dtype, device=q.device)
    if B == 0 or Sq == 0:
        return out
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3],
                                      *v.stride()[:3])
    ints = (_DTYPE_CODE[q.dtype], d, B, Sq, Sk, H, Hkv, int(causal), window)
    runtime.launch("flash_attn", "flash_attn_launch", launch_plan(q, k, v, out), q, k, v, out,
                   *(ctypes.c_int(i) for i in ints), strides)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def analysis_cases():
    """(label, fn, args) triples for the launch-plan lint
    (:mod:`repro_torch.analysis.launch_checks`), ``args`` as (shape,
    dtype) pairs made on the fake card: the reference's cases
    (``repro.kernels.attn_kernel.analysis_cases``), then whisper-large-v3's
    decoder self-attention as the prefill launches it, (4, 384, 20, 64)
    bfloat16, causal, and d = 128 in float32, the one plan that opts in to
    more than 48 KB."""
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
    ]
