"""Shared model machinery of the port (the subset of
``repro.models.common`` that the ported models run): parameter
initialisation with the reference's scales, activation checkpointing
(``remat_wrap``), the next-token cross-entropy, RMS norm, softcapping, the
logits dtype, RoPE, attention with the reference's routing to the flash
kernel, SwiGLU and the sort-based token-choice MoE FFN, with its
expert-parallel all-to-all branch (``MOE_A2A_MESH``, ``models/moe_a2a.py``)
and its dispatch buffer's sharding pin (``MOE_DISPATCH_SPEC``).  The
model code also runs on DTensors (the dry run, ``launch/dryrun.py``):
attention then runs on each rank's shard (the flash kernel where
eligible), and so does the per-row body of a model (``on_batch_rows``).

Parameters are nested dicts of tensors in the reference's layout (per
layer weights stacked on a leading layer axis), so the JAX package's
parameter trees carry across one to one (``models/convert.py``).
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.kernels import ops

Params = Dict[str, Any]
# name -> (shape, scale or None, init) or a nested dict of the same
Specs = Dict[str, Any]

# The reference's switch for the expert-parallel MoE (``common.py:28``): a
# ``launch.mesh.Mesh`` with a "data" axis sends ``moe_ffn`` through
# ``moe_a2a.moe_ffn_a2a`` on every rank of it; None runs the single-device
# dispatch.
MOE_A2A_MESH = None

# The reference's pin of the MoE dispatch buffer's sharding
# (``common.py:24``): a spec of the (E, C, D) buffer, one entry a dim
# (None, a mesh axis name or a tuple of names), e.g. ("data", None,
# "model").  When the buffer is a DTensor, ``moe_ffn`` redistributes it to
# that spec's placements (``with_sharding_constraint``'s counterpart);
# otherwise it does nothing.
MOE_DISPATCH_SPEC = None


def spec(shape: Tuple[int, ...], scale: Optional[float] = None,
         init: str = "normal") -> Tuple[Tuple[int, ...], Optional[float], str]:
    """One parameter: ``init`` is "normal" (times ``scale``; by default
    ``1/sqrt(shape[-2])``, the reference's fan-in rule), "zeros" or
    "ones"."""
    return tuple(shape), scale, init


def init_params(specs: Specs, generator: torch.Generator, dtype: torch.dtype,
                device: torch.device) -> Params:
    """Draw every parameter of ``specs`` in order from ``generator`` (on
    the generator's device), as the reference's ``Builder`` scales them:
    a float32 standard normal times the scale, cast to ``dtype``.

    The fan-in of a normal parameter is ``shape[-2]`` as in the reference
    (``Builder.param``), which for a stacked ``(L, D, H, dh)`` projection
    is H, not D."""
    out: Params = {}
    for name, s in specs.items():
        if isinstance(s, dict):
            out[name] = init_params(s, generator, dtype, device)
            continue
        shape, scale, init = s
        if init in ("zeros", "ones"):
            out[name] = (torch.zeros if init == "zeros" else torch.ones)(
                shape, dtype=dtype, device=device)
            continue
        if scale is None:
            scale = fan_in_scale(shape)
        val = torch.randn(shape, generator=generator, device=generator.device,
                          dtype=torch.float32) * scale
        out[name] = val.to(device=device, dtype=dtype)
    return out


def fan_in_scale(shape: Tuple[int, ...]) -> float:
    """The reference's default scale of a normal parameter:
    ``1/sqrt(shape[-2])`` (``shape[-1]`` for a vector)."""
    return 1.0 / math.sqrt(shape[-2] if len(shape) >= 2 else shape[-1])


def tree_map(fn, params: Params, *rest: Params) -> Params:
    """``fn`` applied to every tensor of a nested parameter dict (e.g.
    ``tree_map(lambda t: t.to("cuda"), params)``), with the matching
    leaves of each of ``rest`` (dicts of the same structure) as further
    arguments."""
    return {n: tree_map(fn, t, *(r[n] for r in rest)) if isinstance(t, dict)
            else fn(t, *(r[n] for r in rest)) for n, t in params.items()}


def first_leaf(params: Params) -> Any:
    """The first leaf of a nested dict, in its order."""
    while isinstance(params, dict):
        params = params[next(iter(params))]
    return params


def n_params(params: Params) -> int:
    return sum(n_params(t) if isinstance(t, dict) else t.numel() for t in params.values())


def _unbind(stacked: Params) -> Dict[str, Any]:
    return {n: _unbind(w) if isinstance(w, dict) else w.unbind(0) for n, w in stacked.items()}


def _pick(parts: Dict[str, Any], i: int) -> Params:
    return {n: _pick(w, i) if isinstance(w, dict) else w[i] for n, w in parts.items()}


def layers(stacked: Params):
    """Every layer's views of weights stacked on a leading layer axis
    (nested dicts included), taken by one ``unbind`` a leaf: autograd then
    stacks the layers' gradients once, where a view a layer (``w[i]``)
    has its backward write a zero gradient of the whole stack for every
    layer and add them up (L times the stack's bytes)."""
    parts = _unbind(stacked)
    for i in range(len(first_leaf(parts))):
        yield _pick(parts, i)


def position(pos: Union[torch.Tensor, int], device: torch.device) -> torch.Tensor:
    """A decode step's ``pos`` as a (1,) int64 index on ``device``: a fill
    for a Python int, a reshape of a device tensor (no host-to-device
    copy, no sync)."""
    if isinstance(pos, torch.Tensor):
        return pos.reshape(1).to(torch.int64)
    return torch.full((1,), pos, dtype=torch.int64, device=device)


# The matrix products whose outputs each selective policy saves (the
# counterparts of jax.checkpoint_policies.dots_saveable and
# dots_with_no_batch_dims_saveable); everything else is recomputed.
_aten = torch.ops.aten
_SAVED_PRODUCTS = {
    "dots_saveable": {_aten.mm.default, _aten.addmm.default, _aten.bmm.default},
    "dots_with_no_batch_dims_saveable": {_aten.mm.default, _aten.addmm.default},
}


def remat_wrap(body, policy_name: str):
    """``body`` under activation checkpointing with the reference's named
    policy (``remat_wrap``, ``jax.checkpoint``): "none" is ``body``
    itself; "nothing_saveable" saves only the inputs and recomputes the
    whole body in the backward; "dots_saveable" also saves the outputs of
    the matrix products (``mm``, ``addmm``, ``bmm``),
    "dots_with_no_batch_dims_saveable" those of ``mm`` and ``addmm``.  A
    flash attention inside the body launches again in the recompute."""
    if policy_name == "none":
        return body
    if policy_name == "nothing_saveable":
        return functools.partial(checkpoint, body, use_reentrant=False)
    saved = _SAVED_PRODUCTS[policy_name]

    def policy(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in saved else CheckpointPolicy.PREFER_RECOMPUTE

    return functools.partial(
        checkpoint, body, use_reentrant=False,
        context_fn=functools.partial(create_selective_checkpoint_contexts, policy))


def next_token_ce(cfg, logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of position t's logits against label t + 1,
    float32.  ``cfg.ce_impl`` "logp" takes the float32 log-softmax;
    "lse" takes logsumexp minus the picked logit (no (B, S, V) float32
    log-probabilities)."""
    l32 = logits[:, :-1].float()
    labels = labels[:, 1:].long()

    def picked(x):  # x[b, s, labels[b, s]]; nll_loss's rule keeps a sharded batch
        return -F.nll_loss(x.flatten(0, 1), labels.flatten(), reduction="none").view(labels.shape)

    if cfg.ce_impl == "lse":
        nll = torch.logsumexp(l32, dim=-1) - picked(l32)
    else:
        nll = -picked(torch.log_softmax(l32, dim=-1))
    return shard_batch(nll).mean()


def dtype_of(name: str) -> torch.dtype:
    return getattr(torch, name)


def logits_dtype(cfg) -> torch.dtype:
    return torch.float32 if cfg.fp32_logits else dtype_of(cfg.compute_dtype)


def embed(table: torch.Tensor, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The rows of ``table`` (V, D) at ``tokens``, in ``dtype``: the
    embedding lookup.  A DTensor table is gathered whole first (a
    vocab-sharded lookup leaves partial rows whose mask DTensor keeps only
    until the next op) and the rows come out batch sharded
    (:func:`shard_batch`)."""
    if is_dtensor(table):
        from torch.distributed.tensor import Replicate

        table = table.redistribute(table.device_mesh, [Replicate()] * table.device_mesh.ndim)
    return shard_batch(F.embedding(tokens.long(), table)).to(dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Normalise in float32 and scale by ``1 + weight``, back in x's type."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * (1.0 + weight.float())).to(dt)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """``cap * tanh(x / cap)``; ``x`` itself for a zero cap."""
    return cap * torch.tanh(x / cap) if cap else x


def rope_freqs(dh: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32, device=device) / dh))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split (not interleaved) rotary embedding of x (B, S, H, dh) at
    ``positions`` (S,) or (B, S), with float32 angles; back in x's type."""
    dh = x.shape[-1]
    ang = positions[..., None].float() * rope_freqs(dh, theta, x.device)
    if ang.dim() == 2:  # (S, dh/2): the same positions for every row
        ang = ang[None]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def flash_eligible(q: torch.Tensor, k: torch.Tensor, causal: bool,
                   q_offset: Union[torch.Tensor, int] = 0,
                   kv_len: Union[torch.Tensor, int, None] = None,
                   window: Union[torch.Tensor, int] = 0, cap: float = 0.0) -> bool:
    """The reference's test for the flash kernel (``common.attention``
    under ``ATTN_IMPL="pallas"``, ``common.py:185-190``): plain causal
    self-attention without a softcap, a window that is a Python int, a
    sequence that is a multiple of 128, head dim a multiple of 8, no
    KV-length limit and a query offset of 0 as a Python int.  So a decode
    step (``kv_len`` set, a device ``q_offset``) never takes the kernel,
    nor does a softcapped layer (gemma2)."""
    Sq, dh = q.shape[1], q.shape[3]
    return (causal and not cap and kv_len is None and isinstance(q_offset, int)
            and q_offset == 0 and isinstance(window, int) and Sq == k.shape[1]
            and Sq % 128 == 0 and dh % 8 == 0)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0, cap: float = 0.0,
              q_offset: Union[torch.Tensor, int] = 0,
              kv_len: Union[torch.Tensor, int, None] = None,
              chunk_q: int = 0, score_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Grouped-query attention, q (B, Sq, H, dh), k and v (B, Sk, Hkv, dh).

    The query rows sit at positions ``q_offset + arange(Sq)`` (for the
    causal mask and the window); ``kv_len`` keeps the keys at positions
    below it (the valid prefix of a decode cache).  Each may be a Python
    int or a 0-d integer tensor on q's device, which is read on the device
    only (no host sync).  A positive ``window`` (a Python int) keeps the
    keys j > i - window; ``cap`` softcaps the scores.  An eligible call
    (:func:`flash_eligible`) goes to the flash kernel
    (``ops.flash_attention``, differentiable).  DTensor inputs run on
    each rank's shard (:func:`_sharded_attention`), the flash kernel
    where eligible.
    Otherwise the plain path of the reference: scores in ``score_dtype``
    (float32 by default), softcapped, masked to -1e30, softmax in
    ``score_dtype``, the output cast to q's type; ``chunk_q`` runs the
    query rows in chunks of that size."""
    if is_dtensor(q):
        return _sharded_attention(
            q, k, v, functools.partial(
                attention, causal=causal, window=window, cap=cap, q_offset=_local(q_offset),
                kv_len=_local(kv_len), chunk_q=chunk_q, score_dtype=score_dtype))
    if flash_eligible(q, k, causal, q_offset, kv_len, window, cap):
        return ops.flash_attention(q, k, v, causal=True, **({"window": window} if window else {}))
    B, Sq, H, dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    R = H // Hkv
    qg = q.reshape(B, Sq, Hkv, R, dh)
    scale = 1.0 / math.sqrt(dh)
    ks, vs = k.to(score_dtype), v.to(score_dtype)
    k_pos = torch.arange(Sk, device=q.device)

    def block(q_blk: torch.Tensor, q_pos: torch.Tensor) -> torch.Tensor:
        s = softcap(torch.einsum("bqgrd,bkgd->bgrqk", q_blk.to(score_dtype), ks) * scale, cap)
        mask = torch.ones((q_blk.shape[1], Sk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= k_pos[None, :] <= q_pos[:, None]
        if window > 0:
            mask &= k_pos[None, :] > q_pos[:, None] - window
        if kv_len is not None:
            mask &= k_pos[None, :] < kv_len
        s = torch.where(mask, s, torch.full((), -1e30, dtype=score_dtype, device=q.device))
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bgrqk,bkgd->bqgrd", p, vs).to(q.dtype)

    q_positions = q_offset + torch.arange(Sq, device=q.device)
    if chunk_q and Sq % chunk_q == 0 and Sq > chunk_q:
        out = torch.cat([block(qg[:, i:i + chunk_q], q_positions[i:i + chunk_q])
                         for i in range(0, Sq, chunk_q)], dim=1)
    else:
        out = block(qg, q_positions)
    return out.reshape(B, Sq, H, dh)


def is_dtensor(t) -> bool:
    """Whether ``t`` is a DTensor (a sharded tensor of the dry run)."""
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def zeros_on(like: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    """Zeros of ``shape`` in ``like``'s type and device; for a DTensor
    ``like``, replicated over its mesh (what a plain tensor is to the
    DTensors it meets), so that later ops can shard it."""
    if not is_dtensor(like):
        return torch.zeros(shape, dtype=like.dtype, device=like.device)
    from torch.distributed.tensor import DTensor, Replicate

    mesh = like.device_mesh
    return DTensor.from_local(torch.zeros(shape, dtype=like.dtype, device=like.device),
                              mesh, [Replicate()] * mesh.ndim, run_check=False)


def _batch_placements(mesh, batch: int) -> list:
    """DTensor placements of a tensor whose dim 0 is the batch: sharded
    over ("pod", "data") where it divides, replicated on every other mesh
    dim (the reference's ``batch_spec``)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names or ())
    size = dict(zip(names, mesh.shape))
    out = [Replicate()] * mesh.ndim
    bnames = [n for n in ("pod", "data") if size.get(n, 1) > 1]
    if bnames and batch % math.prod(size[n] for n in bnames) == 0:
        for n in bnames:
            out[names.index(n)] = Shard(0)
    return out


def shard_batch(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself, or for a DTensor, ``x`` redistributed to batch
    sharding (:func:`_batch_placements`): the layout the residual stream
    keeps between layers, and its gradient with it (the counterpart of a
    sharding constraint; left to itself DTensor's op-by-op choice drifts,
    e.g. to the embedding table's sharding)."""
    if not is_dtensor(x):
        return x
    placements = _batch_placements(x.device_mesh, x.shape[0])
    y = x.redistribute(x.device_mesh, placements)
    if y.requires_grad:
        # the gradient takes the same layout (DTensor propagates forward
        # only: a loss's gradient would otherwise spread replicated)
        y.register_hook(lambda g: g.redistribute(g.device_mesh, placements))
    return y


class _ScaleGrad(torch.autograd.Function):
    """The identity forward, its cotangent times ``s`` backward."""

    @staticmethod
    def forward(ctx, x, s):
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


def _local_a2a(a2a, split: bool, x, router, w1, w3, w2):
    """The all-to-all MoE on each rank's shard of DTensor inputs
    (``local_map``), with the reference's ``shard_map`` in_specs: x's rows
    of the batch (:func:`_batch_placements`), the router replicated, the
    stacks sharded over "data" on the expert dim and, where ``split`` (F
    splits over "model", ``moe_a2a.ffn_shard_width``), over "model" on the
    FFN dim, replicated on every other mesh dim.  These are the ep
    scheme's parameter placements, so nothing moves to meet them.  ->
    the rows' output, batch sharded, and the aux loss (the mean over the
    data axis and the pods).

    A replicated output's cotangent reaches every copy, while the body's
    collectives sum cotangents over the ranks (``moe_a2a``'s doc), so the
    body takes 1 / M of the output's cotangent and 1 / (n M) of the aux's.
    Then a rank's gradient of each input is its part of the global one:
    sharded where the input is, a partial sum on every mesh dim where the
    input is replicated (the stacks' over "pod" and an unsplit "model", x's
    over "model", the router's over every dim)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    names = list(mesh.mesh_dim_names)
    size = dict(zip(names, mesh.shape))
    M, n, pods = size.get("model", 1), size["data"], size.get("pod", 1)

    def on(**dims):
        return [dims.get(a, Replicate()) for a in names]

    rows, full = _batch_placements(mesh, x.shape[0]), on()
    w_in = on(data=Shard(0), model=Shard(2) if split else Replicate())
    w_out = on(data=Shard(0), model=Shard(1) if split else Replicate())
    ins = (rows, full, w_in, w_in, w_out)
    grads = tuple([Partial() if isinstance(p, Replicate) else p for p in pl] for pl in ins)

    def body(*args):
        out, aux = a2a(*args)
        return _ScaleGrad.apply(out, 1.0 / M), _ScaleGrad.apply(aux, 1.0 / (n * M)) / pods

    return local_map(body, out_placements=(rows, on(pod=Partial())), in_placements=ins,
                     in_grad_placements=grads, device_mesh=mesh,
                     redistribute_inputs=True)(x, router, w1, w3, w2)


def _flash_placements(q, k):
    """(q's placements, k's and v's, k's and v's gradient placements, the
    local query heads' first KV head as a function of the model rank or
    None) for the flash kernel on each rank's shard: the batch over
    ("pod", "data") where it divides, the query heads over "model" where
    they divide and each rank's heads fall in whole KV groups or whole
    parts of one, the KV heads over "model" where they divide too.  Where
    the query heads are split and the KV heads are not, every rank holds
    all KV heads and its gradient of them is a partial sum."""
    from torch.distributed.tensor import Partial, Shard

    mesh = q.device_mesh
    names = list(mesh.mesh_dim_names or ())
    size = dict(zip(names, mesh.shape))
    H, Hkv = q.shape[2], k.shape[2]
    qp = _batch_placements(mesh, q.shape[0])
    kp = list(qp)
    kgrad, first_kv = list(kp), None
    m = size.get("model", 1)
    if m > 1 and H % m == 0:
        Hl, R = H // m, H // Hkv
        if Hkv % m == 0:
            qp[names.index("model")] = kp[names.index("model")] = Shard(2)
            kgrad = list(kp)
        elif R % Hl == 0 or Hl % R == 0:
            qp[names.index("model")] = Shard(2)
            kgrad[names.index("model")] = Partial()
            first_kv = (lambda r: r * Hl // R, max(Hl // R, 1))
    return qp, kp, kgrad, first_kv


def _local(x):
    """A replicated DTensor scalar (a decode step's position) as this
    rank's tensor; anything else as it is."""
    return x.to_local() if is_dtensor(x) else x


def _sharded_attention(q, k, v, local_attention):
    """``local_attention(q, k, v)`` on each rank's shard of DTensors q, k,
    v (``local_map``): the query and KV shards of
    :func:`_flash_placements`, the output sharded as the queries.  Where
    the query heads are split over "model" and the KV heads are not, a
    rank's query heads ``r Hl .. (r + 1) Hl - 1`` (``Hl = H / model``,
    ``r`` its model coordinate) read KV heads ``h // (H / Hkv)``: the
    local body takes those KV heads, not the first."""
    from torch.distributed.tensor.experimental import local_map

    qp, kp, kgrad, first_kv = _flash_placements(q, k)
    mesh = q.device_mesh

    def body(ql, kl, vl):
        if first_kv is not None:
            at, n = first_kv
            j = at(mesh.get_local_rank("model"))
            kl, vl = kl[:, :, j:j + n], vl[:, :, j:j + n]
        return local_attention(ql, kl, vl)

    return local_map(body, out_placements=qp, in_placements=(qp, kp, kp),
                     in_grad_placements=(qp, kgrad, kgrad), device_mesh=mesh,
                     redistribute_inputs=True)(q, k, v)


def on_batch_rows(fn, rows, shared):
    """``fn(*rows, *shared)`` on each rank's rows of the batch
    (``local_map``): ``rows`` DTensors whose dim 0 is the batch, batch
    sharded (:func:`_batch_placements`) and replicated over every other
    mesh dim, ``shared`` (parameters) replicated; the one output batch
    sharded.  A rank's gradient of a shared input covers its rows alone,
    a partial sum over the batch's mesh dims."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = rows[0].device_mesh
    rp = _batch_placements(mesh, rows[0].shape[0])
    full = [Replicate()] * mesh.ndim
    partial = [Partial() if p.is_shard() else Replicate() for p in rp]
    return local_map(fn, out_placements=rp,
                     in_placements=(rp,) * len(rows) + (full,) * len(shared),
                     in_grad_placements=(rp,) * len(rows) + (partial,) * len(shared),
                     device_mesh=mesh, redistribute_inputs=True)(*rows, *shared)


def project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk")``: x (B, S, D) by w (D, H, dh)."""
    D, H, dh = w.shape
    return (x @ w.reshape(D, H * dh)).reshape(*x.shape[:-1], H, dh)


def project_out(o: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bshk,hkd->bsd")``: o (B, S, H, dh) by w (H, dh, D)."""
    H, dh, D = w.shape
    return o.reshape(*o.shape[:-2], H * dh) @ w.reshape(H * dh, D)


def swiglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """``silu(x w1) * (x w3)``, then by w2; products in the operands' type."""
    return (F.silu(x @ w1) * (x @ w3)) @ w2


def sorted_top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest of each row and their indices, largest first, ties
    to the lower index (``jax.lax.top_k``'s order): a stable descending
    sort, never ``torch.topk``."""
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    return srt.values[..., :k], srt.indices[..., :k]


def moe_capacity(T: int, n_experts: int, top_k: int, capacity_factor: float) -> int:
    """Slots an expert: ``max(ceil(T k / E cf), k)`` rounded up to a
    multiple of 8, as the reference sizes its dispatch buffer."""
    C = max(int(math.ceil(T * top_k / n_experts * capacity_factor)), top_k)
    return (C + 7) // 8 * 8


def moe_route(xt: torch.Tensor, router: torch.Tensor,
              top_k: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Token-choice routing of xt (T, D) over router (D, E): ``(gate,
    eidx, aux)``, each token's top-k experts (T, k) by float32 router
    probabilities with their gates renormalised over the k, and the
    Switch-style load-balance loss of these T tokens (float32)."""
    T, E = xt.shape[0], router.shape[1]
    probs = torch.softmax(xt.float() @ router.float(), dim=-1)
    gate, eidx = sorted_top_k(probs, top_k)
    gate = gate / (gate.sum(-1, keepdim=True) + 1e-9)
    assign = torch.zeros((T, E), dtype=torch.float32, device=xt.device)
    assign.scatter_add_(1, eidx, torch.ones_like(gate))
    return gate, eidx, E * torch.mean(assign.mean(0) * probs.mean(0))


def moe_slots(eidx: torch.Tensor, n_experts: int, capacity: int) -> Tuple[torch.Tensor, ...]:
    """The dispatch slots of the T k (token, expert) entries of eidx (T,
    k) at ``capacity`` slots an expert: ``(order, keep, slot, safe)``.
    ``order`` sorts the flat entries by expert, stably; in that order an
    expert keeps its first ``capacity`` entries (``keep``), entry i goes to
    slot ``slot[i]`` = expert x capacity + its position (clamped for the
    dropped), and ``safe`` sends the dropped to slot E x capacity, a spare
    row that no expert reads.  Counts by ``index_add_``, not
    ``torch.bincount``, which reads the largest index on the host."""
    flat_e = eidx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = torch.zeros(n_experts, dtype=torch.int64, device=eidx.device).index_add_(
        0, flat_e, torch.ones_like(flat_e))
    pos = torch.arange(flat_e.numel(), device=eidx.device) - (torch.cumsum(counts, 0)
                                                             - counts)[sorted_e]
    keep = pos < capacity
    slot = sorted_e * capacity + pos.clamp(0, capacity - 1)
    return order, keep, slot, torch.where(keep, slot, n_experts * capacity)


def _takes_a2a(x: torch.Tensor, n_experts: int) -> bool:
    """Whether ``moe_ffn`` takes the all-to-all branch: :data:`MOE_A2A_MESH`
    set, its "data" axis dividing the experts and, for a DTensor x, the
    batch dividing over the batch's mesh dims (the reference's condition
    that B divides over "data"; a plain x holds the rank's rows)."""
    if MOE_A2A_MESH is None:
        return False
    if n_experts % dict(zip(MOE_A2A_MESH.axis_names, MOE_A2A_MESH.shape)).get("data", 1):
        return False
    if not is_dtensor(x):
        return True
    mesh = x.device_mesh
    return x.shape[0] % math.prod(s for a, s in zip(mesh.mesh_dim_names, mesh.shape)
                                  if a in ("pod", "data")) == 0


def moe_ffn(x: torch.Tensor, router: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
            w2: torch.Tensor, *, top_k: int, capacity_factor: float = 1.25,
            routing: Optional[list] = None,
            d_ff: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort-based token-choice MoE with capacity (the reference's
    ``moe_ffn``): x (B, S, D), router (D, E),
    w1 and w3 (E, D, F), w2 (E, F, D) -> (output (B, S, D), the Switch-style
    load-balance loss, float32).

    Each token's top-k experts by float32 router probabilities (gates
    renormalised over the k); the T k (token, expert) entries sorted by
    expert, stably; an expert keeps its first C entries
    (:func:`moe_capacity`) and drops the rest, whose rows go to a spare
    last row of the dispatch buffer that no expert reads.  The expert
    products are batched matrix products in x's type; the gated outputs
    are added back to their tokens in x's type.  If ``routing`` is a list,
    a dict is appended to it: ``eidx`` (T, k), ``keep`` (T k,) in sorted
    order, ``capacity`` C and ``dropped``, a device count (no host sync).

    With :data:`MOE_A2A_MESH` set and E divisible by its "data" axis, the
    call is ``moe_a2a.moe_ffn_a2a`` on that mesh instead, as in the
    reference: every rank calls it with its own rows of the batch as x
    (the reference's condition that B divides over the axis is the
    caller's split) and its own shards of the stacks, w1 and w3 (E / n, D,
    F_loc) and w2 (E / n, F_loc, D) (``moe_a2a.expert_shard``), with
    ``d_ff`` the global F, which fixes F_loc (a shard's width cannot tell
    whether F was split); it gets its rows' output and the data-axis mean
    of the aux loss.  DTensor inputs (the dry run) carry their global
    shapes and take that branch where the batch divides over the batch's
    mesh dims, each rank on its shards (:func:`_local_a2a`).  With
    :data:`MOE_DISPATCH_SPEC` set and DTensor inputs, the (E, C, D)
    dispatch buffer is redistributed to that spec before the expert
    products."""
    B, S, D = x.shape
    E = router.shape[1]
    if _takes_a2a(x, E):
        from repro_torch.models import moe_a2a

        a2a = functools.partial(moe_a2a.moe_ffn_a2a, top_k=top_k, mesh=MOE_A2A_MESH,
                                capacity_factor=capacity_factor, routing=routing)
        if is_dtensor(x):
            Fd = w1.shape[-1]
            return _local_a2a(functools.partial(a2a, d_ff=Fd),
                              moe_a2a.ffn_shard_width(Fd, MOE_A2A_MESH) != Fd,
                              x, router, w1, w3, w2)
        if d_ff is None:
            raise ValueError("under MOE_A2A_MESH the stacks are this rank's shards: pass "
                             "d_ff, the experts' global FFN width")
        return a2a(x, router, w1, w3, w2, d_ff=d_ff)
    T = B * S
    xt = x.reshape(T, D)
    gate, eidx, aux = moe_route(xt, router, top_k)
    C = moe_capacity(T, E, top_k, capacity_factor)
    sort_idx, keep, buf_idx, safe_idx = moe_slots(eidx, E, C)
    token_of = sort_idx // top_k

    buf = zeros_on(xt, (E * C + 1, D))
    buf.index_copy_(0, safe_idx, xt[token_of])
    ebuf = buf[:E * C].view(E, C, D)
    if MOE_DISPATCH_SPEC is not None and is_dtensor(ebuf):
        from repro_torch.launch.sharding import placements

        ebuf = ebuf.redistribute(ebuf.device_mesh, placements(MOE_DISPATCH_SPEC,
                                                              ebuf.device_mesh))
    h = torch.bmm(ebuf, w1)
    g = torch.bmm(ebuf, w3)
    y = torch.bmm(F.silu(h) * g, w2).reshape(E * C, D)

    y_tok = torch.where(keep[:, None], y[buf_idx], torch.zeros((), dtype=y.dtype,
                                                                 device=y.device))
    gate_sorted = gate.reshape(-1)[sort_idx].to(x.dtype)
    out = zeros_on(xt, (T, D))
    out.index_add_(0, token_of, y_tok * gate_sorted[:, None])
    if routing is not None:
        routing.append(dict(eidx=eidx, keep=keep, capacity=C, dropped=(~keep).sum()))
    return out.reshape(B, S, D), aux
