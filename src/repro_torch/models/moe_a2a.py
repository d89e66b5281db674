"""Expert-parallel MoE dispatch over a true all-to-all (the port of
``repro.models.moe_a2a``, the ``MOE_A2A_MESH`` branch of
``common.moe_ffn``).

The reference runs its body under ``shard_map``, one program over the
mesh.  Here every rank of a ``torch.distributed`` world runs the same
body on its own shard (the rank's ``"data"`` coordinate d of n):

  1. it routes its own tokens (router weights replicated);
  2. it sorts its T k (token, expert) entries by global expert id,
     stably: experts are contiguous per rank (expert e lives on rank
     e // E_loc), so an expert-major send buffer is also rank-major;
  3. it fills fixed per-expert send slots at the all-to-all's own
     capacity ``cap_e = max(round_up_8(ceil(T k / E cf)), 8)`` (not
     ``moe_ffn``'s); an expert's entries past it are dropped;
  4. one ``all_to_all`` over the data group sends each rank its experts'
     slots, regrouped per local expert (E_loc, n cap_e, D);
  5. it runs its local experts' SwiGLU FFN;
  6. the return ``all_to_all`` brings each slot's output home, where it
     is unsorted and gate-combined over the k choices.

The aux load-balance loss is the data-axis mean of each rank's loss over
its own tokens (the reference's ``pmean``), which differs from the loss
of the whole batch at once.  Where the mesh has a ``"model"`` axis of
size M > 1 that divides F, the ranks along it split the FFN dim (each
takes F / M columns of w1 and w3 and rows of w2) and sum their partial
outputs over the model group, as the reference's ``psum``.

Each rank holds only its shards of the expert stacks, as the reference's
``shard_map`` gives each device (``in_specs`` ``P("data", None, model)``
for w1 and w3, ``P("data", model, None)`` for w2): its experts
``[d E_loc, (d + 1) E_loc)`` and, where the FFN dim is split, its F / M
columns of w1 and w3 and rows of w2.  Whether F is split follows from
the global F and M alone (:func:`ffn_shard_width`), never from a shard's
width, so the caller passes ``d_ff``; a stack of another shape raises
``ValueError`` (full stacks on a data axis of n > 1 among them).
:func:`expert_shard` cuts a rank's shards out of full stacks.  At
jamba-v0.1-52b's MoE layer (E = 16, D = 4096, F = 14336, bf16) a rank of
an n x M mesh (M dividing F) holds 5,637,144,576 / (n M) B of expert
weights.

The exchange moves 2 E cap_e D elements a rank a call (there and back),
not the token tensor.  The routing and the slots are ``common.moe_ffn``'s
(``moe_route``, ``moe_slots``: counts by ``index_add_``); nothing here
syncs with the host but the collectives themselves.

Gradients flow through both exchanges and both sums
(``launch.mesh.all_to_all`` and ``psum``, whose backward is their
transpose), so every rank of the mesh must run the backward together.
It gives each rank the gradient of the sum of all the ranks' losses with
respect to that rank's own copy of each input.  So the reference's
``jax.grad`` of a global loss L, when the ranks' losses add up to L
(the M ranks along ``"model"`` each take 1 / M of their rows' share), is
for the rank's shards of the expert stacks its own gradient, the
matching slice of the reference's with no sum over ranks (the exchanges'
transposes bring the other ranks' tokens); for its rows of x the
gradient summed over ``"model"``; for the router the gradient summed
over every rank.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import common as cm

__all__ = ["a2a_capacity", "ffn_shard_width", "expert_shard", "moe_ffn_a2a"]


def a2a_capacity(T: int, n_experts: int, top_k: int, capacity_factor: float) -> int:
    """The all-to-all's slots an expert for T local tokens:
    ``ceil(T k / E cf)`` rounded up to a multiple of 8, at least 8."""
    cap = int(math.ceil(T * top_k / n_experts * capacity_factor))
    return max((cap + 7) // 8 * 8, 8)


def ffn_shard_width(d_ff: int, mesh: mesh_lib.Mesh) -> int:
    """A rank's share F_loc of the expert FFN dim F = ``d_ff``: F / M where
    the mesh's ``"model"`` axis has M > 1 ranks and M divides F, else F
    (the reference's ``model_axis``)."""
    M = mesh_lib.mesh_axis_sizes(mesh).get(mesh_lib.MODEL_AXIS, 1)
    return d_ff // M if M > 1 and d_ff % M == 0 else d_ff


def expert_shard(w1: torch.Tensor, w3: torch.Tensor, w2: torch.Tensor,
                 mesh: mesh_lib.Mesh) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """This rank's shards of the full stacks w1 and w3 (E, D, F) and w2
    (E, F, D), as new tensors that own their memory (so the full stacks
    can be freed): its E / n experts by its ``"data"`` coordinate and, of
    their FFN dim, its F_loc by its ``"model"`` coordinate
    (:func:`ffn_shard_width`)."""
    E, Fd = w1.shape[0], w1.shape[-1]
    n = mesh_lib.mesh_axis_sizes(mesh)[mesh_lib.CLIENT_AXIS]
    if E % n:
        raise ValueError(f"{E} experts do not divide over a data axis of {n}")
    e_loc, f = E // n, ffn_shard_width(Fd, mesh)
    lo = mesh.axis_index(mesh_lib.CLIENT_AXIS) * e_loc
    c = mesh.axis_index(mesh_lib.MODEL_AXIS) * f if f != Fd else 0
    return (w1[lo:lo + e_loc, :, c:c + f].clone(), w3[lo:lo + e_loc, :, c:c + f].clone(),
            w2[lo:lo + e_loc, c:c + f].clone())


def moe_ffn_a2a(x: torch.Tensor, router: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
                w2: torch.Tensor, *, top_k: int, mesh: mesh_lib.Mesh, d_ff: int,
                capacity_factor: float = 1.25,
                routing: Optional[list] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel token-choice MoE of this rank's shard: x (B_loc, S,
    D), the rank's rows of the batch (the same on every rank along
    ``"model"``); router (D, E); w1 and w3 (E / n, D, F_loc), w2 (E / n,
    F_loc, D), the rank's shards (:func:`expert_shard`), where F_loc is
    :func:`ffn_shard_width` of the global FFN dim ``d_ff`` -> (output
    (B_loc, S, D) in x's type, the aux loss averaged over the data axis,
    float32).  Stacks of any other shape raise ``ValueError``.  Every rank
    of ``mesh`` must call it together.  If ``routing`` is a list, a dict
    is appended to it as ``common.moe_ffn`` does: ``eidx`` (T, k),
    ``keep`` (T k,) in sorted order, ``capacity`` cap_e and ``dropped``,
    this rank's device count of dropped entries."""
    E = router.shape[1]
    n = mesh_lib.mesh_axis_sizes(mesh)[mesh_lib.CLIENT_AXIS]
    if E % n:
        raise ValueError(f"{E} experts do not divide over a data axis of {n}")
    e_loc, f = E // n, ffn_shard_width(d_ff, mesh)
    Bl, S, D = x.shape
    want = {"w1": (e_loc, D, f), "w3": (e_loc, D, f), "w2": (e_loc, f, D)}
    for name, t in (("w1", w1), ("w3", w3), ("w2", w2)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} {tuple(t.shape)}: this rank's shard of {E} experts over a "
                             f"data axis of {n} with F = {d_ff} is {want[name]} "
                             f"(expert_shard cuts it from the full stack)")
    tensor_parallel = f != d_ff

    T = Bl * S
    xt = x.reshape(T, D)
    gate, eidx, aux = cm.moe_route(xt, router, top_k)
    aux = mesh_lib.psum(aux.reshape(1), mesh.group)[0] / n

    # one sort by global expert id covers the exchange and the grouping
    cap = a2a_capacity(T, E, top_k, capacity_factor)
    order, keep, slot, safe = cm.moe_slots(eidx, E, cap)
    send = torch.zeros((E * cap + 1, D), dtype=x.dtype, device=x.device)
    send.index_copy_(0, safe, xt[order // top_k])

    # (n, E_loc cap, D) a block a rank; received: (src, E_loc, cap, D) ->
    # (E_loc, src cap, D)
    recv = mesh_lib.all_to_all(send[:E * cap].view(n, e_loc * cap, D), mesh.group)
    buf = recv.view(n, e_loc, cap, D).transpose(0, 1).reshape(e_loc, n * cap, D)
    y = torch.bmm(F.silu(torch.bmm(buf, w1)) * torch.bmm(buf, w3), w2)
    if tensor_parallel:
        y = mesh_lib.psum(y, mesh.model_group)
    back = y.view(e_loc, n, cap, D).transpose(0, 1).reshape(n, e_loc * cap, D)
    y_flat = mesh_lib.all_to_all(back, mesh.group).view(E * cap, D)

    y_slot = torch.where(keep[:, None], y_flat[slot],
                         torch.zeros((), dtype=x.dtype, device=x.device))
    contrib = torch.empty_like(y_slot).index_copy_(0, order, y_slot)
    out = (contrib * gate.reshape(-1, 1).to(x.dtype)).view(T, top_k, D).sum(1)
    if routing is not None:
        routing.append(dict(eidx=eidx, keep=keep, capacity=cap, dropped=(~keep).sum()))
    return out.reshape(Bl, S, D), aux
