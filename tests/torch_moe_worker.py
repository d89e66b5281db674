"""What each rank of the all-to-all MoE test world runs
(``tests/test_torch_moe_a2a.py``).  A plain module, not a test file: the
spawned ranks import it by name, and it imports neither ``jax`` nor the
reference, so no rank does.
"""
from __future__ import annotations

import sys
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import common as cm
from repro_torch.models.moe_a2a import expert_shard, ffn_shard_width, moe_ffn_a2a


def shard_rows(x: np.ndarray, mesh) -> np.ndarray:
    """The rows of the batch that ``mesh``'s rank holds: its "data"
    coordinate's block."""
    n = mesh_lib.mesh_axis_sizes(mesh)["data"]
    b = x.shape[0] // n
    d = mesh.axis_index("data")
    return x[d * b:(d + 1) * b]


def _call(fn, xs, w, top_k, cf):
    routing: List[dict] = []
    y, aux = fn(xs, *w, top_k=top_k, capacity_factor=cf, routing=routing)
    r = routing[0]
    return dict(out=y.numpy().copy(), aux=float(aux), eidx=r["eidx"].numpy().copy(),
                dropped=int(r["dropped"]), capacity=r["capacity"])


def _grads(mesh, x, w, cotangent, top_k, cf, aux_weight, d_ff) -> Dict[str, np.ndarray]:
    """The gradients of this rank's share of the loss ``sum(out *
    cotangent) + aux_weight * aux`` of the whole batch with respect to its
    rows of x, the router and its shards of the stacks (``w``): its rows'
    term and 1 / n of the aux term, each divided over the M ranks along
    "model" that hold the same rows, so the ranks' losses add up to the
    loss."""
    sizes = mesh_lib.mesh_axis_sizes(mesh)
    xs = shard_rows(x, mesh).clone().requires_grad_()
    ws = [t.clone().requires_grad_() for t in w]
    y, aux = moe_ffn_a2a(xs, *ws, top_k=top_k, mesh=mesh, capacity_factor=cf, d_ff=d_ff)
    loss = (y * shard_rows(cotangent, mesh)).sum() + aux_weight * aux / sizes["data"]
    (loss / sizes["model"]).backward()
    return {k: t.grad.numpy().copy() for k, t in zip(GRAD_LEAVES, [xs] + ws)}


def _dtensor(mesh, shape, x, w, cotangent, top_k, cf, aux_weight) -> Dict[str, Any]:
    """``common.moe_ffn`` under ``MOE_A2A_MESH`` on DTensors (the dry
    run's seam, ``common._local_a2a``) over a ``DeviceMesh`` of the same
    shape: x and the cotangent batch sharded, the router replicated, the
    stacks this rank's shards (the ep scheme's placements); the global
    output, aux and the gradients of ``sum(out * cotangent) + aux_weight *
    aux`` (every DTensor gathered), and the stacks' gradient placements."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    dmesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    split = ffn_shard_width(w[1].shape[-1], mesh) != w[1].shape[-1]
    rows, full = [Shard(0), Replicate()], [Replicate(), Replicate()]
    w_in = [Shard(0), Shard(2) if split else Replicate()]
    w_out = [Shard(0), Shard(1) if split else Replicate()]

    def leaf(local, full_shape, placements):
        return DTensor.from_local(local, dmesh, placements, run_check=False,
                                  shape=torch.Size(full_shape),
                                  stride=torch.empty(full_shape).stride()).requires_grad_()

    xd = leaf(shard_rows(x, mesh).clone(), x.shape, rows)
    ws = [leaf(w[0].clone(), w[0].shape, full)] + [
        leaf(t, f.shape, p) for t, f, p in zip(expert_shard(*w[1:], mesh), w[1:],
                                                (w_in, w_in, w_out))]
    ct = DTensor.from_local(shard_rows(cotangent, mesh), dmesh, rows, run_check=False,
                            shape=cotangent.shape, stride=cotangent.stride())
    cm.MOE_A2A_MESH = mesh
    try:
        y, aux = cm.moe_ffn(xd, *ws, top_k=top_k, capacity_factor=cf)
    finally:
        cm.MOE_A2A_MESH = None
    ((y * ct).sum() + aux_weight * aux).backward()
    return dict(out=y.full_tensor().detach().numpy(), aux=float(aux.full_tensor()),
                grads={k: t.grad.full_tensor().numpy() for k, t in zip(GRAD_LEAVES, [xd] + ws)},
                placements={k: [f"Shard({p.dim})" if p.is_shard() else type(p).__name__
                                 for p in t.grad.placements]
                            for k, t in zip(GRAD_LEAVES[2:], ws[1:])})


GRAD_LEAVES = ("x", "router", "w1", "w3", "w2")


def a2a_rank(inputs: Sequence[np.ndarray], top_k: int,
             cases: Sequence[Tuple[Tuple[int, int], float]], cotangent: np.ndarray,
             aux_weight: float) -> Dict[str, Any]:
    """For each (mesh shape, capacity factor) case on this rank's
    ("data", "model") mesh: ``moe_ffn_a2a`` called directly and
    ``common.moe_ffn`` under ``MOE_A2A_MESH``, each on the rank's rows of
    ``inputs[0]`` and its shards of the stacks (``expert_shard``), with the
    mesh's facts, the shards' shapes and the gradients of the rank's share
    of a loss (:func:`_grads`), and the same layer on DTensors
    (:func:`_dtensor`); then the ``all_to_all`` helper on blocks that name
    their sender and receiver, and the helper's refusal of a first axis
    that is not the group's size."""
    x, router, *stacks = (torch.from_numpy(a) for a in inputs)
    d_ff = stacks[0].shape[-1]
    ct = torch.from_numpy(cotangent)
    out: Dict[str, Any] = {"cases": []}
    for shape, cf in cases:
        mesh = mesh_lib.make_mesh(shape, ("data", "model"))
        xs = shard_rows(x, mesh)
        w = (router,) + expert_shard(*stacks, mesh)
        direct = _call(lambda *a, **k: moe_ffn_a2a(*a, mesh=mesh, d_ff=d_ff, **k), xs, w,
                       top_k, cf)
        cm.MOE_A2A_MESH = mesh
        try:
            via = _call(lambda *a, **k: cm.moe_ffn(*a, d_ff=d_ff, **k), xs, w, top_k, cf)
        finally:
            cm.MOE_A2A_MESH = None
        out["cases"].append(dict(
            coords=mesh.coords, direct=direct, via=via,
            shard_shapes=[tuple(t.shape) for t in w[1:]],
            data_ranks=dist.get_process_group_ranks(mesh.group),
            model_ranks=(None if mesh.model_group is None
                         else dist.get_process_group_ranks(mesh.model_group)),
            grads=_grads(mesh, x, w, ct, top_k, cf, aux_weight, d_ff),
            dtensor=_dtensor(mesh, shape, x, (router,) + tuple(stacks), ct, top_k, cf,
                             aux_weight)))
    n, r = dist.get_world_size(), dist.get_rank()
    # block i of rank r holds 10 r + i; after the exchange block j holds 10 j + r
    sent = (10 * r + torch.arange(n, dtype=torch.float32))[:, None].repeat(1, 3)
    out["exchanged"] = mesh_lib.all_to_all(sent, dist.group.WORLD).numpy()
    try:
        mesh_lib.all_to_all(torch.zeros(n + 1, 2), dist.group.WORLD)
        out["refusal"] = ""
    except ValueError as e:
        out["refusal"] = str(e)
    out["modules"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro"))
    return out
