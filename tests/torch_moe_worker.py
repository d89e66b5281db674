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
from repro_torch.models.moe_a2a import moe_ffn_a2a


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


def _grads(mesh, x, w, cotangent, top_k, cf, aux_weight) -> Dict[str, np.ndarray]:
    """The gradients of this rank's share of the loss ``sum(out *
    cotangent) + aux_weight * aux`` of the whole batch: its rows' term and
    1 / n of the aux term, each divided over the M ranks along "model"
    that hold the same rows, so the ranks' losses add up to the loss."""
    sizes = mesh_lib.mesh_axis_sizes(mesh)
    xs = shard_rows(x, mesh).clone().requires_grad_()
    ws = [t.clone().requires_grad_() for t in w]
    y, aux = moe_ffn_a2a(xs, *ws, top_k=top_k, mesh=mesh, capacity_factor=cf)
    loss = (y * shard_rows(cotangent, mesh)).sum() + aux_weight * aux / sizes["data"]
    (loss / sizes["model"]).backward()
    return {k: t.grad.numpy().copy() for k, t in zip(GRAD_LEAVES, [xs] + ws)}


GRAD_LEAVES = ("x", "router", "w1", "w3", "w2")


def a2a_rank(inputs: Sequence[np.ndarray], top_k: int,
             cases: Sequence[Tuple[Tuple[int, int], float]], cotangent: np.ndarray,
             aux_weight: float) -> Dict[str, Any]:
    """For each (mesh shape, capacity factor) case on this rank's
    ("data", "model") mesh: ``moe_ffn_a2a`` called directly and
    ``common.moe_ffn`` under ``MOE_A2A_MESH``, each on the rank's rows of
    ``inputs[0]``, with the mesh's facts and the gradients of the rank's
    share of a loss (:func:`_grads`); then the ``all_to_all`` helper on
    blocks that name their sender and receiver, and the helper's refusal
    of a first axis that is not the group's size."""
    x, *w = (torch.from_numpy(a) for a in inputs)
    out: Dict[str, Any] = {"cases": []}
    for shape, cf in cases:
        mesh = mesh_lib.make_mesh(shape, ("data", "model"))
        xs = shard_rows(x, mesh)
        direct = _call(lambda *a, **k: moe_ffn_a2a(*a, mesh=mesh, **k), xs, w, top_k, cf)
        cm.MOE_A2A_MESH = mesh
        try:
            via = _call(cm.moe_ffn, xs, w, top_k, cf)
        finally:
            cm.MOE_A2A_MESH = None
        out["cases"].append(dict(
            coords=mesh.coords, direct=direct, via=via,
            data_ranks=dist.get_process_group_ranks(mesh.group),
            model_ranks=(None if mesh.model_group is None
                         else dist.get_process_group_ranks(mesh.model_group)),
            grads=_grads(mesh, x, w, torch.from_numpy(cotangent), top_k, cf, aux_weight)))
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
