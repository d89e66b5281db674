"""What each rank of the sharded-numerics world runs
(``tests/test_torch_sharding.py``).  A plain module, not a test file: the
spawned ranks import it by name, and it imports neither ``jax`` nor the
reference, so no rank does.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import sharding as sh
from repro_torch.launch.specs import make_batch
from repro_torch.launch.trace_analysis import sharded_ops
from repro_torch.models import common as cm
from repro_torch.models import registry


def _tempered(cfg: ModelConfig, seed: int) -> cm.Params:
    """Seeded parameters with the q/k projections / 8 (moderate scores)."""
    params = registry.init(cfg, torch.Generator().manual_seed(seed), device="cpu")
    for w in ("wq", "wk"):
        if w in params["layers"]:
            params["layers"][w] = params["layers"][w] / 8
    return params


def _loss_and_grads(cfg, params, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    leaves = cm.tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss = registry.loss_fn(cfg, leaves, batch, remat=True)
    loss.backward()
    return loss, leaves


def _full(t: torch.Tensor) -> torch.Tensor:
    return t.full_tensor() if isinstance(t, DTensor) else t


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def numerics_rank(jobs: Dict[str, Tuple[ModelConfig, Sequence[Tuple[Tuple[int, int], str]]]],
                  seed: int, batch: int, seq: int) -> Dict[str, Dict[str, Dict[str, float]]]:
    """For each job's configuration and each of its (mesh shape, scheme)
    cases: :func:`numerics` (one world runs them all)."""
    return {name: numerics(cfg, seed, batch, seq, cases) for name, (cfg, cases) in jobs.items()}


def numerics(cfg: ModelConfig, seed: int, batch: int, seq: int,
             cases: Sequence[Tuple[Tuple[int, int], str]]) -> Dict[str, Dict[str, float]]:
    """For each (mesh shape, scheme): the largest absolute difference
    between the sharded and the single-device prefill logits, train loss
    and every parameter's gradient, each beside the single-device value's
    largest magnitude."""
    torch.manual_seed(seed)
    params = _tempered(cfg, seed)
    data = make_batch(cfg, batch, seq, seed=seed, device="cpu")
    data["labels"] = data["tokens"]
    with torch.no_grad():
        ref_logits = registry.prefill(cfg, params, data)
    ref_loss, ref_leaves = _loss_and_grads(cfg, params, data)
    out = {}
    for shape, scheme in cases:
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
        specs = sh.param_shardings(registry.param_axes(cfg), params, mesh, scheme)
        dparams = cm.tree_map(lambda t, s: distribute_tensor(t, mesh, sh.placements(s, mesh)),
                              params, specs)
        bspec = sh.batch_spec(mesh)
        dbatch = {k: distribute_tensor(t, mesh, sh.placements(bspec + (None,) * (t.dim() - 1),
                                                              mesh))
                  for k, t in data.items()}
        with sharded_ops() as fallback:
            with torch.no_grad():
                logits = _full(registry.prefill(cfg, dparams, dbatch))
            loss, leaves = _loss_and_grads(cfg, dparams, dbatch)
            loss = _full(loss)
            errs = {"logits": (float((logits - ref_logits).abs().max()),
                               float(ref_logits.abs().max())),
                    "loss": (float((loss - ref_loss).abs()), float(ref_loss.abs()))}
            for (name, got), (_, want) in zip(_flat(leaves), _flat(ref_leaves)):
                g = _full(got.grad)
                errs[f"grad {name}"] = (float((g - want.grad).abs().max()),
                                        float(want.grad.abs().max()))
        errs["fallbacks"] = dict(fallback.ops)
        out[f"{shape[0]}x{shape[1]} {scheme}"] = errs
    return out
