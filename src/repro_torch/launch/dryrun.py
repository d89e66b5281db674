"""Production dry run (the port of ``repro.launch.dryrun``): for an
architecture x input shape on the production mesh (16x16 = 256 ranks, or
2x16x16 = 512) under a sharding scheme, prove that the port's step can be
laid out, and give a rank's memory plan and roofline terms, without a
cluster and without allocating anything.

Where the reference lowers and compiles an XLA program for 512 forced
host devices, this traces the port's own step as one rank of a fake world
(``launch/fake.py``): a ``"fake"`` process group of prod(mesh) ranks and a
``DeviceMesh`` with the reference's axis names; the parameters, the
optimizer state and the inputs (or the decode cache) are fake DTensors
sharded by ``launch/sharding.py``'s rules, and DTensor propagates the
shardings through the step, as GSPMD does.  The step is the port's own:

- train: ``launch.train.train_step`` with ``remat=True`` (the loss,
  ``backward()``, then AdamW with bfloat16 moments, as the reference's
  dry run builds it);
- prefill: ``models.registry.prefill``;
- decode: ``models.registry.decode_step``, the cache sharded by
  ``cache_shardings`` and written in place.

``launch/trace_analysis.py`` counts what the rank does: its matrix-product
and kernel FLOPs, the bytes its unfused eager ops read and write, its
collectives, and its memory plan.  The whole depth is traced (the
reference extrapolates from two unrolled depths only because XLA counts a
while loop's body once; the port's layers are a Python loop).

``--device cuda`` (the default; raises without a card) traces fake CUDA
tensors: eligible attention takes the flash kernel, whose launches are
recorded, not made, and counted at their own shapes, and memory is
rounded to the caching allocator's blocks.  ``--device cpu`` traces fake
CPU tensors: attention takes its plain route (the score matrices and
their products then count as ops), so its FLOPs, bytes and memory differ
from the card's.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-2b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--scheme fsdp]
  (``--device cpu`` on a machine without a card)
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import traceback
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import SHAPES_BY_NAME, InputShape, ModelConfig
from repro_torch.configs.registry import ARCHS, ASSIGNED
from repro_torch.kernels.runtime import resolve_device
from repro_torch.launch import roofline as rl
from repro_torch.launch import sharding as sh
from repro_torch.launch import trace_analysis as ta
from repro_torch.launch.fake import fake_mode, fake_world
from repro_torch.launch.specs import input_specs
from repro_torch.models import common as cm
from repro_torch.models import registry
from repro_torch.obs.trace import now as _now
from repro_torch.optim import get as get_opt

__all__ = ["SKIPS", "COMBO_OVERRIDES", "MESH_AXES", "mesh_shape_of", "trace_one",
           "stack_collectives", "run_combo", "main"]

# (arch, shape) combos skipped with reasons (the reference's)
SKIPS: Dict[tuple, str] = {
    (a, "long_500k"): "pure full-attention arch: 500k dense KV cache unsupported "
                      "without sliding-window/block-sparse variant"
    for a in ("kimi-k2-1t-a32b", "internvl2-26b", "grok-1-314b",
              "granite-3-2b", "phi4-mini-3.8b", "granite-3-8b",
              "whisper-large-v3")
}

# per-combo config overrides (the reference's documented deviation):
# gemma2 long-context serving runs all layers in local (sliding-window)
# mode, its global layers would otherwise need a dense 500k KV score.
COMBO_OVERRIDES: Dict[tuple, Dict[str, Any]] = {
    ("gemma2-27b", "long_500k"): {"local_global_alternating": False},
}

MESH_AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}

LR = 3e-4


def mesh_shape_of(multi_pod: bool) -> Tuple[int, ...]:
    """The production mesh: 16x16 ("data", "model"), or 2x16x16 ("pod",
    "data", "model") across two pods."""
    return (2, 16, 16) if multi_pod else (16, 16)


def _sharded(spec_tree, shard_tree, mesh, device) -> Any:
    """Fake DTensors of ``spec_tree``'s ``(shape, dtype)`` leaves, each
    sharded by its spec: a rank's local tensor of its local shape."""
    from torch.distributed.tensor import DTensor

    if isinstance(spec_tree, dict):
        return {k: _sharded(spec_tree[k], shard_tree[k], mesh, device) for k in spec_tree}
    shape, dtype = spec_tree
    local = torch.empty(sh.local_shape(shape, shard_tree, mesh), dtype=dtype, device=device)
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(local, mesh, sh.placements(shard_tree, mesh), run_check=False,
                              shape=torch.Size(shape), stride=stride)


def _param_specs(cfg: ModelConfig) -> Any:
    specs, dtype = registry.param_layout(cfg)
    return cm.tree_map(lambda s: (s[0], dtype), specs)


def _meta(spec_tree):
    return cm.tree_map(lambda s: torch.empty(s[0], dtype=s[1], device="meta"), spec_tree)


def _specs_of(tree):
    """``(shape, dtype)`` of every tensor of ``tree`` (dicts of tensors)."""
    if isinstance(tree, dict):
        return {k: _specs_of(v) for k, v in tree.items()}
    return (tuple(tree.shape), tree.dtype)


def trace_one(cfg: ModelConfig, shape: InputShape, mesh_shape: Sequence[int], scheme: str,
              optimizer: str = "adamw", device="cuda", moe_a2a: bool = False
              ) -> Tuple[ta.TraceSummary, Dict[str, Any]]:
    """Trace one rank of ``cfg``'s step at ``shape`` on a fake world of
    ``mesh_shape`` under ``scheme``: (the rank's summary, a dict with its
    parameter bytes and the recorded flash launches' plans).  Refuses when
    a process group is already initialised; tears its own down.
    ``moe_a2a`` routes every MoE layer through the all-to-all dispatch
    (``common.MOE_A2A_MESH``) on the production mesh of ``mesh_shape``."""
    dev = resolve_device(device)
    names = MESH_AXES[len(mesh_shape)]
    with fake_world(mesh_shape, names, dev.type) as mesh, fake_mode():
        if moe_a2a:
            from repro_torch.launch.mesh import make_mesh

            cm.MOE_A2A_MESH = make_mesh(mesh_shape, names)
        try:
            return _trace_step(cfg, shape, mesh, scheme, optimizer, dev)
        finally:
            cm.MOE_A2A_MESH = None


def _expert_leaves(axes, params):
    """The parameters whose logical dims include "experts" (the routed
    experts' stacks)."""
    for k, ax in axes.items():
        if isinstance(ax, dict):
            yield from _expert_leaves(ax, params[k])
        elif "experts" in ax:
            yield params[k]


def stack_collectives(shapes: Dict[Tuple[str, tuple, tuple], int], cfg: ModelConfig,
                      mesh_shape: Sequence[int]) -> Dict[str, int]:
    """Of a trace's collectives by shape (``TraceSummary.
    collective_shapes``), the all-gathers and all-reduces whose input or
    output ends in an expert stack's dims or a rank's shard of them, (e,
    D, f) or (e, f, D) with e the experts E or E / n and f the FFN dim F
    or F / M (n and M the "data" and "model" sizes): each as "kind in ->
    out" with its count.  Empty for a dense model."""
    if not cfg.n_experts:
        return {}
    size = dict(zip(MESH_AXES[len(mesh_shape)], mesh_shape))
    E, D, Fe = cfg.n_experts, cfg.d_model, cfg.expert_d_ff
    es = {E, E // size["data"]}
    fs = {Fe, Fe // size["model"]}
    stack = {(e, D, f) for e in es for f in fs} | {(e, f, D) for e in es for f in fs}
    return {f"{kind} {i} -> {o}": n for (kind, i, o), n in shapes.items()
            if kind in ("all-gather", "all-reduce") and (i[-3:] in stack or o[-3:] in stack)}


def _trace_step(cfg, shape, mesh, scheme, optimizer, dev):
    from repro_torch.launch import train

    p_specs = _param_specs(cfg)
    axes = registry.param_axes(cfg)
    p_shard = sh.param_shardings(axes, p_specs, mesh, scheme)
    params = _sharded(p_specs, p_shard, mesh, dev)
    meta = {"param_bytes_per_device": float(sum(
        t.numel() * t.element_size() for t in ta.local_tensors(params))),
        "expert_param_bytes_per_device": float(sum(
            t.numel() * t.element_size()
            for t in ta.local_tensors(list(_expert_leaves(axes, params)))))}
    batch_spec = sh.batch_spec(mesh)
    if shape.mode == "train":
        opt = get_opt(optimizer, state_dtype="bfloat16") if optimizer == "adamw" \
            else get_opt(optimizer)
        o_specs = _specs_of(opt.init(_meta(p_specs)))
        o_shard = sh.opt_state_shardings(p_shard, o_specs, mesh)
        state = _sharded(o_specs, o_shard, mesh, dev) if o_specs != () else ()
        batch = {k: _sharded(s, batch_spec + (None,) * (len(s[0]) - 1), mesh, dev)
                 for k, s in input_specs(cfg, shape).items()}
        args = (params, state, batch)

        def step():
            return train.train_step(cfg, opt, params, state, batch, LR, remat=True)
    elif shape.mode == "prefill":
        batch = {k: _sharded(s, batch_spec + (None,) * (len(s[0]) - 1), mesh, dev)
                 for k, s in input_specs(cfg, shape).items() if k != "labels"}
        args = (params, batch)

        def step():
            with torch.no_grad():
                return registry.prefill(cfg, params, batch)
    else:
        tok_spec, pos_spec, c_specs = input_specs(cfg, shape)
        c_shard = sh.cache_shardings(registry.cache_axes(cfg, shape.name), c_specs, mesh)
        cache = _sharded(c_specs, c_shard, mesh, dev)
        tok_shard = (batch_spec if shape.global_batch > 1 else (None,)) + (None,)
        token = _sharded(tok_spec, tok_shard, mesh, dev)
        pos = _sharded(pos_spec, (), mesh, dev)
        args = (params, cache, token, pos)

        def step():
            with torch.no_grad():
                return registry.decode_step(cfg, params, cache, token, pos)
    _, summary = ta.trace(step, args, dev.type)
    meta["flash_plans"] = [launch.plan for launch in summary.launches
                           if launch.fn == "flash_attn_launch"]
    return summary, meta


def run_combo(arch: str, shape_name: str, multi_pod: bool, scheme: str,
              out_dir: str = "experiments/artifacts", optimizer: str = "adamw",
              verbose: bool = True, roofline: bool = True,
              cfg_overrides: Optional[Dict[str, Any]] = None, variant: str = "",
              moe_a2a: bool = False, device="cuda") -> Dict[str, Any]:
    """Trace one combo and write its JSON artifact (the reference's keys,
    so ``launch/report.py`` reads it, plus ``device``, ``hw``, the
    rank's ``peak_bytes``, ``param_bytes_per_device`` (and of it
    ``expert_param_bytes_per_device``, the routed experts' stacks),
    ``collective_shapes`` and of them ``stack_collectives``
    (:func:`stack_collectives`), ``flash_launches``,
    ``launch_findings`` (what ``analysis/launch_checks.py`` says of the
    recorded launch plans; empty when they pass), ``fallbacks``, the
    ops DTensor could not shard, and ``temp_by_op``, the temporaries alive
    at their peak by the op that made them).  ``compile_s``
    holds the trace's seconds (the port compiles nothing).  A failed
    combo records ``status: "error"`` with its traceback; ``roofline=False``
    records the layout proof and the memory plan alone."""
    cfg = ARCHS[arch]
    combo_over = COMBO_OVERRIDES.get((arch, shape_name), {})
    if combo_over:
        cfg = dataclasses.replace(cfg, **combo_over)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = SHAPES_BY_NAME[shape_name]
    mesh_name = "2x16x16" if multi_pod else "16x16"
    result: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name, "scheme": scheme,
        "variant": variant, "cfg_overrides": dict(cfg_overrides or {}),
        "device": str(device),
    }
    if (arch, shape_name) in SKIPS:
        result["status"] = "skipped"
        result["reason"] = SKIPS[(arch, shape_name)]
        _write(result, out_dir)
        if verbose:
            print(f"[SKIP] {arch} x {shape_name}: {result['reason']}")
        return result

    t0 = _now()
    try:
        mesh_shape = mesh_shape_of(multi_pod)
        summ, meta = trace_one(cfg, shape, mesh_shape, scheme, optimizer, device, moe_a2a)
        bytes_per_device = summ.bytes_per_device
        result["memory_analysis"] = {
            "argument_size_in_bytes": summ.argument_bytes,
            "output_size_in_bytes": summ.output_bytes,
            "temp_size_in_bytes": summ.temp_bytes,
            "alias_size_in_bytes": summ.alias_bytes,
            "generated_code_size_in_bytes": 0.0,
        }
        result.update(peak_bytes=summ.peak_bytes,
                      param_bytes_per_device=meta["param_bytes_per_device"],
                      expert_param_bytes_per_device=meta["expert_param_bytes_per_device"],
                      collective_shapes={f"{k} {i} -> {o}": n for (k, i, o), n
                                         in summ.collective_shapes.items()},
                      stack_collectives=stack_collectives(summ.collective_shapes, cfg,
                                                          mesh_shape),
                      flash_launches=len(meta["flash_plans"]),
                      launch_findings=_lint(meta["flash_plans"]), fallbacks=summ.fallbacks,
                      temp_by_op=summ.temp_by_op, n_ops=summ.n_ops)
        if roofline:
            roof = rl.compute_roofline_from_summary(
                arch=arch, shape=shape_name, mesh_name=mesh_name, scheme=scheme,
                chips=math.prod(mesh_shape), summary=summ,
                bytes_accessed=summ.bytes_accessed, xla_flops=summ.dot_flops,
                model_flops=rl.model_flops_for(cfg, shape),
                bytes_per_device=bytes_per_device)
            result.update(roof.as_dict())
        else:
            result["bytes_per_device"] = bytes_per_device
            result["hw"] = rl.DEFAULT_HW.name
        result["status"] = "ok"
        result["compile_s"] = _now() - t0
        if verbose:
            if roofline:
                print(f"[OK]   {arch} x {shape_name} ({mesh_name}, {scheme}) "
                      f"trace={result['compile_s']:.1f}s "
                      f"flops/dev={roof.hlo_gflops_per_device:.1f}G "
                      f"hbm/dev={roof.hlo_gbytes_per_device:.1f}G (unfused eager) "
                      f"coll/dev={roof.collective_gbytes_per_device:.3f}G "
                      f"terms(c/m/n)={roof.compute_s*1e3:.2f}/{roof.memory_s*1e3:.2f}/"
                      f"{roof.collective_s*1e3:.2f}ms bottleneck={roof.bottleneck} "
                      f"useful={roof.useful_flops_ratio:.2f} "
                      f"per-dev-mem={bytes_per_device/1e9:.2f}GB")
            else:
                print(f"[OK]   {arch} x {shape_name} ({mesh_name}, {scheme}) "
                      f"trace={result['compile_s']:.1f}s "
                      f"per-dev-mem={bytes_per_device/1e9:.2f}GB (layout proof only)")
            print(f"       memory plan: {result['memory_analysis']}; "
                  f"peak alive {summ.peak_bytes/1e9:.2f}GB; flash launches "
                  f"{result['flash_launches']}; replicated fallbacks {summ.fallbacks}")
    except Exception as e:  # noqa: BLE001 — a failed combo is a bug to record
        result["status"] = "error"
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc()[-2000:]
        result["compile_s"] = _now() - t0
        if verbose:
            print(f"[FAIL] {arch} x {shape_name} ({mesh_name}, {scheme}): "
                  f"{result['error'][:400]}")
    _write(result, out_dir)
    return result


def _lint(plans) -> list:
    """The errors and warnings of ``analysis/launch_checks.py`` on each
    distinct recorded launch plan (empty when every plan passes)."""
    from repro_torch.analysis.launch_checks import check_plan

    unique = {repr(p): p for p in plans}
    return sorted({str(f) for p in unique.values() for f in check_plan("flash", p)})


def _write(result: Dict[str, Any], out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    fname = (f"{result['arch']}__{result['shape']}__{result['mesh']}"
             f"__{result['scheme']}"
             + (f"__{result['variant']}" if result.get("variant") else "")
             + ".json")
    with open(os.path.join(out_dir, fname), "w") as f:
        json.dump(result, f, indent=2, default=str)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=sorted(ASSIGNED), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES_BY_NAME), default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--scheme", choices=("tp", "fsdp"), default="fsdp")
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--out", default="experiments/artifacts")
    ap.add_argument("--no-roofline", action="store_true",
                    help="layout proof and memory plan only (no roofline terms)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    if args.all:
        combos = [(a, s) for a in ASSIGNED for s in SHAPES_BY_NAME]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        combos = [(args.arch, args.shape)]

    failures = 0
    for a, s in combos:
        r = run_combo(a, s, args.multi_pod, args.scheme, args.out, args.optimizer,
                      roofline=not args.no_roofline, device=args.device)
        failures += r["status"] == "error"
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
