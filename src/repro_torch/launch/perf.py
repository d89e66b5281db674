"""Perf variants of the dry run (the port of ``repro.launch.perf``): run
named variants for an (arch x shape) through ``launch/dryrun.run_combo``,
record each one's roofline terms and print the comparison.

  PYTHONPATH=src python -m repro_torch.launch.perf --arch kimi-k2-1t-a32b \\
      --shape train_4k --variants baseline-tp,fsdp,fsdp-bf16logits [--device cpu]

Variants (experiments compared side by side, not stacked):
  baseline-tp       Megatron-style tensor parallelism + pure data parallelism
  fsdp              + params/grads/optimizer state sharded over the data axis
  fsdp-bf16logits   fsdp + bf16 logits end to end (no f32 (B,S,V) buffer)
  fsdp-dots-remat   fsdp + dots_saveable remat (recompute the rest)
  fsdp-ep           fsdp + the MoE dispatch buffer pinned to expert-parallel
                    sharding (``common.MOE_DISPATCH_SPEC``)  [MoE archs only]
  fsdp-all          fsdp + bf16 logits + dots remat (+ ep for MoE)
  ep-a2a            experts over data, the all-to-all dispatch
                    (``models/moe_a2a.py``) on each rank's shard
and the tp-* counterparts of ``variant_plan``.
"""
from __future__ import annotations

import argparse
import sys
from typing import Any, Dict, Optional, Tuple

from repro_torch.launch import dryrun
from repro_torch.models import common as cm


def variant_plan(name: str, is_moe: bool) -> Tuple[str, Dict[str, Any], Any, bool]:
    """The reference's variant table: name -> (scheme, cfg_overrides,
    moe_dispatch_spec, moe_a2a)."""
    if name == "ep-a2a":
        # the all-to-all dispatch + experts sharded over data
        return "ep", {}, None, True
    if name == "baseline-tp":
        return "tp", {}, None, False
    if name == "tp-ep":
        return "tp", {}, ("data", None, "model"), False
    if name == "tp-dots-remat":
        return "tp", {"remat_policy": "dots_saveable"}, None, False
    if name == "tp-lse-ce":
        return "tp", {"ce_impl": "lse"}, None, False
    if name == "tp-bf16logits":
        return "tp", {"fp32_logits": False, "ce_impl": "lse"}, None, False
    if name == "tp-bf16attn":
        return "tp", {"attn_f32": False}, None, False
    if name == "tp-all":
        over = {"remat_policy": "dots_saveable", "ce_impl": "lse",
                "attn_f32": False}
        return "tp", over, (("data", None, "model") if is_moe else None), False
    if name == "fsdp":
        return "fsdp", {}, None, False
    if name == "fsdp-bf16logits":
        return "fsdp", {"fp32_logits": False}, None, False
    if name == "fsdp-dots-remat":
        return "fsdp", {"remat_policy": "dots_saveable"}, None, False
    if name == "fsdp-ep":
        return "fsdp", {}, ("data", None, "model"), False
    if name == "fsdp-all":
        over = {"fp32_logits": False, "remat_policy": "dots_saveable"}
        return "fsdp", over, (("data", None, "model") if is_moe else None), False
    raise ValueError(name)


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variants", default="baseline-tp,fsdp,fsdp-all")
    ap.add_argument("--out", default="experiments/perf")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.configs.registry import ARCHS

    is_moe = ARCHS[args.arch].n_experts > 0
    rows = []
    for name in [v.strip() for v in args.variants.split(",")]:
        scheme, overrides, moe_spec, moe_a2a = variant_plan(name, is_moe)
        cm.MOE_DISPATCH_SPEC = moe_spec
        try:
            r = dryrun.run_combo(args.arch, args.shape, multi_pod=False,
                                 scheme=scheme, out_dir=args.out,
                                 cfg_overrides=overrides, variant=name,
                                 moe_a2a=moe_a2a, device=args.device)
        finally:
            cm.MOE_DISPATCH_SPEC = None
        rows.append((name, r))

    print("\n=== perf summary:", args.arch, "x", args.shape, "===")
    print(f"{'variant':18s} {'compute':>10s} {'memory':>10s} {'coll':>10s} "
          f"{'bottleneck':>11s} {'mem/dev GB':>11s}")
    for name, r in rows:
        if r["status"] != "ok":
            print(f"{name:18s} FAILED: {r.get('error', '')[:80]}")
            continue
        print(f"{name:18s} {r['compute_s']*1e3:9.2f}ms {r['memory_s']*1e3:9.2f}ms "
              f"{r['collective_s']*1e3:9.2f}ms {r['bottleneck']:>11s} "
              f"{r['bytes_per_device']/1e9:11.2f}")
    return 0 if all(r["status"] == "ok" for _, r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
