"""The dry run's tables (the port's copy of ``repro.launch.report``): the
summary, the per-mesh dry-run tables and the roofline tables, from the
JSON artifacts ``repro_torch.launch.dryrun`` writes, in the reference's
text.

  PYTHONPATH=src python -m repro_torch.launch.report [--artifacts experiments/artifacts]

The roofline table's heading names the peaks its rows' terms divide by:
those of each row's ``hw`` preset (``launch/roofline.py``), or, for rows
without one (the reference's artifacts), the reference's chip, in the
reference's words.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from collections import defaultdict
from typing import Dict, List


def load(art_dir: str) -> List[Dict]:
    rows = []
    for f in sorted(glob.glob(os.path.join(art_dir, "*.json"))):
        with open(f) as fh:
            rows.append(json.load(fh))
    return rows


def _fmt_s(x: float) -> str:
    if x >= 1.0:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.2f}ms"
    return f"{x*1e6:.0f}us"


def dryrun_table(rows: List[Dict], mesh: str, scheme: str) -> str:
    out = [
        f"### Mesh {mesh}, scheme `{scheme}`\n",
        "| arch | shape | status | compile | per-dev mem (GB) | flops/dev (G) "
        "| HBM/dev (GB) | coll/dev (GB) | collectives |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        if r["mesh"] != mesh or r["scheme"] != scheme:
            continue
        if r["status"] == "skipped":
            out.append(f"| {r['arch']} | {r['shape']} | SKIP | — | — | — | — | — | "
                       f"{r['reason'][:60]}… |")
            continue
        if r["status"] == "error":
            out.append(f"| {r['arch']} | {r['shape']} | **FAIL** | — | — | — | — | — | "
                       f"{r['error'][:60]} |")
            continue
        if "hlo_gflops_per_device" not in r:  # compile-proof-only artifact
            out.append(
                f"| {r['arch']} | {r['shape']} | ok | {r['compile_s']:.0f}s "
                f"| {r['bytes_per_device']/1e9:.1f} | — | — | — | compile-proof |")
            continue
        colls = ", ".join(f"{k}x{v}" for k, v in sorted(
            r.get("collective_counts", {}).items()))
        out.append(
            f"| {r['arch']} | {r['shape']} | ok | {r['compile_s']:.0f}s "
            f"| {r['bytes_per_device']/1e9:.1f} "
            f"| {r['hlo_gflops_per_device']:.0f} "
            f"| {r['hlo_gbytes_per_device']:.0f} "
            f"| {r['collective_gbytes_per_device']:.2f} "
            f"| {colls} |")
    return "\n".join(out) + "\n"


def _peaks(rows: List[Dict]) -> str:
    """The peaks the rows' terms divide by: their ``hw`` presets' (the
    port's artifacts), or the reference's chip for rows without one."""
    names = sorted({r["hw"] for r in rows if r.get("hw")})
    if not names:
        return "197 TF/s bf16, 819 GB/s HBM, 50 GB/s link"
    from repro_torch.launch.roofline import resolve_hw

    return "; ".join(f"{h.peak_flops / 1e12:.0f} TF/s bf16, {h.hbm_bw / 1e9:.0f} GB/s HBM, "
                     f"{h.link_bw / 1e9:.0f} GB/s link ({h.name})"
                     for h in map(resolve_hw, names))


def roofline_table(rows: List[Dict], mesh: str, scheme: str) -> str:
    mine = [r for r in rows if r["mesh"] == mesh and r["scheme"] == scheme]
    out = [
        f"### Roofline — mesh {mesh}, scheme `{scheme}` "
        f"(terms per device over per-chip peaks: {_peaks(mine)})\n",
        "| arch | shape | compute | memory | collective | bottleneck "
        "| MODEL_GF | HLO_GF(fleet) | useful | note |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        if r["mesh"] != mesh or r["scheme"] != scheme or r["status"] != "ok":
            continue
        if "compute_s" not in r:  # compile-proof-only artifact
            continue
        note = _note_for(r)
        out.append(
            f"| {r['arch']} | {r['shape']} | {_fmt_s(r['compute_s'])} "
            f"| {_fmt_s(r['memory_s'])} | {_fmt_s(r['collective_s'])} "
            f"| **{r['bottleneck']}** | {r['model_gflops']:.0f} "
            f"| {r['hlo_gflops']:.0f} | {r['useful_flops_ratio']:.2f} | {note} |")
    return "\n".join(out) + "\n"


def _note_for(r: Dict) -> str:
    """One sentence on what would move the dominant term down."""
    b = r["bottleneck"]
    shape = r["shape"]
    if b == "memory":
        if shape.startswith("decode") or shape.startswith("long"):
            return ("KV/state reads dominate: shard KV heads (or sequence) "
                    "further / quantize cache to int8")
        return ("activation+logit traffic dominates: fused flash-attention "
                "kernel + bf16 logits + saner remat policy")
    if b == "collective":
        return ("comm-bound: move grad sync to reduce-scatter (FSDP), "
                "overlap collectives with compute, shrink TP degree")
    return "MXU-bound: good — increase per-chip batch or sharpen kernels"


def summarize(rows: List[Dict]) -> str:
    counts = defaultdict(int)
    for r in rows:
        counts[(r["mesh"], r["scheme"], r["status"])] += 1
    lines = ["| mesh | scheme | ok | skipped | failed |", "|---|---|---|---|---|"]
    seen = sorted({(r["mesh"], r["scheme"]) for r in rows})
    for mesh, scheme in seen:
        lines.append(
            f"| {mesh} | {scheme} | {counts[(mesh, scheme, 'ok')]} "
            f"| {counts[(mesh, scheme, 'skipped')]} "
            f"| {counts[(mesh, scheme, 'error')]} |")
    return "\n".join(lines) + "\n"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--artifacts", default="experiments/artifacts")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    rows = load(args.artifacts)
    chunks = ["## Dry-run summary\n", summarize(rows)]
    meshes = sorted({(r["mesh"], r["scheme"]) for r in rows})
    for mesh, scheme in meshes:
        chunks.append(dryrun_table(rows, mesh, scheme))
    chunks.append("\n## Roofline\n")
    for mesh, scheme in meshes:
        chunks.append(roofline_table(rows, mesh, scheme))
    text = "\n".join(chunks)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    else:
        print(text)


if __name__ == "__main__":
    main()
