#!/usr/bin/env python3
"""Time one measurement of two checkouts in turns on one card, to tell a
change from the card's own spread.

    python3 tools/ab.py {prefill,era_fused} PARENT_DIR CHANGE_DIR [ROUNDS]

Each checkout is a tree of this repository (for example the parent
commit unpacked with ``git archive`` into a gitignored directory).  Every
round runs, each in a fresh process, parent, change, change, parent; a
process builds that tree's kernels (cached under its own ``src/``) and
takes the measurement with that tree's ``chip_smoke``:

- ``prefill``: whisper-large-v3's full-width prefill, ms, the median of
  three synchronized host-clock prefills after a warm-up (4 requests of
  384 decoder tokens over 1500 audio frames, bfloat16, random weights
  from a seed; ``chip_smoke.run_whisper``);
- ``era_fused``: ``enhanced_era_fused`` at the slice's (100, 1000, 10)
  stack, ms a call, CUDA events (``chip_smoke.cuda_ms``, as phase 6).

Prints one line a process and the medians and ranges of both trees.
Needs the card.
"""
from __future__ import annotations

import os
import statistics
import subprocess
import sys

CHILD = {
    "prefill": """
import os, sys
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke
from repro_torch.kernels import runtime
runtime.build()
print("ms", repr(chip_smoke.run_whisper(torch.device("cuda"))["ms"]), flush=True)
""",
    "era_fused": """
import os, sys
sys.path.insert(0, os.getcwd())
import numpy as np
import torch
import chip_smoke
from repro_torch.kernels import era_kernel, runtime
runtime.build()
s = chip_smoke.SLICE
z = chip_smoke._probs(np.random.default_rng(3),
                      (s["n_clients"], s["public_per_round"], s["n_classes"]),
                      torch.device("cuda"))
print("ms", repr(chip_smoke.cuda_ms(lambda: era_kernel.enhanced_era_fused(z, chip_smoke.BETA))),
      flush=True)
""",
}


def measure(what: str, tree: str) -> float:
    p = subprocess.run([sys.executable, "-c", CHILD[what]], cwd=tree, capture_output=True,
                       text=True, timeout=600)
    if p.returncode != 0:
        raise RuntimeError(f"{tree}: exit {p.returncode}\n{p.stderr[-3000:]}")
    line = [ln for ln in p.stdout.splitlines() if ln.startswith("ms ")][-1]
    return float(line.split()[1])


def main(argv) -> int:
    if len(argv) not in (3, 4) or argv[0] not in CHILD:
        print(__doc__, file=sys.stderr)
        return 2
    what = argv[0]
    trees = {"parent": os.path.abspath(argv[1]), "change": os.path.abspath(argv[2])}
    rounds = int(argv[3]) if len(argv) == 4 else 3
    times = {"parent": [], "change": []}
    for r in range(rounds):
        for side in ("parent", "change", "change", "parent"):
            ms = measure(what, trees[side])
            times[side].append(ms)
            print(f"round {r + 1} {side} {what} {ms!r} ms", flush=True)
    for side, t in times.items():
        print(f"{side}: median {statistics.median(t)!r} ms, range {min(t)!r}-{max(t)!r} ms "
              f"over {len(t)} processes", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
