#!/usr/bin/env python3
"""How far a random Mamba2 stack moves its logits when the SSD scan sums
the same terms in another order, by depth and dtype.

mamba2-1.3b's layer structure (SSM state 128, heads of 64, expand 2) at
d_model 512 and vocab 512, random weights from seed 0, one sequence of
512 tokens: for each dtype (float32, bfloat16) and depth (2, 8, 24, 48
layers) the prefill at ``ssm_chunk`` 256 against 64, which computes the
same sums in another order.  Prints the largest logit difference and the
largest logit.  Run from the repo root:

    python3 tools/ssd_depth_sweep.py [--device cuda|cpu]

The device defaults to ``cuda`` (raising without a card); the sizes are
small enough for the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "src"))

import torch  # noqa: E402

from repro_torch.configs.mamba2_1_3b import CONFIG  # noqa: E402
from repro_torch.launch.specs import make_batch  # noqa: E402
from repro_torch.models import registry  # noqa: E402

DEPTHS = (2, 8, 24, 48)
WIDTH, VOCAB, SEQ, CHUNKS = 512, 512, 512, (256, 64)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args(argv).device
    for dt in ("float32", "bfloat16"):
        for L in DEPTHS:
            cfg = dataclasses.replace(CONFIG, d_model=WIDTH, vocab_size=VOCAB, n_layers=L,
                                      param_dtype=dt, compute_dtype=dt)
            p = registry.init(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
            batch = make_batch(cfg, 1, SEQ, device=dev)
            a, b = (registry.prefill(dataclasses.replace(cfg, ssm_chunk=c), p, batch)
                    for c in CHUNKS)
            print(f"{dt} {L} layers: chunk {CHUNKS[0]} against {CHUNKS[1]}: logits max_abs_diff "
                  f"{float((a - b).abs().max())!r}, max |logit| {float(a.abs().max())!r}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
