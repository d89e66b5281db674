#!/usr/bin/env python3
"""Which allocations make a sharded-engine rank's device peak, on the card.

    python3 tools/shard_peak.py [out_dir]     (default profile_out/shard_peak)

SCARLET at ``chip_smoke.py``'s slice population (100 clients, 1000 public
samples a round, ``cache_delta+quant8``, per-op), on worlds of 1, 2 and 4
ranks spawned on the one card over gloo (NCCL refuses two ranks on a
device).  Each rank, in a fresh process:

1. records the CUDA caching allocator's history
   (``torch.cuda.memory._record_memory_history``, Python stacks), builds a
   per-op engine and runs two rounds: the "cold" run, the first CUDA work
   of the process;
2. replays the recorded allocations and frees, finds the peak of the
   bytes alive, and groups the blocks alive there by the first frame in
   ``repro_torch`` (else the first frame), with their sizes, and flags
   the sizes of a full-width ``(K, ...)`` client leaf, stack or shard;
3. frees cuBLAS's workspaces (``torch._C._cuda_clearCublasWorkspaces``)
   and reports the bytes that frees;
4. builds a second per-op engine in the same process and runs the same
   two rounds: the "warm" run.

Each run's peak is its growth above what the process held before it
(``max_memory_allocated`` after ``reset_peak_memory_stats``), as phase 4k
of ``chip_smoke.py`` measures it.  Rank 0's snapshot of the world of two
goes to ``out_dir/snapshot_n2_rank0.pickle`` (``torch.cuda.memory``'s
viz format) and every number to ``out_dir/shard_peak.json``.
"""
from __future__ import annotations

import collections
import json
import os
import pickle
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

ROUNDS = 2
WORLDS = (1, 2, 4)


def _engine(device):
    from repro_torch.fl import FLConfig, STRATEGIES, ShardedFederatedDistillation

    cfg = FLConfig(**cs.SLICE, rounds=ROUNDS, eval_every=ROUNDS, uplink_codec=cs.CODEC)
    return ShardedFederatedDistillation(cfg, STRATEGIES["scarlet"](beta=cs.BETA),
                                        cache_duration=cs.CACHE_DURATION, device=device)


def _run(device) -> int:
    """A per-op engine built and run for ROUNDS rounds: the run's peak
    growth in bytes."""
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    before = torch.cuda.memory_allocated(device)
    eng = _engine(device)
    eng.run(ROUNDS)
    torch.cuda.synchronize(device)
    return torch.cuda.max_memory_allocated(device) - before


def _frame(frames) -> str:
    """The first frame in the port (else the first frame) as file:line name."""
    for f in frames:
        if "repro_torch" in f["filename"] or "chip_smoke" in f["filename"]:
            return f"{f['filename'].split('src/')[-1]}:{f['line']} {f['name']}"
    return (f"{frames[0]['filename']}:{frames[0]['line']} {frames[0]['name']}"
            if frames else "(no Python frame: allocated from C++)")


def alive_at_peak(snapshot, device_index: int):
    """Replay the trace: (peak bytes, [(bytes, count, frame)] of the blocks
    alive at the peak, largest first)."""
    live, total, peak, at_peak = {}, 0, 0, {}
    for ev in snapshot["device_traces"][device_index]:
        if ev["action"] == "alloc":
            live[ev["addr"]] = (ev["size"], _frame(ev.get("frames", [])))
            total += ev["size"]
        elif ev["action"] == "free_completed" and ev["addr"] in live:
            total -= live.pop(ev["addr"])[0]
        if total > peak:
            peak, at_peak = total, dict(live)
    groups = collections.defaultdict(lambda: [0, 0, set()])
    for size, frame in at_peak.values():
        g = groups[frame]
        g[0] += size
        g[1] += 1
        g[2].add(size)
    rows = sorted(((b, n, f, sorted(s)) for f, (b, n, s) in groups.items()), reverse=True)
    return peak, rows


def wide_sizes(n: int):
    """Byte sizes of a full-width (K, ...) float32 client array of the slice
    (a client stack of soft-labels, a private shard, the per-client
    parameters) against the same at K/n: a block of the first kind alive
    on a rank of n > 1 is client state that is not sharded."""
    from repro_torch.fl import FLConfig
    cfg = FLConfig(**cs.SLICE)
    K, m, N = cfg.n_clients, cfg.public_per_round, cfg.n_classes
    per_client = {"soft-label stack (K, m, N)": m * N * 4,
                  "private shard (K, rows, dim)": (cfg.private_size // K) * cfg.dim * 4}
    return {name: (K * b, K // n * b) for name, b in per_client.items()}


def rank_main(n: int, out_dir: str) -> dict:
    import torch.distributed as dist

    r = dist.get_rank()
    device = torch.device("cuda", r % torch.cuda.device_count())
    torch.cuda.init()
    torch.cuda.set_device(device)
    torch.cuda.memory._record_memory_history(max_entries=400_000, stacks="python")
    cold = _run(device)
    snap = torch.cuda.memory._snapshot()
    torch.cuda.memory._record_memory_history(enabled=None)
    peak, rows = alive_at_peak(snap, device.index)
    if n == 2 and r == 0:
        with open(os.path.join(out_dir, "snapshot_n2_rank0.pickle"), "wb") as f:
            pickle.dump(snap, f)
    held = torch.cuda.memory_allocated(device)
    torch._C._cuda_clearCublasWorkspaces()
    workspaces = held - torch.cuda.memory_allocated(device)
    warm_first = _run(device)  # re-creates the workspaces it needs
    warm = _run(device)
    return dict(rank=r, cold=cold, warm_first=warm_first, warm=warm, replay_peak=peak,
                cublas_workspaces=workspaces,
                alive_at_peak=[dict(bytes=b, blocks=c, frame=f, sizes=s[:8])
                               for b, c, f, s in rows[:25]])


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.launch import mesh as mesh_lib

    out_dir = sys.argv[1] if len(sys.argv) > 1 else os.path.join("profile_out", "shard_peak")
    os.makedirs(out_dir, exist_ok=True)
    card = cs.card_line()
    cs.build_kernels()
    out = dict(card=card, rounds=ROUNDS, worlds={})
    for n in WORLDS:
        ranks = mesh_lib.run_world(n, rank_main, n, out_dir, backend="gloo", threads=None)
        out["worlds"][n] = ranks
        wide = wide_sizes(n)
        for rk in ranks:
            print(f"n={n} rank {rk['rank']}: peak growth cold {rk['cold']} B, warm "
                  f"{rk['warm']} B (first warm run after freeing cuBLAS's workspaces "
                  f"{rk['warm_first']} B); replayed peak {rk['replay_peak']} B; cuBLAS "
                  f"workspaces {rk['cublas_workspaces']} B ({card})", flush=True)
        print(f"n={n} rank 0, blocks alive at the cold run's peak, by first frame in the "
              f"port (bytes, blocks, frame, sizes); full-width client sizes {wide}:",
              flush=True)
        for row in ranks[0]["alive_at_peak"]:
            print(f"  {row['bytes']:>12} {row['blocks']:>5}  {row['frame']}  {row['sizes']}",
                  flush=True)
    cold1 = out["worlds"][1][0]["cold"]
    warm1 = out["worlds"][1][0]["warm"]
    for n in WORLDS[1:]:
        print(f"n={n}: worst rank's peak over n=1's, cold "
              f"{max(r['cold'] for r in out['worlds'][n]) / cold1:.4f}, warm "
              f"{max(r['warm'] for r in out['worlds'][n]) / warm1:.4f} ({card})", flush=True)
    with open(os.path.join(out_dir, "shard_peak.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
