#!/usr/bin/env python3
"""What ``torch.distributed`` does with CUDA tensors on this machine's
card: the facts the sharded engine's design rests on.

    python3 tools/probe_collectives.py

For NCCL and gloo, worlds of one and two ranks (all on ``cuda:0``), over
a ``file://`` rendezvous: an all-reduce of a CUDA tensor with CUDA's
sync debug mode at its default and at "error" (a device engine's rounds
run at "error"), and the host-clock time of 20 all-reduces of 40 KB
(1000 x 10 float32, about one round's aggregation moment at the slice's
shape).  Last, NCCL with two ranks on the one card, which NCCL refuses.
Each trial prints ``ok`` with a value or ``FAIL`` with the error's first
line; the script itself exits 0.
"""
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def trial(label, fn):
    try:
        print(f"{label}: ok {fn()}", flush=True)
    except Exception as e:  # noqa: BLE001 - every outcome is the probe's result
        print(f"{label}: FAIL {type(e).__name__}: {str(e).splitlines()[0][:300]}", flush=True)


def all_reduce_under(x, mode):
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(mode)
    try:
        dist.all_reduce(x)
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    return x


def rank(r, n, rendezvous, backend):
    dist.init_process_group(backend, init_method=f"file://{rendezvous}/rdzv", rank=r,
                            world_size=n)
    dev = torch.device("cuda", 0)
    tag = f"[{backend} n={n} r={r}]"
    x = torch.full((8,), float(r + 1), device=dev)
    trial(f"{tag} cuda all_reduce, sync debug default",
          lambda: all_reduce_under(x, "default").tolist()[:2])
    x = torch.full((1000, 10), float(r + 1), device=dev)
    trial(f"{tag} cuda all_reduce, sync debug error",
          lambda: all_reduce_under(x, "error")[0, :2].tolist())
    t0 = time.perf_counter()
    for _ in range(20):
        dist.all_reduce(x)
    torch.cuda.synchronize()
    print(f"{tag} 20 all_reduces of 40 KB: {(time.perf_counter() - t0) / 20 * 1e3:.3f} ms each",
          flush=True)
    dist.destroy_process_group()


def main():
    print(torch.__version__, torch.version.cuda, torch.cuda.device_count(), flush=True)
    for backend, n in (("nccl", 1), ("gloo", 1), ("gloo", 2)):
        with tempfile.TemporaryDirectory() as d:
            if n == 1:
                rank(0, 1, d, backend)
            else:
                mp.spawn(rank, args=(n, d, backend), nprocs=n, join=True)
    with tempfile.TemporaryDirectory() as d:
        trial("nccl, two ranks on one card",
              lambda: mp.spawn(rank, args=(2, d, "nccl"), nprocs=2, join=True))


if __name__ == "__main__":
    main()
