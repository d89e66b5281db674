#!/usr/bin/env python3
"""Where a round of the port's SCARLET host loop spends its time on the card.

Runs the slice of ``chip_smoke.py`` (100 clients, 1000 public samples a
round, 10 classes, ``cache_delta+quant8``) on one CUDA device: two warm-up
rounds, three rounds timed with the profiler off, then ``torch.profiler``
over three more.  Prints the wall time per round with and without the
profiler, the device's busy share (the union of kernel
intervals over the wall time), and the device time by class of
operation (matrix products, elementwise, reductions, the port's two
kernels, ...) and by operator.  Run from the repo root:

    python3 tools/profile_torch_slice.py [out_dir]

``out_dir`` (default ``profile_out`` in the repo root, gitignored)
receives ``torch_slice_trace.json`` (a Chrome trace) and
``torch_slice_profile.txt``.
"""
from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.fl import FederatedDistillation, FLConfig, STRATEGIES  # noqa: E402

SLICE = dict(n_clients=100, n_classes=10, public_per_round=1000,
             public_size=10000, private_size=50000, rounds=5, eval_every=5,
             uplink_codec="cache_delta+quant8")
WARM, PROFILED = 2, 3


# Device operations by class, matched on the kernel name in this order.
CLASSES = (("port ERA kernel", ("era_fused_kernel",)),
           ("port qdq kernel", ("qdq_kernel",)),
           ("matrix products", ("gemm", "xmma")),
           ("softmax", ("softmax",)),
           ("reductions", ("reduce_kernel",)),
           ("elementwise", ("elementwise",)),
           ("copies and fills", ("memcpy", "memset", "Memcpy", "Memset")))


def _device(events):
    return [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]


def _by_class(events):
    """{class: (device ops, device us)} over the device events."""
    out = {}
    for e in _device(events):
        cls = next((c for c, keys in CLASSES if any(k in e.name for k in keys)),
                   "other")
        n, us = out.get(cls, (0, 0.0))
        out[cls] = (n + 1, us + e.time_range.elapsed_us())
    return out


def _busy_us(events) -> float:
    """Union of the device kernel intervals, in microseconds."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in _device(events))
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_slice: needs a CUDA device", file=sys.stderr)
        return 1
    out_dir = sys.argv[1] if len(sys.argv) > 1 else os.path.join(ROOT, "profile_out")
    os.makedirs(out_dir, exist_ok=True)
    eng = FederatedDistillation(FLConfig(**SLICE), STRATEGIES["scarlet"](beta=1.5),
                                cache_duration=25, device="cuda")
    eng.run(WARM)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run(PROFILED)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run(PROFILED)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    busy = _busy_us(events)
    classes = _by_class(events)
    dev_us = sum(us for _, us in classes.values())
    lines = [
        f"device {torch.cuda.get_device_name(0)}; torch {torch.__version__}",
        f"profiled {PROFILED} rounds: {wall * 1e3 / PROFILED:.3f} ms/round wall "
        f"(profiler on, one eval included)",
        f"device busy {busy / 1e3 / PROFILED:.3f} ms/round = "
        f"{busy / (wall * 1e6):.4f} of wall; idle share {1 - busy / (wall * 1e6):.4f}",
        f"profiler off, the {PROFILED} rounds before: {plain_wall * 1e3 / PROFILED:.3f} "
        f"ms/round wall; the profiled device busy time over it: "
        f"{busy / (plain_wall * 1e6):.4f} (idle share {1 - busy / (plain_wall * 1e6):.4f})",
        f"device operations {sum(n for n, _ in classes.values()) / PROFILED:.1f}"
        f"/round, {dev_us / 1e3 / PROFILED:.3f} ms/round of device time:",
    ]
    for cls, (n, us) in sorted(classes.items(), key=lambda kv: -kv[1][1]):
        lines.append(f"  {cls:18s} {n / PROFILED:7.1f} ops/round "
                     f"{us / PROFILED:10.1f} us/round {us / dev_us:7.4f} of device time")
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=25)
    with open(os.path.join(out_dir, "torch_slice_profile.txt"), "w") as f:
        f.write("\n".join(lines + ["", table]))
    prof.export_chrome_trace(os.path.join(out_dir, "torch_slice_trace.json"))
    print("\n".join(lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
