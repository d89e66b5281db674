#!/usr/bin/env python3
"""Where a round of the port's SCARLET slice spends its time on the card.

Runs the slice of ``chip_smoke.py`` (100 clients, 1000 public samples a
round, 10 classes, ``cache_delta+quant8``) on one CUDA device through
two engines in turn: the host round loop (``engine="host"``) and the
device-resident engine on its fused path (``engine="scan"``,
``fused_round=True``).  For each: two warm-up rounds and three rounds
timed with the profiler off; then, once every engine is timed,
``torch.profiler`` over three more rounds of each.  Prints
the wall time per round with and without the profiler, the device's busy
share (the union of kernel intervals over the wall time), and the device
operations per round by class (matrix products, elementwise,
reductions, the port's kernels, ...) and by operator.  Run from the repo
root:

    python3 tools/profile_torch_slice.py [out_dir]

``out_dir`` (default ``profile_out`` in the repo root, gitignored)
receives, per engine, ``torch_slice_<engine>_trace.json`` (a Chrome
trace) and ``torch_slice_<engine>_profile.txt``.
"""
from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.fl import (  # noqa: E402
    FederatedDistillation,
    FLConfig,
    STRATEGIES,
    ScannedFederatedDistillation,
)

SLICE = dict(n_clients=100, n_classes=10, public_per_round=1000,
             public_size=10000, private_size=50000, rounds=5, eval_every=5,
             uplink_codec="cache_delta+quant8")
WARM, PROFILED = 2, 3


# Device operations by class, matched on the kernel name in this order.
CLASSES = (("port ERA kernel", ("era_fused_kernel",)),
           ("port qdq kernel", ("qdq_kernel",)),
           ("port fused_round kernel", ("fused_round_tile", "fused_round_rows")),
           ("matrix products", ("gemm", "xmma")),
           ("softmax", ("softmax",)),
           ("reductions", ("reduce_kernel",)),
           ("elementwise", ("elementwise",)),
           ("copies and fills", ("memcpy", "memset", "Memcpy", "Memset")))


def _device(events):
    return [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]


def _by_class(events, classes=CLASSES):
    """{class: (device ops, device us)} over the device events."""
    out = {}
    for e in _device(events):
        cls = next((c for c, keys in classes if any(k in e.name for k in keys)),
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


def time_engine(eng) -> float:
    """Warm up, then the wall time of PROFILED rounds with the profiler
    off (seconds)."""
    eng.run(WARM)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run(PROFILED)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def profile_engine(name: str, eng, plain_wall: float, out_dir: str) -> list:
    """Profile PROFILED rounds; returns the report lines and writes the
    trace and table under ``out_dir``."""
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
        f"== {name}: device {torch.cuda.get_device_name(0)}; torch {torch.__version__}",
        f"profiled {PROFILED} rounds: {wall * 1e3 / PROFILED:.3f} ms/round wall "
        f"(profiler on, one eval included)",
        f"device busy {busy / 1e3 / PROFILED:.3f} ms/round = "
        f"{busy / (wall * 1e6):.4f} of wall; idle share {1 - busy / (wall * 1e6):.4f}",
        f"profiler off ({PROFILED} rounds, before any profiling): "
        f"{plain_wall * 1e3 / PROFILED:.3f} "
        f"ms/round wall; the profiled device busy time over it: "
        f"{busy / (plain_wall * 1e6):.4f} (idle share {1 - busy / (plain_wall * 1e6):.4f})",
        f"device operations {sum(n for n, _ in classes.values()) / PROFILED:.1f}"
        f"/round, {dev_us / 1e3 / PROFILED:.3f} ms/round of device time:",
    ]
    for cls, (n, us) in sorted(classes.items(), key=lambda kv: -kv[1][1]):
        lines.append(f"  {cls:24s} {n / PROFILED:7.1f} ops/round "
                     f"{us / PROFILED:10.1f} us/round {us / dev_us:7.4f} of device time")
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=25)
    with open(os.path.join(out_dir, f"torch_slice_{name}_profile.txt"), "w") as f:
        f.write("\n".join(lines + ["", table]))
    prof.export_chrome_trace(os.path.join(out_dir, f"torch_slice_{name}_trace.json"))
    return lines


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_slice: needs a CUDA device", file=sys.stderr)
        return 1
    out_dir = sys.argv[1] if len(sys.argv) > 1 else os.path.join(ROOT, "profile_out")
    os.makedirs(out_dir, exist_ok=True)
    engines = {
        "host": FederatedDistillation(FLConfig(**SLICE), STRATEGIES["scarlet"](beta=1.5),
                                      cache_duration=25, device="cuda"),
        "scan_fused": ScannedFederatedDistillation(
            FLConfig(**SLICE, fused_round=True), STRATEGIES["scarlet"](beta=1.5),
            cache_duration=25, device="cuda"),
    }
    # every engine is timed before any is profiled: a process that has
    # run the profiler once issues slower afterwards
    walls = {name: time_engine(eng) for name, eng in engines.items()}
    for name, eng in engines.items():
        print("\n".join(profile_engine(name, eng, walls[name], out_dir)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
