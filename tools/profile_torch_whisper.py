#!/usr/bin/env python3
"""Where whisper-large-v3's prefill spends its time on the card.

Runs the prefill of ``chip_smoke.py`` (whisper-large-v3 at full width
and depth, random weights from seed 0, 4 requests of 384 decoder tokens
over 1500 audio frames, bfloat16) on one CUDA device: one warm-up, then
the wall time of three prefills and of three encoder passes alone with
the profiler off (host clock, synchronized), then ``torch.profiler`` over
two prefills.  Prints the wall time per prefill, the encoder's share of
it, the device's busy share (the union of kernel intervals over the wall
time) and the device time by class (matrix products, the flash kernel,
softmax, elementwise, ...).  Run from the repo root:

    python3 tools/profile_torch_whisper.py [out_dir]

``out_dir`` (default ``profile_out`` in the repo root, gitignored)
receives ``torch_whisper_prefill_trace.json`` (a Chrome trace) and
``torch_whisper_prefill_profile.txt``.
"""
from __future__ import annotations

import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402
from profile_torch_slice import _busy_us, _by_class  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs.whisper_large_v3 import CONFIG  # noqa: E402
from repro_torch.launch.specs import make_batch  # noqa: E402
from repro_torch.models import registry, whisper  # noqa: E402

B, S, SEED = 4, 384, 0
TIMED, PROFILED = 3, 2

# Device operations by class, matched on the kernel name in this order.
CLASSES = (("port flash kernel", ("flash_fwd",)),
           ("matrix products", ("gemm", "xmma", "cutlass", "sm90_")),
           ("softmax", ("softmax",)),
           ("reductions", ("reduce_kernel",)),
           ("elementwise", ("elementwise",)),
           ("copies and fills", ("memcpy", "memset", "Memcpy", "Memset", "copy")))


def wall_ms(fn, n: int) -> list:
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_whisper: needs a CUDA device", file=sys.stderr)
        return 1
    out_dir = sys.argv[1] if len(sys.argv) > 1 else os.path.join(ROOT, "profile_out")
    os.makedirs(out_dir, exist_ok=True)
    dev = torch.device("cuda")
    params = registry.init(CONFIG, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    batch = make_batch(CONFIG, B, S, seed=SEED, device=dev)
    prefill = lambda: registry.prefill(CONFIG, params, batch)  # noqa: E731
    encode = lambda: whisper.encode(CONFIG, params, batch["audio_embeds"])  # noqa: E731
    prefill()
    torch.cuda.synchronize()
    t_pre, t_enc = wall_ms(prefill, TIMED), wall_ms(encode, TIMED)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED):
            prefill()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    busy = _busy_us(events)
    classes = _by_class(events, CLASSES)
    dev_us = sum(us for _, us in classes.values())
    pre, enc = statistics.median(t_pre), statistics.median(t_enc)
    lines = [
        f"== whisper-large-v3 prefill B={B} S={S} frames={CONFIG.encoder_len}: device "
        f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}",
        f"profiler off: prefill {pre:.3f} ms median of {[round(t, 3) for t in t_pre]}; "
        f"encoder alone {enc:.3f} ms median of {[round(t, 3) for t in t_enc]} "
        f"({enc / pre:.4f} of the prefill)",
        f"profiled {PROFILED} prefills: {wall / 1e3 / PROFILED:.3f} ms/prefill wall; "
        f"device busy {busy / 1e3 / PROFILED:.3f} ms/prefill = {busy / wall:.4f} of wall, "
        f"idle share {1 - busy / wall:.4f}",
        f"device operations {sum(n for n, _ in classes.values()) / PROFILED:.1f}/prefill, "
        f"{dev_us / 1e3 / PROFILED:.3f} ms/prefill of device time:",
    ]
    for cls, (n, us) in sorted(classes.items(), key=lambda kv: -kv[1][1]):
        lines.append(f"  {cls:20s} {n / PROFILED:7.1f} ops/prefill "
                     f"{us / PROFILED:10.1f} us/prefill {us / dev_us:7.4f} of device time")
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=30)
    with open(os.path.join(out_dir, "torch_whisper_prefill_profile.txt"), "w") as f:
        f.write("\n".join(lines + ["", table]))
    prof.export_chrome_trace(os.path.join(out_dir, "torch_whisper_prefill_trace.json"))
    print("\n".join(lines), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
