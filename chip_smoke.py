#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

Run from the root of a checkout, with no arguments and no PYTHONPATH:

    python3 chip_smoke.py

It builds both CUDA kernels (``sm_90a``) from
``src/repro_torch/kernels/csrc``, holds each against its plain PyTorch
version on the card, runs the SCARLET host round loop at the paper's
population (100 clients, 1000 public samples a round, 10 classes,
``cache_delta+quant8`` uplink) with launch counts that show both kernels
on the path, checks a small configuration on the card against the same
configuration on the CPU, and prints one JSON line per the kernels and,
last, ``{"ok": true, "device": {...}}``.  Any failure raises: the script
then exits non-zero without the last line.  Without a CUDA device it
exits 1 at once.  It imports neither ``jax`` nor ``repro``.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and the
# float32 rate outside the tensor cores.  The bound of a kernel is the
# larger of bytes / HBM rate and operations / float32 rate.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# The slice at full width: the paper's population on the repo's MLP client.
SLICE = dict(n_clients=100, n_classes=10, public_per_round=1000,
             public_size=10000, private_size=50000)
SLICE_ROUNDS = 10
BETA = 1.5
CACHE_DURATION = 25
CODEC = "cache_delta+quant8"

# Kernel vs plain version on the card.  ERA: the plain version sums the
# K clients in another order (a tree, not a sequential loop), and
# logf/expf may differ by an ulp, so agreement is to float32 rounding,
# atol 1e-6 on probabilities.  qdq: the same operations in the same order
# without FMA contraction, so agreement is to 1e-6 with zero level flips.
ERA_ATOL = 1e-6
QDQ_ATOL = 1e-6

# The small configuration run on the card and on the CPU.  The ledger is
# a function of integer counts and must be equal.  Teachers (the cache
# values) agree to 1e-3: float32 products on the two devices sum in other
# orders (~1e-7), and a difference that lands on a rounding tie of the
# 8-bit residual code moves one value by a whole level (range/255) before
# it is averaged over the participants.  Accuracies agree to one test
# sample.
SMALL = dict(n_clients=8, n_classes=10, dim=16, hidden=32, rounds=4,
             local_steps=3, distill_steps=3, public_size=200,
             public_per_round=64, private_size=800, eval_every=1,
             participation=0.5, alpha=0.5, uplink_codec=CODEC)
SMALL_TEACHER_ATOL = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _probs(rng: np.random.Generator, shape, device) -> torch.Tensor:
    """Dirichlet soft-labels of ``shape`` (last axis = classes)."""
    n = shape[-1]
    z = rng.dirichlet(np.ones(n), size=int(np.prod(shape[:-1]))).astype(np.float32)
    return torch.from_numpy(z.reshape(shape)).to(device)


# ---------------------------------------------------------------------------
# phase 1-2: card and build
# ---------------------------------------------------------------------------

def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def build_kernels() -> None:
    from repro_torch.kernels import runtime

    t0 = time.perf_counter()
    logs = runtime.build()
    log(f"kernel build: {time.perf_counter() - t0:.3f} s for {sorted(runtime.SOURCES)}")
    for name, text in sorted(logs.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------

def check_era(device) -> float:
    from repro_torch.kernels import era_kernel

    rng = np.random.default_rng(1)
    K, m, N = SLICE["n_clients"], SLICE["public_per_round"], SLICE["n_classes"]
    cases = [(f"slice ({K},{m},{N})", _probs(rng, (K, m, N), device), BETA)]
    cases += [(f"slice beta={b}", _probs(rng, (K, m, N), device), b)
              for b in (0.5, 1.0, 4.0)]
    cases += [
        ("K=1", _probs(rng, (1, m, N), device), BETA),
        ("N=1", _probs(rng, (5, 7, 1), device), BETA),
        ("odd N=130", _probs(rng, (3, 33, 130), device), 4.0),
        ("constant rows", torch.full((7, 1001, N), 0.1, device=device), BETA),
    ]
    worst = 0.0
    for label, z, beta in cases:
        got = era_kernel.enhanced_era_fused(z, beta)
        want = era_kernel.enhanced_era_fused_plain(z, beta)
        _sync(device)
        err = float((got - want).abs().max())
        ok = bool(torch.isfinite(got).all()) and err <= ERA_ATOL
        log(f"era_fused {label} {tuple(z.shape)} beta={beta}: "
            f"max_abs_err={err!r} (atol {ERA_ATOL}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"era_fused {label}: max_abs_err {err} > {ERA_ATOL}")
        worst = max(worst, err)
    return worst


def _level_flips(got, want, z, bits) -> int:
    """Values whose quantization level differs: off by half a step or
    more of their row's range."""
    levels = float(2 ** bits - 1)
    scale = torch.clamp_min(z.amax(-1, keepdim=True) - z.amin(-1, keepdim=True), 1e-9)
    return int(((got - want).abs() >= 0.5 * scale / levels).sum())


def residual_view(rng, device):
    """The cache-delta residual as the main path hands it to the kernel:
    ``(z - base)[..., :-1]``, a strided (K, m, N-1) view, signed."""
    K, m, N = SLICE["n_clients"], SLICE["public_per_round"], SLICE["n_classes"]
    z = _probs(rng, (K, m, N), device)
    base = _probs(rng, (m, N), device)
    return (z - base)[..., :-1]


def check_qdq(device) -> float:
    from repro_torch.kernels import quant_kernel

    rng = np.random.default_rng(2)
    rows = SLICE["n_clients"] * SLICE["public_per_round"]
    N = SLICE["n_classes"]
    cases = [
        ("cache-delta residual view", residual_view(rng, device), 8),
        (f"({rows},{N - 1}) contiguous", _probs(rng, (rows, N - 1), device), 8),
        ("bits=1", _probs(rng, (rows, N - 1), device), 1),
        ("bits=4", _probs(rng, (rows, N - 1), device), 4),
        ("N=1", _probs(rng, (37, 1), device), 8),
        ("constant rows", torch.full((1001, N), 0.1, device=device), 8),
        ("negative residual rows",
         -torch.from_numpy(rng.random((4096, N - 1), dtype=np.float32)).to(device), 8),
    ]
    worst = 0.0
    for label, z, bits in cases:
        got = quant_kernel.quantize_dequantize(z, bits)
        want = quant_kernel.quantize_dequantize_plain(z, bits)
        _sync(device)
        err = float((got - want).abs().max())
        flips = _level_flips(got, want, z, bits)
        ok = bool(torch.isfinite(got).all()) and err <= QDQ_ATOL and flips == 0
        log(f"qdq {label} {tuple(z.shape)} bits={bits}: max_abs_err={err!r} "
            f"(atol {QDQ_ATOL}) level_flips={flips} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"qdq {label}: max_abs_err {err}, {flips} flips")
        worst = max(worst, err)
    return worst


# ---------------------------------------------------------------------------
# phase 4: the full-width slice
# ---------------------------------------------------------------------------

def run_slice(device, rounds: int = SLICE_ROUNDS) -> dict:
    from repro_torch.core.comm import CommLedger
    from repro_torch.fl import FederatedDistillation, FLConfig, STRATEGIES
    from repro_torch.kernels import ops

    cfg = FLConfig(**SLICE, rounds=rounds, eval_every=rounds, uplink_codec=CODEC)
    t0 = time.perf_counter()
    eng = FederatedDistillation(cfg, STRATEGIES["scarlet"](beta=BETA),
                                cache_duration=CACHE_DURATION, device=device)
    _sync(device)
    t_setup = time.perf_counter() - t0
    ops.reset_launches()
    t0 = time.perf_counter()
    first = eng.run(1)
    _sync(device)
    t1 = time.perf_counter()
    rest = eng.run(rounds - 1)
    _sync(device)
    t2 = time.perf_counter()
    launches = ops.launches()

    per_round = (t2 - t1) / (rounds - 1)
    ledger = first.ledger.rounds + rest.ledger.rounds
    log(f"slice: setup {t_setup:.3f} s, first round {t1 - t0:.4f} s, "
        f"then {per_round * 1e3:.3f} ms/round over {rounds - 1} rounds "
        f"(host clock, synchronized, one eval included)")
    summary = CommLedger(ledger).summary()
    log(f"slice: ledger {json.dumps(summary)}")
    sa, ca = rest.final_server_acc, rest.final_client_acc
    log(f"slice: final server_acc={sa!r} client_acc={ca!r}")
    log(f"slice: launches {launches}")

    # the path went through both kernels, once per round each (no round
    # here is an outage: participation is full)
    for name, n in launches.items():
        if n != rounds:
            raise AssertionError(f"{name} launched {n} times in {rounds} rounds")
    # round 1: every sample misses; the uplink carries the 8-bit residual
    # of N-1 classes, the downlink fp32 labels + request list + signals
    K, m, N = SLICE["n_clients"], SLICE["public_per_round"], SLICE["n_classes"]
    want_up = float(K * (m * (N - 1) * 8 / 8.0))
    want_down = float(K * (m * N * 4.0 + m * 4.0 + m * 4.0 + m * 0.25))
    r1 = ledger[0]
    if (r1.uplink, r1.downlink) != (want_up, want_down):
        raise AssertionError(f"round-1 ledger {r1} != ({want_up}, {want_down})")
    if not (np.isfinite(sa) and np.isfinite(ca) and sa > 1.0 / N and ca > 1.0 / N):
        raise AssertionError(f"accuracies not above chance: {sa}, {ca}")
    cache = eng.cache_g
    vals = cache.values[cache.present]
    if not (torch.isfinite(vals).all()
            and torch.allclose(vals.sum(-1), torch.ones_like(vals[:, 0]), atol=1e-5)):
        raise AssertionError("cached teachers are not finite probability rows")
    return dict(launches=launches, per_round_ms=per_round * 1e3, summary=summary)


# ---------------------------------------------------------------------------
# phase 5: the same small run on the card and on the CPU
# ---------------------------------------------------------------------------

def run_small(device):
    from repro_torch.fl import FederatedDistillation, FLConfig, STRATEGIES

    eng = FederatedDistillation(FLConfig(**SMALL), STRATEGIES["scarlet"](beta=BETA),
                                cache_duration=2, device=device)
    return eng, eng.run()


def check_small_cuda_vs_cpu() -> None:
    from repro_torch.fl import FLConfig, run_method

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("small run: torch.backends.cuda.matmul.allow_tf32=False, "
        "torch.backends.cudnn.allow_tf32=False")
    g_eng, g_hist = run_small(torch.device("cuda"))
    c_eng, c_hist = run_small(torch.device("cpu"))
    g_sum, c_sum = g_hist.ledger.summary(), c_hist.ledger.summary()
    teach_err = float((g_eng.cache_g.values.cpu() - c_eng.cache_g.values).abs().max())
    n_test = len(c_eng.y_test)
    acc_err = max(abs(a - b) for a, b in
                  zip(g_hist.server_acc + g_hist.client_acc,
                      c_hist.server_acc + c_hist.client_acc))
    log(f"small run cuda vs cpu: ledger equal={g_sum == c_sum} "
        f"teacher max_abs_err={teach_err!r} (atol {SMALL_TEACHER_ATOL}) "
        f"accuracy max diff={acc_err!r} (one test sample = {1.0 / n_test!r})")
    log(f"small run: server_acc cuda {g_hist.server_acc} cpu {c_hist.server_acc}")
    if g_sum != c_sum:
        raise AssertionError(f"ledgers differ: {g_sum} vs {c_sum}")
    same_cache = (torch.equal(g_eng.cache_g.ts.cpu(), c_eng.cache_g.ts)
                  and torch.equal(g_eng.cache_g.present.cpu(), c_eng.cache_g.present))
    if not same_cache or teach_err > SMALL_TEACHER_ATOL:
        raise AssertionError(f"caches differ (ts/present equal={same_cache}, "
                             f"values {teach_err})")
    if acc_err > 1.0 / n_test + 1e-6:
        raise AssertionError(f"accuracies differ by {acc_err}")
    # the user's front door gives the same run
    h = run_method("scarlet", FLConfig(**SMALL), cache_duration=2, beta=BETA,
                   device="cuda")
    if h.ledger.summary() != g_sum:
        raise AssertionError("run_method's ledger differs from the engine's")


# ---------------------------------------------------------------------------
# phase 6: times at the slice shapes
# ---------------------------------------------------------------------------

def cuda_ms(fn, batches: int = 15, per_batch: int = 20) -> float:
    """Median per-call device time (CUDA events) of ``fn``.  A sleep
    kernel runs first so the host queues a batch of calls ahead of the
    card and the events time the calls back to back, not the Python
    launch gaps.  Inputs stay in L2 between calls, as on the main path,
    where the kernel reads what the previous operation just wrote."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(per_batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_batch)
    return statistics.median(times)


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def kernel_report(launches: dict, errs: dict) -> list:
    from repro_torch.kernels import era_kernel, quant_kernel

    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    K, m, N = SLICE["n_clients"], SLICE["public_per_round"], SLICE["n_classes"]
    out = []

    z = _probs(rng, (K, m, N), dev)
    # bytes: the stack read once, the teacher written once; operations:
    # K adds per output value, then /K, max, log, *beta, max, -, exp, +, /
    b, why = bound_ms(4.0 * (K * m * N + m * N), K * m * N + 9.0 * m * N)
    out.append(dict(
        name="enhanced_era_fused", route="cuda",
        source="src/repro_torch/kernels/csrc/era_fused.cu",
        replaces="src/repro/kernels/era_kernel.py:93",
        launches=launches["enhanced_era_fused"], max_abs_err=errs["era"],
        ms=cuda_ms(lambda: era_kernel.enhanced_era_fused(z, BETA)),
        plain_ms=cuda_ms(lambda: era_kernel.enhanced_era_fused_plain(z, BETA)),
        bound_ms=b, bound_by=why, library_ms=None))

    r = residual_view(rng, dev)
    n_val = r.numel()
    # bytes: the residual read once, the round trip written once;
    # operations: min, max, -, /, *, round, /, 2 clamps, *, + per value
    b, why = bound_ms(4.0 * 2 * n_val, 11.0 * n_val)
    out.append(dict(
        name="quantize_dequantize", route="cuda",
        source="src/repro_torch/kernels/csrc/qdq.cu",
        replaces="src/repro/kernels/quant_kernel.py:47",
        launches=launches["quantize_dequantize"], max_abs_err=errs["qdq"],
        ms=cuda_ms(lambda: quant_kernel.quantize_dequantize(r, 8)),
        plain_ms=cuda_ms(lambda: quant_kernel.quantize_dequantize_plain(r, 8)),
        bound_ms=b, bound_by=why, library_ms=None))
    for k in out:
        log(f"time {k['name']}: {k['ms'] * 1e3:.2f} us (plain {k['plain_ms'] * 1e3:.2f} us, "
            f"bound {k['bound_ms'] * 1e3:.3f} us by {k['bound_by']})")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    # 1. the card
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    # 2. build
    build_kernels()
    # 3. kernels against their plain versions
    errs = {"era": check_era(dev), "qdq": check_qdq(dev)}
    # 4. the full-width slice
    sl = run_slice(dev)
    # 5. card vs CPU on a small configuration
    check_small_cuda_vs_cpu()
    # 6. kernel times and the kernel line
    kernels = kernel_report(sl["launches"], errs)
    log(f"card: {card}; slice {sl['per_round_ms']:.3f} ms/round")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
