#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

Run from the root of a checkout, with no arguments and no PYTHONPATH:

    python3 chip_smoke.py

It builds the seven CUDA kernel libraries (``sm_90a``) from
``src/repro_torch/kernels/csrc``, holds each kernel against its plain
PyTorch version on the card, and drives both engines of the port at the paper's
population (100 clients, 1000 public samples a round, 10 classes,
``cache_delta+quant8`` uplink): the SCARLET host round loop, then the
device-resident engine (``engine="scan"``) with and without its fused
round kernel, each with launch counts that show its kernels on the path,
then the paper's comparison methods at the same population: CFD (its
1-bit uplink through the quantize-dequantize kernel once a round) and
Selective-FD (confidence-gated uploads, without and with the cache) on
both engines, mean on the device engine, COMET on the host loop (host
k-means, per-client teachers through a quant8 downlink), the FedAvg and
Individual baselines, and SCARLET with a ``cache_delta+topk2`` uplink on
both engines.  Then the engine options (phase 4g), SCARLET at the same
population: heterogeneous client schedules with probabilistic cache
expiry on the host loop and both device engines, a run split by a
checkpoint (``repro_torch.checkpoint``) against the uninterrupted run,
bit for bit, and the clients' mirrored local caches against the global
cache under partial participation with an outage.  Then run telemetry
(phase 4h): the engine options' run with ``telemetry=True`` on the three
engines, its per-round Alg. 3 census held against the numpy replay of the
requests and its rows held across engines; the stragglers' catch-up and
staleness counters; telemetry off against on, bit for bit; and the host
plane (``repro_torch.obs``): a span tracer's Chrome trace and a run
record through ``python -m repro_torch.obs validate|render``, and a
fused leg under ``profiler_trace``, whose trace must name the kernels.
It then runs whisper-large-v3's prefill at full width and depth (random
weights from a seed, 4 requests of 384 decoder tokens over 1500 audio
frames, bfloat16), whose decoder self-attention goes through the flash
attention kernel once per layer, and then the soft-label library's
kernel seams at full width (``repro_torch.core`` with ``impl="kernel"``):
``aggregate_soft_labels`` over the paper's (100, 1000, 10) stack with
SCARLET's adaptive beta computed on the card, ``enhanced_era`` over
whisper's vocabulary as soft-labels, and ``soft_cross_entropy`` over the
prefill's logits, all under ``torch.cuda.set_sync_debug_mode("error")``.
Then the static analyzer (``python -m repro_torch.analysis``) runs on the
card: the card's limits against ``runtime.HOPPER``, the strict pass with
the compiled kernels' attributes, the selftest (which launches the three
fixture kernels on their valid plans and has the card refuse the
shared-memory hog), the fixture kernels against their plain versions, the
misaligned plan faulting in a child process, and the contract pass's
verdicts confirmed by CUDA graph capture in another.
Last come the reduced whisper configuration on the card and on the CPU.
The device engine runs its rounds under
``torch.cuda.set_sync_debug_mode("error")`` (it sets and restores the
mode itself), so a host sync inside a round fails the run.  A small
configuration runs on the card and on the CPU through both engines (and
COMET and FedAvg through the front door), and the script prints one JSON line for the kernels and, last,
``{"ok": true, "device": {...}}``.  Any failure raises: the script then
exits non-zero without the last line.  Without a CUDA device it exits 1
at once.  It imports neither ``jax`` nor ``repro``.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time
from typing import Optional

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and the
# float32 rate outside the tensor cores.  The bound of a kernel is the
# larger of bytes / HBM rate and operations / float32 rate.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# ... and the dense tensor-core rates, the peaks for attention's products:
# bfloat16 for bfloat16 inputs; tf32 for float32 inputs, whose kernel
# takes each product as three tf32 products (3xTF32), so its bound counts
# all three passes at the tf32 rate and no share of it reads over 100 %.
BF16_OPS_PER_S = 989e12
TF32_OPS_PER_S = 494.7e12
TF32_PASSES = 3

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
# The fused ERA kernel past its row-block layout (N > 12288), (K, B, N): a
# row over a cluster of 1, 2, 4 (twice) and 8 blocks, and the multi-pass
# layout past eight slices.
ERA_FUSED_WIDE = ((4, 33, 12289), (2, 9, 20001), (8, 16, 51968), (100, 3, 32000),
                  (3, 5, 100001), (3, 5, 106497))
ERA_FUSED_WIDE_BETAS = (0.5, 1.5, 4.0)
# fused_round: probabilities (sharpen=True) to atol 1e-6, as ERA: the
# kernel adds the clients lane-strided then by a shuffle tree, the plain
# version in PyTorch's reduction order.  The linear moment
# (sharpen=False) is a sum of up to K weighted values in [0, 1]; both
# sides' rounding grows with its magnitude, so it is held to 2e-6 * sum|w|
# (each order is within about log2(K) * 2^-23 of the exact sum).
ROUND_ATOL = 1e-6
ROUND_LINEAR_RTOL = 2e-6
# fused vs per-op device runs: the same codec arithmetic in other orders,
# so a cached value may move by one 8-bit level of its residual's range
# (the band the reference's own conformance suite uses)
QUANT_STEP_ATOL = 5e-3

# Phase 4f: the comparison methods at the slice's population, identity
# uplink codec.  CFD's 1-bit uplink (b_up=1) is charged at 1 bit a value
# and the fp32 downlink with the request list: 100 x 1000 x 10 x 1 / 8 up,
# 100 x (1000 x 10 x 4 + 1000 x 4 + 1000 x 4) down.  Selective-FD plugs in
# the cache (Fig. 11) at CACHE_DURATION.  The device engine against the
# host loop: ledgers to rtol 1e-7 (float32 on the card), cache values to
# ERA_ATOL (the two engines average the uploads in other orders).
CFD_ROUND1 = (125000.0, 4800000.0)
# Selective-FD charges each client's mean count of uploaded samples, a
# fraction: the device's float32 ledger rounds it three times (the mean,
# times N, times the clients), so it lies within 2^-22 of the host's
# float64 value (1e-7 is under that: 3.2 % of the totals from 50000 to
# 100000 uploads over 100 clients differ by more).  Each engine's bytes
# are also checked exactly against its own arithmetic on the recorded
# masks (check_selective_fd_ledger).
SFD_LEDGER_RTOL = 2.0 ** -22
COMPARISON_ROUNDS = SLICE_ROUNDS
# COMET on the host loop: the cache plugged in at CACHE_DURATION, the
# slice's uplink codec and a quant8 downlink, which round-trips the
# shared teacher and the (100, 1000, 10) per-client stack: three qdq
# launches a round.
COMET_DOWNLINK = "quant8"
COMET_QDQ_A_ROUND = 3
# SCARLET with a top-k residual uplink: 2 values and 2 indices a row of
# the N - 1 sent classes, indices at the run's FLConfig.index_bytes.
TOPK_CODEC = "cache_delta+topk2"
TOPK_INDEX_BYTES = 1.0

# Phase 4g: the engine options at the slice's population.  (a) SCARLET
# with heterogeneous schedules (client k: E_k = HET_STEPS[k % 4] local
# steps at HET_LR_SCALE[k % 3] times the lr, decayed by HET_LR_DECAY a
# round) and probabilistic expiry (the engines' default uniforms) on the
# host loop and both device engines: ledgers to rtol 1e-7 and each
# round's bytes exact for its requests, cache values to ERA_ATOL (per-op
# against the host loop) and QUANT_STEP_ATOL (fused against either), the
# E_k = 0 clients unchanged by local training bit for bit; (b) a run split
# by a checkpoint after RESTORE_AT rounds against (a)'s uninterrupted run,
# ledgers and state bit for bit; (c) mirrored local caches at
# MIRROR_PARTICIPATION with MIRROR_OUTAGE's client offline, each
# participant's mirror equal to the global cache after every round.
# Phase 4h: run telemetry at the slice's population.  (a) Phase 4g (a)'s
# configuration with telemetry on, on the three engines: the Alg. 3 census
# against request_masks, participants, bytes equal to the ledger, beta,
# sharpening (entropy post < pre) and the 8-bit codec error in (0, 1/255];
# counters and bytes equal on the three engines.  Every run's gauges equal
# a float64 recomputation from the round's own inputs (the participation,
# the transmitted stack, the server's view, the teacher) to TEL_GAUGE_ATOL
# (float32 means over 1000 rows and 100 clients).  Across engines, where
# the state is the same: the host loop and the per-op engine at full
# participation in every round (the same bits), and every engine in round
# 1, to TEL_GAUGE_ATOL, the fused engine's post-sharpening entropy to
# TEL_FUSED_POST_ATOL (its teacher lies within one 8-bit level of the
# per-op one).  After round 1 an engine whose clients distilled on another
# teacher (the fused kernel's, or a partial mean in another order) follows
# its own trajectory: its gauges are printed and held to
# TEL_TRAJECTORY_RTOL.  (b) Phase 4g (c)'s stragglers without the mirrors:
# TEL_CATCH_UP returning clients of TEL_PARTICIPATIONS (client, round)
# pairs, TEL_BUCKET0 of them present the round before (a numpy replay of
# the draws).  (c) Telemetry off against on, each engine: ledgers, caches,
# parameters and accuracies bit for bit.  (d) The host plane: (a) in a
# SpanTracer, its Chrome trace and a run record through ``python -m
# repro_torch.obs`` in a child process, and one fused leg under
# ``profiler_trace``.
TEL_GAUGE_ATOL = 1e-5
TEL_FUSED_POST_ATOL = 1e-3
TEL_TRAJECTORY_RTOL = 0.1
TEL_CATCH_UP = 188
TEL_PARTICIPATIONS = 300
TEL_BUCKET0 = 112
TEL_PROFILED_ROUNDS = 3

HET_STEPS = (0, 2, 5, 8)
HET_LR_SCALE = (0.5, 1.0, 2.0)
HET_LR_DECAY = 0.95
RESTORE_AT = 5
MIRROR_PARTICIPATION = 0.3
MIRROR_OUTAGE = (3, 2, 6)  # client, first and last round offline

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

# whisper-large-v3's prefill at full width: 4 requests of 384 decoder
# tokens (a multiple of 128, so the decoder's causal self-attention takes
# the flash kernel; inside Whisper's 448-token text context), over the
# configuration's 1500 audio frames.
WHISPER_B, WHISPER_S = 4, 384
# Phase 6 also times flash attention at whisper's decoder shape with these
# head dims per dtype, beside SDPA at the same shape and dtype (bfloat16:
# D = 128 on tiles zero past 96, column blocks at 256; float32: whisper's
# d = 64, the reduced whisper's, then column blocks of 64 at 96 and 256),
# and the fused ERA kernel at 8 clients x 384 positions x whisper's
# vocabulary.
FLASH_TIMED_DIMS = {torch.bfloat16: (96, 256), torch.float32: (64, 96, 256)}
ERA_FUSED_VOCAB = (8, 384, 51968)
WHISPER_SEED = 0
WHISPER_TIMED = 3
# Flash attention, kernel vs plain version on the card: float32 to atol
# 1e-5 (the kernel takes each product as three tf32 products, about 2^-22
# of the product from float32's, sums in its own order and runs an online
# softmax; the plain version is the oracle's order); bfloat16
# compared in bfloat16: both sides compute in float32 (the tensor-core
# kernel with p split exactly into three bf16 pieces) and round once, so
# to one bfloat16 step: |got - want| <= 2**-7 * max(|want|, 1).
FLASH_F32_ATOL = 1e-5
BF16_STEP = 2.0 ** -7
# The reduced whisper configuration at S=128 in float32, card vs CPU:
# float32 products summed in other orders and the kernel vs its plain
# version, about 2e-6 on logits up to ~3 (the CPU port against the JAX
# package gives 2.3e-6 on the same tempered weights); atol 1e-4.  The q
# and k projections are scaled by 1/8 first: with the initialiser's
# fan-in rule the scores have a standard deviation near 64, and near-ties
# of so peaked a softmax turn 1e-7 roundings into logits differences of
# ~0.1 between any two float32 implementations (tests/test_torch_whisper.py).
WHISPER_SMALL_S = 128
WHISPER_SMALL_ATOL = 1e-4

# Per-row Enhanced ERA, kernel vs plain version: float32 to ERA_ATOL (the
# row sums run in other orders); bfloat16 bit for bit the float32
# kernel's result rounded once (the same float32 arithmetic on the
# upcast input), and within one bfloat16 step of the plain version.
# Shapes (B, N): N=1, the paper's 10, 100 (warp per row); 12289, one past
# the fused kernel's limit (one block a row); 20001 (clusters of 2);
# whisper's padded vocabulary 51968 and 51967, whose rows start off
# 16-byte boundaries (clusters of 4); 100001 (clusters of 8); 300001, past
# eight slices (the multi-pass layout).  The first and last row of each input are all zero.  Each
# shape is also launched twice and split over two launches (rows [:k] and
# [k:], k odd), in both dtypes: the results must be equal bit for bit.
ERA_ROWS_SHAPES = ((37, 1), (1000, 10), (333, 100), (64, 12289), (9, 20001), (48, 51968),
                   (7, 51967), (5, 100001), (3, 300001))
ERA_ROWS_BETAS = (0.5, 1.0, 1.5, 4.0, 200.0)
# The distillation loss, kernel vs plain version: both sum V float32
# terms in other orders (the kernel per thread, then a shuffle tree), and
# the rounding grows with the magnitudes summed, so each row's loss is
# held to DISTILL_RTOL of its scale |lse| * |sum t| + sum |t * l|.
DISTILL_SHAPES = ((8, 100), (3, 131), (64, 32000), (100, 163840))
DISTILL_DTYPES = ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
                  (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16))
DISTILL_RTOL = 1e-5
# The soft-label library at full width: SCARLET's adaptive beta (entropy
# of the client mean) with the reference's default beta_max.
ADAPTIVE_BETA_MAX = 2.5


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
    log(f"kernel build: {time.perf_counter() - t0:.3f} s for {sorted(runtime.SOURCES)} "
        f"({len(runtime.SOURCES)} libraries)")
    for name, text in sorted(logs.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")


def check_flash_sass() -> None:
    """Phase 2b: the flash kernels, bfloat16 and float32, are Hopper
    kernels: their machine code (``cuobjdump -sass``) holds wgmma (HGMMA)
    and TMA loads (UTMALDG) and no mma.sync (HMMA)."""
    from repro_torch.kernels import attn_kernel

    counts = attn_kernel.sass_opcodes()
    for name, c in sorted(counts.items()):
        log(f"flash sass {name}: {c}")
    for what, names in (("bf16", attn_kernel.BF16_KERNELS), ("float32", attn_kernel.F32_KERNELS)):
        got = {n: counts.get(n) for n in names}
        if any(c is None or c["HGMMA"] == 0 or c["UTMALDG"] == 0 or c["HMMA"]
               for c in got.values()):
            raise AssertionError(f"the {what} flash kernels are not wgmma/TMA kernels: {got}")
        log(f"flash sass: every {what} kernel ({len(got)}: {sorted(got)}) has HGMMA and "
            "UTMALDG and no HMMA ok")
    if set(counts) != set(attn_kernel.BF16_KERNELS + attn_kernel.F32_KERNELS):
        raise AssertionError(f"flash kernels in the library: {sorted(counts)}")


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------

def check_era(device) -> float:
    from repro_torch.kernels import era_kernel
    from repro_torch.kernels.era_kernel import fused_layout

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
    cases += [(f"wide {fused_layout(n)}", _probs(rng, (k, b, n), device), beta)
              for k, b, n in ERA_FUSED_WIDE for beta in ERA_FUSED_WIDE_BETAS]
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
    # each layout's result depends on N alone: two launches, and rows split
    # over two launches, give the same bits
    for k, b, n in ((K, m, N),) + ERA_FUSED_WIDE:
        z = _probs(rng, (k, b, n), device)
        one = era_kernel.enhanced_era_fused(z, BETA)
        half = (b // 2) | 1
        two = torch.cat([era_kernel.enhanced_era_fused(z[:, :half], BETA),
                         era_kernel.enhanced_era_fused(z[:, half:], BETA)])
        if not (torch.equal(one, era_kernel.enhanced_era_fused(z, BETA)) and torch.equal(one, two)):
            raise AssertionError(f"era_fused ({k},{b},{n}): two launches, or rows split over two, "
                                 "differ")
    log(f"era_fused two launches and rows split over two equal bit for bit at "
        f"{[(K, m, N)] + list(ERA_FUSED_WIDE)} ok")
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
        ("residual view bits=1", residual_view(rng, device), 1),
        ("residual view bits=4", residual_view(rng, device), 4),
        (f"({rows},{N - 1}) contiguous", _probs(rng, (rows, N - 1), device), 8),
        ("bits=1", _probs(rng, (rows, N - 1), device), 1),
        ("bits=4", _probs(rng, (rows, N - 1), device), 4),
        ("N=1", _probs(rng, (37, 1), device), 8),
        ("constant rows", torch.full((1001, N), 0.1, device=device), 8),
        ("negative residual rows",
         -torch.from_numpy(rng.random((4096, N - 1), dtype=np.float32)).to(device), 8),
        ("N=130 (a warp a row)", _probs(rng, (4097, 130), device) - 1.0 / 130, 8),
        ("N=2000 (a block a row)", _probs(rng, (65, 2000), device) - 1.0 / 2000, 8),
        # CFD's uplink: the whole client stack at b_up = 1, once a round
        ("CFD uplink", _probs(rng, (SLICE["n_clients"], SLICE["public_per_round"], N), device),
         1),
    ]
    worst = 0.0
    for label, z, bits in cases:
        got = quant_kernel.quantize_dequantize(z, bits)
        want = quant_kernel.quantize_dequantize_plain(z, bits)
        _sync(device)
        err = float((got - want).abs().max())
        flips = _level_flips(got, want, z, bits)
        ok = bool(torch.isfinite(got).all()) and err <= QDQ_ATOL and flips == 0
        flat = z.reshape(-1, z.shape[-1])
        log(f"qdq {label} {tuple(z.shape)} bits={bits} "
            f"{quant_kernel.layout(flat.shape[1], flat.stride(0))}: max_abs_err={err!r} "
            f"(atol {QDQ_ATOL}) level_flips={flips} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"qdq {label}: max_abs_err {err}, {flips} flips")
        worst = max(worst, err)
    return worst


ROUND_MODES = (("identity", None), ("quant", 8), ("quant", 1), ("quant", 4),
               ("delta", None), ("delta", 8))
# (K, m, N): one client; odd row counts; N=2 and N=130 beside the slice's
# 10 (130 spans more than one 16-class register chunk and 32 lanes, and
# holds the pair's row in the slab); all K clients in one chunk, and 300
# at N=130 (five chunks of 64) and 1000 (four of 256); one row (m=1);
# N=400 (7 clients, two rows a tile); N=700 at 40 clients, past the tile
# layout (a warp a row); N=1 only where no class is implied (identity,
# quant)
ROUND_SHAPES = ((1, 1, 2), (7, 1000, 10), (100, 1001, 130), (1, 1001, 10),
                (7, 1, 130), (100, 1000, 10), (1000, 64, 10), (150, 1, 10),
                (300, 7, 130), (7, 5, 400), (40, 3, 700))
# fused_round's determinism: two launches, and rows split over two launches
ROUND_SPLIT_SHAPES = ((100, 1000, 10), (1000, 64, 10), (300, 7, 130), (7, 5, 400),
                      (40, 3, 700))
ROUND_BETAS = (0.5, 1.0, 1.5, 4.0)


def participant_weights(rng, K, device, outage=False):
    """``part * K / n_part`` with about 40 % zero-weight clients (at least
    one participant), as the SCARLET strategy passes them; all zero for a
    total outage."""
    part = (rng.random(K) < 0.6).astype(np.float32)
    part[rng.integers(K)] = 1.0
    if outage:
        part[:] = 0.0
    w = part * np.float32(K / max(part.sum(), 1.0))
    return torch.from_numpy(w.astype(np.float32)).to(device)


def slice_round_inputs(rng, device):
    """The slice shape's fused-round operands: (K, m, N) soft-labels,
    participant weights, a cache base."""
    K, m, N = SLICE["n_clients"], SLICE["public_per_round"], SLICE["n_classes"]
    return (_probs(rng, (K, m, N), device), participant_weights(rng, K, device),
            _probs(rng, (m, N), device))


def check_fused_round(device) -> float:
    from repro_torch.kernels import round_kernel

    rng = np.random.default_rng(4)
    cases = []
    for mode, bits in ROUND_MODES:
        shapes = ROUND_SHAPES + (((7, 33, 1),) if mode != "delta" else ())
        for K, m, N in shapes:
            cases.append((mode, bits, K, m, N, False))
    cases.append(("delta", 8, 7, 1000, 10, True))  # total outage: all weights 0
    worst = 0.0
    per_mode = {}  # (mode, bits) -> [worst probability error, worst linear error / sum|w|]
    for mode, bits, K, m, N, outage in cases:
        z = _probs(rng, (K, m, N), device)
        w = participant_weights(rng, K, device, outage)
        wsum = float(w.abs().sum())
        base = _probs(rng, (m, N), device) if mode == "delta" else None
        acc = per_mode.setdefault((mode, bits), [0.0, 0.0])
        for sharpen, beta in [(False, None)] + [(True, b) for b in ROUND_BETAS]:
            kw = dict(mode=mode, bits=bits, sharpen=sharpen)
            got = round_kernel.fused_round(z, w, beta, base, **kw)
            want = round_kernel.fused_round_plain(z, w, beta, base, **kw)
            _sync(device)
            err = float((got - want).abs().max())
            atol = ROUND_ATOL if sharpen else ROUND_LINEAR_RTOL * wsum
            if not (bool(torch.isfinite(got).all()) and err <= atol):
                raise AssertionError(f"fused_round {mode} bits={bits} ({K},{m},{N}) "
                                     f"outage={outage} sharpen={sharpen} "
                                     f"beta={beta}: max_abs_err {err} > {atol}")
            if sharpen:
                acc[0] = max(acc[0], err)
            elif wsum > 0:
                acc[1] = max(acc[1], err / wsum)
        worst = max(worst, acc[0])
    for (mode, bits), (e_p, e_l) in per_mode.items():
        log(f"fused_round {mode} bits={bits} over (K,m,N) in {ROUND_SHAPES}"
            f"{' + (7,33,1)' if mode != 'delta' else ''}, beta in {ROUND_BETAS}, "
            f"zero-weight clients: max_abs_err={e_p!r} (atol {ROUND_ATOL}); "
            f"linear max_abs_err/sum|w|={e_l!r} (rtol {ROUND_LINEAR_RTOL}) ok")
    # the slice shape exactly as the fused device engine calls it
    z, w, base = slice_round_inputs(rng, device)
    got = round_kernel.fused_round(z, w, BETA, base, mode="delta", bits=8)
    want = round_kernel.fused_round_plain(z, w, BETA, base, mode="delta", bits=8)
    _sync(device)
    err = float((got - want).abs().max())
    log(f"fused_round slice {tuple(z.shape)} delta+quant8 beta={BETA}: "
        f"max_abs_err={err!r} (atol {ROUND_ATOL})")
    if err > ROUND_ATOL:
        raise AssertionError(f"fused_round slice: {err} > {ROUND_ATOL}")
    for K, m, N in ROUND_SPLIT_SHAPES:
        z, base = _probs(rng, (K, m, N), device), _probs(rng, (m, N), device)
        w = participant_weights(rng, K, device)
        k = m // 3
        for sharpen, beta in ((False, None), (True, BETA)):
            kw = dict(mode="delta", bits=8, sharpen=sharpen)
            one = round_kernel.fused_round(z, w, beta, base, **kw)
            two = torch.cat([round_kernel.fused_round(z[:, :k], w, beta, base[:k], **kw),
                             round_kernel.fused_round(z[:, k:], w, beta, base[k:], **kw)])
            if not (torch.equal(one, round_kernel.fused_round(z, w, beta, base, **kw))
                    and torch.equal(one, two)):
                raise AssertionError(f"fused_round ({K},{m},{N}) sharpen={sharpen}: two "
                                     "launches, or rows split over two, differ")
    log(f"fused_round over (K,m,N) in {ROUND_SPLIT_SHAPES}: two launches equal bit for bit, "
        f"rows [:m//3] and [m//3:] in two launches equal to one ok")
    return max(worst, err)


# ---------------------------------------------------------------------------
# phase 4: the full-width slice
# ---------------------------------------------------------------------------

def run_engine(device, label: str, method: str, engine: str, *, fused: bool = False,
               codec: str = "identity", downlink: str = "identity",
               index_bytes: float = 4.0, cache_duration: int = 0,
               use_cache: Optional[bool] = None, rounds: int = SLICE_ROUNDS,
               scenario=None, probabilistic_expiry: bool = False,
               track_local_caches: bool = False, hook=None, telemetry: bool = False,
               **strategy_kw) -> dict:
    """``method`` at the slice's population through the host loop
    (``engine="host"``) or the device engine (``"scan"``): round 1, then
    the other rounds in one leg (on the device engine its only host sync
    is the read-back at its end), the launch counts set to 0 just before
    and read just after.  Selective-FD's upload masks are recorded with
    the normalized entropies they gate on, for the engines' comparison.
    ``hook(engine)`` runs once the engine is built.  With ``telemetry``
    the run's ``History`` (both legs' ledger and telemetry rows) is kept
    as ``history``."""
    from repro_torch.core import era
    from repro_torch.core.comm import CommLedger
    from repro_torch.fl import (FederatedDistillation, FLConfig, History, STRATEGIES,
                                ScannedFederatedDistillation)
    from repro_torch.kernels import ops
    from repro_torch.kernels.runtime import divide
    from repro_torch.obs.device import RoundTelemetry, TelemetryLog

    cfg = FLConfig(**SLICE, rounds=rounds, eval_every=rounds, uplink_codec=codec,
                   downlink_codec=downlink, index_bytes=index_bytes, fused_round=fused,
                   telemetry=telemetry)
    strat = STRATEGIES[method](**strategy_kw)
    masks = []
    if method == "selective_fd":
        gate = strat.upload_mask

        def recorded(z):
            um = gate(z)
            masks.append((um, divide(era.entropy(z), math.log(z.shape[-1]))))
            return um

        strat.upload_mask = recorded
    agg_s = []
    if method == "comet":  # the host k-means' share of the round
        agg = strat.aggregate

        def timed(z, um, t):
            _sync(device)
            t0 = time.perf_counter()
            out = agg(z, um, t)
            _sync(device)
            agg_s.append(time.perf_counter() - t0)
            return out

        strat.aggregate = timed
    Engine = FederatedDistillation if engine == "host" else ScannedFederatedDistillation
    t0 = time.perf_counter()
    eng = Engine(cfg, strat, cache_duration=cache_duration, use_cache=use_cache,
                 scenario=scenario, probabilistic_expiry=probabilistic_expiry,
                 track_local_caches=track_local_caches, device=device)
    _sync(device)
    t_setup = time.perf_counter() - t0
    if hook is not None:
        hook(eng)
    ops.reset_launches()
    t0 = time.perf_counter()
    first = eng.run(1)
    _sync(device)
    t1 = time.perf_counter()
    rest = eng.run(rounds - 1)
    _sync(device)
    t2 = time.perf_counter()
    launches = ops.launches()
    if device.type == "cuda" and torch.cuda.get_sync_debug_mode() != 0:
        raise AssertionError("the engine left the sync debug mode set")

    per_round = (t2 - t1) / (rounds - 1)
    ledger = first.ledger.rounds + rest.ledger.rounds
    summary = CommLedger(ledger).summary()
    sa, ca = rest.final_server_acc, rest.final_client_acc
    sync = ("synchronized" if engine == "host" else
            "rounds under sync debug mode 'error', one read-back at the end")
    log(f"{label}: setup {t_setup:.3f} s, first round {t1 - t0:.4f} s, then "
        f"{per_round * 1e3:.3f} ms/round over {rounds - 1} rounds (host clock, {sync}; "
        "one eval included)")
    log(f"{label}: per-round ledger {[(r.uplink, r.downlink) for r in ledger]}")
    log(f"{label}: ledger {json.dumps(summary)}")
    log(f"{label}: final server_acc={sa!r} client_acc={ca!r}")
    log(f"{label}: launches {launches}")
    run = dict(eng=eng, ledger=ledger, launches=launches, per_round_ms=per_round * 1e3,
               summary=summary, masks=masks, aggregate_s=agg_s, label=label,
               accs=first.server_acc + first.client_acc + rest.server_acc + rest.client_acc)
    if telemetry:
        a, b = first.telemetry.stacks(), rest.telemetry.stacks()
        tel_log = TelemetryLog.from_stacked(RoundTelemetry(*(
            np.concatenate([a[f], b[f]]) for f in RoundTelemetry._fields)))
        run["history"] = History(rounds=rest.rounds, server_acc=rest.server_acc,
                                 client_acc=rest.client_acc, ledger=CommLedger(ledger),
                                 final_server_acc=sa, final_client_acc=ca, telemetry=tel_log)
        run["telemetry"] = tel_log.stacks()
    check_outputs(run, sa, ca)
    return run


def check_outputs(run: dict, sa: float, ca: float) -> None:
    """Accuracies above chance; the last teacher and the cached teachers
    finite probability rows."""
    N = SLICE["n_classes"]
    if not (np.isfinite(sa) and np.isfinite(ca) and sa > 1.0 / N and ca > 1.0 / N):
        raise AssertionError(f"{run['label']}: accuracies not above chance: {sa}, {ca}")
    eng = run["eng"]
    for rows in (eng.prev_teacher[1], eng.cache_g.values[eng.cache_g.present]):
        sums = rows.sum(-1)
        if not (torch.isfinite(rows).all()
                and torch.allclose(sums, torch.ones_like(sums), atol=1e-5)):
            raise AssertionError(f"{run['label']}: teachers are not finite probability rows")


def run_slice(device) -> dict:
    """Phase 4: SCARLET through the host loop; the ERA and qdq kernels
    once a round each (no round here is an outage: participation is full)."""
    sl = run_engine(device, "slice", "scarlet", "host", codec=CODEC,
                    cache_duration=CACHE_DURATION, beta=BETA)
    check_launches(sl["launches"], {"enhanced_era_fused": SLICE_ROUNDS,
                                    "quantize_dequantize": SLICE_ROUNDS})
    check_slice_round1(sl)
    return sl


def check_launches(got: dict, want: dict) -> None:
    """``got`` equals ``want``, with every kernel ``want`` does not name at 0."""
    want = dict(dict.fromkeys(got, 0), **want)
    if got != want:
        raise AssertionError(f"kernel launches {got}, expected {want}")


def check_slice_round1(run: dict) -> None:
    """Round 1's analytic bytes: every sample misses; the uplink carries
    the 8-bit residual of N-1 classes, the downlink fp32 labels + request
    list + signals."""
    K, m, N = SLICE["n_clients"], SLICE["public_per_round"], SLICE["n_classes"]
    want_up = float(K * (m * (N - 1) * 8 / 8.0))
    want_down = float(K * (m * N * 4.0 + m * 4.0 + m * 4.0 + m * 0.25))
    r1 = run["ledger"][0]
    if (r1.uplink, r1.downlink) != (want_up, want_down):
        raise AssertionError(f"round-1 ledger {r1} != ({want_up}, {want_down})")


# ---------------------------------------------------------------------------
# phase 4b: the device-resident engine at the same width
# ---------------------------------------------------------------------------

def run_device_slice(device, fused: bool) -> dict:
    """Phase 4b: SCARLET through ``engine="scan"``; fused: one fused_round
    a round and neither per-op kernel; per-op: the qdq and ERA kernels
    once a round each."""
    r = run_engine(device, "device engine " + ("fused" if fused else "per-op"), "scarlet",
                   "scan", fused=fused, codec=CODEC, cache_duration=CACHE_DURATION, beta=BETA)
    n = SLICE_ROUNDS
    check_launches(r["launches"],
                   {"fused_round": n} if fused else
                   {"enhanced_era_fused": n, "quantize_dequantize": n})
    check_slice_round1(r)
    return r


def compare_runs(label: str, a: dict, b: dict, ledger_rtol: float,
                 values_atol: float) -> None:
    """Per-round ledgers (equal when ``ledger_rtol`` is 0), cache
    timestamps and presence equal, cache values to ``values_atol``."""
    la = np.array([(r.uplink, r.downlink) for r in a["ledger"]])
    lb = np.array([(r.uplink, r.downlink) for r in b["ledger"]])
    ledger_ok = (la.shape == lb.shape and
                 (np.array_equal(la, lb) if ledger_rtol == 0
                  else np.allclose(la, lb, rtol=ledger_rtol, atol=0)))
    ca, cb = a["eng"].cache_g, b["eng"].cache_g
    same = torch.equal(ca.ts, cb.ts) and torch.equal(ca.present, cb.present)
    err = float((ca.values - cb.values).abs().max())
    log(f"{label}: per-round ledger {'equal' if ledger_rtol == 0 else 'allclose'}="
        f"{ledger_ok} (rtol {ledger_rtol}); cache ts/present equal={same}; "
        f"cache values max_abs_err={err!r} (atol {values_atol})")
    if not (ledger_ok and same and err <= values_atol):
        raise AssertionError(f"{label}: runs differ")


def check_sync_guard() -> None:
    """A host read inside a device round must fail the run: the guard the
    slice runs above rely on is live."""
    from repro_torch.fl import FLConfig, STRATEGIES, ScannedFederatedDistillation

    class Syncing(ScannedFederatedDistillation):
        def _round_device(self, st, t, part, idx, do_eval):
            float(part.sum())  # reads the card from the host
            return super()._round_device(st, t, part, idx, do_eval)

    eng = Syncing(FLConfig(**SMALL), STRATEGIES["scarlet"](beta=BETA),
                  cache_duration=2, device="cuda")
    try:
        eng.run(1)
    except RuntimeError as e:
        log(f"sync guard: a host read inside a round raised: {str(e).splitlines()[0]}")
    else:
        raise AssertionError("a host sync inside a device round did not raise")
    if torch.cuda.get_sync_debug_mode() != 0:
        raise AssertionError("the engine left the sync debug mode set")


# ---------------------------------------------------------------------------
# phase 4f: the comparison methods (CFD, Selective-FD, mean) at full width
# ---------------------------------------------------------------------------

def request_masks(rounds: int, D: int, seed: int, uniforms=None,
                  expired: Optional[list] = None) -> list:
    """Each round's requests (bool over sorted P^t), from the engines'
    numpy P^t stream (Generator ``[seed, 17]``, as ``_draw_round`` draws
    it) and Alg. 3's test at full participation: absent, or older than
    ``D`` rounds; with ``uniforms(t)`` (the round's (m,) float32 expiry
    uniforms), absent or expired where ``u < clip((age - 1) / D, 0, 1)``
    in float32.  ``expired`` receives each round's count of present
    entries requested again."""
    m, n_pub = SLICE["public_per_round"], SLICE["public_size"]
    rng = np.random.default_rng([seed, 17])
    ts = np.zeros(n_pub, np.int64)
    present = np.zeros(n_pub, bool)
    out = []
    f32 = np.float32
    for t in range(1, rounds + 1):
        idx = np.sort(rng.choice(n_pub, m, replace=False))
        if not D:
            miss = np.ones(m, bool)
        elif uniforms is None:
            miss = ~(present[idx] & (t - ts[idx] <= D))
        else:
            age = (t - ts[idx]).astype(f32)
            hazard = np.clip((age - f32(1.0)) / f32(D), f32(0.0), f32(1.0))
            miss = ~(present[idx] & ~(uniforms(t) < hazard))
        if expired is not None:
            expired.append(int((miss & present[idx]).sum()))
        out.append(miss)
        ts[idx[miss]], present[idx[miss]] = t, True
    return out


def check_selective_fd_ledger(run: dict, use_cache: bool, host: bool) -> None:
    """Each round's bytes from its request count and its recorded upload
    mask, exactly: the downlink carries every requested sample; the
    uplink each client's mean count of uploaded requested samples, in the
    engine's arithmetic (host float64, device float32, the reference's
    order of operations).  The uplink never exceeds the full upload, and
    the gate withholds in some round."""
    K, m, N = SLICE["n_clients"], SLICE["public_per_round"], SLICE["n_classes"]
    misses = request_masks(len(run["ledger"]), CACHE_DURATION if use_cache else 0,
                           run["eng"].cfg.seed)
    n_req, below = [], []
    for t, (r, miss, (um, _)) in enumerate(zip(run["ledger"], misses, run["masks"]), start=1):
        n = int(miss.sum())
        uploaded = int(um.cpu().numpy()[:, miss].sum())
        down = float(K * (n * N * 4.0 + n * 4.0 + m * 4.0 + (m * 0.25 if use_cache else 0.0)))
        if host:
            up = K * (uploaded / K * N * 32.0 / 8.0)
        else:
            f = np.float32
            up = float(f(K) * (f(uploaded) / f(K) * f(N) * f(32.0) / f(8.0)))
        full_up = float(K * n * N * 4.0)
        if (r.uplink, r.downlink) != (up, down) or r.uplink > full_up:
            raise AssertionError(f"{run['label']} round {t}: ledger {r}, {n} requests, "
                                 f"{uploaded} uploaded: want ({up!r}, {down!r}), uplink at "
                                 f"most {full_up}")
        n_req.append(n)
        below.append(r.uplink < full_up)
    log(f"{run['label']}: requests a round {n_req}; uplink below the full upload in rounds "
        f"{[t for t, b in enumerate(below, start=1) if b]}; every round's bytes equal the "
        "analytic value for its requests and uploads ok")
    if not any(below):
        raise AssertionError(f"{run['label']}: the confidence gate withheld nothing")


def compare_masks(a: dict, b: dict, tau: float) -> None:
    """The two engines' upload masks, round by round; where they differ,
    each entry and its normalized entropy's distance from ``1 - tau``."""
    differ = 0
    for t, ((ma, ha), (mb, hb)) in enumerate(zip(a["masks"], b["masks"]), start=1):
        bad = (ma != mb).nonzero()
        differ += len(bad)
        for k, i in bad.tolist()[:50]:
            log(f"mask differs: round {t} client {k} sample {i}: host {bool(ma[k, i])} "
                f"device {bool(mb[k, i])}; distance from the threshold "
                f"{float(ha[k, i]) - (1.0 - tau)!r} / {float(hb[k, i]) - (1.0 - tau)!r}")
    n = sum(int(m.numel()) for m, _ in a["masks"])
    withheld = sum(int((~m).sum()) for m, _ in a["masks"])
    log(f"{a['label']} vs {b['label']}: upload masks over {len(a['masks'])} rounds, "
        f"{n} entries, {withheld} withheld; {differ} differ")
    if len(a["masks"]) != len(b["masks"]) or differ:
        raise AssertionError(f"{a['label']} vs {b['label']}: {differ} mask entries differ")


def run_comparison_methods(device, card: str) -> None:
    """Phase 4f: CFD on both engines (its 1-bit uplink through the qdq
    kernel, once a round), Selective-FD on both engines without and with
    the cache, and mean on the device engine."""
    def run(method, engine, use_cache=False):
        label = f"{method} {'host loop' if engine == 'host' else 'device engine per-op'}"
        label += f" cache D={CACHE_DURATION}" if use_cache else ""
        return run_engine(device, label, method, engine, use_cache=use_cache,
                          cache_duration=CACHE_DURATION if use_cache else 0,
                          rounds=COMPARISON_ROUNDS)

    runs = {}
    for engine in ("host", "scan"):
        r = run("cfd", engine)
        check_launches(r["launches"], {"quantize_dequantize": COMPARISON_ROUNDS})
        r1 = (r["ledger"][0].uplink, r["ledger"][0].downlink)
        if r1 != CFD_ROUND1:
            raise AssertionError(f"{r['label']}: round-1 ledger {r1} != {CFD_ROUND1}")
        log(f"{r['label']}: round-1 ledger {r1} ok; quantize_dequantize once a round ok")
        runs[f"cfd {engine}"] = r
    compare_runs("cfd device engine vs host loop", runs["cfd scan"], runs["cfd host"],
                 1e-7, ERA_ATOL)
    tau = 0.0625  # Selective-FD's default tau_client
    for use_cache in (False, True):
        pair = []
        for engine in ("host", "scan"):
            r = run("selective_fd", engine, use_cache)
            check_launches(r["launches"], {})
            check_selective_fd_ledger(r, use_cache, host=engine == "host")
            pair.append(r)
            runs[f"selective_fd {engine}" + (" cache" if use_cache else "")] = r
        compare_masks(pair[0], pair[1], tau)
        compare_runs(f"selective_fd{' cache' if use_cache else ''} device engine vs host loop",
                     pair[1], pair[0], SFD_LEDGER_RTOL, ERA_ATOL)
    r = run("mean", "scan")
    check_launches(r["launches"], {})
    runs["mean scan"] = r
    runs["comet host cache"] = run_comet(device)
    for method in ("fedavg", "individual"):
        runs[f"{method} host"] = run_baseline(device, method)
    pair = [run_topk_scarlet(device, engine) for engine in ("host", "scan")]
    runs["scarlet topk host"], runs["scarlet topk scan"] = pair
    compare_runs("scarlet topk device engine vs host loop", pair[1], pair[0], 1e-7, ERA_ATOL)
    log(f"comparison methods ({card}): " + ", ".join(
        f"{k} {v['per_round_ms']:.3f} ms/round" for k, v in runs.items()))


def check_codec_ledger(run: dict, up_bytes, down_bytes, uniforms=None,
                       expired: Optional[list] = None) -> None:
    """Each round's bytes at full participation with the cache on:
    ``up_bytes(n)`` and ``down_bytes(n)`` a client for ``n`` requested
    samples (``request_masks``, with ``uniforms`` under probabilistic
    expiry), the downlink with the request list and the signals over all
    of P^t (indices at the run's ``index_bytes``)."""
    K, m = SLICE["n_clients"], SLICE["public_per_round"]
    cfg = run["eng"].cfg
    ib = cfg.index_bytes
    misses = request_masks(len(run["ledger"]), CACHE_DURATION, cfg.seed, uniforms, expired)
    for t, (r, miss) in enumerate(zip(run["ledger"], misses), start=1):
        n = int(miss.sum())
        want = (float(K * up_bytes(n)),
                float(K * (down_bytes(n) + n * ib + m * ib + m * 0.25)))
        if (r.uplink, r.downlink) != want:
            raise AssertionError(f"{run['label']} round {t}: ledger {r}, {n} requests: "
                                 f"want {want}")
    log(f"{run['label']}: requests a round {[int(x.sum()) for x in misses]}; every "
        "round's bytes equal the analytic value ok")


def run_comet(device) -> dict:
    """COMET on the host loop: qdq three times a round (the uplink's
    residual, the downlink's shared teacher and per-client stack), each
    round's bytes analytic, and clients of different clusters distilling
    on different teachers."""
    N = SLICE["n_classes"]
    r = run_engine(device, f"comet host loop cache D={CACHE_DURATION}", "comet", "host",
                   codec=CODEC, downlink=COMET_DOWNLINK, use_cache=True,
                   cache_duration=CACHE_DURATION, rounds=COMPARISON_ROUNDS)
    check_launches(r["launches"],
                   {"quantize_dequantize": COMET_QDQ_A_ROUND * COMPARISON_ROUNDS})
    check_codec_ledger(r, lambda n: n * (N - 1) * 8 / 8.0, lambda n: n * N * 8 / 8.0)
    teach = r["eng"].prev_teacher[1]
    K = SLICE["n_clients"]
    if tuple(teach.shape) != (K, SLICE["public_per_round"], N):
        raise AssertionError(f"comet: per-client teachers of shape {tuple(teach.shape)}")
    n_distinct = int(torch.unique(teach.reshape(K, -1), dim=0).shape[0])
    agg_ms = statistics.mean(r["aggregate_s"][1:]) * 1e3
    log(f"{r['label']}: quantize_dequantize {COMET_QDQ_A_ROUND} a round ok; "
        f"{n_distinct} distinct per-client teachers among {K} clients; aggregate "
        f"(host k-means and cluster teachers, synchronized) {agg_ms:.3f} ms a round "
        f"after round 1, of {r['per_round_ms']:.3f}")
    if n_distinct < 2:
        raise AssertionError("comet: every client got the same teacher")
    return r


def run_baseline(device, method: str) -> dict:
    """FedAvg or Individual at the slice's population: round 1, then the
    other rounds (host clock), no kernel launched; round 1's bytes are
    FedAvg's two copies of the model a client, Individual's none."""
    from repro_torch.fl import FedAvg, FLConfig, Individual
    from repro_torch.kernels import ops

    rounds = COMPARISON_ROUNDS
    cfg = FLConfig(**SLICE, rounds=rounds, eval_every=rounds)
    t0 = time.perf_counter()
    b = (FedAvg if method == "fedavg" else Individual)(cfg, device=device)
    _sync(device)
    t_setup = time.perf_counter() - t0
    ops.reset_launches()
    t0 = time.perf_counter()
    first = b.run(1)
    _sync(device)
    t1 = time.perf_counter()
    rest = b.run(rounds - 1)
    _sync(device)
    t2 = time.perf_counter()
    launches = ops.launches()
    per_round = (t2 - t1) / (rounds - 1)
    label = f"{method} host"
    K, n_params = SLICE["n_clients"], b.fd.n_params
    want = ((K * n_params * 4.0, K * n_params * 4.0) if method == "fedavg" else (0.0, 0.0))
    r1 = first.ledger.rounds[0]
    accs = first.server_acc + first.client_acc + rest.server_acc + rest.client_acc
    log(f"{label}: setup {t_setup:.3f} s, first round {t1 - t0:.4f} s, then "
        f"{per_round * 1e3:.3f} ms/round over {rounds - 1} rounds (host clock, synchronized; "
        "one eval included)")
    log(f"{label}: round-1 ledger {(r1.uplink, r1.downlink)} ({n_params} parameters); "
        f"final server_acc={rest.final_server_acc!r} client_acc={rest.final_client_acc!r}; "
        f"launches {launches}")
    if (r1.uplink, r1.downlink) != want:
        raise AssertionError(f"{label}: round-1 ledger {r1} != {want}")
    check_launches(launches, {})
    if not all(np.isfinite(a) and 0.0 <= a <= 1.0 for a in accs):
        raise AssertionError(f"{label}: accuracies outside [0, 1]: {accs}")
    if method == "individual" and rest.final_server_acc is not None:
        raise AssertionError("individual: a server accuracy was reported")
    return dict(per_round_ms=per_round * 1e3, launches=launches, label=label)


def run_topk_scarlet(device, engine: str) -> dict:
    """SCARLET with the top-k residual uplink on the host loop or the
    per-op device engine: the ERA kernel once a round, no qdq; round 1
    sends 2 values and 2 indices for each of the 1000 samples."""
    K, m, N = SLICE["n_clients"], SLICE["public_per_round"], SLICE["n_classes"]
    label = f"scarlet {TOPK_CODEC} " + ("host loop" if engine == "host"
                                        else "device engine per-op")
    r = run_engine(device, label, "scarlet", engine, codec=TOPK_CODEC,
                   index_bytes=TOPK_INDEX_BYTES, cache_duration=CACHE_DURATION,
                   rounds=COMPARISON_ROUNDS, beta=BETA)
    check_launches(r["launches"], {"enhanced_era_fused": COMPARISON_ROUNDS})
    up1 = float(K * m * 2 * (4.0 + TOPK_INDEX_BYTES))
    if r["ledger"][0].uplink != up1:
        raise AssertionError(f"{label}: round-1 uplink {r['ledger'][0].uplink} != {up1}")
    check_codec_ledger(r, lambda n: n * 2 * (4.0 + TOPK_INDEX_BYTES),
                       lambda n: n * N * 4.0)
    return r


# ---------------------------------------------------------------------------
# phase 4g: the engine options at full width
# ---------------------------------------------------------------------------

def het_scenario():
    """Full participation, client k on HET_STEPS[k % 4] local steps at
    HET_LR_SCALE[k % 3] times the lr, decayed by HET_LR_DECAY a round."""
    from repro_torch.fl import Heterogeneity, Scenario

    K = SLICE["n_clients"]
    return Scenario(heterogeneity=Heterogeneity(
        local_steps=tuple(HET_STEPS[k % len(HET_STEPS)] for k in range(K)),
        lr_scale=tuple(HET_LR_SCALE[k % len(HET_LR_SCALE)] for k in range(K)),
        lr_decay=HET_LR_DECAY))


def watch_frozen(eng, record: list) -> None:
    """Wrap the engine's local training: each round, keep device copies
    of the E_k = 0 clients' rows of every leaf before and after it (no
    host read, so the device engine's sync guard stays quiet)."""
    K = SLICE["n_clients"]
    zero = torch.tensor([k for k in range(K) if HET_STEPS[k % len(HET_STEPS)] == 0],
                        device=eng.device)
    if eng.models.n_cohorts != 1:
        raise AssertionError("the slice has one client cohort")
    inner = eng._local_train_all

    def wrapped(params, t):
        out = inner(params, t)
        record.append([(params[0][k].index_select(0, zero), out[0][k].index_select(0, zero))
                       for k in params[0]])
        return out

    eng._local_train_all = wrapped


def options_run(device, label: str, engine: str, fused: bool, hook=None) -> dict:
    return run_engine(device, f"options {label}", "scarlet", engine, fused=fused, codec=CODEC,
                      cache_duration=CACHE_DURATION, scenario=het_scenario(),
                      probabilistic_expiry=True, hook=hook, beta=BETA)


def run_engine_options(device, card: str) -> dict:
    """Phase 4g (a): heterogeneous schedules with probabilistic expiry on
    the host loop and the device engine, per-op and fused."""
    K, N = SLICE["n_clients"], SLICE["n_classes"]
    runs = {}
    for label, engine, fused in (("host loop", "host", False),
                                 ("device engine per-op", "scan", False),
                                 ("device engine fused", "scan", True)):
        rec: list = []
        r = options_run(device, label, engine, fused,
                        hook=lambda e, rec=rec: watch_frozen(e, rec))
        n = SLICE_ROUNDS
        check_launches(r["launches"], {"fused_round": n} if fused else
                       {"enhanced_era_fused": n, "quantize_dequantize": n})
        expired: list = []
        check_codec_ledger(r, lambda n: n * (N - 1) * 8 / 8.0, lambda n: n * N * 4.0,
                           uniforms=r["eng"].expiry_uniforms, expired=expired)
        moved = [not torch.equal(a, b) for rnd in rec for a, b in rnd]
        n_zero = sum(1 for k in range(K) if HET_STEPS[k % len(HET_STEPS)] == 0)
        log(f"{r['label']}: expired requests a round {expired}; {n_zero} clients with "
            f"E_k = 0 unchanged by local training in {len(rec)} of {n} rounds "
            f"(leaves moved: {sum(moved)}); {r['per_round_ms']:.3f} ms/round ({card})")
        if len(rec) != n or any(moved):
            raise AssertionError(f"{r['label']}: an E_k = 0 client moved in local training")
        if not sum(expired):
            raise AssertionError(f"{r['label']}: no request expired")
        runs[label] = r
    host, perop, fused = (runs[k] for k in ("host loop", "device engine per-op",
                                            "device engine fused"))
    compare_runs("options per-op device engine vs host loop", perop, host, 1e-7, ERA_ATOL)
    compare_runs("options fused vs per-op device engine", fused, perop, 1e-7, QUANT_STEP_ATOL)
    compare_runs("options fused device engine vs host loop", fused, host, 1e-7,
                  QUANT_STEP_ATOL)
    log(f"engine options ({card}): " + ", ".join(
        f"{k} {v['per_round_ms']:.3f} ms/round" for k, v in runs.items())
        + f"; {max(HET_STEPS)} masked local steps a round against the slice's "
        f"{host['eng'].cfg.local_steps}")
    return runs


def state_leaves(eng) -> dict:
    from repro_torch.checkpoint.io import _flatten, _key

    return {_key(k): v for k, v in _flatten(eng.state_dict())}


def run_restore(device, card: str, uninterrupted: dict) -> None:
    """Phase 4g (b): (a)'s configuration for RESTORE_AT rounds, a
    checkpoint in a temporary directory, a fresh engine restored from it,
    the remaining rounds; against (a)'s uninterrupted run, on the host
    loop and the fused device engine: ledgers and state bit for bit."""
    import tempfile

    from repro_torch.checkpoint import load_pytree, save_pytree
    from repro_torch.fl import FederatedDistillation, STRATEGIES, ScannedFederatedDistillation

    for label, engine in (("host loop", FederatedDistillation),
                          ("device engine fused", ScannedFederatedDistillation)):
        full = uninterrupted[label]

        def make():
            return engine(full["eng"].cfg, STRATEGIES["scarlet"](beta=BETA),
                          cache_duration=CACHE_DURATION, probabilistic_expiry=True,
                          scenario=het_scenario(), device=device)

        first = make()
        h1 = first.run(RESTORE_AT)
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "engine.npz")
            _sync(device)
            t0 = time.perf_counter()
            save_pytree(path, first.state_dict())
            t1 = time.perf_counter()
            size = os.path.getsize(path)
            restored = make()
            _sync(device)
            t2 = time.perf_counter()
            restored.load_state_dict(load_pytree(path, restored.state_dict()))
            _sync(device)
            t3 = time.perf_counter()
        h2 = restored.run(SLICE_ROUNDS - RESTORE_AT)
        ledger = [(r.uplink, r.downlink) for r in h1.ledger.rounds + h2.ledger.rounds]
        want = [(r.uplink, r.downlink) for r in full["ledger"]]
        a, b = state_leaves(restored), state_leaves(full["eng"])
        differ = [k for k in b if k not in a or not torch.equal(a[k], b[k])]
        log(f"restore {label}: {RESTORE_AT} rounds, checkpoint {size} bytes "
            f"(save {t1 - t0:.3f} s, restore {t3 - t2:.3f} s, host clock), "
            f"{SLICE_ROUNDS - RESTORE_AT} more rounds: ledger equal={ledger == want}; "
            f"{len(b)} state leaves, {len(differ)} differ from the uninterrupted run "
            f"{differ[:5]} ({card})")
        if ledger != want or differ or a.keys() != b.keys():
            raise AssertionError(f"restore {label}: the split run differs")


def run_mirrors(device, card: str) -> None:
    """Phase 4g (c): mirrored local caches on the host loop at
    MIRROR_PARTICIPATION with MIRROR_OUTAGE's client offline: after every
    round each participant's mirror (catch-up package applied on return,
    then Alg. 2's local update) equals the global cache bit for bit."""
    from repro_torch.fl import Outage, Scenario, fixed_fraction

    scenario = Scenario(participation=fixed_fraction(MIRROR_PARTICIPATION),
                        outages=(Outage(*MIRROR_OUTAGE),))
    stats = dict(checked=0, returning=0, bad=[], back=[])

    def hook(eng):
        inner = eng._round

        def wrapped(t, hist, u):
            before = eng.last_sync.copy()
            inner(t, hist, u)
            took_part = np.nonzero(eng.last_sync == t)[0]
            for k in took_part:
                stats["checked"] += 1
                stats["returning"] += int(before[k] < t - 1)
                if not all(torch.equal(a, b) for a, b in zip(eng.local_caches[k], eng.cache_g)):
                    stats["bad"].append((t, int(k)))
            if MIRROR_OUTAGE[0] in took_part and t > MIRROR_OUTAGE[2]:
                stats["back"].append(t)

        eng._round = wrapped

    r = run_engine(device, "mirrors host loop", "scarlet", "host", codec=CODEC,
                   cache_duration=CACHE_DURATION, scenario=scenario,
                   track_local_caches=True, hook=hook, beta=BETA)
    check_launches(r["launches"], {"enhanced_era_fused": SLICE_ROUNDS,
                                   "quantize_dequantize": SLICE_ROUNDS})
    log(f"{r['label']}: {stats['checked']} (client, round) mirrors checked, "
        f"{stats['returning']} of them returning stragglers (catch-up applied); client "
        f"{MIRROR_OUTAGE[0]} offline in rounds {MIRROR_OUTAGE[1]}-{MIRROR_OUTAGE[2]} took part "
        f"again in rounds {stats['back']}; {len(stats['bad'])} differ from the global cache "
        f"{stats['bad'][:5]}; {r['per_round_ms']:.3f} ms/round ({card})")
    if stats["bad"] or not stats["returning"]:
        raise AssertionError("mirrored local caches differ from the global cache")


# ---------------------------------------------------------------------------
# phase 4h: run telemetry at full width
# ---------------------------------------------------------------------------

TEL_ENGINES = (("host loop", "host", False), ("device engine per-op", "scan", False),
               ("device engine fused", "scan", True))


def path_launches(fused: bool, telemetry: bool) -> dict:
    """The slice's launches a 10-round run: the fused engine's telemetry
    adds one qdq a round (the server's view of the transmitted stack)."""
    n = SLICE_ROUNDS
    if fused:
        return dict(fused_round=n, **({"quantize_dequantize": n} if telemetry else {}))
    return {"enhanced_era_fused": n, "quantize_dequantize": n}


def hold_telemetry(label: str, runs: dict, perop_same_state: bool) -> None:
    """The three engines' stacks: counters and bytes equal; gauges against
    the host loop's to TEL_GAUGE_ATOL where the state is the same (round 1;
    every round for the per-op engine when ``perop_same_state``), the fused
    engine's post-sharpening entropy to TEL_FUSED_POST_ATOL; after that to
    TEL_TRAJECTORY_RTOL (see the phase's comment), the differences printed."""
    from repro_torch.obs.device import EXACT_FIELDS, GAUGE_FIELDS

    host, perop, fused = (runs[k]["telemetry"] for k, _, _ in TEL_ENGINES)
    bad = [f"{f} ({name})" for f in EXACT_FIELDS for name, other in
           (("per-op", perop), ("fused", fused))
           if other[f].dtype != host[f].dtype or not np.array_equal(other[f], host[f])]
    failed = list(bad)
    for name, other in (("per-op", perop), ("fused", fused)):
        same = SLICE_ROUNDS if (name == "per-op" and perop_same_state) else 1
        for f in GAUGE_FIELDS:
            d = np.abs(other[f].astype(np.float64) - host[f])
            atol = TEL_FUSED_POST_ATOL if (name, f) == ("fused", "teacher_entropy_post") \
                else TEL_GAUGE_ATOL
            rel = d / np.maximum(np.abs(host[f]), 1e-30)
            log(f"telemetry {label} {name} vs host loop {f}: max_abs_err rounds 1-{same} "
                f"{float(d[:same].max())!r} (atol {atol}), all rounds {d.tolist()} "
                f"(rel max {float(rel.max())!r}, limit {TEL_TRAJECTORY_RTOL})")
            if d[:same].max() > atol or rel.max() > TEL_TRAJECTORY_RTOL:
                failed.append(f"{f} ({name})")
    log(f"telemetry {label}: counters and bytes equal on the three engines: {not bad} "
        f"{bad[:4]}")
    if failed:
        raise AssertionError(f"telemetry {label}: the engines' rows differ: {failed}")


def capture_rows(eng, record: list) -> None:
    """Wrap the engine's ``_telemetry_row``: each round, keep device copies
    of its inputs and the row it returned (no host read, so the device
    engine's sync guard stays quiet)."""
    inner = eng._telemetry_row

    def wrapped(**kw):
        tel = inner(**kw)
        record.append(dict({k: kw[k].clone() for k in ("part", "z_tx", "z_srv", "fresh")},
                           tel=tel))
        return tel

    eng._telemetry_row = wrapped


def check_recomputed(run: dict, record: list) -> None:
    """Each round's gauges against a float64 numpy recomputation from the
    round's own inputs, to TEL_GAUGE_ATOL."""
    def entropy(p):
        p = np.clip(p, 1e-12, 1.0)
        return float(np.mean(-np.sum(p * np.log(p), axis=-1)))

    worst = dict.fromkeys(("teacher_entropy_pre", "teacher_entropy_post", "beta",
                           "codec_quant_error"), 0.0)
    for rec in record:
        part, z_tx, z_srv, fresh = (rec[k].double().cpu().numpy()
                                    for k in ("part", "z_tx", "z_srv", "fresh"))
        n = max(part.sum(), 1.0)
        want = dict(teacher_entropy_pre=entropy(np.tensordot(part, z_srv, 1) / n),
                    teacher_entropy_post=entropy(fresh), beta=BETA,
                    codec_quant_error=float(np.sum(np.abs(z_srv - z_tx) * part[:, None, None])
                                            / max(n * z_srv[0].size, 1.0)))
        for f, w in want.items():
            worst[f] = max(worst[f], abs(float(getattr(rec["tel"], f)) - w))
    log(f"{run['label']}: gauges against a float64 recomputation from each round's "
        f"inputs, {len(record)} rounds: max_abs_err {worst} (atol {TEL_GAUGE_ATOL})")
    if len(record) != SLICE_ROUNDS or max(worst.values()) > TEL_GAUGE_ATOL:
        raise AssertionError(f"{run['label']}: gauges differ from their recomputation")


def check_census(run: dict) -> None:
    """(a)'s rows: the Alg. 3 census equal to request_masks' numpy replay;
    full participation; bytes equal to the ledger's rows in float32; beta;
    sharpening; the 8-bit codec error in (0, 1/255]."""
    st = run["telemetry"]
    m, K = SLICE["public_per_round"], SLICE["n_clients"]
    expired: list = []
    req = np.array([int(x.sum()) for x in request_masks(
        SLICE_ROUNDS, CACHE_DURATION, run["eng"].cfg.seed,
        run["eng"].expiry_uniforms, expired)])
    led = np.array([(r.uplink, r.downlink) for r in run["ledger"]], np.float32)
    checks = {
        "cache_expired == expired requests": np.array_equal(st["cache_expired"], expired),
        "cache_miss_new + cache_expired == requests": np.array_equal(
            st["cache_miss_new"] + st["cache_expired"], req),
        "cache_hits == |P^t| - requests": np.array_equal(st["cache_hits"], m - req),
        "participants == K": np.array_equal(st["participants"], np.full((SLICE_ROUNDS, 1), K)),
        "bytes == ledger": (np.array_equal(st["uplink_bytes"], led[:, 0])
                            and np.array_equal(st["downlink_bytes"], led[:, 1])),
        "beta == 1.5": bool((st["beta"] == np.float32(BETA)).all()),
        "entropy post < pre": bool((st["teacher_entropy_post"]
                                    < st["teacher_entropy_pre"]).all()),
        "codec error in (0, 1/255]": bool(((st["codec_quant_error"] > 0)
                                           & (st["codec_quant_error"] <= 1 / 255)).all()),
    }
    log(f"{run['label']}: requests {req.tolist()}, expired {st['cache_expired'].tolist()}, "
        f"hits {st['cache_hits'].tolist()}; teacher entropy pre "
        f"{st['teacher_entropy_pre'].tolist()} post {st['teacher_entropy_post'].tolist()}; "
        f"codec error {st['codec_quant_error'].tolist()}; launches {run['launches']}; "
        f"{run['per_round_ms']:.3f} ms/round")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{run['label']}: telemetry rows fail {failed}")


def telemetry_run(device, label: str, engine: str, fused: bool, telemetry: bool,
                  stragglers: bool = False, capture: bool = False, tag: str = "") -> dict:
    """(a)'s configuration, or (b)'s straggler scenario, on one engine;
    ``capture``: each round's gauges held against their recomputation."""
    from repro_torch.fl import Outage, Scenario, fixed_fraction

    kw = (dict(scenario=Scenario(participation=fixed_fraction(MIRROR_PARTICIPATION),
                                 outages=(Outage(*MIRROR_OUTAGE),)))
          if stragglers else dict(scenario=het_scenario(), probabilistic_expiry=True))
    record: list = []
    r = run_engine(device, f"telemetry {tag} {label}", "scarlet", engine, fused=fused,
                   codec=CODEC, cache_duration=CACHE_DURATION, telemetry=telemetry,
                   hook=(lambda e: capture_rows(e, record)) if capture else None,
                   beta=BETA, **kw)
    if device.type == "cuda":
        check_launches(r["launches"], path_launches(fused, telemetry))
    if capture:
        check_recomputed(r, record)
    return r


def run_telemetry(device, card: str, tracer) -> dict:
    """Phase 4h (a)-(c); (a)'s three runs inside ``tracer``."""
    on, off, strag = {}, {}, {}
    for label, engine, fused in TEL_ENGINES:
        with tracer.span(label, engine=engine, fused=fused, rounds=SLICE_ROUNDS):
            on[label] = telemetry_run(device, label, engine, fused, True, capture=True,
                                      tag="(a)")
        check_census(on[label])
    hold_telemetry("(a) options", on, perop_same_state=True)

    K, m, N = SLICE["n_clients"], SLICE["public_per_round"], SLICE["n_classes"]
    ib = 4.0
    for label, engine, fused in TEL_ENGINES:
        r = strag[label] = telemetry_run(device, label, engine, fused, True, stragglers=True,
                                         capture=True, tag="(b) stragglers")
        st = r["telemetry"]
        n_part = st["participants"].sum(1)
        if label == "host loop":  # the catch-up share: downlink less the broadcast
            misses = request_masks(SLICE_ROUNDS, CACHE_DURATION, r["eng"].cfg.seed)
            share = np.array([d.downlink - n_part[i] * (n * N * 4.0 + n * ib + m * ib + m * 0.25)
                              for i, (d, n) in enumerate(zip(r["ledger"],
                                                             (int(x.sum()) for x in misses)))],
                             np.float32)
        checks = {
            "catch_up_clients": int(st["catch_up_clients"].sum()) == TEL_CATCH_UP,
            "participations": int(n_part.sum()) == TEL_PARTICIPATIONS,
            "bucket 0": int(st["staleness_hist"][:, 0].sum()) == TEL_BUCKET0,
            "buckets 1-7": int(st["staleness_hist"][:, 1:].sum()) == TEL_CATCH_UP,
            "catch_up_bytes == ledger share": np.array_equal(st["catch_up_bytes"], share),
        }
        log(f"{r['label']}: catch-up clients {st['catch_up_clients'].tolist()} "
            f"(sum {int(st['catch_up_clients'].sum())}), participations {int(n_part.sum())}, "
            f"staleness {st['staleness_hist'].sum(0).tolist()}, catch-up bytes "
            f"{st['catch_up_bytes'].tolist()}; {r['per_round_ms']:.3f} ms/round")
        failed = [k for k, ok in checks.items() if not ok]
        if failed:
            raise AssertionError(f"{r['label']}: telemetry fails {failed}")
    hold_telemetry("(b) stragglers", strag, perop_same_state=False)

    for label, engine, fused in TEL_ENGINES:  # (c): off, then on, without capture
        r = off[label] = telemetry_run(device, label, engine, fused, False, tag="(c) off")
        o = telemetry_run(device, label, engine, fused, True, tag="(c) on")
        a, b = state_leaves(r["eng"]), state_leaves(o["eng"])
        differ = [k for k in a if k not in b or not torch.equal(a[k], b[k])]
        same = (r["ledger"] == o["ledger"] and r["accs"] == o["accs"]
                and not differ and a.keys() == b.keys())
        log(f"telemetry off vs on, {label}: ledger equal={r['ledger'] == o['ledger']}, "
            f"accuracies equal={r['accs'] == o['accs']}, {len(differ)} of {len(a)} "
            f"state leaves differ {differ[:5]}; {r['per_round_ms']:.3f} ms/round off, "
            f"{o['per_round_ms']:.3f} on ({card})")
        if not same:
            raise AssertionError(f"telemetry on moved the {label} run")
    return dict(on=on, off=off, stragglers=strag)


def run_obs_host_plane(device, tracer, tel: dict) -> None:
    """Phase 4h (d): (a)'s SpanTracer as a Chrome trace and a run record
    with the engines' telemetry summaries, validated and rendered by
    ``python -m repro_torch.obs`` in child processes; one fused leg under
    ``profiler_trace``, whose trace must name the fused round and qdq
    kernels."""
    import tempfile

    from repro_torch.fl import FLConfig, STRATEGIES, ScannedFederatedDistillation
    from repro_torch.obs import profiler_trace
    from repro_torch.obs.export import telemetry_summary, write_chrome_trace, write_run_record
    from repro_torch.obs.trace import PROFILE_TRACE

    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    env = dict(os.environ, PYTHONPATH=src)
    host = tel["on"]["host loop"]
    with tempfile.TemporaryDirectory() as d:
        trace_path = write_chrome_trace(os.path.join(d, "trace.json"), tracer)
        rec_path = os.path.join(d, "record.json")
        write_run_record(rec_path, name="phase 4h (a)", config=host["eng"].cfg,
                         history=host["history"], tracer=tracer,
                         extra={"engines": {k: telemetry_summary(v["history"])
                                            for k, v in tel["on"].items()}})
        for args in (["validate", trace_path], ["render", rec_path, "--format", "text"]):
            p = subprocess.run([sys.executable, "-m", "repro_torch.obs", *args],
                               capture_output=True, text=True, env=env, timeout=120)
            log(f"python -m repro_torch.obs {args[0]}: exit {p.returncode}; "
                + (p.stdout.strip().splitlines()[0] if args[0] == "validate"
                   else f"{len(p.stdout.splitlines())} lines"))
            if args[0] == "render":
                print(p.stdout, flush=True)
            if p.returncode != 0:
                raise AssertionError(f"python -m repro_torch.obs {args[0]} failed: "
                                     f"{p.stderr[-2000:]}")

        cfg = FLConfig(**SLICE, rounds=TEL_PROFILED_ROUNDS, eval_every=TEL_PROFILED_ROUNDS,
                       uplink_codec=CODEC, fused_round=True, telemetry=True)
        eng = ScannedFederatedDistillation(cfg, STRATEGIES["scarlet"](beta=BETA),
                                           cache_duration=CACHE_DURATION, device=device)
        with profiler_trace(d):
            eng.run()
            _sync(device)
        with open(os.path.join(d, PROFILE_TRACE)) as f:
            events = json.load(f)["traceEvents"]
        size = os.path.getsize(os.path.join(d, PROFILE_TRACE))
    kernels = [e for e in events if e.get("cat") == "kernel"]
    names = {e["name"] for e in kernels}
    hits = {k: sum(1 for e in kernels if k in e["name"]) for k in ("fused_round", "qdq")}
    log(f"profiler_trace of a {TEL_PROFILED_ROUNDS}-round fused leg: {size} bytes, "
        f"{len(events)} events, {len(kernels)} kernel events, {len(names)} kernel names; "
        f"kernels naming fused_round {hits['fused_round']}, qdq {hits['qdq']}: "
        f"{sorted(n for n in names if 'fused_round' in n or 'qdq' in n)}")
    if not (hits["fused_round"] >= TEL_PROFILED_ROUNDS and hits["qdq"] >= TEL_PROFILED_ROUNDS):
        raise AssertionError("the profiler's trace does not name the fused round and qdq "
                             "kernels")


# ---------------------------------------------------------------------------
# phase 5: the same small run on the card and on the CPU
# ---------------------------------------------------------------------------

def check_options_cuda_vs_cpu(card_run: dict, card_tel: dict) -> None:
    """Phase 4g (a)'s host-loop run on the CPU, telemetry on: the ledger
    equal to the card's (telemetry off), accuracies within one test
    sample; its telemetry against phase 4h (a)'s card host loop: counters
    and bytes equal, gauges to TEL_GAUGE_ATOL in round 1 and in their
    recomputation from each round's inputs, to TEL_TRAJECTORY_RTOL after
    (the two devices break 8-bit rounding ties differently)."""
    from repro_torch.obs.device import EXACT_FIELDS, GAUGE_FIELDS

    c = telemetry_run(torch.device("cpu"), "host loop (cpu)", "host", False, True,
                      capture=True, tag="options")
    g_st, c_st = card_tel["telemetry"], c["telemetry"]
    bad = [f for f in EXACT_FIELDS
           if c_st[f].dtype != g_st[f].dtype or not np.array_equal(c_st[f], g_st[f])]
    d = {f: np.abs(c_st[f].astype(np.float64) - g_st[f]) for f in GAUGE_FIELDS}
    rel = max(float((d[f] / np.maximum(np.abs(g_st[f]), 1e-30)).max()) for f in d)
    log(f"options host loop telemetry cuda vs cpu: counters and bytes equal={not bad} "
        f"{bad}; gauge abs err round 1 { {f: float(v[0]) for f, v in d.items()} } (atol "
        f"{TEL_GAUGE_ATOL}), all rounds { {f: float(v.max()) for f, v in d.items()} } "
        f"(rel max {rel!r}, limit {TEL_TRAJECTORY_RTOL})")
    if (bad or max(float(v[0]) for v in d.values()) > TEL_GAUGE_ATOL
            or rel > TEL_TRAJECTORY_RTOL):
        raise AssertionError("options host loop: telemetry differs between card and CPU")
    equal = c["ledger"] == card_run["ledger"]
    n_test = len(c["eng"].y_test)
    acc_err = max(abs(a - b) for a, b in zip(card_run["accs"], c["accs"]))
    log(f"options host loop cuda vs cpu: ledger equal={equal} accuracy max diff={acc_err!r} "
        f"(one test sample = {1.0 / n_test!r})")
    if not equal:
        raise AssertionError("options host loop: ledgers differ between card and CPU")
    if acc_err > 1.0 / n_test + 1e-6:
        raise AssertionError(f"options host loop: accuracies differ by {acc_err}")

def run_small(device, engine: str):
    from repro_torch.fl import (FederatedDistillation, FLConfig, STRATEGIES,
                                ScannedFederatedDistillation)

    if engine == "host":
        eng = FederatedDistillation(FLConfig(**SMALL), STRATEGIES["scarlet"](beta=BETA),
                                    cache_duration=2, device=device)
    else:  # the device engine on its fused path
        eng = ScannedFederatedDistillation(
            FLConfig(**SMALL, fused_round=True), STRATEGIES["scarlet"](beta=BETA),
            cache_duration=2, device=device)
    return eng, eng.run()


def check_small_methods_cuda_vs_cpu() -> None:
    """COMET (its k-means on the host, from the card's or the CPU's
    predictions) and FedAvg through the front door on the small
    configuration, card against CPU: equal ledgers, accuracies within one
    test sample."""
    import dataclasses

    from repro_torch.fl import FLConfig, run_method

    n_test = max(SMALL["private_size"] // 5, 200)  # the synthetic test set
    for method in ("comet", "fedavg"):
        cfg = FLConfig(**SMALL)
        if method == "fedavg":  # the baseline exchanges parameters: no codec
            cfg = dataclasses.replace(cfg, uplink_codec="identity")
        g, c = (run_method(method, cfg, device=d) for d in ("cuda", "cpu"))
        equal = g.ledger.summary() == c.ledger.summary()
        acc_err = max(abs(a - b) for a, b in zip(g.server_acc + g.client_acc,
                                                 c.server_acc + c.client_acc))
        log(f"small run ({method}) cuda vs cpu: ledger equal={equal} accuracy max "
            f"diff={acc_err!r} (one test sample = {1.0 / n_test!r})")
        if not equal:
            raise AssertionError(f"{method}: ledgers differ: {g.ledger.summary()} vs "
                                 f"{c.ledger.summary()}")
        if acc_err > 1.0 / n_test + 1e-6:
            raise AssertionError(f"{method}: accuracies differ by {acc_err}")


def check_small_cuda_vs_cpu(engine: str) -> None:
    from repro_torch.fl import FLConfig, run_method

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"small run ({engine}): torch.backends.cuda.matmul.allow_tf32=False, "
        "torch.backends.cudnn.allow_tf32=False")
    g_eng, g_hist = run_small(torch.device("cuda"), engine)
    c_eng, c_hist = run_small(torch.device("cpu"), engine)
    g_sum, c_sum = g_hist.ledger.summary(), c_hist.ledger.summary()
    teach_err = float((g_eng.cache_g.values.cpu() - c_eng.cache_g.values).abs().max())
    n_test = len(c_eng.y_test)
    acc_err = max(abs(a - b) for a, b in
                  zip(g_hist.server_acc + g_hist.client_acc,
                      c_hist.server_acc + c_hist.client_acc))
    log(f"small run ({engine}) cuda vs cpu: ledger equal={g_sum == c_sum} "
        f"teacher max_abs_err={teach_err!r} (atol {SMALL_TEACHER_ATOL}) "
        f"accuracy max diff={acc_err!r} (one test sample = {1.0 / n_test!r})")
    log(f"small run ({engine}): server_acc cuda {g_hist.server_acc} "
        f"cpu {c_hist.server_acc}")
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
    cfg = FLConfig(**SMALL, fused_round=engine == "scan")
    h = run_method("scarlet", cfg, engine=engine, cache_duration=2, beta=BETA,
                   device="cuda")
    if h.ledger.summary() != g_sum:
        raise AssertionError("run_method's ledger differs from the engine's")


# flash attention cases on the card: (label, B, Sq, Sk, H, Hkv, d, causal,
# window), each in bfloat16 and float32 (both Hopper kernels), whisper's
# shape in bfloat16 only, as the path gives it.  The kernels' pipeline
# edges: a key range that wraps the stage rings many times (32 key
# tiles), Sk one past whole key tiles (TMA's zero fill of the last tile),
# and GQA at d = 32 (bf16: 64-byte swizzle, 4 stages; f32: DV = 32); then
# head dims 8, 40, 80, 96, 112 (bf16: the instantiations 32, 64 and 128 on
# tiles zero past d; f32: a partial last 32-column chunk, column blocks of
# 64 past 64) and 136, 192, 200, 256 (column blocks; at 200 the last
# block's second half lies partly past d, in f32 wholly).
FLASH_CASES = tuple(
    case + (dtype,)
    for case in (("GQA + window, ragged", 2, 200, 200, 8, 2, 64, True, 64),
                 ("non-causal Sq != Sk", 2, 100, 300, 4, 4, 64, False, 0),
                 ("rows left with no key", 1, 300, 100, 4, 2, 64, False, 16),
                 ("d=32 window 7", 1, 130, 130, 2, 1, 32, True, 7),
                 ("d=128", 1, 129, 129, 4, 1, 128, True, 0),
                 ("tiny", 1, 4, 4, 2, 1, 64, True, 0),
                 ("stage ring wraps", 1, 2048, 2048, 4, 1, 128, True, 0),
                 ("Sk one past 4 key tiles", 2, 200, 257, 4, 2, 64, False, 0),
                 ("GQA d=32", 2, 256, 256, 8, 2, 32, True, 0),
                 # head dims between and past the instantiations
                 ("d=8", 1, 130, 130, 2, 1, 8, True, 0),
                 ("GQA d=40", 2, 200, 200, 8, 2, 40, True, 0),
                 ("d=80", 1, 130, 130, 4, 4, 80, True, 0),
                 ("d=96", 1, 300, 300, 4, 2, 96, True, 0),
                 ("d=112 non-causal", 1, 200, 257, 2, 2, 112, False, 0),
                 ("d=136 window 33", 1, 200, 200, 4, 1, 136, True, 33),
                 ("d=192", 1, 130, 130, 2, 2, 192, True, 0),
                 ("d=200 (last column block partly past d)", 1, 130, 130, 2, 1, 200, True, 0),
                 ("d=256 rows left with no key", 1, 300, 100, 2, 1, 256, False, 16),
                 ("GQA d=256", 2, 256, 256, 4, 2, 256, True, 0))
    for dtype in (torch.bfloat16, torch.float32)
) + (("whisper decoder", WHISPER_B, WHISPER_S, WHISPER_S, 20, 20, 64, True, 0,
      torch.bfloat16),)


def attn_inputs(rng, B, Sq, Sk, H, Hkv, d, dtype, device):
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(device, dtype)
            for s in ((B, Sq, H, d), (B, Sk, Hkv, d), (B, Sk, Hkv, d))]


def check_flash(device) -> float:
    from repro_torch.kernels import attn_kernel

    rng = np.random.default_rng(5)
    worst = 0.0
    for label, B, Sq, Sk, H, Hkv, d, causal, window, dtype in FLASH_CASES:
        q, k, v = attn_inputs(rng, B, Sq, Sk, H, Hkv, d, dtype, device)
        got = attn_kernel.flash_attention(q, k, v, causal=causal, window=window)
        want = attn_kernel.flash_attention_plain(q, k, v, causal, window)
        _sync(device)
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        if dtype == torch.bfloat16:
            ok = bool((diff <= BF16_STEP * want.float().abs().clamp_min(1.0)).all())
            tol = "one bf16 step, 2^-7 * max(|want|, 1)"
        else:
            ok = err <= FLASH_F32_ATOL
            tol = f"atol {FLASH_F32_ATOL}"
        ok = ok and bool(torch.isfinite(got).all()) and got.dtype == dtype
        log(f"flash_attention {label} B={B} Sq={Sq} Sk={Sk} H={H} Hkv={Hkv} d={d} "
            f"causal={causal} window={window} {str(dtype)[6:]}: max_abs_err={err!r} "
            f"({tol}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash_attention {label}: max_abs_err {err}")
        worst = max(worst, err)
    return worst


def check_era_rows(device) -> float:
    from repro_torch.kernels import era_kernel

    rng = np.random.default_rng(6)
    worst = 0.0
    for B, N in ERA_ROWS_SHAPES:
        z = _probs(rng, (B, N), device)
        z[0] = 0.0
        z[-1] = 0.0
        errs = []
        for beta in ERA_ROWS_BETAS:
            got = era_kernel.enhanced_era(z, beta)
            want = era_kernel.enhanced_era_plain(z, beta)
            zb = z.to(torch.bfloat16)
            got_b = era_kernel.enhanced_era(zb, beta)
            got_up = era_kernel.enhanced_era(zb.float(), beta).to(torch.bfloat16)
            want_b = era_kernel.enhanced_era_plain(zb, beta).float()
            _sync(device)
            err = float((got - want).abs().max())
            err_b = float((got_b.float() - want_b).abs().max())
            ok = (bool(torch.isfinite(got).all()) and err <= ERA_ATOL
                  and float((got[0] - 1.0 / N).abs().max()) <= ERA_ATOL
                  and got_b.dtype == torch.bfloat16
                  and torch.equal(got_b, got_up)
                  and bool(((got_b.float() - want_b).abs()
                            <= BF16_STEP * want_b.abs() + ERA_ATOL).all()))
            if not ok:
                raise AssertionError(f"era_rows ({B},{N}) beta={beta}: float32 max_abs_err "
                                     f"{err}, bfloat16 {err_b}")
            errs.append((err, err_b))
            worst = max(worst, err)
        k = (B // 2) | 1
        for zz in (z, z.to(torch.bfloat16)):
            one = era_kernel.enhanced_era(zz, BETA)
            two = torch.cat([era_kernel.enhanced_era(zz[:k], BETA),
                             era_kernel.enhanced_era(zz[k:], BETA)])
            if not (torch.equal(one, era_kernel.enhanced_era(zz, BETA))
                    and torch.equal(one, two)):
                raise AssertionError(f"era_rows ({B},{N}) {zz.dtype}: two launches, or rows "
                                     "split over two, differ")
        log(f"era_rows ({B},{N}) {era_kernel.rows_layout(N)} beta in {ERA_ROWS_BETAS}, zero "
            f"first/last rows: float32 max_abs_err={max(e for e, _ in errs)!r} (atol "
            f"{ERA_ATOL}); bfloat16 equal to the float32 kernel rounded, max_abs_err vs plain="
            f"{max(e for _, e in errs)!r} (one bf16 step); two launches and rows [:{k}], "
            f"[{k}:] equal bit for bit ok")
    # beta as a float32 tensor on the card, read by the kernel (a warp a
    # row, and a cluster a row)
    for shape in ((1000, 10), (48, 51968)):
        z = _probs(rng, shape, device)
        got = era_kernel.enhanced_era(z, torch.full((), BETA, device=device))
        if not torch.equal(got, era_kernel.enhanced_era(z, BETA)):
            raise AssertionError(f"era_rows {shape}: beta as a CUDA tensor differs from beta "
                                 "as a float")
    log("era_rows beta as a CUDA 0-d tensor at (1000, 10) and (48, 51968): equal to beta as "
        "a float ok")
    return worst


def _distill_inputs(gen, B, V, ldt, tdt, device):
    """Student logits (3 * N(0, 1)) and a teacher's softmax rows."""
    logits = 3.0 * torch.randn(B, V, device=device, generator=gen)
    teacher = torch.softmax(torch.randn(B, V, device=device, generator=gen), -1)
    return logits.to(ldt), teacher.to(tdt)


def distill_scale(logits, teacher) -> torch.Tensor:
    """Per row ``|lse| * |sum t| + sum |t * l|``: the magnitudes the
    loss's float32 sums carry."""
    l32, t32 = logits.float(), teacher.float()
    return torch.logsumexp(l32, -1).abs() * t32.sum(-1).abs() + (t32 * l32).abs().sum(-1)


def check_distill(device) -> float:
    from repro_torch.kernels import distill_kernel

    gen = torch.Generator(device=device).manual_seed(7)
    worst = 0.0
    for B, V in DISTILL_SHAPES:
        for ldt, tdt in DISTILL_DTYPES:
            logits, teacher = _distill_inputs(gen, B, V, ldt, tdt, device)
            got = distill_kernel.distill_loss(logits, teacher)
            want = distill_kernel.distill_loss_plain(logits, teacher)
            _sync(device)
            diff = (got - want).abs()
            rel = float((diff / distill_scale(logits, teacher)).max())
            err = float(diff.max())
            ok = (got.shape == (B,) and got.dtype == torch.float32
                  and bool(torch.isfinite(got).all()) and rel <= DISTILL_RTOL)
            log(f"distill ({B},{V}) logits {str(ldt)[6:]} teacher {str(tdt)[6:]}: "
                f"max_abs_err={err!r}, max err/scale={rel!r} (rtol {DISTILL_RTOL}), "
                f"mean loss {float(want.mean())!r} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"distill ({B},{V}) {ldt}/{tdt}: err/scale {rel}")
            worst = max(worst, err)
    return worst


# ---------------------------------------------------------------------------
# phase 4c: whisper-large-v3 prefill at full width
# ---------------------------------------------------------------------------

def run_whisper(device) -> dict:
    from repro_torch.configs.whisper_large_v3 import CONFIG
    from repro_torch.kernels import ops
    from repro_torch.launch.specs import make_batch
    from repro_torch.models import common as cm
    from repro_torch.models import registry, whisper

    cfg = CONFIG
    t0 = time.perf_counter()
    params = registry.init(cfg, torch.Generator(device=device).manual_seed(WHISPER_SEED),
                           device=device)
    batch = make_batch(cfg, WHISPER_B, WHISPER_S, seed=WHISPER_SEED, device=device)
    _sync(device)
    log(f"whisper: {cfg.name} {cfg.n_encoder_layers}+{cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.n_heads} heads of {cfg.dh}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab_size} padded to {cfg.padded_vocab}, {cfg.param_dtype}; "
        f"{cm.n_params(params)} parameters, set up in {time.perf_counter() - t0:.3f} s")
    registry.prefill(cfg, params, batch)  # warm-up
    _sync(device)

    # the encoder and the cross-attention never reach the kernel
    ops.reset_launches()
    whisper.encode(cfg, params, batch["audio_embeds"])
    _sync(device)
    enc_launches = ops.launches()
    check_launches(enc_launches, {"enhanced_era_fused": 0, "quantize_dequantize": 0,
                                  "fused_round": 0, "flash_attention": 0})

    # the main path: one prefill, counted
    ops.reset_launches()
    t0 = time.perf_counter()
    logits = registry.prefill(cfg, params, batch)
    _sync(device)
    times = [time.perf_counter() - t0]
    launches = ops.launches()
    log(f"whisper: launches of one prefill {launches}; of the encoder alone {enc_launches}")
    check_launches(launches, {"enhanced_era_fused": 0, "quantize_dequantize": 0,
                              "fused_round": 0, "flash_attention": cfg.n_layers})
    want_shape = (WHISPER_B, WHISPER_S, cfg.padded_vocab)
    if tuple(logits.shape) != want_shape or logits.dtype != torch.float32:
        raise AssertionError(f"logits {tuple(logits.shape)} {logits.dtype}, "
                             f"expected {want_shape} float32")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("whisper logits are not finite")
    for _ in range(WHISPER_TIMED - 1):
        t0 = time.perf_counter()
        registry.prefill(cfg, params, batch)
        _sync(device)
        times.append(time.perf_counter() - t0)
    ms = statistics.median(times) * 1e3
    tokens = WHISPER_B * WHISPER_S
    log(f"whisper: prefill B={WHISPER_B} S={WHISPER_S} over {cfg.encoder_len} frames: "
        f"{ms:.3f} ms median of {[round(t * 1e3, 3) for t in times]} ms "
        f"(host clock, synchronized, after one warm-up), "
        f"{tokens / (ms / 1e3):.1f} decoder tokens/s; logits {want_shape} finite, "
        f"max |logit| {float(logits.abs().max())!r}")
    return dict(launches=launches, ms=ms, logits=logits, params=params)


# ---------------------------------------------------------------------------
# phase 4d: the soft-label library's kernel seams at full width
# ---------------------------------------------------------------------------

def _row_sum_err(p: torch.Tensor) -> float:
    return float((p.sum(-1) - 1.0).abs().max())


def run_library(device, wh: dict) -> dict:
    """``repro_torch.core`` with ``impl="kernel"``: SCARLET's aggregation
    over the paper's stack with the adaptive beta computed on the card,
    Enhanced ERA over whisper's vocabulary, and the distillation loss of
    the prefill's logits against a teacher's, all under sync debug mode
    "error"; each against the kernel's plain version."""
    from repro_torch import core
    from repro_torch.configs.whisper_large_v3 import CONFIG
    from repro_torch.fl import STRATEGIES
    from repro_torch.kernels import distill_kernel, era_kernel, ops
    from repro_torch.launch.specs import make_batch
    from repro_torch.models import registry

    K, m, N = SLICE["n_clients"], SLICE["public_per_round"], SLICE["n_classes"]
    z = _probs(np.random.default_rng(8), (K, m, N), device)
    scarlet = STRATEGIES["scarlet"](beta="adaptive", beta_max=ADAPTIVE_BETA_MAX)
    student = wh["logits"]                       # (4, 384, V) float32
    soft = torch.softmax(student, -1)            # whisper's vocab as soft-labels
    batch = make_batch(CONFIG, WHISPER_B, WHISPER_S, seed=WHISPER_SEED + 1, device=device)
    teacher = torch.softmax(registry.prefill(CONFIG, wh["params"], batch), -1)
    _sync(device)

    # the path: counts set to 0 just before, read just after
    ops.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        beta = scarlet._adaptive_beta(torch.mean(z, 0))
        agg = core.aggregate_soft_labels(z, "enhanced_era", beta=beta, impl="kernel")
        sharp = core.enhanced_era(soft, BETA, impl="kernel")
        loss = core.soft_cross_entropy(student, teacher, impl="kernel")
        t_issue = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode(0)
    _sync(device)
    launches = ops.launches()
    log(f"library: launches {launches} (host issue {t_issue * 1e3:.3f} ms under sync "
        f"debug mode 'error')")
    check_launches(launches, {"enhanced_era": 2, "distill_loss": 1})

    want_agg = era_kernel.enhanced_era_plain(torch.mean(z, 0), beta)
    err_agg = float((agg - want_agg).abs().max())
    V = student.shape[-1]
    want_sharp = era_kernel.enhanced_era_plain(soft.reshape(-1, V), BETA).reshape(soft.shape)
    err_sharp = float((sharp - want_sharp).abs().max())
    rows_l, rows_t = student.reshape(-1, V), teacher.reshape(-1, V)
    want_loss = distill_kernel.distill_loss_plain(rows_l, rows_t).mean()
    torch_loss = core.soft_cross_entropy(student, teacher)   # the log_softmax path
    scale = float(distill_scale(rows_l, rows_t).mean())
    err_loss = abs(float(loss) - float(want_loss))
    err_torch = abs(float(loss) - float(torch_loss))
    log(f"library: aggregate_soft_labels {tuple(z.shape)} -> {tuple(agg.shape)}, adaptive "
        f"beta {float(beta)!r}: max_abs_err={err_agg!r} (atol {ERA_ATOL}), rows sum to 1 "
        f"within {_row_sum_err(agg)!r}")
    log(f"library: enhanced_era over whisper's vocab {tuple(soft.shape)} beta={BETA}: "
        f"max_abs_err={err_sharp!r} (atol {ERA_ATOL}), rows sum to 1 within {_row_sum_err(sharp)!r}")
    log(f"library: soft_cross_entropy over the prefill's logits {tuple(student.shape)}: "
        f"{float(loss)!r}; plain {float(want_loss)!r} (err {err_loss!r}), impl='torch' "
        f"{float(torch_loss)!r} (err {err_torch!r}); rtol {DISTILL_RTOL} of the mean "
        f"scale {scale!r}")
    ok = (agg.shape == (m, N) and sharp.shape == soft.shape and sharp.dtype == soft.dtype
          and loss.dim() == 0 and loss.dtype == torch.float32
          and all(bool(torch.isfinite(t).all()) for t in (agg, sharp, loss))
          and err_agg <= ERA_ATOL and err_sharp <= ERA_ATOL
          and _row_sum_err(agg) <= 1e-5 and _row_sum_err(sharp) <= 1e-5
          and err_loss <= DISTILL_RTOL * scale and err_torch <= DISTILL_RTOL * scale)
    if not ok:
        raise AssertionError("the soft-label library's results are wrong")
    return dict(launches=launches, loss=float(loss))


# ---------------------------------------------------------------------------
# phase 4e: the static analyzer on the card
# ---------------------------------------------------------------------------

# torch.cuda.get_device_properties fields that hold a runtime.Limits field
# (where this torch has them)
TORCH_PROPS = (("max_threads_per_block", "max_threads_per_block"),
               ("smem_per_block", "shared_memory_per_block"),
               ("smem_per_block_optin", "shared_memory_per_block_optin"),
               ("smem_per_sm", "shared_memory_per_multiprocessor"),
               ("regs_per_sm", "regs_per_multiprocessor"),
               ("warp_size", "warp_size"))

# A child process: the float4 copy of a view 4 bytes into its storage.
MISALIGNED_CHILD = """
import sys, torch
from repro_torch.kernels import fixture_kernel
base = torch.zeros(100 * 128 + 1, device="cuda")
fixture_kernel.copy_vec4(base.narrow(0, 1, 100 * 128).view(100, 128))
torch.cuda.synchronize()
print("no fault")
"""

# A child process: each strategy's aggregate_masked at the analysis shapes
# captured in a CUDA graph (and, where the capture holds, replayed); one
# JSON line {name: "captured" or the capture's error}.
CAPTURE_CHILD = """
import json, numpy as np, torch
from repro_torch.analysis import fixtures
from repro_torch.fl.strategies import STRATEGIES
K, M, N = 8, 16, 10
rng = np.random.default_rng(0)
z = torch.from_numpy(rng.dirichlet(np.ones(N), size=K * M).astype(np.float32)
                     .reshape(K, M, N)).cuda()
part = torch.ones(K, device="cuda")
out = {}


def hooks(s):
    zt = s.transmit(z)
    return s.aggregate_masked(zt, part, s.upload_mask(zt), 1)


for name, s in [(n, STRATEGIES[n](**({"beta": 1.5} if n == "scarlet" else {})))
                for n in ("scarlet", "dsfl", "cfd", "mean", "selective_fd")] + [
        ("fixture_callback_smuggler", fixtures.CallbackSmugglerStrategy())]:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        hooks(s)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(g):
            t = hooks(s)
        g.replay()
        torch.cuda.synchronize()
        ok = torch.equal(t, hooks(s))
        out[name] = "captured" if ok else "captured, replay differs"
    except Exception as e:
        out[name] = type(e).__name__ + ": " + str(e).strip().splitlines()[0][:160]
print(json.dumps(out))
"""


def _child(code: str, timeout: int = 300) -> subprocess.CompletedProcess:
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    env = dict(os.environ, PYTHONPATH=src)
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=timeout)


def check_device_limits() -> None:
    """``runtime.HOPPER`` against the card: every field through
    ``cudaDeviceGetAttribute``, and torch's device properties where they
    hold the same field."""
    from repro_torch.kernels import runtime

    card = runtime.device_limits(0)
    log(f"analysis: the card's limits (cudaDeviceGetAttribute): {card}")
    props = torch.cuda.get_device_properties(0)
    seen = {f: getattr(props, p) for f, p in TORCH_PROPS if hasattr(props, p)}
    log(f"analysis: torch.cuda.get_device_properties(0) fields: {seen}; "
        f"absent in torch {torch.__version__}: "
        f"{[p for f, p in TORCH_PROPS if f not in seen]}")
    bad = [f for f, v in seen.items() if v != getattr(runtime.HOPPER, f)]
    if card != runtime.HOPPER or bad:
        raise AssertionError(f"runtime.HOPPER {runtime.HOPPER} differs from the card "
                             f"{card} (torch fields off: {bad})")
    log("analysis: runtime.HOPPER equals the card's limits ok")


def run_analysis(device) -> dict:
    """The analyzer on the card: the strict pass with compiled attributes,
    the selftest (the path of the fixture kernels: counts set to 0 just
    before, read just after), each fixture kernel's valid plan bit for bit
    against its plain version, the hog refused then a valid launch, the
    misaligned plan faulting in a child, and graph capture of the
    strategies' aggregation in another."""
    from repro_torch.analysis.__main__ import main as analysis_main
    from repro_torch.kernels import fixture_kernel as fk
    from repro_torch.kernels import ops, runtime

    check_device_limits()
    attrs = {}
    for lib in runtime.SOURCES:
        for name in runtime.kernel_names(lib):
            attrs[name] = runtime.func_attrs(lib, name)
            log(f"analysis: func_attrs {lib}/{name}: {attrs[name]}")

    t0 = time.perf_counter()
    rc = analysis_main(["--strict"])
    log(f"analysis: python -m repro_torch.analysis --strict (device cuda) exit {rc} in "
        f"{time.perf_counter() - t0:.3f} s")
    if rc != 0:
        raise AssertionError("the strict analysis pass found errors or warnings on the card")

    ops.reset_launches()
    rc = analysis_main(["--selftest"])
    torch.cuda.synchronize()
    launches = ops.launches()
    log(f"analysis: --selftest exit {rc}, launches {launches}")
    if rc != 0:
        raise AssertionError("the analyzer's selftest failed on the card")
    check_launches(launches, {"copy_vec4": 1, "scale": 1, "copy_smem": 1})

    rng = np.random.default_rng(10)

    def card(shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device)

    x, xs, s, xh = card((100, 128)), card((16, 128)), card((1,)), card((4096, 1024))
    pairs = (("copy_vec4", fk.copy_vec4(x), fk.copy_plain(x)),
             ("scale", fk.scale(xs, s), fk.scale_plain(xs, s)),
             ("copy_smem", fk.copy_smem(xh), fk.copy_plain(xh)))
    errs = {}
    for name, got, want in pairs:
        errs[name] = float((got - want).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: the kernel differs from its plain version")
        log(f"analysis: {name} valid plan {tuple(got.shape)} equals its plain version bit "
            "for bit ok")

    n = fk.copy_smem.launches
    try:
        fk.copy_smem(xh, fk.HOG_TILE)
    except RuntimeError as e:
        refused = str(e)
    else:
        raise AssertionError("the card launched the shared-memory hog")
    if fk.copy_smem.launches != n or not torch.equal(fk.copy_smem(xh), xh):
        raise AssertionError("after the hog's refusal a valid launch failed or was miscounted")
    torch.cuda.synchronize()
    log(f"analysis: hog plan {fk.HOG_TILE} refused ({refused}); a valid launch after it ok")

    p = _child(MISALIGNED_CHILD)
    fault = [ln for ln in p.stderr.splitlines() if "misaligned address" in ln]
    log(f"analysis: misaligned plan in a child: exit {p.returncode}, "
        f"{(fault or [''])[0].strip()[:200]}")
    if p.returncode == 0 or "misaligned address" not in p.stderr:
        raise AssertionError("the misaligned float4 copy did not fault with "
                             f"cudaErrorMisalignedAddress:\n{p.stdout}\n{p.stderr[-3000:]}")

    p = _child(CAPTURE_CHILD)
    if p.returncode != 0:
        raise AssertionError(f"graph capture child failed:\n{p.stderr[-3000:]}")
    cap = json.loads(p.stdout.strip().splitlines()[-1])
    log(f"analysis: CUDA graph capture of transmit, upload_mask and aggregate_masked: {cap}")
    scan_safe = ("scarlet", "dsfl", "cfd", "mean", "selective_fd")
    if any(cap[n] != "captured" for n in scan_safe) or \
            cap["fixture_callback_smuggler"].startswith("captured"):
        raise AssertionError("graph capture disagrees with the contract pass")
    return dict(launches=launches, errs=errs, attrs=attrs)


# ---------------------------------------------------------------------------
# phase 5b: the reduced whisper prefill on the card and on the CPU
# ---------------------------------------------------------------------------

def tempered(params: dict) -> dict:
    """``params`` with the q and k projections scaled by 1/8 (see
    WHISPER_SMALL_ATOL)."""
    for part, names in (("encoder", ("wq", "wk")), ("decoder", ("wq", "wk", "xwq", "xwk"))):
        for n in names:
            params[part][n] = params[part][n] / 8
    return params


def check_whisper_cuda_vs_cpu() -> float:
    from repro_torch.configs.whisper_large_v3 import CONFIG
    from repro_torch.kernels import ops
    from repro_torch.launch.specs import make_batch
    from repro_torch.models import common as cm
    from repro_torch.models import registry

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = CONFIG.reduced()
    p = tempered(registry.init(cfg, torch.Generator().manual_seed(WHISPER_SEED), device="cpu"))
    batch = make_batch(cfg, 2, WHISPER_SMALL_S, seed=WHISPER_SEED, device="cpu")
    want = registry.prefill(cfg, p, batch)
    p_dev = cm.tree_map(lambda t: t.cuda(), p)
    ops.reset_launches()
    got = registry.prefill(cfg, p_dev, {n: t.cuda() for n, t in batch.items()})
    _sync(torch.device("cuda"))
    n = ops.launches()["flash_attention"]
    err = float((got.cpu() - want).abs().max())
    log(f"whisper small ({cfg.name}, S={WHISPER_SMALL_S}, float32) cuda vs cpu: "
        f"logits max_abs_err={err!r} (atol {WHISPER_SMALL_ATOL}), "
        f"max |logit| {float(want.abs().max())!r}, flash launches {n}")
    if n != cfg.n_layers or not bool(torch.isfinite(got).all()) or err > WHISPER_SMALL_ATOL:
        raise AssertionError(f"whisper small cuda vs cpu: err {err}, launches {n}")
    return err


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


def bound_ms(n_bytes: float, n_ops: float, ops_per_s: float = FP32_OPS_PER_S):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# The Pallas fixture each fixture kernel replaces (src/repro/analysis/fixtures.py).
FIXTURE_REPLACES = {"copy_vec4": "src/repro/analysis/fixtures.py:125",
                    "scale": "src/repro/analysis/fixtures.py:135",
                    "copy_smem": "src/repro/analysis/fixtures.py:146"}


def kernel_report(launches: dict, errs: dict) -> list:
    from repro_torch.kernels import (attn_kernel, distill_kernel, era_kernel, quant_kernel,
                                     round_kernel)

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
    # past the row-block layout: 8 clients' soft-labels over whisper's
    # vocabulary for a prefill's 384 positions (clusters of 4); bytes: the
    # stack read once, the teacher written once
    kw, bw, nw = ERA_FUSED_VOCAB
    zw = torch.softmax(torch.randn(kw, bw, nw, device=dev,
                                   generator=torch.Generator(device=dev).manual_seed(11)), -1)
    b, why = bound_ms(4.0 * (kw + 1) * bw * nw, kw * bw * nw + 9.0 * bw * nw)
    log(f"time enhanced_era_fused {ERA_FUSED_VOCAB} {era_kernel.fused_layout(nw)}: "
        f"ms={cuda_ms(lambda: era_kernel.enhanced_era_fused(zw, BETA))!r} "
        f"plain_ms={cuda_ms(lambda: era_kernel.enhanced_era_fused_plain(zw, BETA))!r} "
        f"bound_ms={b!r} by {why}")
    del zw

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
    # CFD's uplink: the (K, m, N) stack at 1 bit, contiguous; bytes and
    # operations as above
    zc = _probs(np.random.default_rng(12), (K, m, N), dev)
    b, why = bound_ms(4.0 * 2 * zc.numel(), 11.0 * zc.numel())
    log(f"time quantize_dequantize {tuple(zc.shape)} bits=1 (CFD's uplink) "
        f"{quant_kernel.layout(N, N)}: "
        f"ms={cuda_ms(lambda: quant_kernel.quantize_dequantize(zc, 1))!r} "
        f"plain_ms={cuda_ms(lambda: quant_kernel.quantize_dequantize_plain(zc, 1))!r} "
        f"bound_ms={b!r} by {why}")
    del zc
    z, w, base = slice_round_inputs(rng, dev)
    n_in = K * m * N
    # bytes: the stack, the weights and the base read once, the teacher
    # written once; operations, per client value: residual, min, max, 9 of
    # the 8-bit round trip, the implied class's sum, base add, clamp,
    # simplex sum and divide, weight multiply and add (20); then the
    # sharpening's 9 per output value
    b, why = bound_ms(4.0 * (n_in + K + 2 * m * N), 20.0 * n_in + 9.0 * m * N)
    rkw = dict(mode="delta", bits=8)
    out.append(dict(
        name="fused_round", route="cuda",
        source="src/repro_torch/kernels/csrc/fused_round.cu",
        replaces="src/repro/kernels/round_kernel.py:150",
        launches=launches["fused_round"], max_abs_err=errs["round"],
        ms=cuda_ms(lambda: round_kernel.fused_round(z, w, BETA, base, **rkw)),
        plain_ms=cuda_ms(lambda: round_kernel.fused_round_plain(z, w, BETA, base, **rkw)),
        bound_ms=b, bound_by=why, library_ms=None))

    # whisper's decoder self-attention as the prefill calls it
    B, S, H, d = WHISPER_B, WHISPER_S, 20, 64
    q, k, v = attn_inputs(rng, B, S, S, H, H, d, torch.bfloat16, dev)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))  # (B, H, S, d) views
    # bytes: q, k, v read once and o written once, bfloat16; operations:
    # q.k and p.v, 2 * d each, over the S(S+1)/2 causal (query, key) pairs
    # of each batch row and head
    pairs = B * H * S * (S + 1) // 2
    b, why = bound_ms(2.0 * 4 * B * S * H * d, 4.0 * d * pairs, BF16_OPS_PER_S)
    out.append(dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attn.cu",
        replaces="src/repro/kernels/attn_kernel.py:80",
        launches=launches["flash_attention"], max_abs_err=errs["flash"],
        ms=cuda_ms(lambda: attn_kernel.flash_attention(q, k, v, causal=True)),
        plain_ms=cuda_ms(lambda: attn_kernel.flash_attention_plain(q, k, v, True, 0)),
        bound_ms=b, bound_by=why,
        library_ms=cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))))
    # the same shape at other head dims, beside SDPA at the same shape and
    # dtype; the float32 bound counts the kernel's three tf32 passes
    for dt, dims in FLASH_TIMED_DIMS.items():
        for dd in dims:
            q, k, v = attn_inputs(rng, B, S, S, H, H, dd, dt, dev)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            pairs = B * H * S * (S + 1) // 2
            if dt == torch.bfloat16:
                b, why = bound_ms(2.0 * 4 * B * S * H * dd, 4.0 * dd * pairs, BF16_OPS_PER_S)
            else:
                b, why = bound_ms(4.0 * 4 * B * S * H * dd, TF32_PASSES * 4.0 * dd * pairs,
                                  TF32_OPS_PER_S)
            ms = cuda_ms(lambda: attn_kernel.flash_attention(q, k, v, causal=True))
            sdpa_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True))
            log(f"time flash_attention ({B},{S},{H},{dd}) {str(dt)[6:]} causal "
                f"{attn_kernel.launch_plan(q, k, v, q).kernel}: ms={ms!r} sdpa_ms={sdpa_ms!r} "
                f"bound_ms={b!r} by {why}")
    del q, k, v, qt, kt, vt
    # per-row Enhanced ERA: the paper's aggregate (1000, 10) float32, then
    # whisper's vocabulary as soft-labels (1536, 51968) in bfloat16 and in
    # float32; bytes: the input read once and the output written once;
    # operations: clamp, log, *beta, max, -, exp, +, / per value.  The line
    # reports the float32 vocabulary shape.
    gen = torch.Generator(device=dev).manual_seed(9)
    V, rows = 51968, WHISPER_B * WHISPER_S
    z_small = _probs(rng, (m, N), dev)
    z_vocab = torch.softmax(torch.randn(rows, V, device=dev, generator=gen), -1)
    for zz in (z_small, z_vocab.to(torch.bfloat16), z_vocab):
        b, why = bound_ms(zz.element_size() * 2.0 * zz.numel(), 8.0 * zz.numel())
        row = dict(
            name="enhanced_era", route="cuda",
            source="src/repro_torch/kernels/csrc/era_rows.cu",
            replaces="src/repro/kernels/era_kernel.py:61",
            launches=launches["enhanced_era"], max_abs_err=errs["era_rows"],
            ms=cuda_ms(lambda: era_kernel.enhanced_era(zz, BETA)),
            plain_ms=cuda_ms(lambda: era_kernel.enhanced_era_plain(zz, BETA)),
            bound_ms=b, bound_by=why, library_ms=None)
        log(f"time enhanced_era {tuple(zz.shape)} {zz.dtype}: ms={row['ms']!r} "
            f"plain_ms={row['plain_ms']!r} bound_ms={b!r} by {why}")
    out.append(row)
    del z_vocab

    # the distillation loss at whisper's vocabulary, float32; bytes: logits
    # and teacher read once, the (B,) losses written once; operations per
    # value pair: max, -, exp, + (the exp sum), *, + (t.l), + (sum t)
    logits = 3.0 * torch.randn(rows, V, device=dev, generator=gen)
    teacher = torch.softmax(torch.randn(rows, V, device=dev, generator=gen), -1)
    b, why = bound_ms(4.0 * (2 * rows * V + rows), 7.0 * rows * V)
    out.append(dict(
        name="distill_loss", route="cuda",
        source="src/repro_torch/kernels/csrc/distill.cu",
        replaces="src/repro/kernels/distill_kernel.py:64",
        launches=launches["distill_loss"], max_abs_err=errs["distill"],
        ms=cuda_ms(lambda: distill_kernel.distill_loss(logits, teacher)),
        plain_ms=cuda_ms(lambda: distill_kernel.distill_loss_plain(logits, teacher)),
        bound_ms=b, bound_by=why,
        library_ms=cuda_ms(lambda: torch.nn.functional.cross_entropy(
            logits, teacher, reduction="none"))))
    del logits, teacher

    # the analyzer's fixture kernels on their valid plans, at the selftest's
    # shapes; bytes: the input read once and the output written once
    # (scale: and s); operations: scale's one multiply a value
    from repro_torch.kernels import fixture_kernel as fk

    x, xs, sv, xh = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev)
                     for shape in ((100, 128), (16, 128), (1,), (4096, 1024)))
    for name, fn, plain, lib, inp, n_ops, extra in (
            ("copy_vec4", lambda: fk.copy_vec4(x), lambda: fk.copy_plain(x),
             lambda o=torch.empty_like(x): o.copy_(x), x, 0.0, 0),
            ("scale", lambda: fk.scale(xs, sv), lambda: fk.scale_plain(xs, sv),
             lambda: torch.mul(xs, sv), xs, float(xs.numel()), 4),
            ("copy_smem", lambda: fk.copy_smem(xh), lambda: fk.copy_plain(xh),
             lambda o=torch.empty_like(xh): o.copy_(xh), xh, 0.0, 0)):
        b, why = bound_ms(4.0 * 2 * inp.numel() + extra, n_ops)
        out.append(dict(
            name=name, route="cuda", source="src/repro_torch/kernels/csrc/fixtures.cu",
            replaces=FIXTURE_REPLACES[name], launches=launches[name],
            max_abs_err=errs[name], ms=cuda_ms(fn), plain_ms=cuda_ms(plain), bound_ms=b,
            bound_by=why, library_ms=cuda_ms(lib)))
    for k in out:
        lib = "" if k["library_ms"] is None else f", library {k['library_ms'] * 1e3:.2f} us"
        log(f"time {k['name']}: {k['ms'] * 1e3:.2f} us (plain {k['plain_ms'] * 1e3:.2f} us, "
            f"bound {k['bound_ms'] * 1e3:.3f} us by {k['bound_by']}{lib})")
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
    # 2. build; 2b. what the flash kernels compiled to
    build_kernels()
    check_flash_sass()
    # 3. kernels against their plain versions
    errs = {"era": check_era(dev), "qdq": check_qdq(dev),
            "round": check_fused_round(dev), "flash": check_flash(dev),
            "era_rows": check_era_rows(dev), "distill": check_distill(dev)}
    # 4. the full-width slice through the host loop
    sl = run_slice(dev)
    # 4b. ... and through the device engine, fused and per-op
    check_sync_guard()
    fused = run_device_slice(dev, fused=True)
    perop = run_device_slice(dev, fused=False)
    compare_runs("fused vs per-op device engine", fused, perop, 0.0, QUANT_STEP_ATOL)
    compare_runs("fused device engine vs host loop", fused, sl, 1e-7, QUANT_STEP_ATOL)
    compare_runs("per-op device engine vs host loop", perop, sl, 1e-7, QUANT_STEP_ATOL)
    # 4f. the comparison methods at the same width, both engines
    run_comparison_methods(dev, card)
    # 4g. the engine options at the same width
    opts = run_engine_options(dev, card)
    run_restore(dev, card, opts)
    run_mirrors(dev, card)
    # 4h. run telemetry at the same width, and the obs host plane
    from repro_torch.obs import SpanTracer

    tracer = SpanTracer("phase 4h", meta={"card": card})
    tel = run_telemetry(dev, card, tracer)
    run_obs_host_plane(dev, tracer, tel)
    # 4c. whisper-large-v3 prefill at full width
    wh = run_whisper(dev)
    # 4d. the soft-label library's kernel seams at full width
    lib = run_library(dev, wh)
    del wh["logits"], wh["params"]
    # 4e. the static analyzer on the card
    an = run_analysis(dev)
    # 5. card vs CPU on a small configuration, both engines
    check_small_cuda_vs_cpu("host")
    check_small_cuda_vs_cpu("scan")
    check_small_methods_cuda_vs_cpu()
    check_options_cuda_vs_cpu(opts["host loop"], tel["on"]["host loop"])
    # 5b. the reduced whisper prefill, card vs CPU
    check_whisper_cuda_vs_cpu()
    # 6. kernel times and the kernel line: each kernel's launches from the
    # run of the path it serves (ERA and qdq: the host loop; fused_round:
    # the fused device engine; flash_attention: one whisper prefill;
    # enhanced_era and distill_loss: the library at full width; the
    # fixture kernels: the analyzer's selftest)
    launches = dict(sl["launches"], fused_round=fused["launches"]["fused_round"],
                    flash_attention=wh["launches"]["flash_attention"],
                    enhanced_era=lib["launches"]["enhanced_era"],
                    distill_loss=lib["launches"]["distill_loss"],
                    **{k: an["launches"][k] for k in FIXTURE_REPLACES})
    kernels = kernel_report(launches, dict(errs, **an["errs"]))
    log(f"card: {card}; slice host loop {sl['per_round_ms']:.3f} ms/round, "
        f"device engine fused {fused['per_round_ms']:.3f}, "
        f"per-op {perop['per_round_ms']:.3f} ms/round; whisper-large-v3 prefill "
        f"({WHISPER_B},{WHISPER_S}) {wh['ms']:.3f} ms")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
