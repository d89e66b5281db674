#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

Run from the root of a checkout, with no arguments and no PYTHONPATH:

    python3 chip_smoke.py

It builds the eight CUDA kernel libraries (``sm_90a``) from
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
Then the active-set engine (phase 4i, ``engine="active"``): at the same
population, per-op and fused, under partial participation (a total
outage, a round of one participant, returning stragglers; telemetry on)
and full participation, its ledgers bit for bit the device engine's and
its state close to the device engine's and the host loop's; the ERA, qdq
and fused-round kernels at every gathered stack size it reached; the
reference's million-client configuration at K = 10^4 (RAM store) and
10^6 (memmap store) on the numpy and the jax stream, whose device peak
may grow by less than 32 bytes a client on each; and a checkpoint split
after 5 rounds, bit for bit.  Then the async engine (phase 4j, ``engine="async"``): at the same population under the
default traffic model and a wide window, per-op and fused, bit for bit the
device engine's ledger; under Poisson arrivals, 0-3 windows of report
latency and churn, at staleness decay 1.0 and 0.5, each round's bytes
against a host replay of the reference's rule, the staleness histogram
against the replay, no in-flight client dispatched and the ledger
unmoved by the decay; the ERA, qdq and fused-round kernels at the
staleness weights those runs aggregated with; and a checkpoint split with
reports in flight, bit for bit.  Then the client-sharded engine (phase
4k, ``engine="shard"``): a world of one over NCCL in this process, per-op
and fused, and once through ``run_method``, which starts that world
itself, each ledger bit for bit the device engine's; worlds of 2 and 4
ranks spawned on the one card over gloo with CUDA tensors (NCCL refuses
two ranks on a device), every rank's ledger and replicated state equal,
with launches, ms/round, device peak and each all-reduce's time per
rank, and each path's device peak per rank at n = 4 at most 0.30 of
n = 1's; and the qdq and fused-round kernels at each world's per-rank
shapes.  Then the paper's FL launcher (phase 4l,
``repro_torch.launch.fl_train``): SCARLET and CFD for 20 rounds on the
card and on the CPU (per-round ledgers bit for bit, accuracies within one
test sample, the ERA and qdq kernels counted on the path and held against
their plain versions on the inputs the path gave them), the launcher at
its defaults (300 rounds) and with ``--telemetry`` (its trace through
``python -m repro_torch.obs validate``), and its configuration for 300
rounds on the fused device engine and the async engine (staleness decay
0.5), whose final accuracies are findings.  Then the reference's jax key
stream (phase 4q, ``repro_torch.core.prng``): the threefry counter-hash
kernel bit for bit against its plain version on the CPU at the FL path's
draw shapes (a leg's sort bits over |P| = 10^4 and K = 100, expiry
uniforms at m = 1000, the 100 clients' MLP init, a 4096-client chunk of
the active store's init, the keys of 10^6 clients), timed; the slice on
the device engine under ``rng_backend="jax"``, per-op and fused, its P^t,
participation and ledger on the card equal to the CPU's; every engine's
ms/round under both streams with its threefry launches a round.
It then runs whisper-large-v3's prefill at full width and depth (random
weights from a seed, 4 requests of 384 decoder tokens over 1500 audio
frames, bfloat16), whose decoder self-attention goes through the flash
attention kernel once per layer, then its KV-cache decode (phase
4c-decode: the 384 tokens teacher-forced through ``decode_step`` at a
device position with no host sync, every position's logits against the
prefill's, then 32 greedy tokens timed), and then the soft-label library's
kernel seams at full width (``repro_torch.core`` with ``impl="kernel"``):
``aggregate_soft_labels`` over the paper's (100, 1000, 10) stack with
SCARLET's adaptive beta computed on the card, ``enhanced_era`` over
whisper's vocabulary as soft-labels, and ``soft_cross_entropy`` over the
prefill's logits, all under ``torch.cuda.set_sync_debug_mode("error")``.
Then the Jamba hybrid and Mamba2 (phase 4m): jamba-v0.1-52b at its
published widths, one block of 8 sublayers deep (random weights from a
seed, bfloat16), prefills 2 x 4096 tokens with its attention through the
flash kernel at head dim 128 (GQA 32:8), held there against the kernel's
plain version and timed beside SDPA, and counts the entries its MoE
sublayers drop; then decodes 512 teacher-forced positions on q/k-tempered
weights against the prefill, with no host sync; then mamba2-1.3b at full
size prefills 2 x 2048 tokens and decodes 256 positions, held against
the prefill in float32.
Then LM training (phase 4n, ``repro_torch.launch.train``): granite-3-2b
at its published widths and depth (2.64e9 parameters, bfloat16, random
weights from a seed) takes 5 steps of ``train_step`` (the loss, its
backward through the flash kernel's differentiable Function, AdamW) at
B = 8, S = 128, every parameter's gradient finite and nonzero on step 1,
then one step with activation checkpointing; the Function against
autograd through the kernel's plain version at that attention shape and
in float32; one step of each ported family's reduced float32
configuration on the card and on the CPU; and the launcher's default
run, whose loss must improve.
Then the last model modules (phase 4o): ResNet-20 at its published
widths on a batch of 128 CIFAR-shaped images, its logits and the
gradients of mean(logits^2) on the card against the CPU's (float32 and
float64), timed with TF32 off and on; and jamba-v0.1-52b's MoE layer at
full width through ``common.moe_ffn`` under ``MOE_A2A_MESH`` (the
all-to-all expert-parallel dispatch, ``repro_torch.models.moe_a2a``) on
a world of one over NCCL and on the ("data", "model") meshes (2, 1),
(4, 1) and (2, 2) over gloo on the one card, each rank holding only its
shards of the expert stacks (their bytes gated), against the
single-device ``moe_ffn`` without drops (outputs, aux and the gradients,
the shards' against their slices), with each rank's drops recounted on
the host.
Then the production dry run (phase 4p, ``repro_torch.launch.dryrun``):
granite-3-2b's phase 4n step traced as a world of one on fake CUDA
tensors, its predicted memory plan, matrix-product FLOPs and flash
launches held against the real step's device peak, ``FlopCounterMode``
and launch count; then granite-3-2b and kimi-k2-1t-a32b at train_4k under
fsdp as one rank of a fake world of 256, each rank's parameter bytes
against the sharding's arithmetic and each recorded flash launch plan
through the launch lint; then kimi-k2-1t-a32b at train_4k under the
ep-a2a variant (the all-to-all MoE on 16x16): its routed-expert bytes a
rank against the arithmetic, no all-gather or all-reduce of an expert
stack, its all-to-all bytes against the prediction.
Then the static analyzer (``python -m repro_torch.analysis``) runs on the
card: the card's limits against ``runtime.HOPPER``, the strict pass with
the compiled kernels' attributes (the active-set pass among them), the
selftest (which launches the three fixture kernels on their valid plans,
has the card refuse the shared-memory hog, flags the active engine's
O(K) leak for its K-sized shape, the async engine's staleness hook
that computes on the host and the replicated carry keyed on a
shard-local slice), the fixture kernels against their plain versions, the
misaligned plan faulting in a child process, and the contract pass's
verdicts confirmed by CUDA graph capture in another.
Last come the reduced whisper, jamba and mamba2 configurations' prefill
and decode on the card and on the CPU.
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
from contextlib import contextmanager
from typing import Optional

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.launch.roofline import HW_PRESETS  # noqa: E402

# Published H100 SXM peaks (NVIDIA data sheet; the port's hardware model,
# repro_torch.launch.roofline's "h100_sxm"): HBM3 bandwidth and the
# float32 rate outside the tensor cores.  The bound of a kernel is the
# larger of bytes / HBM rate and operations / float32 rate.
HBM_BYTES_PER_S = HW_PRESETS["h100_sxm"].hbm_bw
FP32_OPS_PER_S = 67e12
# ... and the dense tensor-core rates, the peaks for attention's products:
# bfloat16 for bfloat16 inputs; tf32 for float32 inputs, whose kernel
# takes each product as three tf32 products (3xTF32), so its bound counts
# all three passes at the tf32 rate and no share of it reads over 100 %.
BF16_OPS_PER_S = HW_PRESETS["h100_sxm"].peak_flops
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

# Phase 4i: the active-set engine (engine="active").  (a) The slice's
# population under ACTIVE_PARTICIPATION with outages: every client offline
# in ACTIVE_OUTAGE_ROUND (a total outage), all but client 0 in
# ACTIVE_SINGLE_ROUND (a gathered stack of one), clients
# ACTIVE_STRAGGLERS offline in rounds 2-3 (catch-up on return); then full
# participation (a stack of 128 with 28 padding rows).  The active engine,
# per-op and fused, against the device engine and the host loop on the same
# numpy draws: ledgers equal bit for bit to the device engine's and to
# float32 to the host loop's; caches to QUANT_STEP_ATOL (the reference's
# quant8 band); accuracies to ACTIVE_ACC_ATOL and the server's parameters
# to ACTIVE_PARAM_ATOL (the gathered stack sums its rows in another order
# than the dense one, and an 8-bit level flip in a cached teacher moves the
# next rounds' training a little).  (b) The three kernels at every stack
# size the runs reach, 1 included, against their plain versions with phase
# 3's tolerances.  (c) The reference's million-client configuration
# (benchmarks/active_bench.py:_cfg): ACTIVE_M of K clients a round at each
# K of ACTIVE_KS, the largest on a memmap store, on each stream of
# ACTIVE_STREAMS (the jax stream, the default, draws the participation
# over K on the card: by selection, a chunk of clients at a time, then
# conscription's int32 ranks); one warm-up round, then ACTIVE_TIMED timed
# rounds; on each stream the device's peak may grow by less than
# ACTIVE_PEAK_PER_CLIENT bytes a client from the smaller K to the larger
# (int32 last_sync, the bool mask, int32 searchsorted positions and float32
# counts are about 22).  (d) ACTIVE_RESTORE_AT rounds, a checkpoint, a
# fresh engine, the rest: (a)'s run bit for bit.
ACTIVE_PARTICIPATION = 0.3
ACTIVE_OUTAGE_ROUND = 4
ACTIVE_SINGLE_ROUND = 6
ACTIVE_STRAGGLERS = tuple(range(0, 100, 9))
ACTIVE_ACC_ATOL = 2e-3
ACTIVE_PARAM_ATOL = 1e-3
ACTIVE_BENCH = dict(n_classes=10, dim=8, hidden=8, mlp_depth=1, local_steps=1,
                    distill_steps=1, public_size=256, public_per_round=64,
                    partition="uniform", eval_every=10 ** 6, seed=0)
ACTIVE_BENCH_CACHE = 3
ACTIVE_M = 64
ACTIVE_KS = (10_000, 1_000_000)
ACTIVE_MEMMAP_FROM = 1_000_000
ACTIVE_TIMED = 3
ACTIVE_PEAK_PER_CLIENT = 32
ACTIVE_STREAMS = ("numpy", "jax")
ACTIVE_RESTORE_AT = 5

# Phase 4j: the async engine (engine="async"), SCARLET at the slice's
# population with its codec and cache.  (a) The default traffic model and
# a wide window (latency uniform on ASYNC_WIDE_TICKS ticks at ASYNC_WINDOW
# ticks a window: every delay floors to 0), per-op and fused, against phase
# 4b's device-engine run of the same path: the ledger bit for bit, cache
# values to QUANT_STEP_ATOL (phase 4b's band), the server's parameters to
# ASYNC_PARAM_ATOL and accuracies to one test sample (the same operations
# in the same order; the log says whether they are bit for bit).  (b)
# Genuinely async traffic: ASYNC_RATE Poisson contacts a tick (reachable
# with p = 1 - e^-1.5 = 0.777), latency uniform on 0..ASYNC_MAX_DELAY
# windows, clients ASYNC_JOINERS join at round ASYNC_JOIN and ASYNC_LEAVERS
# leave after round ASYNC_LEAVE; staleness decay 1.0 and ASYNC_DECAY,
# per-op and fused, telemetry on.  A host replay from the planned dispatch
# masks, the traffic (compiled anew) and the recorded pre-round caches: no
# blocked client dispatched; each round's bytes by the reference's rule in
# float64 (exact where every term is exact in float32; else to
# ASYNC_LEDGER_RTOL: the arrivals' mean dispatch-time request count is a
# fraction, and the card rounds it, times N - 1 and times the arrivals);
# the staleness histogram (a report that was in flight: its delay).  The
# four ledgers equal bit for bit.  (c) The three kernels at the weights the
# decayed runs aggregated with (w K / sum w, w = decay^s on the arrivals),
# against their plain versions at phase 3's tolerances.  (d)
# ASYNC_RESTORE_AT rounds with reports in flight, a checkpoint, a fresh
# engine, the rest: (b)'s per-op decayed run, leaves and ledger bit for
# bit.  (e) Phase 4e: the analyzer's async pass clean on its five variants
# and its fixture flagged.
ASYNC_WIDE_TICKS = (0, 3)
ASYNC_WINDOW = 4
ASYNC_RATE = 1.5
ASYNC_MAX_DELAY = 3
ASYNC_JOIN, ASYNC_JOINERS = 3, tuple(range(0, 10))
ASYNC_LEAVE, ASYNC_LEAVERS = 7, tuple(range(10, 20))
ASYNC_DECAY = 0.5
ASYNC_SEED = 5
ASYNC_LEDGER_RTOL = 2.0 ** -22
ASYNC_PARAM_ATOL = 1e-4
ASYNC_RESTORE_AT = 5

# Phase 4k: the client-sharded engine (engine="shard"), SCARLET at the
# slice's population with its codec and cache, per-op and fused.  (a) A
# world of one over NCCL in this process: the rounds under the device
# engine's sync guard as they are; the engine driven as phase 4b drives
# the device engine (launch counts, ms/round, the device's peak) and once
# more through run_method, which starts the world itself: each ledger bit
# for bit phase 4b's, caches to QUANT_STEP_ATOL, accuracies and the
# server's parameters to phase 4i's ACTIVE_ACC_ATOL and ACTIVE_PARAM_ATOL
# (the per-op path sharpens the summed mean with the plain ERA where 4b
# runs enhanced_era_fused over the weighted stack; the fused path adds
# the moments by all-reduce, then sharpens).  (b) Worlds of SHARD_WORLDS
# ranks on the one card: NCCL refuses two ranks on one device, so these
# run over gloo with CUDA tensors (gloo stages them through host memory;
# the engine's all-reduce turns the sync debug mode off for the gloo
# collective call alone).  Each rank: the ledger equal to (a)'s, the
# replicated state (cache, server parameters, teacher, last_sync, the
# gathered clients) equal on every rank bit for bit, 10 qdq (per-op) or
# 10 fused_round (fused) launches, ms/round, the device's peak above what
# the process held before the engine was built; each
# all-reduce of the run timed alone at its size.  (c) qdq (residual view,
# 8 bits) and fused_round (delta+quant8, sharpen=False, 0/1 participation)
# at each world's per-rank shape (K/n, m, N) against their plain versions
# at phase 3's tolerances, timed.
SHARD_WORLDS = (2, 4)
SHARD_TIMED = 20
# A rank's device peak is the growth of a run above what its process held
# before it.  A spawned rank's first matrix products allocate cuBLAS's
# workspaces, one a thread that multiplies (the rank's own and autograd's
# backward thread), which live as long as the process and do not depend on
# K: shard_rank makes them (warm_cublas) before it measures, and logs
# their bytes.  Then the client state is a rank's K/n share: at n = 4 each
# path's peak may be at most SHARD_PEAK_RATIO of n = 1's (K/n = 0.25 of the
# clients, plus the replicated server state).
SHARD_PEAK_RATIO = 0.30
# Phase 4l: the launcher (repro_torch.launch.fl_train) for LAUNCHER_ROUNDS
# rounds on the card and on the CPU (the per-round ledger bit for bit; the
# accuracies within one test sample for the methods of
# LAUNCHER_FREE_RUN_GATED), its configuration's rounds in lockstep on the
# two (each round from the card's state; the round's ledger equal, its
# accuracies within one test sample), then at its defaults; the ERA and qdq
# kernels on the inputs the card's runs gave them (and on random inputs of
# the same shapes) against their plain versions at ERA_ATOL / QDQ_ATOL;
# the launcher's configuration on the fused device engine and the async
# engine for its 300 rounds, the async engine under Poisson contacts at
# LAUNCHER_TRAFFIC[0] a tick and latency uniform on 0..LAUNCHER_TRAFFIC[1]
# windows (phase 4j's, without its churn, which names clients of the
# slice), at staleness decay LAUNCHER_DECAY.
LAUNCHER_ROUNDS = 20
# CFD's two free runs are not held to one test sample: at the launcher's
# configuration float rounding parts them for some initial realizations
# (CFD's on the key stream, 0.0134 apart; seeds 1 and 3 of the former
# torch.Generator init too), which its lockstep rounds show is no fault of
# a round's computation on the card
LAUNCHER_FREE_RUN_GATED = ("scarlet",)
LAUNCHER_TRAFFIC = (ASYNC_RATE, ASYNC_MAX_DELAY)
LAUNCHER_DECAY = 0.5
# Probabilistic expiry draws a leg's uniforms from the jax key stream
# whatever the engine's stream: two threefry launches a leg (the rounds'
# keys, then the uniforms), two legs a run_engine run.
EXPIRY_LAUNCHES = 4
# Phase 4q: the jax key stream.  (a) The threefry kernel against its plain
# version (the CPU copy of the same keys) at STREAM_SHAPES, bit for bit,
# each timed beside the plain version on the host CPU (the plain hash
# never takes a CUDA tensor), its bound the larger of the bytes the
# function moves at the HBM rate (two 32-bit words a key read, one 32-bit
# word a value written, two a pair: the port's int64 words count as the
# uint32 words jax's threefry2x32 produces) and THREEFRY_INSTR integer
# instructions a value at the card's issue rate (ISSUE_PER_S: 132 SMs x 4
# schedulers x 32 lanes at 1980 MHz, the enhanced_era row's reckoning);
# the first shape is the kernel line's.  (b) The slice on the device
# engine under rng_backend="jax", per-op and fused: per-op against fused,
# the leg's P^t and participation on the card against the CPU's, its first
# STREAM_CPU_ROUNDS rounds' ledger against a CPU engine's; the threefry
# launches a leg (STREAM_LEG_KEYS plus two a sort round of P^t).  (c) Each
# engine's ms/round under both streams (host clock) and threefry launches
# a round.
ISSUE_PER_S = 132 * 4 * 32 * 1980e6
THREEFRY_INSTR = 72  # the hash alone, where the SASS loop is not found
STREAM_PLAIN_MAX = 10 ** 5  # values past which the plain hash is not timed
STREAM_SHAPES = (
    ("P^t sort bits, a leg of 9 round keys over |P| = 10^4", 9, 0, 10000, "bits"),
    ("participation sort bits, 9 round keys over K = 100", 9, 0, 100, "bits"),
    ("expiry uniforms, 9 rounds of m = 1000", 9, 0, 1000, "uniform"),
    ("a leg's round keys fold_in(key, 2..10)", 1, 2, 9, "pair"),
    ("the clients' keys split(key(seed), K + 1), K = 100", 1, 0, 101, "pair"),
    ("MLP init, 100 clients: w0 (32, 64)", 100, 0, 2048, "uniform"),
    ("MLP init, 100 clients: w1 (64, 64)", 100, 0, 4096, "uniform"),
    ("MLP init, 100 clients: w2 (64, 10)", 100, 0, 640, "uniform"),
    ("active store init chunk, 4096 clients: split", 4096, 0, 2, "pair"),
    ("active store init chunk, 4096 clients: w0 (8, 8)", 4096, 0, 64, "uniform"),
    ("active store init chunk, 4096 clients: w1 (8, 10)", 4096, 0, 80, "uniform"),
    ("the clients' keys at K = 10^6", 1, 0, 10 ** 6 + 1, "pair"),
    ("participation at K = 10^6 by selection: one chunk's bits", 1, 0, 1 << 18, "bits"),
)
STREAM_LEG_KEYS = 3  # the leg's round keys, their transmit keys, their split
STREAM_CPU_ROUNDS = 2
STREAM_ENGINES = (("host loop", "host", False), ("device engine per-op", "scan", False),
                  ("device engine fused", "scan", True), ("active", "active", False),
                  ("async", "async", False), ("shard n=1 (nccl)", "shard", False))

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
# Phase 4c-decode: whisper-large-v3's KV-cache decode at full width, on
# phase 4c's weights tempered (see WHISPER_SMALL_ATOL) and its batch: the
# WHISPER_S prompt tokens teacher-forced through registry.decode_step one
# position a step at a device position, under sync debug "error", then
# DECODE_GEN greedy tokens, the next token staying on the card.  Each
# step's logits are held against the tempered prefill's at its position
# (the flash kernel in the decoder's self-attention).  Both paths keep the
# residual stream in bfloat16 and round every product and attention output
# to it; they add in other orders (a (4, D) product against a (1536, D)
# one; the plain float32 score chain against flash's online softmax), so
# an element may round to its neighbouring bfloat16 value (2^-8 of it) at
# each of the 2 x 32 residual updates of a layer stack.  Such flips add
# like a random walk, sqrt(64) x 2^-8: the logits are held to DECODE_RTOL
# = 2^-5 of the largest prefill logit.  The greedy token (the argmax) must
# agree at DECODE_ARGMAX_SHARE of the positions: a position whose top two
# logits lie closer than that error may flip.
DECODE_GEN = 32
DECODE_RTOL = 2.0 ** -5
DECODE_ARGMAX_SHARE = 0.95
# The reduced float32 whisper's decode, card vs CPU: DECODE_SMALL_S
# positions teacher-forced on both, each step's logits to WHISPER_SMALL_ATOL.
DECODE_SMALL_S = 32
# Phase 4m: the Jamba hybrid and Mamba2 at full width.  (a)
# jamba-v0.1-52b at its published widths, one block of the 32 layers
# (JAMBA_LAYERS = attn_layer_period: attention, 7 Mamba2 mixers, 4 dense
# and 4 MoE FFNs of 16 experts, top-2; 12.73e9 parameters, 26.5 GB in
# bfloat16; two blocks and their float32 draws would not fit the card's 80
# GB), random weights from a CUDA generator, prefill B = 2, S = 4096: one
# warm-up, then the median of JAMBA_TIMED by the host clock; the flash
# kernel at exactly the prefill's attention, (2, 4096, 32, 8, 128)
# bfloat16, held against its plain version on the inputs the path gives it
# (one bfloat16 step, as in phase 3) and timed beside SDPA.  (b) Decode on
# (a)'s weights with wq and wk scaled by JAMBA_QK_SCALE (see
# WHISPER_SMALL_ATOL: as drawn, the fan-in rule gives scores of standard
# deviation in the hundreds): JAMBA_DECODE_S tokens teacher-forced through
# registry.decode_step at a device position under sync debug "error",
# each step's logits held against the prefill's at its position.  The
# prefill drops the entries past an expert's capacity; a decode step of B
# tokens never does, so where the published capacity_factor drops any,
# the comparison prefill runs at capacity_factor = n_experts / top_k
# (capacity for every token).  Both paths keep the residual stream in
# bfloat16; the prefill's conv runs in bfloat16, the decode's in float32,
# and the SSD chunk form sums in another order than the recurrence, so an
# element may round to its neighbouring bfloat16 value at each of the 16
# residual updates.  A token whose second and third experts lie closer
# than that rounding may route to another expert in one path: its logits
# then move by up to a few per cent of the largest.  So each position's
# logits are held to JAMBA_DECODE_RTOL of the largest prefill logit at
# JAMBA_DECODE_SHARE of the positions and to JAMBA_FLIP_RTOL at every
# position; the greedy token must agree at DECODE_ARGMAX_SHARE.  (c)
# mamba2-1.3b at full size (48 layers), prefill B = 2, S = MAMBA_S and
# MAMBA_DECODE_S decode steps timed in bfloat16.  In bfloat16 its 48
# random layers amplify a one-ulp rounding flip of the residual stream
# (0.4 %) into O(10 %) of the logits: the prefill at ssm_chunk 256 against
# MAMBA_SMALL_CHUNK, the same sums in another order, differed by 0.153 of
# logits up to 1.19 on the card, and tools/ssd_depth_sweep.py on the CPU
# grows that gap from 0.5 % at 2 layers to 22 % at 48.  So the
# bfloat16 errors are printed, and both checks are held on the same
# weights in float32 (TF32 off), where the chunk sizes agreed to 8.5e-5 of
# the largest logit at 48 layers on the CPU: chunk 256 against
# MAMBA_SMALL_CHUNK (8 against 32 chunks: the recurrence between chunks)
# and every decode position against the prefill to MAMBA_F32_RTOL = 2^-10
# of the largest logit, ten times that.  No kernel runs in (c).  (d) The
# reduced float32 configurations on
# the card and on the CPU (TF32 off): REDUCED_S-position prefills and
# REDUCED_DECODE steps each, logits to WHISPER_SMALL_ATOL.
JAMBA_LAYERS = 8
JAMBA_B, JAMBA_S = 2, 4096
JAMBA_SEED = 0
JAMBA_TIMED = 3
JAMBA_QK_SCALE = 1 / 8
JAMBA_DECODE_S = 512
JAMBA_DECODE_RTOL = 2.0 ** -5
JAMBA_DECODE_SHARE = 0.98
JAMBA_FLIP_RTOL = 2.0 ** -2
MAMBA_B, MAMBA_S = 2, 2048
MAMBA_DECODE_S = 256
MAMBA_SMALL_CHUNK = 64
MAMBA_F32_RTOL = 2.0 ** -10
REDUCED_S, REDUCED_DECODE = 128, 16
# Phase 4n: LM training (repro_torch.launch.train).  (a) granite-3-2b,
# the launcher's default architecture, at its published widths and all
# 40 layers (2.64e9 parameters in bfloat16; random weights from a CUDA
# generator), TRAIN_STEPS steps of launch.train.train_step with the
# launcher's AdamW (weight decay 0.01, lr TRAIN_LR, bfloat16 moments) at
# B = TRAIN_B, S = TRAIN_S on make_batch's tokens (the launcher's own
# token_stream builds two (V, V) float64 bigram tables, 19.3 GB each at V
# = 49155): the losses finite, every parameter's gradient of step 1
# finite and nonzero in every layer (a detached attention leaves wq, wk
# and wv without one), every parameter changed, flash launched once a
# layer a step; ms/step by CUDA events over steps 2..TRAIN_STEPS, the
# device peak; then one more step with remat (each layer's flash launches
# again in the recompute).  (b) attn_kernel.flash_attention_diff at
# granite's attention shape TRAIN_ATTN (bfloat16) and at TRAIN_ATTN_F32
# (float32, a window) against autograd through flash_attention_plain on
# the same inputs and cotangent: the forward to one bfloat16 step
# (BF16_STEP, as phase 3) or FLASH_F32_ATOL; dq, dk, dv to two bfloat16
# steps of each gradient's largest value (both compute in float32 and
# round once, but autograd through the plain version also rounds the
# repeated heads' dk and dv to bfloat16 before it sums each group of H /
# Hkv), or TRAIN_GRAD_RTOL of it in float32 (the same float32 recompute in
# another order of operations).
# (c) The reduced float32 configuration of each family (TRAIN_FAMILIES;
# q and k projections tempered, see WHISPER_SMALL_ATOL), one train_step
# on the card and on the CPU from the same weights and batch, TF32 off:
# the loss, each parameter's gradient and AdamW's moments m and v after
# the step (each relative to the leaf's norm; m and v are linear and
# quadratic in g, with no eps) and the whole parameter tree after the
# step (relative to its norm) to TRAIN_STEP_RTOL; the flash launches of
# each family's step.  Each parameter leaf after the step is printed, not
# held: AdamW moves an element by
# lr g / (|g| + eps), so where |g| is near eps = 1e-8 the step follows
# g's rounding, and a zero-initialised leaf (a norm, conv_b, dt_bias) is
# nothing but its step (on the H100, the reduced mamba2's conv_b, whose
# gradients reach down to 2.6e-8, came out 7.8e-4 of its norm apart; on
# the CPU its float32 gradients lie up to 20 % from float64's there).
# (d) python -m repro_torch.launch.train --steps TRAIN_LAUNCHER_STEPS on
# the card, in process: its last line says "improved".
TRAIN_B, TRAIN_S = 8, 128
TRAIN_STEPS = 5
TRAIN_SEED = 0
TRAIN_LR = 1e-3
TRAIN_ATTN = (8, 128, 32, 8, 64)
TRAIN_ATTN_F32 = (2, 256, 8, 2, 64, 64)
TRAIN_GRAD_RTOL = 1e-5
TRAIN_STEP_RTOL = 1e-4
TRAIN_FAMILIES = (("granite-3-2b", 2), ("gemma2-27b", 0), ("grok-1-314b", 2),
                  ("kimi-k2-1t-a32b", 2), ("internvl2-26b", 2), ("whisper-large-v3", 2),
                  ("jamba-v0.1-52b", 1), ("mamba2-1.3b", 0))
TRAIN_LAUNCHER_STEPS = 20
# Phase 4o: the last model modules.  (a) ResNet-20 (repro_torch.models.
# resnet, the paper's client/server model, Table III) at its published
# widths 16/32/64 (0.27e6 parameters, float32, random weights from a
# seed) on a CIFAR-shaped batch of RESNET_B standard-normal 32x32x3
# images from a seed.  The FL system never builds the CNN, so no run of
# the repository fixes a batch: RESNET_B is a stand-in.  The forward's
# logits, the loss mean(logits^2) and its gradients on the card (cuDNN's
# convolutions, TF32 off) and on the CPU from the same weights: the
# logits to RESNET_RTOL of their norm; in float64 on both sides (the
# GroupNorm statistics stay float32, as the model writes them) the logits
# and every leaf's gradient to RESNET_RTOL of its norm; the card's float32
# gradients to RESNET_F32_GRAD_RTOL of each leaf's norm from the CPU's
# float64 ones, printed beside the CPU's own float32 distance (GroupNorm's
# backward subtracts nearly equal terms, so a float32 gradient of this
# network lies about 1e-4 of a leaf's norm from the float64 one on either
# device).  Then ms per forward and per forward + backward by CUDA events
# (TF32 off and on), the device peak above what the process held before
# (earlier phases leave tensors alive) and one profiled step.
RESNET_B = 128
RESNET_SEED = 0
RESNET_RTOL = 1e-4
RESNET_F32_GRAD_RTOL = 1e-3
RESNET_TIMED = 20
# (b) The all-to-all MoE (repro_torch.models.moe_a2a) at full width:
# jamba-v0.1-52b's MoE layer (D = 4096, F = 14336, E = 16, top_k = 2,
# bfloat16; weights drawn by common.init_params from a CUDA generator at
# A2A_SEED, so every rank of a world draws the same bits), the global
# batch A2A_B x A2A_S of standard normals, called through common.moe_ffn
# with MOE_A2A_MESH set: on a world of one over NCCL in this process, and
# on ("data", "model") meshes A2A_MESHES over gloo on the one card (NCCL
# refuses two ranks on a device).  Each rank draws the layer, checks its
# fingerprint, keeps only its shards of the stacks (moe_a2a.expert_shard:
# E / n experts, F / M columns) and frees the full draw; its stack bytes
# must be exactly the full stacks' 5,637,144,576 B / (n M).  At capacity
# factor 8 nothing drops:
# the ranks' outputs, gathered in data order, equal the single-device
# moe_ffn of the whole batch to A2A_RTOL of its largest magnitude (both
# round the expert products to bfloat16, whose accumulation order may
# differ with the products' row counts, and the (2, 2) mesh sums two
# bfloat16 halves of each output: two bfloat16 steps, BF16_STEP), and the aux loss
# equals the mean of the single-device loss over each data coordinate's
# rows (the reference's pmean of local losses) to A2A_AUX_RTOL.  At the
# default 1.25 and at 1.0 each rank's dropped count equals a host recount
# from its routing (random routing at this width fills no expert past 1.25
# of its share, so 1.0, where about half the experts overflow, is the
# case that drops; the gate also fails if no rank drops there).  The
# gradients through the exchanges: at cf 8 each rank's share of the loss
# sum(out c) + A2A_AUX_WEIGHT aux (c a float32 cotangent drawn after x;
# its rows' term and 1 / n of the aux term, divided over the M ranks along
# "model") is differentiated with respect to its rows of x, the router
# and its shards; the x gradients summed over "model" and gathered, and
# the router gradients summed over every rank, equal the single-device
# moe_ffn's gradients of sum(out c) + A2A_AUX_WEIGHT times the mean of
# the aux losses of the data coordinates' row blocks, and each rank's
# shards' gradients equal their slices of the single-device stack
# gradients (kept on the card in bfloat16 and shared with the ranks
# through CUDA IPC, so no host holds a float32 copy), each to
# A2A_GRAD_RTOL of its largest magnitude (four bfloat16 steps: a token's
# gradient adds its k expert paths and its routing path in bfloat16, in
# another order on each side; a wrong transpose is off by the whole
# gradient).
# A2A_AUX_WEIGHT gives the aux term a visible share of the router
# gradient (per unit weight its gradient is far smaller than the output
# term's).  Each rank's ms per call at 1.25, its two all-to-alls' ms and
# bytes (2 E cap_e D 2 B), its device peak above what it held before
# drawing the layer (forward calls only, its shards held) and the ms of
# the gradient step are printed; the world of one's call is profiled.
A2A_B, A2A_S = 4, 1024
A2A_SEED = 0
A2A_MESHES = ((2, 1), (4, 1), (2, 2))
A2A_FACTORS = (8.0, 1.25, 1.0)
A2A_DEFAULT_CF = 1.25
A2A_RTOL = 2.0 ** -6
A2A_AUX_RTOL = 1e-5
A2A_GRAD_RTOL = 2.0 ** -5
A2A_AUX_WEIGHT = 1000.0
A2A_TIMED = 5

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
               engine_kw: Optional[dict] = None, rng_backend: str = "numpy",
               **strategy_kw) -> dict:
    """``method`` at the slice's population through the host loop
    (``engine="host"``), the device engine (``"scan"``), the active-set
    engine (``"active"``), the async engine (``"async"``) or the sharded
    engine (``"shard"``, on the process group already started;
    ``engine_kw`` goes to the engine's constructor): round 1, then
    the other rounds in one leg (on the device engine its only host sync
    is the read-back at its end), the launch counts set to 0 just before
    and read just after.  Selective-FD's upload masks are recorded with
    the normalized entropies they gate on, for the engines' comparison.
    ``hook(engine)`` runs once the engine is built.  With ``telemetry``
    the run's ``History`` (both legs' ledger and telemetry rows) is kept
    as ``history``.  ``rng_backend`` is the draws' stream, ``"numpy"``
    unless given on every engine: the phases before 4q hold their runs
    against each other and against ``request_masks``' replay of the numpy
    P^t stream (the device engines' own default is the jax stream)."""
    from repro_torch.core import era
    from repro_torch.core.comm import CommLedger
    from repro_torch.fl import (ActiveSetFederatedDistillation, AsyncFederatedDistillation,
                                FederatedDistillation, FLConfig, History, STRATEGIES,
                                ScannedFederatedDistillation, ShardedFederatedDistillation)
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
    Engine = {"host": FederatedDistillation, "scan": ScannedFederatedDistillation,
              "active": ActiveSetFederatedDistillation,
              "async": AsyncFederatedDistillation,
              "shard": ShardedFederatedDistillation}[engine]
    t0 = time.perf_counter()
    eng = Engine(cfg, strat, cache_duration=cache_duration, use_cache=use_cache,
                 scenario=scenario, probabilistic_expiry=probabilistic_expiry,
                 track_local_caches=track_local_caches, rng_backend=rng_backend,
                 device=device, **(engine_kw or {}))
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
    sync = {"host": "synchronized",
            "scan": "rounds under sync debug mode 'error', one read-back at the end",
            "active": "gathered steps under sync debug mode 'error', one read-back a round",
            "async": "rounds under sync debug mode 'error', one read-back at the end",
            "shard": "rounds under sync debug mode 'error', one read-back at the end"
            }[engine]
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
        def _round_device(self, st, t, part, idx, do_eval, **kw):
            float(part.sum())  # reads the card from the host
            return super()._round_device(st, t, part, idx, do_eval, **kw)

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
    uniforms, a tensor on any device or an array), absent or expired where
    ``u < clip((age - 1) / D, 0, 1)`` in float32.  ``expired`` receives each round's count of present
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
            u = uniforms(t)
            u = u.cpu().numpy() if torch.is_tensor(u) else u
            miss = ~(present[idx] & ~(u < hazard))
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
        check_launches(r["launches"], dict({"fused_round": n} if fused else
                                           {"enhanced_era_fused": n, "quantize_dequantize": n},
                                           threefry=EXPIRY_LAUNCHES))
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
                          scenario=het_scenario(), rng_backend=full["eng"].rng_backend,
                          device=device)

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
    """Wrap the engine's ``_telemetry_gauges``: each round, keep device
    copies of its inputs and the gauges it returned (no host read, so the
    device engine's sync guard stays quiet)."""
    inner = eng._telemetry_gauges

    def wrapped(t, w, **kw):
        gauges = inner(t, w, **kw)
        record.append(dict({k: kw[k].clone() for k in ("z_tx", "z_srv", "fresh")},
                           w=w.clone(), gauges=gauges))
        return gauges

    eng._telemetry_gauges = wrapped


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
                                    for k in ("w", "z_tx", "z_srv", "fresh"))
        n = max(part.sum(), 1.0)
        want = dict(teacher_entropy_pre=entropy(np.tensordot(part, z_srv, 1) / n),
                    teacher_entropy_post=entropy(fresh), beta=BETA,
                    codec_quant_error=float(np.sum(np.abs(z_srv - z_tx) * part[:, None, None])
                                            / max(n * z_srv[0].size, 1.0)))
        for f, w in want.items():
            worst[f] = max(worst[f], abs(float(rec["gauges"][f]) - w))
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
        check_launches(r["launches"], dict(path_launches(fused, telemetry),
                                           threefry=0 if stragglers else EXPIRY_LAUNCHES))
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
# phase 4i: the active-set engine
# ---------------------------------------------------------------------------

def active_scenario():
    """Phase 4i (a)'s partial participation: bernoulli draws, a total
    outage, a round of one participant, and stragglers that come back."""
    from repro_torch.fl import Outage, Scenario, bernoulli_participation

    K = SLICE["n_clients"]
    outages = (tuple(Outage(k, ACTIVE_OUTAGE_ROUND, ACTIVE_OUTAGE_ROUND) for k in range(K))
               + tuple(Outage(k, ACTIVE_SINGLE_ROUND, ACTIVE_SINGLE_ROUND) for k in range(1, K))
               + tuple(Outage(k, 2, 3) for k in ACTIVE_STRAGGLERS))
    return Scenario(participation=bernoulli_participation(ACTIVE_PARTICIPATION), outages=outages)


def record_stacks(sizes: list):
    """A run_engine hook: each gathered round's stack size (one cohort)."""
    def hook(eng):
        plan = eng._gather_plan

        def recorded(part):
            out = plan(part)
            sizes.append(sum(len(pad) for _, _, pad in out))
            return out

        eng._gather_plan = recorded
    return hook


# the active round's host-side parts, timed by ``time_parts``: the engine's
# methods, and the store's scatter
ACTIVE_PARTS = ("_draw_round", "_gather_plan", "_build_step_args", "_bookkeeping_step",
                "_client_step", "scatter", "_eval")


def time_parts(eng) -> dict:
    """Wrap each of ACTIVE_PARTS (on the engine, ``scatter`` on its store)
    with the host clock; returns {part: seconds so far}.  No synchronise:
    inside the guarded steps one would raise, so the two steps' share is
    their issue time and the card's work shows up where the round's
    read-back waits for it."""
    spent = dict.fromkeys(ACTIVE_PARTS, 0.0)
    for name in ACTIVE_PARTS:
        owner = eng.store if name == "scatter" else eng
        fn = getattr(owner, name)

        def timed(*a, _fn=fn, _name=name, **k):
            t0 = time.perf_counter()
            try:
                return _fn(*a, **k)
            finally:
                spent[_name] += time.perf_counter() - t0

        setattr(owner, name, timed)
    return spent


def parts_line(spent: dict, total_s: float, rounds: int) -> str:
    """ms a round of each part, and the rest of the leg (the read-back's
    wait for the card, the ledger, last_sync)."""
    rest = total_s - sum(spent.values())
    return ", ".join(f"{k.strip('_')} {v / rounds * 1e3:.3f}" for k, v in spent.items()) + \
        f", rest (the read-back's wait for the card, the ledger) {rest / rounds * 1e3:.3f}"


def _equal(a, b) -> bool:
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b.to(a.device))
    return np.array_equal(np.asarray(a), np.asarray(b))


def hold_active(label: str, act: dict, ref: dict, ledger_rtol: float,
                acc_atol: float = ACTIVE_ACC_ATOL, param_atol: float = ACTIVE_PARAM_ATOL) -> None:
    """A run against another engine's (the active engine's, phase 4i; the
    async engine's, 4j): the per-round ledger (equal when ``ledger_rtol``
    is 0), cache timestamps and presence equal, values to QUANT_STEP_ATOL;
    accuracies to ``acc_atol``, the server's parameters to ``param_atol``,
    ``last_sync`` equal."""
    compare_runs(label, act, ref, ledger_rtol, QUANT_STEP_ATOL)
    acc = float(np.max(np.abs(np.array(act["accs"]) - np.array(ref["accs"]))))
    sp = max(float((act["eng"].server_params[k] - v).abs().max())
             for k, v in ref["eng"].server_params.items())
    cv = float((act["eng"].cache_g.values - ref["eng"].cache_g.values).abs().max())
    sync = np.array_equal(act["eng"].last_sync, ref["eng"].last_sync)
    log(f"{label}: accuracies max_abs_err={acc!r} (atol {acc_atol}); server params "
        f"max_abs_err={sp!r} (atol {param_atol}); last_sync equal={sync}; bit for bit="
        f"{acc == sp == cv == 0.0}")
    if not (acc <= acc_atol and sp <= param_atol and sync):
        raise AssertionError(f"{label}: runs differ")


def run_active_slice(device, card: str) -> dict:
    """Phase 4i (a): the active engine at the slice's population, per-op and
    fused, against the device engine and the host loop, under partial
    participation (telemetry on for the per-op pair) and full
    participation; launch counts a run; the store's initial parameters
    against the dense engine's, bit for bit."""
    from repro_torch.obs.device import EXACT_FIELDS

    n_out = 1  # ACTIVE_OUTAGE_ROUND
    runs, sizes = {}, []
    for scen in ("partial", "full"):
        scenario = active_scenario if scen == "partial" else (lambda: None)
        active_rounds = SLICE_ROUNDS - (n_out if scen == "partial" else 0)
        for fused in (False, True):
            tel = scen == "partial" and not fused
            kw = dict(fused=fused, codec=CODEC, cache_duration=CACHE_DURATION, beta=BETA,
                      telemetry=tel)
            path = "fused" if fused else "per-op"
            parts = {}

            def hook(eng, parts=parts):
                record_stacks(sizes)(eng)
                parts.update(spent=time_parts(eng), t0=time.perf_counter())

            act = run_engine(device, f"active {path} {scen}", "scarlet", "active",
                             scenario=scenario(), hook=hook, **kw)
            total = time.perf_counter() - parts["t0"]
            log(f"active {path} {scen}: ms a round by part over the run's {SLICE_ROUNDS} "
                f"rounds and 2 evals: {parts_line(parts['spent'], total, SLICE_ROUNDS)}")
            dev = run_engine(device, f"device engine {path} {scen}", "scarlet", "scan",
                             scenario=scenario(), **kw)
            check_launches(act["launches"], {"fused_round": active_rounds} if fused else
                           {"enhanced_era_fused": active_rounds,
                            "quantize_dequantize": active_rounds})
            hold_active(f"active {path} vs device engine {path} ({scen})", act, dev, 0.0)
            if tel:
                same = {f: np.array_equal(act["telemetry"][f], dev["telemetry"][f])
                        for f in EXACT_FIELDS}
                log(f"active per-op vs device engine per-op ({scen}): telemetry exact fields "
                    f"equal {same}")
                if not all(same.values()):
                    raise AssertionError("active telemetry counters differ from the device "
                                         "engine's")
            runs[(scen, path)] = act
            runs[(scen, "device " + path)] = dev
        host = run_engine(device, f"host loop {scen}", "scarlet", "host", codec=CODEC,
                          cache_duration=CACHE_DURATION, beta=BETA, scenario=scenario())
        for path in ("per-op", "fused"):
            hold_active(f"active {path} vs host loop ({scen})", runs[(scen, path)], host, 1e-7)
        ledger = runs[(scen, "per-op")]["ledger"]
        if scen == "partial" and (ledger[ACTIVE_OUTAGE_ROUND - 1].uplink,
                                  ledger[ACTIVE_OUTAGE_ROUND - 1].downlink) != (0.0, 0.0):
            raise AssertionError("the total-outage round was charged")
    if 1 not in sizes or 128 not in sizes:
        raise AssertionError(f"phase 4i (a) did not reach stacks of 1 and 128: {sorted(set(sizes))}")

    from repro_torch.fl import (ActiveSetFederatedDistillation, FLConfig,
                                ScannedFederatedDistillation, STRATEGIES)

    cfg = FLConfig(**SLICE, rounds=SLICE_ROUNDS, uplink_codec=CODEC)
    dense = ScannedFederatedDistillation(cfg, STRATEGIES["scarlet"](beta=BETA), device=device)
    store = ActiveSetFederatedDistillation(cfg, STRATEGIES["scarlet"](beta=BETA), device=device)
    same = all(np.array_equal(store.client_params[0][k], v.cpu().numpy())
               for k, v in dense.client_params[0].items()) and all(
        torch.equal(store.server_params[k], v) for k, v in dense.server_params.items())
    log(f"active store: initial parameters equal the dense engine's bit for bit={same} "
        f"({store.store.nbytes} bytes on the host for {SLICE['n_clients']} clients)")
    if not same:
        raise AssertionError("the store's initial parameters differ from the dense engine's")
    log(f"phase 4i (a): gathered stack sizes {sorted(set(sizes))}; ms/round "
        + ", ".join(f"{k[1]} {k[0]} {v['per_round_ms']:.3f}" for k, v in runs.items())
        + f" ({card})")
    return dict(runs=runs, sizes=sorted(set(sizes)))


def active_weights(K: int, n: int, device) -> torch.Tensor:
    """The SCARLET strategy's weights over a gathered stack of ``K`` rows
    whose first ``n`` take part: ``pv * (K / n)``, float32."""
    pv = torch.zeros(K, device=device)
    pv[:n] = 1.0
    return pv * (torch.full((), float(K), device=device) / pv.sum())


def check_active_kernels(device, sizes: list, card: str) -> dict:
    """Phase 4i (b): the ERA, qdq and fused-round kernels at every gathered
    stack size of (a) and (c), 1 included, as the active engine calls them
    (padding rows at weight 0), against their plain versions; one shape
    of each timed."""
    from repro_torch.kernels import era_kernel, quant_kernel, round_kernel

    rng = np.random.default_rng(14)
    m, N = SLICE["public_per_round"], SLICE["n_classes"]
    shapes = [(k, m, N) for k in sorted(set(sizes) | {1})]
    shapes.append((ACTIVE_M, ACTIVE_BENCH["public_per_round"], ACTIVE_BENCH["n_classes"]))
    errs = {"era": 0.0, "qdq": 0.0, "round": 0.0}
    for K, mm, n in shapes:
        for n_part in sorted({K // 2 + 1, K}):
            z, base = _probs(rng, (K, mm, n), device), _probs(rng, (mm, n), device)
            w = active_weights(K, n_part, device)
            zw = z * w[:, None, None]
            r = (z - base)[..., :-1]
            pairs = (("era", era_kernel.enhanced_era_fused(zw, BETA),
                      era_kernel.enhanced_era_fused_plain(zw, BETA), ERA_ATOL),
                     ("qdq", quant_kernel.quantize_dequantize(r, 8),
                      quant_kernel.quantize_dequantize_plain(r, 8), QDQ_ATOL),
                     ("round", round_kernel.fused_round(z, w, BETA, base, mode="delta", bits=8),
                      round_kernel.fused_round_plain(z, w, BETA, base, mode="delta", bits=8),
                      ROUND_ATOL))
            _sync(device)
            for name, got, want, atol in pairs:
                err = float((got - want).abs().max())
                flips = _level_flips(got, want, r, 8) if name == "qdq" else 0
                if not (bool(torch.isfinite(got).all()) and err <= atol and flips == 0):
                    raise AssertionError(f"active {name} at ({K},{mm},{n}) with {n_part} "
                                         f"participants: max_abs_err {err} > {atol} or "
                                         f"{flips} level flips")
                errs[name] = max(errs[name], err)
    log(f"phase 4i (b): ERA, qdq (residual view, 8 bits) and fused_round (delta+quant8) at "
        f"the gathered stacks {shapes}, half and all rows taking part: max_abs_err "
        f"{errs} (atol ERA {ERA_ATOL}, qdq {QDQ_ATOL}, round {ROUND_ATOL}) ok")

    times = {}
    K = ACTIVE_M
    z, base = _probs(rng, (K, m, N), device), _probs(rng, (m, N), device)
    w = active_weights(K, K // 2 + 1, device)
    zw, r = z * w[:, None, None], (z - base)[..., :-1]
    zb = _probs(rng, (K, ACTIVE_BENCH["public_per_round"], ACTIVE_BENCH["n_classes"]), device)
    wb = active_weights(K, K, device)
    zbw = zb * wb[:, None, None]
    n_in, n_b = K * m * N, zb.numel()
    for name, shape, fn, plain, nbytes, nops in (
            ("enhanced_era_fused", (K, m, N), lambda: era_kernel.enhanced_era_fused(zw, BETA),
             lambda: era_kernel.enhanced_era_fused_plain(zw, BETA),
             4.0 * (n_in + m * N), n_in + 9.0 * m * N),
            ("enhanced_era_fused", tuple(zb.shape),
             lambda: era_kernel.enhanced_era_fused(zbw, BETA),
             lambda: era_kernel.enhanced_era_fused_plain(zbw, BETA),
             4.0 * (n_b + n_b // K), n_b + 9.0 * n_b // K),
            ("quantize_dequantize", tuple(r.shape), lambda: quant_kernel.quantize_dequantize(r, 8),
             lambda: quant_kernel.quantize_dequantize_plain(r, 8), 4.0 * 2 * r.numel(),
             11.0 * r.numel()),
            ("fused_round", (K, m, N),
             lambda: round_kernel.fused_round(z, w, BETA, base, mode="delta", bits=8),
             lambda: round_kernel.fused_round_plain(z, w, BETA, base, mode="delta", bits=8),
             4.0 * (n_in + K + 2 * m * N), 20.0 * n_in + 9.0 * m * N)):
        b, why = bound_ms(nbytes, nops)
        ms, pms = cuda_ms(fn), cuda_ms(plain)
        times[(name, shape)] = (ms, pms, b)
        log(f"time active {name} {shape}: ms={ms!r} plain_ms={pms!r} bound_ms={b!r} by {why} "
            f"({card})")
    return dict(errs=errs, times=times)


def run_active_million(device, card: str) -> dict:
    """Phase 4i (c): the reference's million-client configuration at each K
    of ACTIVE_KS on each stream of ACTIVE_STREAMS: setup, one warm-up
    round, ACTIVE_TIMED timed rounds (the leg-end eval pass over all K
    clients timed apart), the store's bytes and the device's peak against
    its allocation before the engine."""
    import gc
    import tempfile

    from repro_torch.fl import (ActiveSetFederatedDistillation, FLConfig, STRATEGIES, Scenario,
                                fixed_fraction)
    from repro_torch.kernels import ops

    out = {}
    for backend, K in [(b, K) for b in ACTIVE_STREAMS for K in ACTIVE_KS]:
        memmap = K >= ACTIVE_MEMMAP_FROM
        cfg = FLConfig(n_clients=K, rounds=ACTIVE_TIMED + 1, private_size=2 * K, **ACTIVE_BENCH)
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        with tempfile.TemporaryDirectory() as d:
            t0 = time.perf_counter()
            eng = ActiveSetFederatedDistillation(
                cfg, STRATEGIES["scarlet"](beta=BETA), cache_duration=ACTIVE_BENCH_CACHE,
                scenario=Scenario(participation=fixed_fraction(ACTIVE_M / K)),
                store_backing="memmap" if memmap else "ram", store_dir=d if memmap else None,
                rng_backend=backend, device=device)
            setup = time.perf_counter() - t0
            sizes, shapes, eval_s = [], [], []
            record_stacks(sizes)(eng)
            era = ops.enhanced_era_fused

            def era_recorded(z, beta):
                shapes.append(tuple(z.shape))
                return era(z, beta)

            ev = eng._eval

            def eval_timed(t, hist):
                t1 = time.perf_counter()
                ev(t, hist)
                eval_s.append(time.perf_counter() - t1)

            eng._eval = eval_timed
            ops.enhanced_era_fused = era_recorded
            try:
                eng.run(1)
                spent = time_parts(eng)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                ops.reset_launches()
                t0 = time.perf_counter()
                hist = eng.run(ACTIVE_TIMED)
                torch.cuda.synchronize()
                leg = time.perf_counter() - t0
            finally:
                ops.enhanced_era_fused = era
            launches = ops.launches()
            peak = torch.cuda.max_memory_allocated()
            store_bytes = eng.store.nbytes
            ledger = [(r.uplink, r.downlink) for r in hist.ledger.rounds]
            ms = (leg - eval_s[-1]) / ACTIVE_TIMED * 1e3
            del eng
            gc.collect()
        log(f"active K={K} {backend} stream ({'memmap' if memmap else 'ram'} store, {ACTIVE_M} "
            f"a round): setup "
            f"{setup:.3f} s; {ms:.3f} ms/round over {ACTIVE_TIMED} rounds (host clock, the "
            f"leg-end eval apart); leg-end eval over all {K} clients {eval_s[-1]:.3f} s; store "
            f"{store_bytes} bytes ({store_bytes / K:.1f} a client); device peak "
            f"{peak - before} bytes above the {before} allocated before the engine "
            f"(max_memory_allocated {peak}); ledger {ledger}; ERA shapes {shapes[-ACTIVE_TIMED:]}; "
            f"launches {launches}; accuracies {hist.final_server_acc!r} "
            f"{hist.final_client_acc!r} ({card})")
        log(f"active K={K} {backend}: ms a round by part over {ACTIVE_TIMED} rounds (eval: "
            f"the leg-end pass over {ACTIVE_TIMED}): {parts_line(spent, leg, ACTIVE_TIMED)} ({card})")
        era_shape = (ACTIVE_M, ACTIVE_BENCH["public_per_round"], ACTIVE_BENCH["n_classes"])
        if not (len(ledger) == ACTIVE_TIMED and all(u > 0 and dn > 0 for u, dn in ledger)):
            raise AssertionError(f"active K={K}: the ledger is not {ACTIVE_TIMED} positive rows")
        if shapes[-ACTIVE_TIMED:] != [era_shape] * ACTIVE_TIMED or sizes[-ACTIVE_TIMED:] != \
                [ACTIVE_M] * ACTIVE_TIMED:
            raise AssertionError(f"active K={K}: ERA did not run once a round at {era_shape}")
        draws = (0 if backend == "numpy" else
                 3 + choice_launches(cfg.public_size) + choice_launches(K)) * ACTIVE_TIMED
        check_launches(launches, {"enhanced_era_fused": ACTIVE_TIMED, "threefry": draws})
        if not (np.isfinite(hist.final_server_acc) and np.isfinite(hist.final_client_acc)):
            raise AssertionError(f"active K={K}: accuracies not finite")
        out[backend, K] = dict(ms=ms, eval_s=eval_s[-1], setup_s=setup,
                               store_bytes=store_bytes, peak=peak - before)
    lo, hi = ACTIVE_KS
    for backend in ACTIVE_STREAMS:
        a, b = out[backend, lo]["peak"], out[backend, hi]["peak"]
        per_client = (b - a) / (hi - lo)
        log(f"active device peak, {backend} stream: {b} bytes at K={hi} against {a} at "
            f"K={lo}: {per_client!r} bytes a client (limit {ACTIVE_PEAK_PER_CLIENT}) ({card})")
        if per_client >= ACTIVE_PEAK_PER_CLIENT:
            raise AssertionError(f"the active engine's device memory grows with the "
                                 f"population on the {backend} stream")
        out["peak_per_client", backend] = per_client
    return out


def choice_launches(n: int) -> int:
    """Threefry launches of ``prng.choice`` over n items for one key: a
    split and the sort bits a sort round, or, by selection from
    SELECT_MIN_N items, a split and two passes over the chunks a round."""
    from repro_torch.core import prng

    rounds = prng.shuffle_rounds(n)
    if n < prng.SELECT_MIN_N:
        return 2 * rounds
    return rounds * (1 + 2 * -(-n // prng.SELECT_CHUNK))


def run_active_restore(device, card: str, uninterrupted: dict) -> None:
    """Phase 4i (d): (a)'s partial-participation active run split by a
    checkpoint after ACTIVE_RESTORE_AT rounds, restored into a fresh engine:
    ledger and state bit for bit."""
    import tempfile

    from repro_torch.checkpoint import load_pytree, save_pytree
    from repro_torch.checkpoint.io import _flatten, _key
    from repro_torch.fl import ActiveSetFederatedDistillation, STRATEGIES

    full = uninterrupted

    def make():
        return ActiveSetFederatedDistillation(full["eng"].cfg, STRATEGIES["scarlet"](beta=BETA),
                                              cache_duration=CACHE_DURATION,
                                              scenario=active_scenario(),
                                              rng_backend=full["eng"].rng_backend, device=device)

    first = make()
    h1 = first.run(ACTIVE_RESTORE_AT)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "engine.npz")
        save_pytree(path, first.state_dict())
        size = os.path.getsize(path)
        restored = make()
        restored.load_state_dict(load_pytree(path, restored.state_dict()))
    h2 = restored.run(SLICE_ROUNDS - ACTIVE_RESTORE_AT)
    ledger = [(r.uplink, r.downlink) for r in h1.ledger.rounds + h2.ledger.rounds]
    want = [(r.uplink, r.downlink) for r in full["ledger"]]
    a = {_key(k): v for k, v in _flatten(restored.state_dict())}
    b = {_key(k): v for k, v in _flatten(full["eng"].state_dict())}
    differ = [k for k in b if k not in a or not _equal(a[k], b[k])]
    log(f"restore active: {ACTIVE_RESTORE_AT} rounds, checkpoint {size} bytes, "
        f"{SLICE_ROUNDS - ACTIVE_RESTORE_AT} more rounds: ledger equal={ledger == want}; "
        f"{len(b)} state leaves, {len(differ)} differ from the uninterrupted run {differ[:5]} "
        f"({card})")
    if ledger != want or differ or a.keys() != b.keys():
        raise AssertionError("restore active: the split run differs")


def run_active(device, card: str) -> dict:
    """Phase 4i: (a), (b) at the stacks (a) and (c) reached, (c), (d)."""
    t0 = time.perf_counter()
    sl = run_active_slice(device, card)
    million = run_active_million(device, card)
    kern = check_active_kernels(device, sl["sizes"] + [ACTIVE_M], card)
    run_active_restore(device, card, sl["runs"][("partial", "per-op")])
    log(f"phase 4i: {time.perf_counter() - t0:.3f} s ({card})")
    return dict(slice=sl, million=million, kernels=kern)


# ---------------------------------------------------------------------------
# phase 4j: the async engine
# ---------------------------------------------------------------------------

def async_traffic(kind: str):
    """``default``: the synchronous model; ``wide``: ASYNC_WIDE_TICKS of
    latency at ASYNC_WINDOW ticks a window (every delay floors to 0);
    ``async``: (b)'s Poisson arrivals, latency and churn."""
    from repro_torch.fl import ArrivalProcess, ChurnEvent, LatencyModel, TrafficModel

    if kind == "default":
        return TrafficModel()
    if kind == "wide":
        return TrafficModel(latency=LatencyModel("uniform", lo=ASYNC_WIDE_TICKS[0],
                                                 hi=ASYNC_WIDE_TICKS[1]),
                            window_ticks=ASYNC_WINDOW, seed=ASYNC_SEED)
    churn = (tuple(ChurnEvent(k, join=ASYNC_JOIN) for k in ASYNC_JOINERS)
             + tuple(ChurnEvent(k, join=1, leave=ASYNC_LEAVE) for k in ASYNC_LEAVERS))
    return TrafficModel(arrivals=ArrivalProcess("poisson", rate=ASYNC_RATE),
                        latency=LatencyModel("uniform", lo=0, hi=ASYNC_MAX_DELAY),
                        churn=churn, seed=ASYNC_SEED)


def record_async(rec: dict):
    """A run_engine hook: each leg's flight plan, and each round's inputs to
    the flight bookkeeping (the pre-round cache's timestamps and presence,
    the arrivals' weights: device tensors, read after the run)."""
    def hook(eng):
        plan_flight, books = eng.plan_flight, eng._flight_books

        def planned(T, draws=None):
            plan = plan_flight(T, draws)
            rec.setdefault("plans", []).append(plan)
            return plan

        def booked(cache, last_sync, dispatch, arrive, t):
            out = books(cache, last_sync, dispatch, arrive, t)
            rec.setdefault("rounds", []).append(dict(t=t, ts=cache.ts, present=cache.present,
                                                     w=out["w"]))
            return out

        eng.plan_flight, eng._flight_books = planned, booked
    return hook


def run_async_engine(device, label: str, kind: str, fused: bool, decay: float = 1.0,
                     telemetry: bool = False) -> dict:
    """SCARLET at the slice's population through ``engine="async"`` under
    ``async_traffic(kind)``; the run's merged flight plan and per-round
    records under ``plan`` and ``rec``."""
    rec = {}
    r = run_engine(device, label, "scarlet", "async", fused=fused, codec=CODEC,
                   cache_duration=CACHE_DURATION, telemetry=telemetry,
                   engine_kw=dict(traffic=async_traffic(kind)), hook=record_async(rec),
                   beta=BETA, staleness_decay=decay)
    plans = rec["plans"]
    r["plan"] = {f: np.concatenate([getattr(p, f) for p in plans])
                 for f in ("dispatch", "arrive", "delay", "available", "idx")}
    r["rec"] = rec["rounds"]
    return r


def arrival_rounds(r: dict) -> int:
    return int(r["plan"]["arrive"].any(axis=1).sum())


def check_async_ledger(r: dict) -> dict:
    """(b): a host replay of the run from its planned dispatch masks, the
    traffic's delays and availability (compiled anew) and its recorded
    pre-round caches: no dispatch of a blocked client, the arrivals, each
    round's bytes by the reference's rule in float64 and the staleness
    histogram.  Returns the counts the log reports."""
    from repro_torch.obs.device import STALENESS_BUCKETS

    eng = r["eng"]
    cfg = eng.cfg
    K, m, N, D, ib = (cfg.n_clients, cfg.public_per_round, cfg.n_classes, CACHE_DURATION,
                      cfg.index_bytes)
    T = len(r["ledger"])
    traffic = async_traffic("async").compile(T, K)
    plan, hist = r["plan"], r["telemetry"]["staleness_hist"]
    busy, due = np.zeros(K, bool), np.zeros(K, np.int64)
    ls, fn, sent = np.zeros(K, np.int64), np.zeros(K, np.float64), np.zeros(K, np.int64)
    entry = N * 4.0 + 8.0  # a catch-up entry: values, index, timestamp
    exact = late = 0
    requests = []
    for i, t in enumerate(range(1, T + 1)):
        d, a = plan["dispatch"][i], plan["arrive"][i]
        if (d & busy).any() or (d & ~traffic.available[i]).any():
            raise AssertionError(f"{r['label']} round {t}: a blocked client was dispatched")
        arrive = (busy & (due == t)) | (d & (traffic.delay[i] == 0))
        if not np.array_equal(arrive, a):
            raise AssertionError(f"{r['label']} round {t}: arrivals differ from the replay")
        ts = r["rec"][i]["ts"].cpu().numpy().astype(np.int64)
        present = r["rec"][i]["present"].cpu().numpy()
        idx = plan["idx"][i]
        n_req = int((~(present[idx] & (t - ts[idx] <= D))).sum())
        requests.append(n_req)
        ls_mid = np.where(d, t - 1, ls)

        def charge(sync, who):
            back = np.nonzero(who & (sync < t - 1))[0]
            return float(sum((present & (ts > sync[k])).sum() for k in back)) * entry

        disp, arr = charge(ls, d), charge(ls_mid, a)
        fn[d] = n_req
        n_arr = int(a.sum())
        if n_arr:
            n_up = fn[a].sum() / n_arr
            want = (n_arr * (n_up * (N - 1) * 8 / 8.0),
                    n_arr * (n_req * N * 4.0 + n_req * ib + m * ib + m * 0.25) + disp + arr)
        else:
            want = (0.0, disp if d.any() else 0.0)
        got = (r["ledger"][i].uplink, r["ledger"][i].downlink)
        if got == want:
            exact += 1
        elif not np.allclose(got, want, rtol=ASYNC_LEDGER_RTOL, atol=0):
            raise AssertionError(f"{r['label']} round {t}: ledger {got}, the reference's rule "
                                 f"gives {want} ({n_arr} arrivals, {n_req} requests)")
        row = np.zeros(STALENESS_BUCKETS, np.int64)
        for k in np.nonzero(a)[0]:
            lag = t - 1 - ls[k]
            if not d[k]:  # a report that was in flight: the lag is its delay
                late += 1
                if lag != t - sent[k]:
                    raise AssertionError(f"{r['label']} round {t}: client {k}'s lag {lag} is "
                                         f"not its delay {t - sent[k]}")
            row[min(lag, STALENESS_BUCKETS - 1)] += 1
        if not np.array_equal(hist[i], row):
            raise AssertionError(f"{r['label']} round {t}: staleness histogram {hist[i]}, "
                                 f"the replay gives {row}")
        busy = (busy & ~a) | (d & (traffic.delay[i] > 0))
        due = np.where(d, t + traffic.delay[i], due)
        sent = np.where(d, t, sent)
        ls = np.where(a, t, ls_mid)
    if not np.array_equal(ls, eng.last_sync):
        raise AssertionError(f"{r['label']}: last_sync differs from the replay")
    return dict(exact=exact, late=late, requests=requests,
                dispatched=int(plan["dispatch"].sum()), arrived=int(plan["arrive"].sum()),
                arrival_rounds=arrival_rounds(r))


def check_async_kernels(device, runs: list, card: str) -> dict:
    """(c): the ERA, qdq and fused-round kernels at the weights the decayed
    runs of (b) aggregated with, ``w * K / sum w`` for ``w`` an arrival
    mask times ``decay ** staleness`` (the SCARLET strategy's
    ``_participant_weights``), against their plain versions; one weight
    vector of each run timed."""
    from repro_torch.fl.strategies.scarlet import _participant_weights
    from repro_torch.kernels import era_kernel, quant_kernel, round_kernel

    rng = np.random.default_rng(29)
    K, m, N = SLICE["n_clients"], SLICE["public_per_round"], SLICE["n_classes"]
    weights = []
    for r in runs:
        for rd in r["rec"]:
            w = rd["w"]
            wh = w.cpu().numpy()
            if wh.any() and not np.isin(wh, (0.0, 1.0)).all():  # a fractional round
                weights.append((r["label"], rd["t"], _participant_weights(w)))
    if not weights:
        raise AssertionError("phase 4j (c): no round of (b) aggregated fractional weights")
    errs = {"era": 0.0, "qdq": 0.0, "round": 0.0, "round_linear": 0.0}
    for label, t, pw in weights:
        z, base = _probs(rng, (K, m, N), device), _probs(rng, (m, N), device)
        zw, res = z * pw[:, None, None], (z - base)[..., :-1]
        wsum = float(pw.abs().sum())
        cases = (("era", era_kernel.enhanced_era_fused(zw, BETA),
                  era_kernel.enhanced_era_fused_plain(zw, BETA), ERA_ATOL),
                 ("qdq", quant_kernel.quantize_dequantize(res, 8),
                  quant_kernel.quantize_dequantize_plain(res, 8), QDQ_ATOL),
                 ("round", round_kernel.fused_round(z, pw, BETA, base, mode="delta", bits=8),
                  round_kernel.fused_round_plain(z, pw, BETA, base, mode="delta", bits=8),
                  ROUND_ATOL),
                 ("round_linear",
                  round_kernel.fused_round(z, pw, None, base, mode="delta", bits=8,
                                           sharpen=False),
                  round_kernel.fused_round_plain(z, pw, None, base, mode="delta", bits=8,
                                                 sharpen=False),
                  ROUND_LINEAR_RTOL * wsum))
        _sync(device)
        for name, got, want, atol in cases:
            err = float((got - want).abs().max())
            flips = _level_flips(got, want, res, 8) if name == "qdq" else 0
            if not (bool(torch.isfinite(got).all()) and err <= atol and flips == 0):
                raise AssertionError(f"phase 4j (c) {name} at {label} round {t}'s weights: "
                                     f"max_abs_err {err} > {atol} or {flips} level flips")
            errs[name] = max(errs[name], err)
    distinct = sorted({round(float(v), 6) for _, _, pw in weights for v in pw.cpu().numpy()})
    log(f"phase 4j (c): ERA, qdq (residual view, 8 bits) and fused_round (delta+quant8) at "
        f"{len(weights)} rounds' staleness weights (K/sum w times decay^s; distinct values "
        f"{distinct[:12]}{' ...' if len(distinct) > 12 else ''}): max_abs_err {errs} (atol ERA "
        f"{ERA_ATOL}, qdq {QDQ_ATOL}, round {ROUND_ATOL}, linear {ROUND_LINEAR_RTOL} x sum|w|) ok")
    _, _, pw = weights[0]
    z, base = _probs(rng, (K, m, N), device), _probs(rng, (m, N), device)
    zw, res = z * pw[:, None, None], (z - base)[..., :-1]
    n_in = K * m * N
    times = {}
    for name, shape, fn, plain, nbytes, nops in (
            ("enhanced_era_fused", tuple(zw.shape),
             lambda: era_kernel.enhanced_era_fused(zw, BETA),
             lambda: era_kernel.enhanced_era_fused_plain(zw, BETA),
             4.0 * (n_in + m * N), n_in + 9.0 * m * N),
            ("quantize_dequantize", tuple(res.shape),
             lambda: quant_kernel.quantize_dequantize(res, 8),
             lambda: quant_kernel.quantize_dequantize_plain(res, 8), 4.0 * 2 * res.numel(),
             11.0 * res.numel()),
            ("fused_round", tuple(z.shape),
             lambda: round_kernel.fused_round(z, pw, BETA, base, mode="delta", bits=8),
             lambda: round_kernel.fused_round_plain(z, pw, BETA, base, mode="delta", bits=8),
             4.0 * (n_in + K + 2 * m * N), 20.0 * n_in + 9.0 * m * N)):
        b, why = bound_ms(nbytes, nops)
        ms, pms = cuda_ms(fn), cuda_ms(plain)
        times[name] = (ms, pms, b)
        log(f"time async {name} {shape} at staleness weights: ms={ms!r} "
            f"plain_ms={pms!r} bound_ms={b!r} by {why} ({card})")
    return dict(errs=errs, times=times, n_weights=len(weights))


def run_async_restore(device, card: str, full: dict) -> None:
    """(d): (b)'s per-op decayed run split by a checkpoint after
    ASYNC_RESTORE_AT rounds, with reports in flight, restored into a fresh
    engine through the npz format: leaves and ledger bit for bit."""
    import tempfile

    from repro_torch.checkpoint import load_pytree, save_pytree
    from repro_torch.fl import AsyncFederatedDistillation, STRATEGIES

    def make():
        return AsyncFederatedDistillation(
            full["eng"].cfg, STRATEGIES["scarlet"](beta=BETA, staleness_decay=ASYNC_DECAY),
            cache_duration=CACHE_DURATION, traffic=async_traffic("async"),
            rng_backend=full["eng"].rng_backend, device=device)

    first = make()
    h1 = first.run(ASYNC_RESTORE_AT)
    flying = int(first.in_flight.sum())
    if not flying:
        raise AssertionError("phase 4j (d): no report in flight at the checkpoint")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "engine.npz")
        save_pytree(path, first.state_dict())
        size = os.path.getsize(path)
        restored = make()
        restored.load_state_dict(load_pytree(path, restored.state_dict()))
    h2 = restored.run(SLICE_ROUNDS - ASYNC_RESTORE_AT)
    ledger = [(r.uplink, r.downlink) for r in h1.ledger.rounds + h2.ledger.rounds]
    want = [(r.uplink, r.downlink) for r in full["ledger"]]
    a, b = state_leaves(restored), state_leaves(full["eng"])
    differ = [k for k in b if k not in a or not _equal(a[k], b[k])]
    log(f"restore async: {ASYNC_RESTORE_AT} rounds, {flying} reports in flight, checkpoint "
        f"{size} bytes, {SLICE_ROUNDS - ASYNC_RESTORE_AT} more rounds: ledger equal="
        f"{ledger == want}; {len(b)} state leaves, {len(differ)} differ from the uninterrupted "
        f"run {differ[:5]} ({card})")
    if ledger != want or differ or a.keys() != b.keys():
        raise AssertionError("restore async: the split run differs")


def run_async(device, card: str, device_runs: dict) -> dict:
    """Phase 4j: (a) against ``device_runs`` (phase 4b's, by path), (b),
    (c), (d); the analyzer's async pass is (e), in phase 4e."""
    t0 = time.perf_counter()
    runs = {}
    for kind in ("default", "wide"):
        for path, fused in (("per-op", False), ("fused", True)):
            r = run_async_engine(device, f"async {path} {kind}", kind, fused)
            check_launches(r["launches"], {"fused_round": SLICE_ROUNDS} if fused else
                           {"enhanced_era_fused": SLICE_ROUNDS,
                            "quantize_dequantize": SLICE_ROUNDS})
            if not (r["plan"]["arrive"] == r["plan"]["dispatch"]).all():
                raise AssertionError(f"{r['label']}: a report arrived late under zero delay")
            ref = device_runs[path]
            hold_active(f"async {path} {kind} vs device engine {path}", r, ref, 0.0,
                        acc_atol=1.0 / len(ref["eng"].y_test), param_atol=ASYNC_PARAM_ATOL)
            runs[(kind, path)] = r
    ledgers = []
    for decay in (1.0, ASYNC_DECAY):
        for path, fused in (("per-op", False), ("fused", True)):
            r = run_async_engine(device, f"async {path} traffic decay {decay}", "async", fused,
                                 decay=decay, telemetry=True)
            n_arr = arrival_rounds(r)
            check_launches(r["launches"], {"fused_round": n_arr, "quantize_dequantize": n_arr}
                           if fused else {"enhanced_era_fused": n_arr,
                                          "quantize_dequantize": n_arr})
            got = check_async_ledger(r)
            log(f"{r['label']}: {got['dispatched']} dispatches, {got['arrived']} arrivals "
                f"({got['late']} after time in flight) over {got['arrival_rounds']} arrival "
                f"rounds; requests a round {got['requests']}; every round's bytes equal the "
                f"reference's rule recomputed in float64 ({got['exact']} of {SLICE_ROUNDS} "
                f"exactly, the rest to rtol {ASYNC_LEDGER_RTOL}); no blocked client "
                "dispatched; staleness histogram equal to the replay's ok")
            if not got["late"]:
                raise AssertionError(f"{r['label']}: no report arrived late")
            ledgers.append([(x.uplink, x.downlink) for x in r["ledger"]])
            runs[(f"decay {decay}", path)] = r
    same = all(x == ledgers[0] for x in ledgers)
    log(f"phase 4j (b): decay 1.0 and {ASYNC_DECAY}, per-op and fused: the four ledgers "
        f"equal bit for bit={same}")
    if not same:
        raise AssertionError("phase 4j (b): staleness decay or the fused path moved the ledger")
    kern = check_async_kernels(device, [runs[(f"decay {ASYNC_DECAY}", p)]
                                        for p in ("per-op", "fused")], card)
    run_async_restore(device, card, runs[(f"decay {ASYNC_DECAY}", "per-op")])
    log("phase 4j: ms/round (host clock, rounds 2-10, one eval) async "
        + ", ".join(f"{k[1]} {k[0]} {v['per_round_ms']:.3f}" for k, v in runs.items())
        + f"; device engine per-op {device_runs['per-op']['per_round_ms']:.3f}, fused "
        f"{device_runs['fused']['per_round_ms']:.3f} ({card})")
    log(f"phase 4j: {time.perf_counter() - t0:.3f} s ({card})")
    return dict(runs=runs, kernels=kern)


# ---------------------------------------------------------------------------
# phase 4k: the client-sharded engine
# ---------------------------------------------------------------------------

def record_packs(sizes: list):
    """A run_engine hook: the size of every all-reduce the sharded engine
    packs in its rounds (a Python count, no device read)."""
    def hook(eng):
        real = eng._all_reduce

        def packed(*groups):
            sizes.append(sum(v.numel() for g in groups for v in g.values()))
            return real(*groups)

        eng._all_reduce = packed
    return hook


def time_all_reduce(eng, sizes: list) -> dict:
    """Each distinct packed size's all-reduce over the engine's data axis,
    alone: the median of SHARD_TIMED calls, host clock, the card
    synchronized around each."""
    out = {}
    for n in sorted(set(sizes)):
        flat = torch.ones(n, device=eng.device)
        ts = []
        for _ in range(SHARD_TIMED + 2):
            torch.cuda.synchronize(eng.device)
            t0 = time.perf_counter()
            type(eng)._all_reduce(eng, {"x": flat})  # not record_packs' wrapper
            torch.cuda.synchronize(eng.device)
            ts.append(time.perf_counter() - t0)
        out[n] = statistics.median(ts[2:]) * 1e3
    return out


def shard_state(eng) -> dict:
    """The replicated state and the gathered clients, as numpy."""
    st = eng.state_dict()
    leaves = {"last_sync": np.asarray(eng.last_sync)}
    for name, tree in (("cache", st["cache"]._asdict()), ("server", st["server_params"]),
                       ("prev_teacher", {"": st["prev_teacher"]}),
                       ("clients", st["client_params"][0])):
        for k, v in tree.items():
            leaves[f"{name}.{k}"] = v.cpu().numpy()
    return leaves


def run_shard_engine(device, label: str, fused: bool) -> dict:
    """SCARLET at the slice's population through ``engine="shard"`` on the
    process group already started: run_engine's run, the all-reduce sizes
    and times, the device's peak (above what the process held before the
    engine was built), the replicated state."""
    sizes = []
    torch.cuda.reset_peak_memory_stats(device)
    before = torch.cuda.memory_allocated(device)
    r = run_engine(device, label, "scarlet", "shard", fused=fused, codec=CODEC,
                   cache_duration=CACHE_DURATION, hook=record_packs(sizes), beta=BETA)
    r["peak"] = torch.cuda.max_memory_allocated(device) - before
    r["all_reduce_ms"] = time_all_reduce(r["eng"], sizes)
    r["packs"] = sizes
    r["state"] = shard_state(r["eng"])
    check_launches(r["launches"], {"fused_round": SLICE_ROUNDS} if fused
                   else {"quantize_dequantize": SLICE_ROUNDS})
    check_slice_round1(r)
    return r


def warm_cublas(device) -> int:
    """One float32 product and its backward on ``device``: cuBLAS's
    workspaces of this thread and of autograd's device thread, allocated
    once a process.  Returns the bytes they hold."""
    before = torch.cuda.memory_allocated(device)
    a = torch.ones(8, 8, device=device, requires_grad=True)
    (a @ a).sum().backward()
    del a
    torch.cuda.synchronize(device)
    return torch.cuda.memory_allocated(device) - before


def shard_rank(n: int) -> dict:
    """A rank of a gloo world of ``n`` on the card: both paths, as
    numpy and numbers."""
    import torch.distributed as dist

    device = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
    torch.cuda.init()  # a fresh process: the allocator's statistics exist from here
    torch.cuda.set_device(device)
    out = {"workspaces": warm_cublas(device)}
    for path, fused in (("per-op", False), ("fused", True)):
        r = run_shard_engine(device, f"shard n={n} rank {dist.get_rank()} {path} (gloo)",
                             fused)
        out[path] = {k: r[k] for k in ("ledger", "launches", "per_round_ms", "peak",
                                       "all_reduce_ms", "packs", "state", "accs")}
        out[path]["ledger"] = [(x.uplink, x.downlink) for x in r["ledger"]]
    return out


def check_shard_kernels(device, card: str) -> dict:
    """Phase 4k (c): qdq and fused_round (sharpen=False) at the per-rank
    shapes (K/n, m, N) of n = 1 and SHARD_WORLDS, with about 60 % of the
    clients taking part, against their plain versions; each timed."""
    from repro_torch.kernels import quant_kernel, round_kernel

    rng = np.random.default_rng(15)
    K, m, N = SLICE["n_clients"], SLICE["public_per_round"], SLICE["n_classes"]
    errs, times = {"qdq": 0.0, "round_linear": 0.0}, {}
    for n in (1,) + SHARD_WORLDS:
        k = K // n
        z, base = _probs(rng, (k, m, N), device), _probs(rng, (m, N), device)
        w = torch.from_numpy((rng.random(k) < 0.6).astype(np.float32)).to(device)
        r = (z - base)[..., :-1]
        cases = (("qdq", lambda: quant_kernel.quantize_dequantize(r, 8),
                  lambda: quant_kernel.quantize_dequantize_plain(r, 8), QDQ_ATOL,
                  4.0 * 2 * r.numel(), 11.0 * r.numel(), tuple(r.shape)),
                 ("round_linear",
                  lambda: round_kernel.fused_round(z, w, None, base, mode="delta", bits=8,
                                                   sharpen=False),
                  lambda: round_kernel.fused_round_plain(z, w, None, base, mode="delta",
                                                         bits=8, sharpen=False),
                  ROUND_LINEAR_RTOL * max(float(w.sum()), 1.0),
                  4.0 * (k * m * N + k + 2 * m * N), 20.0 * k * m * N, (k, m, N)))
        for name, fn, plain, atol, nbytes, nops, shape in cases:
            got, want = fn(), plain()
            _sync(device)
            err = float((got - want).abs().max())
            flips = _level_flips(got, want, r, 8) if name == "qdq" else 0
            if not (bool(torch.isfinite(got).all()) and err <= atol and flips == 0):
                raise AssertionError(f"phase 4k (c) {name} at {shape}: max_abs_err {err} > "
                                     f"{atol} or {flips} level flips")
            errs[name] = max(errs[name], err)
            b, why = bound_ms(nbytes, nops)
            ms, pms = cuda_ms(fn), cuda_ms(plain)
            times[(name, n)] = dict(ms=ms, plain_ms=pms, bound_ms=b)
            kernel = "quantize_dequantize" if name == "qdq" else "fused_round sharpen=False"
            log(f"time shard n={n} {kernel} {shape}: ms={ms!r} plain_ms={pms!r} "
                f"bound_ms={b!r} by {why} ({card})")
    log(f"phase 4k (c): qdq (residual view, 8 bits) and fused_round (delta+quant8, "
        f"sharpen=False) at the per-rank shapes of n = {(1,) + SHARD_WORLDS}: max_abs_err "
        f"{errs} (atol qdq {QDQ_ATOL}, zero level flips; linear {ROUND_LINEAR_RTOL} x sum w) ok")
    return dict(errs=errs, times=times)


def run_shard(device, card: str, device_runs: dict) -> dict:
    """Phase 4k: (a) against ``device_runs`` (phase 4b's, by path), (b)
    against (a), (c)."""
    import torch.distributed as dist

    import repro_torch.fl as pfl
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_lib

    t0 = time.perf_counter()
    one = {}
    with mesh_lib.world_of_one("nccl"):
        log(f"phase 4k (a): a world of one, backend {dist.get_backend()}")
        for path, fused in (("per-op", False), ("fused", True)):
            r = run_shard_engine(device, f"shard n=1 {path} (nccl)", fused)
            hold_active(f"shard n=1 {path} vs device engine {path}", r, device_runs[path], 0.0)
            one[path] = r
    for path, fused in (("per-op", False), ("fused", True)):
        cfg = pfl.FLConfig(**SLICE, rounds=SLICE_ROUNDS, eval_every=SLICE_ROUNDS,
                           uplink_codec=CODEC, fused_round=fused)
        ops.reset_launches()
        h = pfl.run_method("scarlet", cfg, engine="shard", cache_duration=CACHE_DURATION,
                           beta=BETA, rng_backend="numpy", device=device)
        launches = ops.launches()
        ledger = [(x.uplink, x.downlink) for x in h.ledger.rounds]
        want = [(x.uplink, x.downlink) for x in device_runs[path]["ledger"]]
        log(f"phase 4k (a): run_method(engine='shard') {path}, a world of one it started "
            f"(NCCL) and tore down: launches {launches}; ledger equal to phase 4b's={ledger == want}")
        # the engine's initial parameters are drawn after the count is reset
        check_launches(launches, dict({"fused_round": SLICE_ROUNDS} if fused
                                      else {"quantize_dequantize": SLICE_ROUNDS},
                                      threefry=init_launches(cfg)))
        if ledger != want or dist.is_initialized():
            raise AssertionError(f"phase 4k (a): run_method {path} differs from phase 4b")
    worlds = {}
    for n in SHARD_WORLDS:
        ranks = mesh_lib.run_world(n, shard_rank, n, backend="gloo", threads=None)
        for path in ("per-op", "fused"):
            rs = [r[path] for r in ranks]
            want = [(x.uplink, x.downlink) for x in one[path]["ledger"]]
            same_ledger = all(r["ledger"] == want for r in rs)
            same_state = all(r["state"].keys() == rs[0]["state"].keys() and all(
                np.array_equal(r["state"][k], rs[0]["state"][k]) for k in r["state"])
                for r in rs[1:])
            vs_one = max(float(np.abs(rs[0]["state"][k] - one[path]["state"][k]).max())
                         for k in rs[0]["state"] if rs[0]["state"][k].dtype.kind == "f")
            log(f"phase 4k (b) n={n} {path} (gloo, CUDA tensors): ledger equal to (a)'s on "
                f"every rank={same_ledger}; replicated state and gathered clients equal on "
                f"every rank bit for bit={same_state} (vs (a): max_abs_err {vs_one!r}); "
                f"launches {[r['launches'] for r in rs]}; ms/round "
                f"{[round(r['per_round_ms'], 3) for r in rs]}; device peak per rank "
                f"{[r['peak'] for r in rs]} B (over n=1's "
                f"{max(r['peak'] for r in rs) / one[path]['peak']:.4f}; cuBLAS workspaces "
                f"made before, {[r['workspaces'] for r in ranks]} B); all-reduce ms by "
                f"packed size {rs[0]['all_reduce_ms']} ({card})")
            for r in rs:
                check_launches(r["launches"], {"fused_round": SLICE_ROUNDS} if path == "fused"
                               else {"quantize_dequantize": SLICE_ROUNDS})
            if not (same_ledger and same_state):
                raise AssertionError(f"phase 4k (b) n={n} {path}: ranks differ")
            worlds[(n, path)] = rs
    for path in ("per-op", "fused"):
        ratio = max(r["peak"] for r in worlds[(SHARD_WORLDS[-1], path)]) / one[path]["peak"]
        log(f"phase 4k (b) {path}: device peak per rank at n={SHARD_WORLDS[-1]} over n=1's "
            f"{ratio:.4f} (at most {SHARD_PEAK_RATIO}) ({card})")
        if ratio > SHARD_PEAK_RATIO:
            raise AssertionError(f"phase 4k (b) {path}: a rank's peak at n="
                                 f"{SHARD_WORLDS[-1]} is {ratio:.4f} of n=1's")
    kern = check_shard_kernels(device, card)
    log("phase 4k: ms/round (host clock, rounds 2-10, one eval) shard "
        + ", ".join(f"{p} n=1 {one[p]['per_round_ms']:.3f}" for p in one)
        + ", " + ", ".join(f"{p} n={n} {max(r['per_round_ms'] for r in v):.3f}"
                           for (n, p), v in worlds.items())
        + f"; device engine per-op {device_runs['per-op']['per_round_ms']:.3f}, fused "
        f"{device_runs['fused']['per_round_ms']:.3f}; device peak n=1 "
        + ", ".join(f"{p} {one[p]['peak']}" for p in one)
        + f" B; all-reduce n=1 (nccl) ms by packed size {one['per-op']['all_reduce_ms']} ({card})")
    log(f"phase 4k: {time.perf_counter() - t0:.3f} s ({card})")
    return dict(one=one, worlds=worlds, kernels=kern)


# ---------------------------------------------------------------------------
# phase 4l: the paper's FL launcher (repro_torch.launch.fl_train)
# ---------------------------------------------------------------------------

def _launch(argv: list, out: str) -> dict:
    """``fl_train.main(argv + ["--out", out])``, the launch counts set to 0
    just before and read just after: its JSON history and the counts."""
    from repro_torch.kernels import ops
    from repro_torch.launch import fl_train

    ops.reset_launches()
    t0 = time.perf_counter()
    fl_train.main(argv + ["--out", out])
    secs = time.perf_counter() - t0
    launches = ops.launches()
    method = argv[argv.index("--method") + 1] if "--method" in argv else "scarlet"
    with open(os.path.join(out, f"{method}_a0.05_p1.0_s0.json")) as f:
        return dict(json.load(f), launches=launches, secs=secs, out=out)


def _ledger(h: dict) -> str:
    """A launcher history's per-round ledger fields, as JSON text."""
    return json.dumps([h["history"][k] for k in ("rounds", "cumulative_mb", "comm")])


def _accs(h: dict) -> list:
    return h["history"]["server_acc"] + h["history"]["client_acc"]


@contextmanager
def record_inputs(store: dict):
    """Within the block, each call of ``kernels.ops.enhanced_era_fused`` and
    ``kernels.ops.quantize_dequantize`` (where the strategies and codecs
    reach the kernels) keeps a copy of its first input at each (kernel,
    shape, beta or bits) in ``store``, then calls the kernel."""
    from repro_torch.kernels import ops

    names = ("enhanced_era_fused", "quantize_dequantize")
    kept = {n: getattr(ops, n) for n in names}

    def recording(name, fn):
        def call(z, arg, *a, **kw):
            store.setdefault((name, tuple(z.shape), arg), z.detach().clone())
            return fn(z, arg, *a, **kw)
        return call

    for n in names:
        setattr(ops, n, recording(n, kept[n]))
    try:
        yield store
    finally:
        for n in names:
            setattr(ops, n, kept[n])


def check_launcher_kernels(device, card: str, inputs: dict) -> dict:
    """Phase 4l (a): the ERA and qdq kernels on each input the launcher's
    card runs gave them (``record_inputs``) and on a random stack of the
    same shape, against their plain versions: ERA to ERA_ATOL, qdq to
    QDQ_ATOL with zero level flips; each timed at its shape."""
    from repro_torch.kernels import era_kernel, quant_kernel
    from repro_torch.launch import fl_train

    beta = fl_train.METHOD_DEFAULTS["scarlet"]["beta"]
    got_kernels = {(name, arg) for name, _, arg in inputs}
    if got_kernels != {("enhanced_era_fused", beta), ("quantize_dequantize", 1)}:
        raise AssertionError(f"phase 4l (a): the launcher's runs reached {got_kernels}, not "
                             f"the ERA kernel at beta={beta} and the 1-bit qdq")
    rng = np.random.default_rng(16)
    errs = {"enhanced_era_fused": 0.0, "quantize_dequantize": 0.0}
    for (name, shape, arg), z in inputs.items():
        if name == "enhanced_era_fused":
            fn, plain, atol = (era_kernel.enhanced_era_fused,
                               era_kernel.enhanced_era_fused_plain, ERA_ATOL)
            n_out = z[0].numel()
            # bytes: the stack read once, the teacher written once
            b, why = bound_ms(4.0 * (z.numel() + n_out), z.numel() + 9.0 * n_out)
        else:
            fn, plain, atol = (quant_kernel.quantize_dequantize,
                               quant_kernel.quantize_dequantize_plain, QDQ_ATOL)
            b, why = bound_ms(4.0 * 2 * z.numel(), 11.0 * z.numel())
        for label, x in (("the path's input", z), ("random", _probs(rng, shape, device))):
            got, want = fn(x, arg), plain(x, arg)
            _sync(device)
            err = float((got - want).abs().max())
            flips = _level_flips(got, want, x, arg) if name == "quantize_dequantize" else 0
            if not (bool(torch.isfinite(got).all()) and err <= atol and flips == 0):
                raise AssertionError(f"phase 4l (a) {name} {shape} ({label}): max_abs_err "
                                     f"{err} > {atol} or {flips} level flips")
            errs[name] = max(errs[name], err)
        ms, pms = cuda_ms(lambda: fn(z, arg)), cuda_ms(lambda: plain(z, arg))
        log(f"time launcher {name} {shape} {'beta' if name == 'enhanced_era_fused' else 'bits'}"
            f"={arg}: ms={ms!r} plain_ms={pms!r} bound_ms={b!r} by {why} ({card})")
    log(f"phase 4l (a): the ERA and qdq kernels on the launcher's inputs at "
        f"{sorted((n, s, a) for n, s, a in inputs)} and on random stacks of those shapes: "
        f"max_abs_err {errs} (atol ERA {ERA_ATOL}, qdq {QDQ_ATOL} with zero level flips) ok")
    return errs


def run_launcher(device, card: str) -> dict:
    """Phase 4l: (a) ``fl_train.main`` for LAUNCHER_ROUNDS rounds on the card
    and on the CPU, SCARLET and CFD: the per-round ledger bit for bit,
    accuracies within one test sample (LAUNCHER_FREE_RUN_GATED; each
    method's rounds in lockstep, ``launcher_lockstep``),
    ``enhanced_era_fused`` once a round on SCARLET's path and qdq once a
    round on CFD's, counted on the card's run; each kernel on the inputs the card's run gave it, against its
    plain version (``check_launcher_kernels``).  (b) The launcher at its
    defaults (300 rounds of SCARLET), and again with ``--telemetry``: the
    same ledger, the Chrome trace through ``python -m repro_torch.obs
    validate``.  (c) The launcher's configuration for its 300 rounds
    through the fused device engine (the per-op engine repeats the host
    loop's accuracies) and the async engine under LAUNCHER_TRAFFIC at
    staleness decay LAUNCHER_DECAY: their final accuracies beside (b)'s,
    findings and not gates.  Returns the kernels' worst errors too."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="fl_train_")
    try:
        return _run_launcher(device, card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def launcher_lockstep(device, method: str, rounds: int) -> dict:
    """The launcher's configuration of ``method`` for ``rounds`` rounds on
    the card and on the CPU in lockstep: before each round the CPU engine
    takes the card engine's state (``state_dict`` / ``load_state_dict``,
    the numpy draws replayed), then each runs the round.  Each round must
    give the same ledger entry and accuracies within one test sample: the
    card's computation of a round against the CPU's from the same state.
    Two free-running trajectories are not held to that: at this
    configuration (ReLU MLPs, lr 0.1, Dirichlet 0.05 shards) float
    rounding parts them for some initial realizations (the z of the
    CPU's and the card's clients 1e-3 apart by round 3 from bit-equal
    initial parameters, for the key stream's and for one of five
    ``torch.Generator`` seeds, while the others stay within 3e-6).
    Returns the worst accuracy difference and the rounds compared."""
    from repro_torch.fl import STRATEGIES, FederatedDistillation
    from repro_torch.launch import fl_train

    cfg = fl_train.config_from_args(fl_train.build_parser().parse_args(
        ["--method", method, "--rounds", str(rounds)]))
    kw = dict(fl_train.METHOD_DEFAULTS[method])
    D = kw.pop("cache_duration", 0)
    g, c = (FederatedDistillation(cfg, STRATEGIES[method](**kw), cache_duration=D, device=d)
            for d in (device, "cpu"))
    worst = 0.0
    for t in range(1, rounds + 1):
        c.load_state_dict(g.state_dict())
        hg, hc = g.run(1), c.run(1)
        lg = [(r.uplink, r.downlink) for r in hg.ledger.rounds]
        lc = [(r.uplink, r.downlink) for r in hc.ledger.rounds]
        err = max(abs(a - b) for a, b in zip(hg.server_acc + hg.client_acc,
                                             hc.server_acc + hc.client_acc))
        worst = max(worst, err)
        if lg != lc or err > 1.0 / len(c.y_test) + 1e-6:
            raise AssertionError(f"phase 4l (a) {method} round {t} from the card's state: "
                                 f"ledger {lg} vs {lc}, accuracies {err} apart")
    return dict(worst=worst, rounds=rounds, n_test=len(c.y_test))


def _run_launcher(device, card: str, tmp: str) -> dict:
    from repro_torch.fl import ArrivalProcess, LatencyModel, TrafficModel, run_method
    from repro_torch.launch import fl_train

    t_phase = time.perf_counter()
    n_test = None
    out, inputs = {}, {}
    for method, kernel in (("scarlet", "enhanced_era_fused"), ("cfd", "quantize_dequantize")):
        argv = ["--method", method, "--rounds", str(LAUNCHER_ROUNDS)]
        with record_inputs(inputs):
            g = _launch(argv + ["--device", "cuda"], os.path.join(tmp, method, "cuda"))
        c = _launch(argv + ["--device", "cpu"], os.path.join(tmp, method, "cpu"))
        cfg = fl_train.config_from_args(fl_train.build_parser().parse_args(argv))
        n_test = max(cfg.private_size // 5, 200)  # the synthetic test set
        acc_err = max(abs(a - b) for a, b in zip(_accs(g), _accs(c)))
        same = _ledger(g) == _ledger(c)
        gated = method in LAUNCHER_FREE_RUN_GATED
        lock = launcher_lockstep(device, method, LAUNCHER_ROUNDS)
        log(f"phase 4l (a) fl_train {method} {LAUNCHER_ROUNDS} rounds, cuda vs cpu: per-round "
            f"ledger bit for bit={same}; accuracy max diff over the two runs={acc_err!r} "
            f"({'gated at one test sample' if gated else 'logged: the trajectories part'}); "
            f"in lockstep, each round from the card's "
            f"state: ledger equal and accuracies within {lock['worst']!r} (one test sample = "
            f"{1.0 / lock['n_test']!r}) over {lock['rounds']} rounds; final server_acc cuda "
            f"{g['history']['final_server_acc']!r} cpu {c['history']['final_server_acc']!r}; "
            f"launches cuda {g['launches']} cpu {c['launches']}; wall {g['wall_s']:.3f} / "
            f"{c['wall_s']:.3f} s ({card})")
        check_launches(g["launches"], {kernel: LAUNCHER_ROUNDS,
                                       "threefry": init_launches(cfg)})
        check_launches(c["launches"], {})
        if not same:
            raise AssertionError(f"phase 4l (a) {method}: cuda and cpu launcher ledgers differ")
        if gated and acc_err > 1.0 / n_test + 1e-6:
            raise AssertionError(f"phase 4l (a) {method}: cuda and cpu launcher accuracies "
                                 f"differ by {acc_err}")
        out[method] = g
    errs = check_launcher_kernels(device, card, inputs)
    # (b) the defaults, and with the span trace
    d = _launch(["--device", "cuda"], os.path.join(tmp, "defaults"))
    t = _launch(["--device", "cuda", "--telemetry"], os.path.join(tmp, "telemetry"))
    trace = os.path.join(t["out"], "scarlet_a0.05_p1.0_s0.trace.json")
    v = subprocess.run([sys.executable, "-m", "repro_torch.obs", "validate", trace],
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=os.path.join(
                           os.path.dirname(os.path.abspath(__file__)), "src")))
    rounds = d["history"]["rounds"][-1]
    cfg_defaults = fl_train.config_from_args(fl_train.build_parser().parse_args([]))
    log(f"phase 4l (b) fl_train at its defaults: {rounds} rounds of scarlet, "
        f"{d['secs']:.3f} s ({d['wall_s']:.3f} s in run_method, "
        f"{d['wall_s'] / rounds * 1e3:.3f} ms/round); final server_acc "
        f"{d['history']['final_server_acc']!r} client_acc "
        f"{d['history']['final_client_acc']!r}; cumulative "
        f"{d['history']['comm']['cumulative_total']!r} B; launches {d['launches']}; "
        f"--telemetry: ledger equal={_ledger(t) == _ledger(d)}, "
        f"{t['history']['telemetry']['rounds']} telemetry rows, trace validate rc "
        f"{v.returncode}: {v.stdout.strip()} ({card})")
    check_launches(d["launches"], {"enhanced_era_fused": rounds,
                                   "threefry": init_launches(cfg_defaults)})
    if (v.returncode != 0 or _ledger(t) != _ledger(d)
            or t["history"]["telemetry"]["rounds"] != rounds):
        raise AssertionError(f"phase 4l (b): telemetry run or trace failed: {v.stdout} "
                             f"{v.stderr}")
    # (c) the same configuration on the device and async engines
    ap = fl_train.build_parser()
    cfg = fl_train.config_from_args(ap.parse_args([]))
    kw = dict(fl_train.METHOD_DEFAULTS["scarlet"])
    traffic = TrafficModel(arrivals=ArrivalProcess("poisson", rate=LAUNCHER_TRAFFIC[0]),
                           latency=LatencyModel("uniform", lo=0, hi=LAUNCHER_TRAFFIC[1]),
                           seed=ASYNC_SEED)
    finals = {"host loop (the launcher)": (d["history"]["final_server_acc"],
                                           d["history"]["final_client_acc"])}
    for label, ekw in (("device engine fused", dict(engine="scan", fused_round=True)),
                       (f"async decay {LAUNCHER_DECAY}",
                        dict(engine="async", traffic=traffic, staleness_decay=LAUNCHER_DECAY))):
        t0 = time.perf_counter()
        h = run_method("scarlet", cfg, device=device, **ekw, **kw)
        finals[label] = (h.final_server_acc, h.final_client_acc)
        log(f"phase 4l (c) {cfg.rounds} rounds of the launcher's configuration, {label}: "
            f"final server_acc {h.final_server_acc!r} client_acc {h.final_client_acc!r}; "
            f"cumulative {h.ledger.summary()['cumulative_total']!r} B; "
            f"{time.perf_counter() - t0:.3f} s ({card})")
    log(f"phase 4l (c): final (server, client) accuracies after {cfg.rounds} rounds "
        f"{finals} (findings, not gates; one test sample = {1.0 / n_test!r})")
    log(f"phase 4l: {time.perf_counter() - t_phase:.3f} s ({card})")
    return dict(runs=out, defaults=d, finals=finals, errs=errs)


# ---------------------------------------------------------------------------
# phase 4q: the jax key stream
# ---------------------------------------------------------------------------

def init_launches(cfg) -> int:
    """Threefry launches of an engine's initial parameters on the card:
    ``split(key(seed), K + 1)``, then a split and a normal's uniforms a
    layer of each cohort's clients and of the server
    (``models/resnet.init_mlp``)."""
    from repro_torch.fl.cohorts import resolve_cohorts

    depths = [c.depth for c in resolve_cohorts(cfg)] + [cfg.mlp_depth]
    return 1 + sum(2 * (d + 1) for d in depths)


def cpu_ms(fn, reps: int = 5) -> float:
    """Median host-clock time of ``fn`` on CPU tensors, ms."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def threefry_sass() -> dict:
    """{kernel: counts} of the built threefry library's machine code
    (``cuobjdump -sass``): its instructions, the funnel shifts (SHF.L.W, 20
    a hash: each rotation one instruction), and ``loop``, the instructions
    of the smallest loop (a backward branch's range) that holds the funnel
    shifts, one value a trip: the SASS instructions a value."""
    import re

    from repro_torch.kernels import runtime

    runtime.load("threefry")
    cuobjdump = os.path.join(os.path.dirname(runtime.nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(runtime._lib_path("threefry"))],
                          capture_output=True, text=True, check=True, timeout=120).stdout
    line = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
    out = {}
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        m = re.search(r"threefry_kernelILi(\d)E", fn.split("\n", 1)[0])
        if not m:
            continue
        ins = [(int(a, 16), op, rest) for a, op, rest in line.findall(fn)]
        shf = [a for a, op, _ in ins if op.startswith("SHF.L.W")]
        loops = []
        for a, op, rest in ins:
            tgt = re.search(r"0x([0-9a-f]+)", rest) if op.startswith("BRA") else None
            if tgt and int(tgt.group(1), 16) < a and shf and \
                    int(tgt.group(1), 16) <= min(shf) and max(shf) <= a:
                loops.append(sum(1 for b, _, _ in ins if int(tgt.group(1), 16) <= b <= a))
        out[f"threefry_kernel<{m.group(1)}>"] = dict(
            instructions=len(ins), shf=len(shf), loop=min(loops) if loops else None)
    return out


def check_threefry(device, card: str) -> dict:
    """Phase 4q (a): the kernel at every STREAM_SHAPES entry against the
    plain hash on the CPU copy of the same keys (bit for bit), timed; the
    slice's MLP init and one active store chunk through ``init_mlp`` on the
    card and on the CPU; the kernels' SASS.  Returns the kernel line's
    numbers (the first shape)."""
    from repro_torch.core import prng
    from repro_torch.kernels import ops, prng_kernel
    from repro_torch.models.resnet import init_mlp

    rng = np.random.default_rng(17)
    sass = threefry_sass()
    for name, counts in sorted(sass.items()):
        log(f"threefry sass {name}: {counts} (loop: the SASS instructions a value)")
    first = None
    for label, n, start, count, mode in STREAM_SHAPES:
        keys = torch.from_numpy(rng.integers(0, 2 ** 32, (n, 2)))
        kd = keys.to(device)
        got = ops.threefry(kd, start, count, mode)
        _sync(device)
        want = prng.counter_hash(keys, start, count, mode)
        equal = got.dtype == want.dtype and torch.equal(got.cpu(), want)
        err = float((got.cpu().to(torch.float64) - want.to(torch.float64)).abs().max())
        values = n * count
        code, _, words = prng_kernel.MODES[mode]
        instr = sass.get(f"threefry_kernel<{code}>", {}).get("loop") or THREEFRY_INSTR
        # bytes: the keys' two words read once, each count's 32-bit words
        # written once
        b, why = bound_ms(8.0 * n + 4.0 * words * values, instr * values, ISSUE_PER_S)
        ms = cuda_ms(lambda: ops.threefry(kd, start, count, mode))
        pms = (cpu_ms(lambda: prng.counter_hash(keys, start, count, mode))
               if values <= STREAM_PLAIN_MAX else None)
        log(f"time threefry {label}: ({n}, {count}) {mode}, layout "
            f"{prng_kernel.layout(n, count)}: ms={ms!r} plain_ms (host CPU)="
            f"{'not timed' if pms is None else repr(pms)} bound_ms={b!r} by {why} "
            f"({f'integer issue, {instr} instructions a value' if why == 'operations' else 'HBM'}); "
            f"bit for bit={equal} ({card})")
        if not equal:
            raise AssertionError(f"phase 4q (a): threefry {label} differs from the plain hash")
        if first is None:
            first = dict(ms=ms, plain_ms=pms, bound_ms=b, bound_by=why, max_abs_err=err)
    # the initial parameters: the slice's 100 clients and one store chunk
    for label, n, dims in (("the slice's 100 clients", 100, (32, 10, 64, 2)),
                           ("one 4096-client store chunk", 4096, (8, 10, 8, 1))):
        keys = prng.split(prng.key(0), n)
        g = init_mlp(keys.to(device), *dims)
        c = init_mlp(keys, *dims)
        perr = max(float((g[k].cpu() - c[k]).abs().max()) for k in c)
        log(f"phase 4q (a) init_mlp {label} {dims}: card vs CPU max_abs_err={perr!r} "
            f"(atol 1e-6: the devices' float32 log1p may differ in the last bit)")
        if perr > 1e-6:
            raise AssertionError(f"phase 4q (a): init_mlp {label} card vs CPU {perr}")
    if any(c["shf"] != 20 for c in sass.values()):
        raise AssertionError(f"phase 4q (a): a threefry kernel's rotations are not 20 funnel "
                             f"shifts: {sass}")
    return first


def stream_draws(eng, T: int):
    """The engine's jax-stream draws of rounds 1..T, ``(part (T, K),
    idx (T, m))`` as host arrays."""
    t_done, eng.t_done = eng.t_done, 0
    try:
        part, idx, _ = eng._leg_draws(T, None)
    finally:
        eng.t_done = t_done
    return part.cpu().numpy(), idx.cpu().numpy()


def run_key_stream(device, card: str) -> dict:
    """Phase 4q: (a) the kernel; (b) the slice under the jax stream on the
    device engine, card against CPU; (c) every engine under both streams."""
    from repro_torch.core import prng
    from repro_torch.fl import FLConfig, STRATEGIES, ScannedFederatedDistillation
    from repro_torch.launch import mesh as mesh_lib

    t_phase = time.perf_counter()
    first = check_threefry(device, card)
    runs, plans = {}, {}
    for label, engine, fused in STREAM_ENGINES:
        for backend in ("numpy", "jax"):  # each engine's two streams side by side
            spent = plans.setdefault((label, backend), [])

            def timed_plan(eng, spent=spent):  # the async engine's host planning
                if hasattr(eng, "plan_flight"):
                    plan = eng.plan_flight

                    def wrapped(*a, **k):
                        t0 = time.perf_counter()
                        out = plan(*a, **k)
                        spent.append(time.perf_counter() - t0)
                        return out
                    eng.plan_flight = wrapped

            def go():
                return run_engine(device, f"4q {label} {backend}", "scarlet", engine,
                                  fused=fused, codec=CODEC, cache_duration=CACHE_DURATION,
                                  rng_backend=backend, hook=timed_plan, beta=BETA)
            if engine == "shard":
                with mesh_lib.world_of_one("nccl"):
                    runs[label, backend] = go()
            else:
                runs[label, backend] = go()
    t_b = time.perf_counter()
    # (b) per-op against fused on the jax stream, and their draws and ledger on the CPU
    perop, fused = runs["device engine per-op", "jax"], runs["device engine fused", "jax"]
    compare_runs("4q jax stream: fused vs per-op device engine", fused, perop, 0.0,
                 QUANT_STEP_ATOL)
    cfg = FLConfig(**SLICE, rounds=SLICE_ROUNDS, eval_every=SLICE_ROUNDS, uplink_codec=CODEC)
    cpu = ScannedFederatedDistillation(cfg, STRATEGIES["scarlet"](beta=BETA),
                                       cache_duration=CACHE_DURATION, device="cpu")
    draws_cpu = stream_draws(cpu, SLICE_ROUNDS)
    same_draws = {lab: all(np.array_equal(a, b) for a, b in zip(
        stream_draws(runs[lab, "jax"]["eng"], SLICE_ROUNDS), draws_cpu))
        for lab in ("device engine per-op", "device engine fused")}
    h = cpu.run(STREAM_CPU_ROUNDS)
    led_cpu = [(r.uplink, r.downlink) for r in h.ledger.rounds]
    same_ledger = {lab: [(r.uplink, r.downlink) for r in runs[lab, "jax"]["ledger"]]
                   [:STREAM_CPU_ROUNDS] == led_cpu
                   for lab in ("device engine per-op", "device engine fused")}
    leg = STREAM_LEG_KEYS + 2 * prng.shuffle_rounds(SLICE["public_size"])
    log(f"phase 4q (b) the slice on the jax stream: P^t and participation of rounds 1.."
        f"{SLICE_ROUNDS} card vs CPU equal {same_draws}; the first {STREAM_CPU_ROUNDS} rounds' "
        f"ledger card vs CPU equal {same_ledger}; threefry launches a leg {leg} "
        f"({STREAM_LEG_KEYS} + 2 a sort round of P^t), 2 legs a run ({card})")
    if not (all(same_draws.values()) and all(same_ledger.values())):
        raise AssertionError("phase 4q (b): the jax stream differs card vs CPU")
    for lab in ("device engine per-op", "device engine fused"):
        got = runs[lab, "jax"]["launches"]["threefry"]
        if device.type == "cuda" and (got != 2 * leg
                                      or runs[lab, "numpy"]["launches"]["threefry"]):
            raise AssertionError(f"phase 4q (b) {lab}: threefry launches {got} on the jax "
                                 f"stream (want {2 * leg}), "
                                 f"{runs[lab, 'numpy']['launches']['threefry']} on numpy")
    # (c) ms/round by engine and stream
    for label, _, _ in STREAM_ENGINES:
        a, b = runs[label, "numpy"], runs[label, "jax"]
        n = len(b["ledger"])
        planned = "".join(f"; flight plans {backend} {[round(x * 1e3, 3) for x in p]} ms"
                          for (lab, backend), p in plans.items() if lab == label and p)
        log(f"phase 4q (c) {label}: {a['per_round_ms']:.3f} ms/round numpy, "
            f"{b['per_round_ms']:.3f} ms/round jax (host clock, the {n - 1} rounds of the "
            f"second leg){planned}; threefry launches a round over both legs numpy "
            f"{a['launches']['threefry'] / n!r}, jax {b['launches']['threefry'] / n!r} ({card})")
    log(f"phase 4q: {time.perf_counter() - t_phase:.3f} s, (b)'s CPU engine "
        f"{time.perf_counter() - t_b:.3f} s of it ({card})")
    return dict(first, launches=fused["launches"]["threefry"])


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

@contextmanager
def sync_error():
    """``torch.cuda.set_sync_debug_mode("error")`` for the block."""
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


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
    with sync_error():
        t0 = time.perf_counter()
        beta = scarlet._adaptive_beta(torch.mean(z, 0))
        agg = core.aggregate_soft_labels(z, "enhanced_era", beta=beta, impl="kernel")
        sharp = core.enhanced_era(soft, BETA, impl="kernel")
        loss = core.soft_cross_entropy(student, teacher, impl="kernel")
        t_issue = time.perf_counter() - t0
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
# phase 4c-decode: whisper-large-v3's KV-cache decode at full width
# ---------------------------------------------------------------------------

def _decode_steps(cfg, params, cache, tokens, pos, logits_out=None):
    """Teacher-force ``tokens`` (B, S) through ``registry.decode_step`` from
    the device position ``pos`` (each step's logits into ``logits_out``
    (B, S, V) when given); returns the cache, the next position and the
    last step's logits."""
    from repro_torch.models import registry

    lg = None
    for i in range(tokens.shape[1]):
        lg, cache = registry.decode_step(cfg, params, cache, tokens[:, i:i + 1], pos)
        if logits_out is not None:
            logits_out[:, i] = lg
        pos = pos + 1
    return cache, pos, lg


def run_whisper_decode(device, card: str, wh: dict) -> dict:
    """Phase 4c-decode (see DECODE_RTOL): parity with the tempered prefill
    at every prompt position, greedy generation timed (host clock and CUDA
    events), the device-busy share of one profiled step, the cache's
    bytes; no kernel launched by decode."""
    from repro_torch.configs.whisper_large_v3 import CONFIG
    from repro_torch.kernels import ops
    from repro_torch.launch.specs import make_batch
    from repro_torch.models import common as cm
    from repro_torch.models import registry, whisper

    cfg = CONFIG
    t_phase = time.perf_counter()
    params = tempered(cm.tree_map(lambda t: t, wh["params"]))  # new tensors where scaled
    batch = make_batch(cfg, WHISPER_B, WHISPER_S, seed=WHISPER_SEED, device=device)
    ops.reset_launches()
    want = registry.prefill(cfg, params, batch)
    check_launches(ops.launches(), {"flash_attention": cfg.n_layers})
    cache = registry.init_decode_cache(cfg, WHISPER_B, WHISPER_S + DECODE_GEN, device=device)
    cache["xk"], cache["xv"] = whisper.precompute_cross_kv(
        cfg, params, whisper.encode(cfg, params, batch["audio_embeds"]))
    cache_bytes = {n: t.numel() * t.element_size() for n, t in cache.items()}
    got = torch.empty_like(want)
    pos = torch.zeros((), dtype=torch.int64, device=device)
    _sync(device)

    # the prompt, teacher-forced, counted, no host sync
    ops.reset_launches()
    t0 = time.perf_counter()
    with sync_error():
        cache, pos, lg = _decode_steps(cfg, params, cache, batch["tokens"], pos, got)
        tok = lg.argmax(-1, keepdim=True)
    _sync(device)
    tf_ms = (time.perf_counter() - t0) * 1e3 / WHISPER_S
    launches = ops.launches()
    check_launches(launches, {})
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    per_pos = (got - want).abs().amax(dim=(0, 2))
    share = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    log(f"phase 4c-decode: {WHISPER_S} positions teacher-forced through decode_step "
        f"(B={WHISPER_B}, a device position, sync debug 'error'): logits max_abs_err "
        f"{err!r} against the tempered prefill's (flash) at every position, max |logit| "
        f"{scale!r}, tolerance DECODE_RTOL x max = {DECODE_RTOL * scale!r}; worst position "
        f"{int(per_pos.argmax())}, error at positions 0/{WHISPER_S // 2}/{WHISPER_S - 1} "
        f"{[float(per_pos[i]) for i in (0, WHISPER_S // 2, WHISPER_S - 1)]}; greedy token "
        f"equal at {share!r} of the positions (at least {DECODE_ARGMAX_SHARE}); launches "
        f"{launches}; {tf_ms:.3f} ms a step (host clock, synchronized at the end) ({card})")
    if not (bool(torch.isfinite(got).all()) and err <= DECODE_RTOL * scale
            and share >= DECODE_ARGMAX_SHARE):
        raise AssertionError(f"phase 4c-decode: decode differs from the prefill: err {err}, "
                             f"argmax share {share}")

    # greedy generation, the next token staying on the card
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    gen = []
    t0 = time.perf_counter()
    with sync_error():
        start.record()
        for _ in range(DECODE_GEN):
            lg, cache = registry.decode_step(cfg, params, cache, tok, pos)
            tok = lg.argmax(-1, keepdim=True)
            gen.append(tok)
            pos = pos + 1
        end.record()
    end.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / DECODE_GEN
    event_ms = start.elapsed_time(end) / DECODE_GEN
    gen = torch.cat(gen, dim=1)
    if int(pos) != WHISPER_S + DECODE_GEN or int(gen.min()) < 0 or \
            int(gen.max()) >= cfg.padded_vocab or not bool(torch.isfinite(lg).all()):
        raise AssertionError("phase 4c-decode: generation out of range")

    # one profiled step: the device's busy share of an unprofiled step
    busy = profiled_step_busy(
        lambda: registry.decode_step(cfg, params, cache, tok, pos - 1), device, event_ms)
    log(f"phase 4c-decode: greedy generation of {DECODE_GEN} tokens x {WHISPER_B} "
        f"sequences at positions {WHISPER_S}..{WHISPER_S + DECODE_GEN - 1}: {host_ms:.3f} "
        f"ms/token (host clock), {event_ms:.3f} ms/token (CUDA events), "
        f"{WHISPER_B * 1e3 / host_ms:.1f} tokens/s over the batch; one profiled step: device "
        f"busy {busy['busy_ms']!r} ms of the unprofiled {event_ms!r} ms = {busy['share']!r} "
        f"(the profiled step took {busy['wall_ms']!r} ms by host clock), "
        f"{busy['kernels']} kernels; cache {sum(cache_bytes.values())} B {cache_bytes} "
        f"(max_len {WHISPER_S + DECODE_GEN}, {cfg.param_dtype}); first generated "
        f"{gen[0, :8].tolist()} ({card})")
    log(f"phase 4c-decode: the profiled step's kernels by class (count, device ms): "
        f"{busy['classes']}")
    log(f"phase 4c-decode: the profiled step's {len(busy['top'])} costliest kernel names "
        f"(count, device ms, name): {busy['top']}")
    log(f"phase 4c-decode: {time.perf_counter() - t_phase:.3f} s ({card})")
    return dict(err=err, scale=scale, share=share, host_ms=host_ms, event_ms=event_ms,
                busy=busy, cache_bytes=cache_bytes)


# Kernel classes of a profiled step, by the first pattern a kernel's name
# matches (the functor in ATen's template names the operation: a dtype
# conversion or a permuted copy is an elementwise kernel of a copy
# functor; cuBLAS's matrix products are gemm, gemv or nvjet kernels)
KERNEL_CLASSES = (("cat", "CatArray"), ("copy", "copy|memcpy"),
                  ("matmul", "gemm|gemv|nvjet|cutlass|xmma"), ("softmax", "softmax"),
                  ("reduction", "reduce"), ("index", "index|scatter|gather"),
                  ("elementwise", "elementwise"))


def profiled_step_busy(step, device, step_ms: float) -> dict:
    """One call of ``step`` under ``torch.profiler`` (CPU and CUDA): the
    summed device time of its kernels (busy), busy over ``step_ms`` (the
    same step's time unprofiled: the profiler's own host work slows the
    profiled step, wall), the kernels by KERNEL_CLASSES and the costliest
    kernel names, each with its count and device ms."""
    import re
    from collections import defaultdict

    from torch.profiler import ProfilerActivity, profile

    step()  # warm
    _sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        _sync(device)
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise AssertionError("the profiler recorded no device time for a decode step")
    busy = sum(e.device_time for e in kernels) / 1e3
    classes, names = defaultdict(lambda: [0, 0.0]), defaultdict(lambda: [0, 0.0])
    for e in kernels:
        cls = next((c for c, pat in KERNEL_CLASSES if re.search(pat, e.name, re.I)), "other")
        for d, key in ((classes, cls), (names, e.name[:100])):
            d[key][0] += 1
            d[key][1] += e.device_time / 1e3
    top = sorted(names.items(), key=lambda kv: -kv[1][1])[:6]
    return dict(busy_ms=busy, wall_ms=wall, share=busy / step_ms, kernels=len(kernels),
                classes={c: (n, round(ms, 4)) for c, (n, ms) in
                         sorted(classes.items(), key=lambda kv: -kv[1][1])},
                top=[(n, round(ms, 4), name) for name, (n, ms) in top])


# ---------------------------------------------------------------------------
# phase 4m: the Jamba hybrid and Mamba2 at full width
# ---------------------------------------------------------------------------

def jamba_cfg():
    """jamba-v0.1-52b at its published widths, one block deep."""
    import dataclasses

    from repro_torch.configs.jamba_v01_52b import CONFIG

    return dataclasses.replace(CONFIG, n_layers=JAMBA_LAYERS)


def _moe_drops(cfg, params, tokens) -> list:
    """The entries each MoE sublayer of a prefill drops, in order."""
    from repro_torch.models import jamba

    routing = []
    jamba.forward(cfg, params, tokens, routing=routing)
    return [int(r["dropped"]) for r in routing]


def _timed_prefill(cfg, params, batch, device, want_launches: dict, label: str):
    """One warm-up, then JAMBA_TIMED prefills by the host clock, the first
    counted (the kernels' launches of one prefill, checked); the logits,
    the launches, the median ms and the device's peak bytes."""
    from repro_torch.kernels import ops
    from repro_torch.models import registry

    registry.prefill(cfg, params, batch)  # warm-up
    _sync(device)
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    ops.reset_launches()
    t0 = time.perf_counter()
    logits = registry.prefill(cfg, params, batch)
    _sync(device)
    times = [time.perf_counter() - t0]
    launches = ops.launches()
    peak = torch.cuda.max_memory_allocated(device) - base
    log(f"{label}: launches of one prefill {launches}")
    check_launches(launches, want_launches)
    B, S = batch["tokens"].shape
    want_shape = (B, S, cfg.padded_vocab)
    if tuple(logits.shape) != want_shape or logits.dtype != torch.float32 or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{label}: logits {tuple(logits.shape)} {logits.dtype}, "
                             f"expected {want_shape} float32, finite")
    for _ in range(JAMBA_TIMED - 1):
        t0 = time.perf_counter()
        registry.prefill(cfg, params, batch)
        _sync(device)
        times.append(time.perf_counter() - t0)
    ms = statistics.median(times) * 1e3
    busy = profiled_step_busy(lambda: registry.prefill(cfg, params, batch), device, ms)
    log(f"{label}: prefill B={B} S={S}: {ms:.3f} ms median of "
        f"{[round(t * 1e3, 3) for t in times]} ms (host clock, synchronized, after one "
        f"warm-up), {B * S / (ms / 1e3):.1f} tokens/s; logits {want_shape} float32 finite, "
        f"max |logit| {float(logits.abs().max())!r}; device peak {peak} B above the "
        f"{base} B held before it; one profiled prefill: device busy {busy['busy_ms']!r} ms "
        f"of the unprofiled {ms!r} = {busy['share']!r}, {busy['kernels']} kernels")
    log(f"{label}: the profiled prefill's kernels by class (count, device ms): "
        f"{busy['classes']}")
    log(f"{label}: its {len(busy['top'])} costliest kernel names (count, device ms, name): "
        f"{busy['top']}")
    return logits, launches, ms, peak


def hold_decode(label: str, device, card: str, cfg, params, tokens, want,
                tol=(JAMBA_DECODE_RTOL, JAMBA_DECODE_SHARE, JAMBA_FLIP_RTOL)) -> dict:
    """Teacher-force ``tokens`` (B, S) through ``registry.decode_step``
    from zero caches at a device position under sync debug "error" (a host
    sync raises), no kernel launched; each position's logits against
    ``want`` (B, S, V), the prefill's.  ``tol`` = (rtol, share, flip): a
    ``share`` of the positions within ``rtol`` of the largest prefill
    logit, every one within ``flip`` of it, the greedy token equal at
    DECODE_ARGMAX_SHARE; ``tol=None`` prints the errors and holds nothing
    but the launches and the absence of a host sync.  Then the
    device-busy share of one profiled step."""
    from repro_torch.kernels import ops
    from repro_torch.models import registry

    B, S = tokens.shape
    cache = registry.init_decode_cache(cfg, B, S, device=device)
    cache_bytes = {n: t.numel() * t.element_size() for n, t in cache.items()}
    got = torch.empty_like(want)
    pos = torch.zeros((), dtype=torch.int64, device=device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    _sync(device)
    ops.reset_launches()
    t0 = time.perf_counter()
    with sync_error():
        start.record()
        cache, pos, _ = _decode_steps(cfg, params, cache, tokens, pos, got)
        end.record()
    end.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / S
    event_ms = start.elapsed_time(end) / S
    launches = ops.launches()
    check_launches(launches, {})
    rtol, share_min, flip = tol or (JAMBA_DECODE_RTOL, 0.0, math.inf)
    scale = float(want.abs().max())
    per_pos = (got - want).abs().amax(dim=(0, 2))
    err = float(per_pos.max())
    within = float((per_pos <= rtol * scale).float().mean())
    share = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    busy = profiled_step_busy(
        lambda: registry.decode_step(cfg, params, cache, tokens[:, -1:], pos - 1), device,
        event_ms)
    ok = (bool(torch.isfinite(got).all()) and err <= flip * scale and within >= share_min
          and (tol is None or share >= DECODE_ARGMAX_SHARE))
    held = ("not held (see MAMBA_F32_RTOL)" if tol is None else
            f"at least {share_min} of them, every one within {flip} x max, greedy at least "
            f"{DECODE_ARGMAX_SHARE}")
    log(f"{label}: {S} positions x B={B} teacher-forced through decode_step ({cfg.param_dtype}, "
        f"a device position, sync debug 'error', no host sync): logits max_abs_err {err!r} "
        f"against the prefill's, max |logit| {scale!r}; {within!r} of the positions within "
        f"{rtol!r} x max = {rtol * scale!r} ({held}); worst position "
        f"{int(per_pos.argmax())}, errors at 0/{S // 2}/{S - 1} "
        f"{[float(per_pos[i]) for i in (0, S // 2, S - 1)]}; greedy token equal at {share!r}; "
        f"kernel launches {launches}; {host_ms:.3f} ms/token (host clock), {event_ms:.3f} "
        f"ms/token (CUDA events), {B * 1e3 / host_ms:.1f} tokens/s over the batch; cache "
        f"{sum(cache_bytes.values())} B {cache_bytes}; one profiled step: device busy "
        f"{busy['busy_ms']!r} ms of the unprofiled {event_ms!r} ms = {busy['share']!r}, "
        f"{busy['kernels']} kernels {'ok' if ok else 'FAIL'} ({card})")
    log(f"{label}: the profiled step's kernels by class (count, device ms): {busy['classes']}")
    log(f"{label}: its {len(busy['top'])} costliest kernel names (count, device ms, name): "
        f"{busy['top']}")
    if not ok:
        raise AssertionError(f"{label}: decode differs from the prefill: err {err}, "
                             f"share within {within}, argmax share {share}")
    return dict(err=err, scale=scale, within=within, share=share, host_ms=host_ms,
                event_ms=event_ms, busy=busy, cache_bytes=cache_bytes)


def run_jamba(device, card: str) -> dict:
    """Phase 4m (a): the full-width block's prefill, its MoE drop counts,
    and the flash kernel at the prefill's attention against its plain
    version, timed beside SDPA."""
    from repro_torch.kernels import attn_kernel
    from repro_torch.launch.specs import make_batch
    from repro_torch.models import common as cm
    from repro_torch.models import jamba, registry

    cfg = jamba_cfg()
    nb = cfg.n_layers // cfg.attn_layer_period
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = registry.init(cfg, torch.Generator(device=device).manual_seed(JAMBA_SEED),
                           device=device)
    batch = make_batch(cfg, JAMBA_B, JAMBA_S, seed=JAMBA_SEED, device=device)
    _sync(device)
    log(f"phase 4m (a): {cfg.name}, {cfg.n_layers} of 32 layers ({nb} block), d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.dh}, d_ff {cfg.d_ff}, "
        f"{cfg.n_experts} experts of {cfg.expert_d_ff} top-{cfg.top_k}, d_inner "
        f"{cfg.d_inner}, {cfg.n_ssm_heads} SSM heads of {cfg.ssm_head_dim}, N "
        f"{cfg.ssm_state}, chunk {cfg.ssm_chunk}, vocab {cfg.vocab_size}, {cfg.param_dtype}; "
        f"{cm.n_params(params)} parameters, {torch.cuda.memory_allocated(device)} B on the "
        f"card, set up in {time.perf_counter() - t0:.3f} s")
    logits, launches, ms, peak = _timed_prefill(
        cfg, params, batch, device, {"flash_attention": nb}, "phase 4m (a) jamba")
    del logits
    drops = _moe_drops(cfg, params, batch["tokens"])
    C = cm.moe_capacity(JAMBA_B * JAMBA_S, cfg.n_experts, cfg.top_k, cfg.capacity_factor)
    log(f"phase 4m (a): MoE entries dropped by each of the {len(drops)} MoE sublayers at "
        f"capacity_factor {cfg.capacity_factor} (C = {C} of {JAMBA_B * JAMBA_S * cfg.top_k} "
        f"entries over {cfg.n_experts} experts): {drops}")

    # the flash kernel on the prefill's own attention inputs
    x = params["embed"][batch["tokens"].long()].to(cm.dtype_of(cfg.compute_dtype))
    q, k, v = jamba._qkv(cfg, next(cm.layers(params["blocks"])), x,
                         torch.arange(JAMBA_S, device=device))
    del x
    got = attn_kernel.flash_attention(q, k, v, causal=True)
    want = attn_kernel.flash_attention_plain(q, k, v, True, 0)
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    ok = (bool((diff <= BF16_STEP * want.float().abs().clamp_min(1.0)).all())
          and bool(torch.isfinite(got).all()) and got.dtype == torch.bfloat16)
    del got, want, diff
    B, S, H, d = q.shape
    Hkv = k.shape[2]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    # bytes: q, k, v read once and o written once, bfloat16; operations:
    # q.k and p.v, 2 d each, over the S(S+1)/2 causal pairs of each row
    # and head
    pairs = B * H * S * (S + 1) // 2
    b, why = bound_ms(2.0 * (2 * B * S * H * d + 2 * B * S * Hkv * d), 4.0 * d * pairs,
                      BF16_OPS_PER_S)
    flash = dict(
        name="flash_attention", route="cuda", source="src/repro_torch/kernels/csrc/flash_attn.cu",
        replaces="src/repro/kernels/attn_kernel.py:80", launches=launches["flash_attention"],
        max_abs_err=err, ms=cuda_ms(lambda: attn_kernel.flash_attention(q, k, v, causal=True)),
        plain_ms=cuda_ms(lambda: attn_kernel.flash_attention_plain(q, k, v, True, 0),
                         batches=5, per_batch=2),
        bound_ms=b, bound_by=why,
        library_ms=cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)),
        shape=f"jamba-v0.1-52b prefill {(B, S, H, Hkv, d)} bfloat16")
    log(f"phase 4m (a): flash_attention at the prefill's attention {(B, S, H, Hkv, d)} "
        f"bfloat16 causal {attn_kernel.launch_plan(q, k, v, q).kernel}: max_abs_err={err!r} "
        f"(one bf16 step, 2^-7 * max(|want|, 1)) {'ok' if ok else 'FAIL'}; ms={flash['ms']!r} "
        f"plain_ms={flash['plain_ms']!r} sdpa_ms={flash['library_ms']!r} "
        f"bound_ms={b!r} by {why} ({card})")
    if not ok:
        raise AssertionError(f"flash_attention at jamba's shape: max_abs_err {err}")
    return dict(params=params, launches=launches, ms=ms, peak=peak, drops=drops, flash=flash)


def run_jamba_decode(device, card: str, ja: dict) -> dict:
    """Phase 4m (b): decode on (a)'s weights, q/k tempered, against the
    prefill (at capacity for every token where the published capacity
    drops any)."""
    import dataclasses

    from repro_torch.kernels import ops
    from repro_torch.launch.specs import make_batch
    from repro_torch.models import registry

    cfg = jamba_cfg()
    blocks = ja["params"]["blocks"]
    params = dict(ja["params"], blocks=dict(blocks, wq=blocks["wq"] * JAMBA_QK_SCALE,
                                            wk=blocks["wk"] * JAMBA_QK_SCALE))
    tokens = make_batch(cfg, JAMBA_B, JAMBA_DECODE_S, seed=JAMBA_SEED + 1,
                        device=device)["tokens"]
    drops = _moe_drops(cfg, params, tokens)
    ref = cfg if not any(drops) else dataclasses.replace(
        cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    ops.reset_launches()
    want = registry.prefill(ref, params, {"tokens": tokens})
    check_launches(ops.launches(), {"flash_attention": cfg.n_layers // cfg.attn_layer_period})
    log(f"phase 4m (b): the S={JAMBA_DECODE_S} prefill (flash) on q/k scaled by "
        f"{JAMBA_QK_SCALE}: MoE entries dropped at capacity_factor {cfg.capacity_factor}: "
        f"{drops}; decode held against the prefill at capacity_factor {ref.capacity_factor}")
    out = hold_decode("phase 4m (b) jamba decode", device, card, cfg, params, tokens, want)
    return dict(out, drops=drops, capacity_factor=ref.capacity_factor)


def run_mamba2(device, card: str) -> dict:
    """Phase 4m (c): mamba2-1.3b at full size in bfloat16: prefill and
    decode timed, decode's errors printed; then the same weights in float32
    (TF32 off): the prefill at two chunk sizes and decode held against it
    to MAMBA_F32_RTOL.  No kernel."""
    import dataclasses

    from repro_torch.configs.mamba2_1_3b import CONFIG
    from repro_torch.launch.specs import make_batch
    from repro_torch.models import common as cm
    from repro_torch.models import registry

    cfg = CONFIG
    torch.cuda.empty_cache()
    params = registry.init(cfg, torch.Generator(device=device).manual_seed(JAMBA_SEED),
                           device=device)
    batch = make_batch(cfg, MAMBA_B, MAMBA_S, seed=JAMBA_SEED, device=device)
    log(f"phase 4m (c): {cfg.name}, {cfg.n_layers} layers, d_model {cfg.d_model}, d_inner "
        f"{cfg.d_inner}, {cfg.n_ssm_heads} SSM heads of {cfg.ssm_head_dim}, N "
        f"{cfg.ssm_state}, chunk {cfg.ssm_chunk}, vocab {cfg.vocab_size}, {cfg.param_dtype}; "
        f"{cm.n_params(params)} parameters")
    logits, launches, ms, peak = _timed_prefill(cfg, params, batch, device, {},
                                                "phase 4m (c) mamba2")
    n = MAMBA_DECODE_S
    tokens = batch["tokens"][:, :n]
    small = registry.prefill(dataclasses.replace(cfg, ssm_chunk=MAMBA_SMALL_CHUNK), params,
                             batch)
    log(f"phase 4m (c): bfloat16 prefill at chunk {MAMBA_SMALL_CHUNK} against chunk "
        f"{cfg.ssm_chunk}: logits max_abs_err {float((small - logits).abs().max())!r}, max "
        f"|logit| {float(logits.abs().max())!r} (not held: see MAMBA_F32_RTOL)")
    del small
    out = hold_decode("phase 4m (c) mamba2 decode", device, card, cfg, params, tokens,
                      logits[:, :n].contiguous(), tol=None)
    del logits

    # the same weights in float32, full-precision products
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        f32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
        params = cm.tree_map(lambda t: t.float(), params)
        want = registry.prefill(f32, params, batch)
        scale = float(want.abs().max())
        err = float((registry.prefill(dataclasses.replace(f32, ssm_chunk=MAMBA_SMALL_CHUNK),
                                      params, batch) - want).abs().max())
        log(f"phase 4m (c): float32 prefill at chunk {MAMBA_SMALL_CHUNK} against chunk "
            f"{cfg.ssm_chunk}: logits max_abs_err {err!r} (MAMBA_F32_RTOL x max = "
            f"{MAMBA_F32_RTOL * scale!r})")
        if err > MAMBA_F32_RTOL * scale:
            raise AssertionError(f"mamba2 float32 prefill differs across chunk sizes: {err}")
        f32_out = hold_decode("phase 4m (c) mamba2 float32 decode", device, card, f32, params,
                              tokens, want[:, :n].contiguous(),
                              tol=(MAMBA_F32_RTOL, 1.0, MAMBA_F32_RTOL))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return dict(out, launches=launches, ms=ms, peak=peak, f32=f32_out)


def check_reduced_hybrids_cuda_vs_cpu() -> dict:
    """Phase 5c: the reduced float32 jamba (q/k / 8) and mamba2 on the card
    and on the CPU from the same weights, TF32 off: REDUCED_S-position
    prefills (jamba's attention through the flash kernel on the card, its
    plain version on the CPU) and REDUCED_DECODE decode steps, logits to
    WHISPER_SMALL_ATOL."""
    from repro_torch.configs.jamba_v01_52b import CONFIG as JAMBA
    from repro_torch.configs.mamba2_1_3b import CONFIG as MAMBA
    from repro_torch.kernels import ops
    from repro_torch.launch.specs import make_batch
    from repro_torch.models import common as cm
    from repro_torch.models import registry

    torch.backends.cuda.matmul.allow_tf32 = False
    errs = {}
    for full, flash in ((JAMBA, 1), (MAMBA, 0)):
        cfg = full.reduced()
        p = tempered(registry.init(cfg, torch.Generator().manual_seed(JAMBA_SEED),
                                   device="cpu"))
        tokens = make_batch(cfg, 2, REDUCED_S, seed=JAMBA_SEED, device="cpu")["tokens"]
        outs = {}
        for dev in ("cpu", "cuda"):
            d = torch.device(dev)
            pd = cm.tree_map(lambda t: t.to(d), p)
            ops.reset_launches()
            prefill = registry.prefill(cfg, pd, {"tokens": tokens.to(d)})
            if dev == "cuda":
                _sync(d)
                check_launches(ops.launches(), {"flash_attention": flash})
            cache = registry.init_decode_cache(cfg, 2, REDUCED_DECODE, device=d)
            dec = torch.empty(2, REDUCED_DECODE, cfg.padded_vocab, device=d)
            _decode_steps(cfg, pd, cache, tokens[:, :REDUCED_DECODE].to(d),
                          torch.zeros((), dtype=torch.int64, device=d), dec)
            outs[dev] = (prefill.cpu(), dec.cpu())
        e_pre = float((outs["cuda"][0] - outs["cpu"][0]).abs().max())
        e_dec = float((outs["cuda"][1] - outs["cpu"][1]).abs().max())
        log(f"{cfg.name} (float32) cuda vs cpu: prefill S={REDUCED_S} logits "
            f"max_abs_err={e_pre!r}, {REDUCED_DECODE} decode steps max_abs_err={e_dec!r} "
            f"(atol {WHISPER_SMALL_ATOL}), max |logit| {float(outs['cpu'][0].abs().max())!r}, "
            f"flash launches {flash}")
        if not (bool(torch.isfinite(outs["cuda"][0]).all()) and e_pre <= WHISPER_SMALL_ATOL
                and e_dec <= WHISPER_SMALL_ATOL):
            raise AssertionError(f"{cfg.name} cuda vs cpu: {e_pre}, {e_dec}")
        errs[cfg.name] = (e_pre, e_dec)
    return errs


# ---------------------------------------------------------------------------
# phase 4n: LM training
# ---------------------------------------------------------------------------

def _leaf_items(tree, prefix=""):
    for n, t in tree.items():
        if isinstance(t, dict):
            yield from _leaf_items(t, f"{prefix}{n}/")
        else:
            yield prefix + n, t


def _check_grads(cfg, grads) -> int:
    """Every gradient finite and, for a leaf stacked on the layer axis,
    nonzero in every layer; returns the leaves checked."""
    n = 0
    for name, g in _leaf_items(grads):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"phase 4n (a): gradient of {name} is not finite")
        per = g.flatten(1).abs().amax(1) if g.dim() > 1 and g.shape[0] == cfg.n_layers \
            else g.abs().amax().reshape(1)
        if not bool((per > 0).all()):
            raise AssertionError(f"phase 4n (a): gradient of {name} is zero in layers "
                                 f"{torch.nonzero(per == 0).flatten().tolist()}")
        n += 1
    return n


def run_train_full(device, card: str) -> dict:
    """Phase 4n (a): granite-3-2b at full width, TRAIN_STEPS steps of
    train_step, then one with remat."""
    from repro_torch.configs.granite_3_2b import CONFIG
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.launch.specs import make_batch
    from repro_torch.models import common as cm
    from repro_torch.models import registry
    from repro_torch.optim import Optimizer, get

    cfg = CONFIG
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = registry.init(cfg, torch.Generator(device=device).manual_seed(TRAIN_SEED),
                           device=device)
    batch = make_batch(cfg, TRAIN_B, TRAIN_S, seed=TRAIN_SEED, device=device)
    batch["labels"] = batch["tokens"]
    opt = get("adamw", weight_decay=0.01)
    state = opt.init(params)
    _sync(device)
    n_params = cm.n_params(params)
    log(f"phase 4n (a): {cfg.name}, {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.dh}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size} (padded {cfg.padded_vocab}), {cfg.param_dtype}; {n_params} "
        f"parameters; AdamW moments {state['m']['embed'].dtype}; "
        f"{torch.cuda.memory_allocated(device)} B on the card, set up in "
        f"{time.perf_counter() - t0:.3f} s")
    seen, upd = {}, []

    def spy(grads, st, p, lr):  # keeps step 1's gradients, times each update
        if not seen:
            seen["grads"] = grads
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = opt.update(grads, st, p, lr)
        ev[1].record()
        upd.append(ev)
        return out

    spied = Optimizer(opt.init, spy)
    losses, launches, ms_host, ms_event = [], [], [], []
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    for step in range(TRAIN_STEPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ops.reset_launches()
        t0 = time.perf_counter()
        start.record()
        loss, new, state = train.train_step(cfg, spied, params, state, batch, TRAIN_LR)
        end.record()
        end.synchronize()
        ms_host.append((time.perf_counter() - t0) * 1e3)
        ms_event.append(start.elapsed_time(end))
        launches.append(ops.launches())
        losses.append(float(loss))
        if step == 0:
            n_leaves = _check_grads(cfg, seen["grads"])
            seen["grads"] = None
            same = [n for (n, a), (_, b) in zip(_leaf_items(params), _leaf_items(new))
                    if torch.equal(a, b)]
            if same:
                raise AssertionError(f"phase 4n (a): step 1 left {same} unchanged")
        params = new
    peak = torch.cuda.max_memory_allocated(device) - base
    for got in launches:
        check_launches(got, {"flash_attention": cfg.n_layers})
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"phase 4n (a): losses {losses}")
    ms = statistics.median(ms_event[1:])
    upd_ms = statistics.median(a.elapsed_time(b) for a, b in upd[1:])
    tokens = TRAIN_B * TRAIN_S
    flops = 6.0 * n_params * tokens
    log(f"phase 4n (a): {TRAIN_STEPS} train_step at B={TRAIN_B} S={TRAIN_S}, lr {TRAIN_LR}: "
        f"losses {losses}; step 1: {n_leaves} gradients finite and nonzero in every layer, "
        f"every parameter changed; flash launches a step "
        f"{[x['flash_attention'] for x in launches]} (all kernels {launches[0]}); ms/step "
        f"{ms!r} median of steps 2-{TRAIN_STEPS} by CUDA events {[round(x, 3) for x in ms_event]}"
        f" (host clock {[round(x, 3) for x in ms_host]}), of which the AdamW update "
        f"{upd_ms!r} ms (median, {[round(a.elapsed_time(b), 3) for a, b in upd]}) and the loss "
        f"with its backward {ms - upd_ms!r}; {tokens / (ms / 1e3):.1f} tokens/s; 6 N tokens = "
        f"{flops:.4e} FLOP a step = {flops / (ms / 1e3) / BF16_OPS_PER_S!r} of the bf16 peak "
        f"({flops / ((ms - upd_ms) / 1e3) / BF16_OPS_PER_S!r} over the loss and backward "
        f"alone); device peak {peak} B above the {base} B of parameters and optimizer state, "
        f"{torch.cuda.memory_reserved(device)} B reserved, "
        f"{torch.cuda.memory_stats(device)['num_alloc_retries']} allocation retries ({card})")
    busy = profiled_step_busy(lambda: train.train_step(cfg, opt, params, state, batch, TRAIN_LR),
                              device, ms)
    log(f"phase 4n (a): one profiled step: device busy {busy['busy_ms']!r} ms of the "
        f"unprofiled {ms!r} = {busy['share']!r}, {busy['kernels']} kernels; by class (count, "
        f"device ms): {busy['classes']}; the {len(busy['top'])} costliest kernel names: "
        f"{busy['top']}")
    # two steps with remat: the first pays checkpoint's one-time setup
    remat_ms = []
    for _ in range(2):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.reset_peak_memory_stats(device)
        ops.reset_launches()
        start.record()
        loss, params, state = train.train_step(cfg, opt, params, state, batch, TRAIN_LR,
                                               remat=True)
        end.record()
        end.synchronize()
        remat_ms.append(start.elapsed_time(end))
        remat = ops.launches()
        remat_peak = torch.cuda.max_memory_allocated(device) - base
        check_launches(remat, {"flash_attention": 2 * cfg.n_layers})
        if not math.isfinite(float(loss)):
            raise AssertionError("phase 4n (a): the remat step's loss is not finite")
    log(f"phase 4n (a): two more steps with remat ({cfg.remat_policy}): loss {float(loss)!r}, "
        f"flash launches {remat['flash_attention']} a step (forward and recompute), "
        f"{remat_ms} ms (CUDA events), device peak {remat_peak} B above the same base, "
        f"{torch.cuda.memory_stats(device)['num_alloc_retries']} allocation retries in all "
        f"({card})")
    return dict(losses=losses, ms=ms, upd_ms=upd_ms, ms_event=ms_event, peak=peak,
                remat_peak=remat_peak, remat_ms=remat_ms, busy=busy,
                launches=sum(x["flash_attention"] for x in launches), n_params=n_params)


def _fwd_bwd(fn, q, k, v, do):
    """(output, dq, dk, dv) of ``fn`` for the cotangent ``do``."""
    q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))
    o = fn(q, k, v)
    return (o.detach(), *torch.autograd.grad(o, (q, k, v), do))


def check_flash_diff(device, card: str, train_launches: int) -> dict:
    """Phase 4n (b): flash_attention_diff against autograd through the
    plain version at granite's training shape (bfloat16) and at
    TRAIN_ATTN_F32 (float32, a window), times by CUDA events; the kernel
    line's training entry."""
    from repro_torch.kernels import attn_kernel

    rng = np.random.default_rng(21)
    out = {}
    for B, S, H, Hkv, d, window, dtype in (TRAIN_ATTN + (0, torch.bfloat16),
                                           TRAIN_ATTN_F32 + (torch.float32,)):
        q, k, v = attn_inputs(rng, B, S, S, H, Hkv, d, dtype, device)
        do = torch.from_numpy(rng.normal(size=(B, S, H, d)).astype(np.float32)).to(device, dtype)
        diff_fn = lambda a, b, c: attn_kernel.flash_attention_diff(a, b, c, True, window)  # noqa: E731
        plain_fn = lambda a, b, c: attn_kernel.flash_attention_plain(a, b, c, True, window)  # noqa: E731
        got, want = _fwd_bwd(diff_fn, q, k, v, do), _fwd_bwd(plain_fn, q, k, v, do)
        _sync(device)
        errs, ok = [], True
        for i, (g, w) in enumerate(zip(got, want)):
            e = (g.float() - w.float()).abs()
            errs.append(float(e.max()))
            if i == 0:
                ok &= bool((e <= BF16_STEP * w.float().abs().clamp_min(1.0)).all()) \
                    if dtype == torch.bfloat16 else errs[-1] <= FLASH_F32_ATOL
            else:
                scale = float(w.float().abs().max())
                ok &= errs[-1] <= (2 * BF16_STEP if dtype == torch.bfloat16
                                   else TRAIN_GRAD_RTOL) * scale
            ok &= bool(torch.isfinite(g).all()) and g.dtype == dtype
        # times: forward (the kernel), backward (the recompute) alone on a
        # kept graph, beside autograd through the plain version and SDPA
        qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
        o_diff = diff_fn(qg, kg, vg)
        o_plain = plain_fn(qg, kg, vg)
        t = dict(
            ms=cuda_ms(lambda: attn_kernel.flash_attention(q, k, v, True, window)),
            plain_ms=cuda_ms(lambda: attn_kernel.flash_attention_plain(q, k, v, True, window)),
            bwd_ms=cuda_ms(lambda: torch.autograd.grad(o_diff, (qg, kg, vg), do,
                                                       retain_graph=True)),
            bwd_plain_ms=cuda_ms(lambda: torch.autograd.grad(o_plain, (qg, kg, vg), do,
                                                             retain_graph=True)))
        if not window:  # SDPA has no window
            qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_(True) for t in (q, k, v))
            sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, is_causal=True, enable_gqa=True)
            o_sdpa = sdpa()
            t.update(library_ms=cuda_ms(sdpa),
                     bwd_library_ms=cuda_ms(lambda: torch.autograd.grad(
                         o_sdpa, (qt, kt, vt), do.transpose(1, 2), retain_graph=True)))
            del qt, kt, vt, o_sdpa
        # bytes: q, k, v read and o written once (forward); q, k, v, do read
        # and dq, dk, dv written once (backward); operations over the causal
        # pairs inside the window: q.k and p.v, 2 d each (forward; in float32
        # the kernel's three tf32 passes at the tf32 rate, as phase 6); the
        # recomputed q.k, dV, dP, dQ, dK, 2 d each (backward, in float32 at
        # the float32 rate: the plain recompute's products, TF32 off)
        pairs = sum(min(i + 1, window or i + 1) for i in range(S)) * B * H
        isz = q.element_size()
        qb, kb = B * S * H * d * isz, B * S * Hkv * d * isz
        if dtype == torch.bfloat16:
            fwd = bound_ms(2 * qb + 2 * kb, 4.0 * d * pairs, BF16_OPS_PER_S)
            bwd = bound_ms(3 * qb + 4 * kb, 10.0 * d * pairs, BF16_OPS_PER_S)
        else:
            fwd = bound_ms(2 * qb + 2 * kb, TF32_PASSES * 4.0 * d * pairs, TF32_OPS_PER_S)
            bwd = bound_ms(3 * qb + 4 * kb, 10.0 * d * pairs, FP32_OPS_PER_S)
        (t["bound_ms"], t["bound_by"]), (t["bwd_bound_ms"], t["bwd_bound_by"]) = fwd, bwd
        shape = (B, S, H, Hkv, d)
        log(f"phase 4n (b): flash_attention_diff {shape} window {window} {str(dtype)[6:]} "
            f"against autograd through flash_attention_plain: max_abs_err out/dq/dk/dv "
            f"{errs} {'ok' if ok else 'FAIL'}; times (ms, CUDA events): {t} ({card})")
        if not ok:
            raise AssertionError(f"phase 4n (b): flash_attention_diff at {shape}: {errs}")
        out[str(dtype)[6:]] = dict(t, errs=errs, shape=shape)
        del q, k, v, do, qg, kg, vg, o_diff, o_plain
    bf = out["bfloat16"]
    flash = dict(
        name="flash_attention", route="cuda", source="src/repro_torch/kernels/csrc/flash_attn.cu",
        replaces="src/repro/kernels/attn_kernel.py:80", launches=train_launches,
        max_abs_err=bf["errs"][0], ms=bf["ms"], plain_ms=bf["plain_ms"],
        bound_ms=bf["bound_ms"], bound_by=bf["bound_by"], library_ms=bf["library_ms"],
        shape=f"granite-3-2b training {bf['shape']} bfloat16, {TRAIN_STEPS} steps",
        bwd_route="plain PyTorch recompute (flash_attention_bwd_plain)",
        bwd_ms=bf["bwd_ms"], bwd_plain_ms=bf["bwd_plain_ms"],
        bwd_library_ms=bf["bwd_library_ms"], bwd_bound_ms=bf["bwd_bound_ms"],
        bwd_max_abs_err=max(bf["errs"][1:]))
    return dict(out, flash=flash)


def check_train_cuda_vs_cpu(card: str) -> dict:
    """Phase 4n (c): one train_step of each family's reduced float32
    configuration on the card and on the CPU, TF32 off."""
    from repro_torch.configs.registry import ARCHS
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.launch.specs import make_batch
    from repro_torch.models import common as cm
    from repro_torch.models import registry
    from repro_torch.optim import Optimizer, get

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for name, flash in TRAIN_FAMILIES:
        cfg = ARCHS[name].reduced()
        p = tempered(registry.init(cfg, torch.Generator().manual_seed(TRAIN_SEED),
                                   device="cpu"))
        batch = make_batch(cfg, 2, 128 - cfg.n_patches, seed=TRAIN_SEED, device="cpu")
        batch["labels"] = batch["tokens"]
        opt = get("adamw", weight_decay=0.01)
        res = {}
        for dev in ("cpu", "cuda"):
            d = torch.device(dev)
            pd = cm.tree_map(lambda t: t.to(d), p)
            grads = []
            spied = Optimizer(opt.init, lambda g, *a: grads.append(g) or opt.update(g, *a))
            ops.reset_launches()
            loss, new, state = train.train_step(cfg, spied, pd, opt.init(pd),
                                                {n: t.to(d) for n, t in batch.items()}, TRAIN_LR)
            _sync(d)
            moments = {"m": state["m"], "v": state["v"]}
            res[dev] = (float(loss), dict(_leaf_items(cm.tree_map(lambda t: t.cpu(), new))),
                        dict(_leaf_items(cm.tree_map(lambda t: t.cpu(), grads[0]))),
                        ops.launches(),
                        dict(_leaf_items(cm.tree_map(lambda t: t.cpu(), moments))))
        check_launches(res["cuda"][3], {"flash_attention": flash})
        loss_err = abs(res["cuda"][0] - res["cpu"][0]) / abs(res["cpu"][0])

        def rel(a, b):
            return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30))

        grad_err = {n: rel(res["cuda"][2][n], g) for n, g in res["cpu"][2].items()}
        leaf_err = {n: rel(res["cuda"][1][n], t) for n, t in res["cpu"][1].items()}
        mom_err = {n: rel(res["cuda"][4][n], t) for n, t in res["cpu"][4].items()}
        tree_err = math.sqrt(sum(float((res["cuda"][1][n].double() - t.double()).square().sum())
                                 for n, t in res["cpu"][1].items())
                             / sum(float(t.double().square().sum())
                                   for t in res["cpu"][1].values()))
        g_worst, p_worst, m_worst = (max(e, key=e.get) for e in (grad_err, leaf_err, mom_err))
        ok = (math.isfinite(res["cuda"][0]) and loss_err <= TRAIN_STEP_RTOL
              and grad_err[g_worst] <= TRAIN_STEP_RTOL and mom_err[m_worst] <= TRAIN_STEP_RTOL
              and tree_err <= TRAIN_STEP_RTOL)
        log(f"phase 4n (c) {cfg.name} (float32) one train_step cuda vs cpu: loss "
            f"{res['cuda'][0]!r} vs {res['cpu'][0]!r} (relative {loss_err!r}); gradients: "
            f"worst leaf |cuda - cpu| / |cpu| {grad_err[g_worst]!r} ({g_worst}); AdamW's "
            f"moments: worst leaf {mom_err[m_worst]!r} ({m_worst}); parameters "
            f"after the AdamW step: the whole tree {tree_err!r}, worst leaf "
            f"{leaf_err[p_worst]!r} ({p_worst}, not held: see TRAIN_STEP_RTOL) (gate "
            f"{TRAIN_STEP_RTOL}); flash launches {flash} {'ok' if ok else 'FAIL'} ({card})")
        if not ok:
            raise AssertionError(f"phase 4n (c) {cfg.name}: loss {loss_err}, gradients "
                                 f"{grad_err[g_worst]}, moments {mom_err[m_worst]}, "
                                 f"parameters {tree_err}")
        out[name] = dict(loss_err=loss_err, grad_err=grad_err[g_worst],
                         mom_err=mom_err[m_worst], tree_err=tree_err,
                         leaf_err=leaf_err[p_worst], flash=flash)
    return out


def run_train_launcher(card: str) -> dict:
    """Phase 4n (d): the launcher at its defaults on the card, in process."""
    import contextlib
    import io

    from repro_torch.kernels import ops
    from repro_torch.launch import train

    buf = io.StringIO()
    ops.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        train.main(["--steps", str(TRAIN_LAUNCHER_STEPS)])
    wall = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    launches = ops.launches()
    log(f"phase 4n (d): python -m repro_torch.launch.train --steps {TRAIN_LAUNCHER_STEPS} "
        f"(in process, {wall:.3f} s, launches {launches}):")
    for ln in lines:
        log(f"  {ln}")
    if not lines or "(improved)" not in lines[-1]:
        raise AssertionError("phase 4n (d): the launcher's loss did not improve")
    return dict(lines=lines, launches=launches)


def run_train(device, card: str) -> dict:
    t0 = time.perf_counter()
    full = run_train_full(device, card)
    diff = check_flash_diff(device, card, full["launches"])
    small = check_train_cuda_vs_cpu(card)
    launcher = run_train_launcher(card)
    log(f"phase 4n: {time.perf_counter() - t0:.3f} s ({card})")
    return dict(full=full, diff=diff, small=small, launcher=launcher)


# ---------------------------------------------------------------------------
# phase 4o: ResNet-20 and the all-to-all MoE
# ---------------------------------------------------------------------------

def _resnet_pass(params, images):
    """Logits, loss mean(logits^2) and the gradient tree of one forward and
    backward, on the device of ``params`` (a copy that requires grad)."""
    from repro_torch.models import common as cm
    from repro_torch.models import resnet

    p = cm.tree_map(lambda t: t.detach().clone().requires_grad_(), params)
    logits = resnet.apply(p, images)
    loss = (logits ** 2).mean()
    loss.backward()
    return logits.detach(), loss.detach(), cm.tree_map(lambda t: t.grad, p)


def _rel_errs(got: dict, want: dict) -> dict:
    """Each leaf's max |got - want| over its norm, by dotted name."""
    return {n: float((g.cpu().double() - w.cpu().double()).abs().max() / w.double().norm())
            for (n, g), (_, w) in zip(_leaf_items(got), _leaf_items(want))}


def run_resnet(device, card: str) -> dict:
    """Phase 4o (a): ResNet-20 at its published widths, card vs CPU, then
    timed."""
    from repro_torch.models import common as cm
    from repro_torch.models import resnet

    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    params, _ = resnet.init(torch.Generator().manual_seed(RESNET_SEED), device="cpu")
    n_params = cm.n_params(params)
    x = torch.from_numpy(np.random.default_rng(RESNET_SEED).standard_normal(
        (RESNET_B, 32, 32, 3)).astype(np.float32))
    runs = {}
    for dev, dt in (("cpu", torch.float32), ("cpu", torch.float64),
                    (device, torch.float32), (device, torch.float64)):
        runs[(str(dev), dt)] = _resnet_pass(cm.tree_map(lambda t: t.to(dev, dt), params),
                                            x.to(dev, dt))
    cpu32, cpu64 = runs[("cpu", torch.float32)], runs[("cpu", torch.float64)]
    card32, card64 = runs[(str(device), torch.float32)], runs[(str(device), torch.float64)]
    logit_err = float((card32[0].cpu() - cpu32[0]).abs().max() / cpu32[0].norm())
    logit_err64 = float((card64[0].cpu() - cpu64[0]).abs().max() / cpu64[0].norm())
    loss_err = abs(float(card32[1]) - float(cpu32[1])) / abs(float(cpu32[1]))
    g64 = _rel_errs(card64[2], cpu64[2])
    g32 = _rel_errs(card32[2], cpu64[2])
    g32_cpu = _rel_errs(cpu32[2], cpu64[2])
    worst = max(g32, key=g32.get)
    log(f"phase 4o (a) resnet20-cifar ({n_params} parameters, widths 16/32/64) B={RESNET_B} "
        f"32x32x3, TF32 off, card vs cpu: float32 logits max_abs_err/norm {logit_err!r}, loss "
        f"rel err {loss_err!r}; float64 logits {logit_err64!r}, gradients worst "
        f"{max(g64.values())!r} (gate {RESNET_RTOL}); card float32 gradients vs cpu float64 "
        f"worst {g32[worst]!r} ({worst}; gate {RESNET_F32_GRAD_RTOL}), the cpu's own float32 "
        f"worst {max(g32_cpu.values())!r} ({max(g32_cpu, key=g32_cpu.get)}) ({card})")
    finite = all(bool(torch.isfinite(t).all()) for _, t in _leaf_items(card32[2]))
    if not (finite and bool(torch.isfinite(card32[0]).all()) and card32[0].shape == (RESNET_B, 10)
            and logit_err <= RESNET_RTOL and logit_err64 <= RESNET_RTOL
            and max(g64.values()) <= RESNET_RTOL
            and max(g32.values()) <= RESNET_F32_GRAD_RTOL):
        raise AssertionError(f"phase 4o (a): resnet card vs cpu: logits {logit_err}, "
                             f"{logit_err64}, gradients f64 {max(g64.values())}, f32 "
                             f"{max(g32.values())}")
    del runs, card32, card64
    base = torch.cuda.memory_allocated(device)
    p = cm.tree_map(lambda t: t.to(device), params)
    pg = cm.tree_map(lambda t: t.detach().clone().requires_grad_(), p)
    xd = x.to(device)

    def fwd_bwd():
        (resnet.apply(pg, xd) ** 2).mean().backward()

    times = {}
    for tf32 in (False, True):
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
        with torch.no_grad():
            fwd = cuda_ms(lambda: resnet.apply(p, xd), batches=5, per_batch=RESNET_TIMED)
        torch.cuda.reset_peak_memory_stats(device)
        both = cuda_ms(fwd_bwd, batches=5, per_batch=RESNET_TIMED)
        times[tf32] = (fwd, both, torch.cuda.max_memory_allocated(device) - base)
    busy = profiled_step_busy(fwd_bwd, device, times[True][1])
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
    log(f"phase 4o (a) resnet20-cifar B={RESNET_B}: ms per forward / forward+backward "
        f"(CUDA events, medians of 5 batches of {RESNET_TIMED}): TF32 off "
        f"{times[False][0]!r} / {times[False][1]!r}, TF32 on {times[True][0]!r} / "
        f"{times[True][1]!r}; device peak (forward+backward, above what the process held before) {times[False][2]} B; one "
        f"profiled forward+backward (TF32 on): device busy {busy['busy_ms']!r} ms "
        f"({busy['share']:.3f} of the timed one), {busy['kernels']} kernels; by class "
        f"{busy['classes']}; top {busy['top']} ({card})")
    return dict(logit_err=logit_err, grad_err64=max(g64.values()), grad_err32=g32[worst],
                times=times)


def a2a_layer(device) -> tuple:
    """jamba-v0.1-52b's MoE layer (router, w1, w3, w2; bfloat16) drawn on
    ``device`` from A2A_SEED, the global batch x (A2A_B, A2A_S, D) and
    the gradient gate's float32 cotangent of x's shape."""
    from repro_torch.models import common as cm

    cfg = jamba_cfg()
    D, E, Fe = cfg.d_model, cfg.n_experts, cfg.expert_d_ff
    gen = torch.Generator(device=device).manual_seed(A2A_SEED)
    w = cm.init_params({"router": cm.spec((D, E)), "w1": cm.spec((E, D, Fe)),
                        "w3": cm.spec((E, D, Fe)), "w2": cm.spec((E, Fe, D))},
                       gen, torch.bfloat16, device)
    x = torch.randn(A2A_B, A2A_S, D, generator=gen, device=device).to(torch.bfloat16)
    ct = torch.randn(A2A_B, A2A_S, D, generator=gen, device=device)
    return cfg, x, (w["router"], w["w1"], w["w3"], w["w2"]), ct


def a2a_grads(x, w, ct, top_k: int, n: int, M: int = 1, d_ff=None, mesh=None,
              ref_stacks=None) -> dict:
    """The gradients of ``(sum(out ct) + A2A_AUX_WEIGHT aux / n) / M`` with
    respect to x and the router (float32, on the CPU) and to the stacks
    ``w[1:]``, out and aux those of ``common.moe_ffn`` at cf 8 (under
    ``MOE_A2A_MESH`` when the caller set it: then x and ct are this rank's
    rows, ``w[1:]`` its shards and ``d_ff`` the global F), and the ms of
    the step by the host clock.  With ``ref_stacks`` (the single-device
    gradients of the full stacks, :func:`a2a_grad_ref`), each shard's
    gradient is held against its slice of them (``expert_shard`` on
    ``mesh``): the max abs difference over the slice's largest magnitude,
    by the "stacks" key (the stacks' gradients stay on the card)."""
    from repro_torch.models import common as cm
    from repro_torch.models.moe_a2a import expert_shard

    xg = x.detach().clone().requires_grad_()
    rg = w[0].detach().clone().requires_grad_()
    ws = [t.detach().requires_grad_() for t in w[1:]]
    _sync(x.device)
    t0 = time.perf_counter()
    y, aux = cm.moe_ffn(xg, rg, *ws, top_k=top_k, capacity_factor=8.0, d_ff=d_ff)
    (((y.float() * ct).sum() + A2A_AUX_WEIGHT * aux / n) / M).backward()
    _sync(x.device)
    out = dict(x=xg.grad.float().cpu(), router=rg.grad.float().cpu(),
               ms=(time.perf_counter() - t0) * 1e3)
    if ref_stacks is not None:
        out["stacks"] = {}
        for k, g, want in zip(("w1", "w3", "w2"), (t.grad for t in ws),
                              expert_shard(*ref_stacks, mesh)):
            err = max(float((g[i].float() - want[i].float()).abs().max())
                      for i in range(g.shape[0]))
            out["stacks"][k] = err / float(want.abs().max())
    return out


def a2a_grad_ref(x, w, ct, top_k: int, n: int, stacks: bool = False) -> dict:
    """The single-device gradients that the ranks of a data axis of ``n``
    add up to: of ``sum(out ct) + A2A_AUX_WEIGHT mean_d aux_d`` with
    respect to x and the router (float32, on the CPU), out the
    single-device ``moe_ffn`` of the whole batch at cf 8 and aux_d the
    routing's aux loss of the d-th of n row blocks (the ranks' pmean);
    with ``stacks``, by the "stacks" key also the gradients of the three
    full stacks, bfloat16 on the card (the aux term does not reach them,
    so they are the same for every n)."""
    from repro_torch.models import common as cm

    xg = x.detach().clone().requires_grad_()
    rg = w[0].detach().clone().requires_grad_()
    ws = [t.detach().requires_grad_(stacks) for t in w[1:]]
    y, _ = cm.moe_ffn(xg, rg, *ws, top_k=top_k, capacity_factor=8.0)
    b, D = x.shape[0] // n, x.shape[-1]
    aux = sum(cm.moe_route(xg[d * b:(d + 1) * b].reshape(-1, D), rg, top_k)[2]
              for d in range(n)) / n
    ((y.float() * ct).sum() + A2A_AUX_WEIGHT * aux).backward()
    out = dict(x=xg.grad.float().cpu(), router=rg.grad.float().cpu())
    if stacks:
        out["stacks"] = tuple(t.grad for t in ws)
    return out


def _fingerprint(ts) -> list:
    return [float(t.sum(dtype=torch.float32)) for t in ts]


def a2a_calls(mesh, x, w, ct, top_k: int, device, base: int, d_ff: int, ref_stacks,
              profile: bool = False) -> dict:
    """``common.moe_ffn`` under ``MOE_A2A_MESH = mesh`` on this rank's rows
    of ``x`` and its shards ``w[1:]`` of the stacks (global FFN width
    ``d_ff``): at each of A2A_FACTORS its output (CPU), aux, routing and
    dropped count; at A2A_DEFAULT_CF, A2A_TIMED calls timed by the host
    clock and one more with each all-to-all synchronised and timed; the
    device peak of these calls above ``base`` (what the process held
    before it drew the layer); then :func:`a2a_grads` on the rank's rows
    of ``ct``, its shards' gradients held against ``ref_stacks``.
    ``profile`` adds a profiled call's busy time."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import common as cm

    sizes = mesh_lib.mesh_axis_sizes(mesh)
    n = sizes["data"]
    b = x.shape[0] // n
    xs = x[mesh.axis_index("data") * b:][:b]

    def call(cf, routing=None):
        return cm.moe_ffn(xs, *w, top_k=top_k, capacity_factor=cf, routing=routing, d_ff=d_ff)

    out = {}
    torch.cuda.reset_peak_memory_stats(device)
    cm.MOE_A2A_MESH = mesh
    try:
        for cf in A2A_FACTORS:
            routing = []
            y, aux = call(cf, routing)
            r = routing[0]
            out[cf] = dict(y=y.cpu(), aux=float(aux), eidx=r["eidx"].cpu().numpy(),
                           cap=r["capacity"], dropped=int(r["dropped"]))
        cf = A2A_DEFAULT_CF
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(A2A_TIMED):
            call(cf)
        _sync(device)
        ms = (time.perf_counter() - t0) * 1e3 / A2A_TIMED
        busy = profiled_step_busy(lambda: call(cf), device, ms) if profile else None
        a2a_ms, plain = [], mesh_lib.all_to_all

        def timed(t, group):
            _sync(device)
            t1 = time.perf_counter()
            o = plain(t, group)
            _sync(device)
            a2a_ms.append((time.perf_counter() - t1) * 1e3)
            return o

        mesh_lib.all_to_all = timed
        try:
            call(cf)
        finally:
            mesh_lib.all_to_all = plain
        peak = torch.cuda.max_memory_allocated(device) - base
        grads = a2a_grads(xs, w, ct[mesh.axis_index("data") * b:][:b], top_k, n,
                          sizes["model"], d_ff, mesh, ref_stacks)
    finally:
        cm.MOE_A2A_MESH = None
    E, D = w[0].shape[1], x.shape[-1]
    return dict(out=out, ms=ms, a2a_ms=a2a_ms, a2a_bytes=2 * E * out[cf]["cap"] * D * 2,
                peak=peak, coords=mesh.coords, busy=busy, grads=grads,
                stack_bytes=sum(t.numel() * t.element_size() for t in w[1:]),
                shard_shapes=[tuple(t.shape) for t in w[1:]])


def a2a_shards(device, mesh, fingerprint: list) -> tuple:
    """The layer drawn again from A2A_SEED on ``device`` (its fingerprint
    must be ``fingerprint``), of which this rank keeps x, the cotangent,
    the router and its shards of the stacks on ``mesh``
    (``expert_shard``'s copies): the full stacks are freed before it
    returns.  -> (cfg, x, (router, w1, w3, w2), ct)."""
    from repro_torch.models.moe_a2a import expert_shard

    cfg, x, w, ct = a2a_layer(device)
    if _fingerprint((x, ct) + w) != fingerprint:
        raise AssertionError(f"mesh {mesh.shape} at {mesh.coords}: the layer drawn from "
                             f"A2A_SEED differs")
    w = (w[0],) + expert_shard(*w[1:], mesh)
    torch.cuda.empty_cache()
    return cfg, x, w, ct


def a2a_rank(device_type: str, top_k: int, fingerprint: list, ref_stacks: list) -> list:
    """A rank of the gloo world on ``device_type`` (the card: all ranks on
    it): for each of A2A_MESHES of this world's size, :func:`a2a_shards`
    then :func:`a2a_calls`.  ``ref_stacks`` holds the parent's
    single-device stack gradients, shared through CUDA IPC (no copy); the
    rank empties it when done, releasing them to the parent."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_lib

    device = mesh_lib.rank_device(device_type)
    if device.type == "cuda":
        torch.cuda.init()
        torch.cuda.set_device(device)
        warm_cublas(device)
    out = []
    for shape in A2A_MESHES:
        if shape[0] * shape[1] != dist.get_world_size():
            continue
        mesh = mesh_lib.make_mesh(shape, ("data", "model"))
        base = torch.cuda.memory_allocated(device)
        cfg, x, w, ct = a2a_shards(device, mesh, fingerprint)
        out.append(a2a_calls(mesh, x, w, ct, top_k, device, base, cfg.expert_d_ff, ref_stacks))
        del x, w, ct
        torch.cuda.empty_cache()
    ref_stacks.clear()
    return out


def hold_a2a(label: str, ranks: list, ref: dict, shape, card: str) -> None:
    """The gates of phase 4o (b) on one mesh's ranks (see A2A_RTOL)."""
    n, M = shape
    by_coord = {r["coords"][0]: r for r in ranks if r["coords"][1] == 0}
    got = torch.cat([by_coord[d]["out"][8.0]["y"] for d in range(n)])
    want = ref["y"]
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    aux_want = ref["aux"][n]
    aux_err = max(abs(r["out"][8.0]["aux"] - aux_want) for r in ranks) / abs(aux_want)
    replicas = all(torch.equal(r["out"][8.0]["y"], by_coord[r["coords"][0]]["out"][8.0]["y"])
                   for r in ranks)
    drops = {}
    for cf in A2A_FACTORS[1:]:
        drops[cf] = []
        for r in ranks:
            o = r["out"][cf]
            counts = np.bincount(o["eidx"].ravel(), minlength=ref["E"])
            drops[cf].append((o["dropped"], int(np.maximum(counts - o["cap"], 0).sum())))
    dropping = sum(a for a, _ in drops[min(A2A_FACTORS)]) > 0
    gx = torch.cat([sum(r["grads"]["x"] for r in ranks if r["coords"][0] == d)
                    for d in range(n)])
    g_err = {k: float((g - ref["grads"][n][k]).abs().max())
             / float(ref["grads"][n][k].abs().max())
             for k, g in (("x", gx), ("router", sum(r["grads"]["router"] for r in ranks)))}
    for k in ("w1", "w3", "w2"):
        g_err[k] = max(r["grads"]["stacks"][k] for r in ranks)
    stack_bytes = [r["stack_bytes"] for r in ranks]
    cf = A2A_DEFAULT_CF
    log(f"phase 4o (b) {label}: each rank's expert shards {ranks[0]['shard_shapes']}, "
        f"{stack_bytes} B (the full stacks {ref['stack_bytes']} B / {n * M}: "
        f"{ref['stack_bytes'] // (n * M)}); cf 8 vs single-device moe_ffn: max_abs_err "
        f"{err!r} of max |out| {scale!r} (gate {A2A_RTOL} x), aux rel err {aux_err!r} (gate "
        f"{A2A_AUX_RTOL}), replicas along model equal={replicas}; dropped (device, host "
        f"recount) per rank by cf {drops}; at cf {cf}: ms per call "
        f"{[round(r['ms'], 3) for r in ranks]}; all-to-all ms "
        f"{[[round(t, 3) for t in r['a2a_ms']] for r in ranks]}, {ranks[0]['a2a_bytes']} B a "
        f"rank a call (cap_e {ranks[0]['out'][cf]['cap']}); device peak per rank above what it "
        f"held before drawing the layer {[r['peak'] for r in ranks]} B; gradients at cf 8 vs "
        f"single-device moe_ffn (the stacks' a rank's shard against its slice, the worst "
        f"rank): max_abs_err / max |grad| {g_err} (gate {A2A_GRAD_RTOL}), ms per forward + "
        f"backward {[round(r['grads']['ms'], 3) for r in ranks]} ({card})")
    if ranks[0]["busy"] is not None:
        b = ranks[0]["busy"]
        log(f"phase 4o (b) {label}: one profiled call at cf {cf}: device busy "
            f"{b['busy_ms']!r} ms of {ranks[0]['ms']!r} ({b['share']:.3f}), {b['kernels']} "
            f"kernels; by class {b['classes']}; top {b['top']} ({card})")
    if not (err <= A2A_RTOL * scale and aux_err <= A2A_AUX_RTOL and replicas
            and all(a == b for d in drops.values() for a, b in d) and dropping
            and all(e <= A2A_GRAD_RTOL for e in g_err.values())
            and stack_bytes == [ref["stack_bytes"] // (n * M)] * len(ranks)
            and bool(torch.isfinite(got.float()).all())):
        raise AssertionError(f"phase 4o (b) {label}: err {err}, aux {aux_err}, drops {drops}, "
                             f"gradients {g_err}, stack bytes {stack_bytes}")


def run_moe_a2a(device, card: str) -> dict:
    """Phase 4o (b): the single-device reference, a world of one over
    NCCL, then the gloo worlds of A2A_MESHES, each rank on its shards of
    the stacks; the single-device stack gradients stay on the card, shared
    with the ranks through CUDA IPC."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import common as cm

    torch.cuda.empty_cache()
    cfg, x, w, ct = a2a_layer(device)
    fingerprint = _fingerprint((x, ct) + w)
    y, aux = cm.moe_ffn(x, *w, top_k=cfg.top_k, capacity_factor=8.0)
    ref = dict(y=y.cpu(), E=cfg.n_experts, aux={1: float(aux)},
               stack_bytes=sum(t.numel() * t.element_size() for t in w[1:]),
               grads={n: a2a_grad_ref(x, w, ct, cfg.top_k, n, stacks=n == 1)
                      for n in sorted({1} | {s[0] for s in A2A_MESHES})})
    ref_stacks = ref["grads"][1].pop("stacks")
    for n in sorted({s[0] for s in A2A_MESHES}):
        b = A2A_B // n
        ref["aux"][n] = float(np.mean([float(cm.moe_ffn(x[d * b:(d + 1) * b], *w,
                                                        top_k=cfg.top_k,
                                                        capacity_factor=8.0)[1])
                                       for d in range(n)]))
    del y, x, w, ct
    log(f"phase 4o (b): {cfg.name}'s MoE layer (D {cfg.d_model}, F {cfg.expert_d_ff}, E "
        f"{cfg.n_experts}, top_k {cfg.top_k}, bfloat16), x ({A2A_B}, {A2A_S}, {cfg.d_model})")
    out = {}
    with mesh_lib.world_of_one("nccl" if device.type == "cuda" else "gloo"):
        mesh = mesh_lib.make_mesh((1, 1), ("data", "model"))
        torch.cuda.empty_cache()
        one_base = torch.cuda.memory_allocated(device)
        _, x, w, ct = a2a_shards(device, mesh, fingerprint)
        one = a2a_calls(mesh, x, w, ct, cfg.top_k, device, one_base, cfg.expert_d_ff,
                        ref_stacks, profile=device.type == "cuda")
        hold_a2a(f"world of one ({dist.get_backend()})", [one], ref, (1, 1), card)
        out[(1, 1)] = [one]
        del x, w, ct
    torch.cuda.empty_cache()
    for n in sorted({s[0] * s[1] for s in A2A_MESHES}):
        ranks = mesh_lib.run_world(n, a2a_rank, device.type, cfg.top_k, fingerprint,
                                   list(ref_stacks), backend="gloo",
                                   threads=None, timeout=900.0)
        for i, shape in enumerate(s for s in A2A_MESHES if s[0] * s[1] == n):
            rs = [r[i] for r in ranks]
            hold_a2a(f"mesh {shape} (gloo, CUDA tensors)", rs, ref, shape, card)
            out[shape] = rs
    del ref_stacks
    if device.type == "cuda":
        torch.cuda.ipc_collect()
    torch.cuda.empty_cache()
    return out


def run_last_modules(device, card: str) -> dict:
    t0 = time.perf_counter()
    rn = run_resnet(device, card)
    a2a = run_moe_a2a(device, card)
    log(f"phase 4o: {time.perf_counter() - t0:.3f} s ({card})")
    return dict(resnet=rn, a2a=a2a)


# ---------------------------------------------------------------------------
# phase 4p: the production dry run
# ---------------------------------------------------------------------------

# Phase 4p: the production dry run (repro_torch.launch.dryrun: the step
# traced as one rank of a fake world on fake CUDA tensors, its shardings
# propagated by DTensor, its counts and memory plan by
# launch/trace_analysis.py).  (a) A world of one: granite-3-2b's phase 4n
# step (B = TRAIN_B, S = TRAIN_S; remat and AdamW with bfloat16 moments,
# as the dry run builds the step) traced on the mesh (1, 1), then run for
# real: the predicted bytes_per_device (arguments + temporary peak +
# outputs) within DRY_MEM_RTOL of the real step's device peak above what
# the process held before its arguments, the trace's peak of live bytes
# within DRY_PEAK_RTOL of it, its matrix-product FLOPs within
# DRY_FLOPS_RTOL of FlopCounterMode over the real step (which cannot see
# the flash kernel: the kernel's FLOPs are the trace's kernel_flops,
# apart), and its recorded flash launches equal to the real step's launch
# count.  (b) DRY_COMBOS at train_4k under fsdp on the production mesh
# 16x16 (256 fake ranks): status ok, a rank's parameter bytes equal to the
# sharding's own arithmetic, and every recorded flash launch plan through
# analysis/launch_checks.py without an error.  Then DRY_A2A_ARCH at
# train_4k under the ep-a2a variant (the ep scheme with the all-to-all MoE,
# common.MOE_A2A_MESH on 16x16): status ok, a rank's routed-expert bytes
# equal to n_layers x 3 (E / 16) D (F / 16) x 2 B and to the sharding's
# arithmetic, no all-gather or all-reduce of an expert stack or a shard of
# one (dryrun.stack_collectives), every flash plan through the lint; its
# all-to-all bytes are printed beside E cap_e D 2 B an exchange.
DRY_MEM_RTOL = 0.15
DRY_PEAK_RTOL = 0.05
DRY_FLOPS_RTOL = 0.01
DRY_COMBOS = ("granite-3-2b", "kimi-k2-1t-a32b")
DRY_A2A_ARCH = "kimi-k2-1t-a32b"


def run_dry_world_of_one(device, card: str) -> dict:
    """Phase 4p (a): the dry run of phase 4n's step against the step."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.base import InputShape
    from repro_torch.configs.granite_3_2b import CONFIG
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun, train
    from repro_torch.launch.specs import make_batch
    from repro_torch.models import registry
    from repro_torch.optim import get

    cfg = CONFIG
    t0 = time.perf_counter()
    summ, meta = dryrun.trace_one(cfg, InputShape("phase 4n", TRAIN_S, TRAIN_B, "train"),
                                  (1, 1), "fsdp", device=device)
    trace_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(device)
    params = registry.init(cfg, torch.Generator(device=device).manual_seed(TRAIN_SEED),
                           device=device)
    batch = make_batch(cfg, TRAIN_B, TRAIN_S, seed=TRAIN_SEED, device=device)
    batch["labels"] = batch["tokens"]
    opt = get("adamw", state_dtype="bfloat16")
    state = opt.init(params)
    warm = train.train_step(cfg, opt, params, state, batch, dryrun.LR, remat=True)
    del warm
    _sync(device)
    torch.cuda.reset_peak_memory_stats(device)
    ops.reset_launches()
    with FlopCounterMode(display=False) as fc:
        loss, new, _ = train.train_step(cfg, opt, params, state, batch, dryrun.LR, remat=True)
    _sync(device)
    real = torch.cuda.max_memory_allocated(device) - base
    launches = ops.launches()["flash_attention"]
    flops = fc.get_total_flops()
    if not math.isfinite(float(loss)):
        raise AssertionError(f"phase 4p (a): loss {float(loss)}")
    del params, state, new, batch
    torch.cuda.empty_cache()
    mm = summ.dot_flops - summ.kernel_flops
    log(f"phase 4p (a): {cfg.name} train step B={TRAIN_B} S={TRAIN_S} on the mesh (1, 1), "
        f"traced on fake CUDA tensors in {trace_s:.3f} s ({summ.n_ops} ops): predicted "
        f"bytes_per_device {summ.bytes_per_device!r} B (arguments {summ.argument_bytes!r}, "
        f"temp {summ.temp_bytes!r}, outputs {summ.output_bytes!r}), peak of live bytes "
        f"{summ.peak_bytes!r}; the real step's peak above the process's {base} B: {real} B "
        f"(predicted / real {summ.bytes_per_device / real:.4f}, live peak / real "
        f"{summ.peak_bytes / real:.4f}); matrix-product FLOPs {mm!r} predicted, "
        f"FlopCounterMode {flops} (ratio {mm / flops:.6f}), flash kernel FLOPs "
        f"{summ.kernel_flops!r}; flash launches {len(meta['flash_plans'])} recorded, {launches} "
        f"launched ({card})")
    if abs(summ.bytes_per_device / real - 1) > DRY_MEM_RTOL:
        raise AssertionError(f"phase 4p (a): predicted {summ.bytes_per_device} B, the step "
                             f"took {real} B (tolerance {DRY_MEM_RTOL})")
    if abs(summ.peak_bytes / real - 1) > DRY_PEAK_RTOL:
        raise AssertionError(f"phase 4p (a): live peak {summ.peak_bytes} B, the step took "
                             f"{real} B (tolerance {DRY_PEAK_RTOL})")
    if abs(mm / flops - 1) > DRY_FLOPS_RTOL:
        raise AssertionError(f"phase 4p (a): {mm} FLOPs predicted, {flops} counted")
    if len(meta["flash_plans"]) != launches or launches != 2 * cfg.n_layers:
        raise AssertionError(f"phase 4p (a): {len(meta['flash_plans'])} flash launches "
                             f"recorded, {launches} made, {2 * cfg.n_layers} expected")
    return dict(predicted=summ.bytes_per_device, peak=summ.peak_bytes, real=real, flops=flops,
                predicted_flops=mm, launches=launches, trace_s=trace_s)


class _ProductionMesh:
    """The 16x16 ("data", "model") mesh's axis names and sizes."""

    axis_names = ("data", "model")
    shape = (16, 16)


def _spec_leaves(specs, shards):
    for k, v in specs.items():
        if isinstance(v, dict):
            yield from _spec_leaves(v, shards[k])
        else:
            yield v[0], shards[k]


def _expert_arithmetic(cfg, scheme: str) -> int:
    """A rank's bytes of the routed experts' stacks on 16x16 under
    ``scheme``, by the sharding's own arithmetic."""
    from repro_torch.launch import sharding as sh
    from repro_torch.models import registry

    specs, dtype = registry.param_layout(cfg)
    axes, mesh = registry.param_axes(cfg)["layers"], _ProductionMesh()
    return sum(math.prod(sh.local_shape(specs["layers"][k][0], sh.spec_for_param(
        axes[k], specs["layers"][k][0], mesh, scheme), mesh)) for k in ("w1", "w3", "w2")) \
        * torch.empty((), dtype=dtype).element_size()


def run_dry_a2a(card: str) -> dict:
    """Phase 4p (b), the all-to-all MoE: DRY_A2A_ARCH at train_4k under
    the ep-a2a variant (the ep scheme, ``common.MOE_A2A_MESH`` on 16x16)."""
    import tempfile

    from repro_torch.configs.registry import ARCHS
    from repro_torch.launch import dryrun
    from repro_torch.models import registry
    from repro_torch.models.moe_a2a import a2a_capacity

    arch, cfg = DRY_A2A_ARCH, ARCHS[DRY_A2A_ARCH]
    with tempfile.TemporaryDirectory() as tmp:
        r = dryrun.run_combo(arch, "train_4k", False, "ep", tmp, device="cuda", verbose=False,
                             variant="ep-a2a", moe_a2a=True)
    if r["status"] != "ok":
        raise AssertionError(f"phase 4p (b): {arch} train_4k ep-a2a 16x16: {r['error']}\n"
                             f"{r['traceback']}")
    n, M = _ProductionMesh.shape
    E, D, Fe = cfg.n_experts, cfg.d_model, cfg.expert_d_ff
    size = torch.empty((), dtype=registry.param_layout(cfg)[1]).element_size()
    want = cfg.n_layers * 3 * (E // n) * D * (Fe // M) * size
    by_sharding = _expert_arithmetic(cfg, "ep")
    T = 256 // n * 4096
    each = E * a2a_capacity(T, E, cfg.top_k, cfg.capacity_factor) * D * size
    a2a = {k: v for k, v in r["collective_shapes"].items() if k.startswith("all-to-all")}
    moved = r["collective_by_kind_gb"].get("all-to-all", 0.0) * 1e9
    count = r["collective_counts"].get("all-to-all", 0)
    errors = [f for f in r["launch_findings"] if f.startswith("[ERROR")]
    log(f"phase 4p (b): {arch} x train_4k (16x16, ep-a2a, fake CUDA): "
        f"{r['bytes_per_device'] / 1e9:.3f} GB a device (peak alive "
        f"{r['peak_bytes'] / 1e9:.3f} GB; parameters {r['param_bytes_per_device']!r} B, of "
        f"them routed experts {r['expert_param_bytes_per_device']!r} B, the arithmetic "
        f"{cfg.n_layers} x 3 x {E // n} x {D} x {Fe // M} x {size} = {want} B, the sharding's "
        f"{by_sharding} B), terms compute {r['compute_s'] * 1e3:.3f} ms, memory "
        f"{r['memory_s'] * 1e3:.3f} ms (unfused eager bytes), collective "
        f"{r['collective_s'] * 1e3:.3f} ms, bottleneck {r['bottleneck']}, useful "
        f"{r['useful_flops_ratio']:.4f}, collectives {r['collective_counts']} "
        f"({r['collective_by_kind_gb']} GB); all-to-all {count} x, {moved!r} B, "
        f"{moved / max(count, 1)!r} B each (predicted E cap_e D {size} = {each} B each, "
        f"{cfg.n_layers} layers x 6 (forward, remat recompute, backward; there and back) = "
        f"{cfg.n_layers * 6} x), by shape {a2a}; all-gathers and all-reduces of an expert "
        f"stack {r['stack_collectives'] or 'none'}; flash launches {r['flash_launches']} "
        f"(lint: {r['launch_findings'] or 'pass'}), replicated fallbacks {r['fallbacks']}, "
        f"traced in {r['compile_s']:.3f} s ({card})")
    if not (r["expert_param_bytes_per_device"] == want == by_sharding):
        raise AssertionError(f"phase 4p (b): {arch} ep-a2a: "
                             f"{r['expert_param_bytes_per_device']} routed-expert bytes a rank, "
                             f"the arithmetic says {want}, the sharding {by_sharding}")
    if r["stack_collectives"] or not count:
        raise AssertionError(f"phase 4p (b): {arch} ep-a2a: stack collectives "
                             f"{r['stack_collectives']}, {count} all-to-alls")
    if errors or not r["flash_launches"]:
        raise AssertionError(f"phase 4p (b): {arch} ep-a2a: {r['flash_launches']} flash "
                             f"launches, lint errors {errors}")
    return r


def run_dry_production(card: str) -> dict:
    """Phase 4p (b): the dry run at production scale on fake CUDA tensors."""
    import tempfile

    from repro_torch.configs.registry import ARCHS
    from repro_torch.launch import dryrun
    from repro_torch.launch import sharding as sh
    from repro_torch.models import registry

    out = {}
    for arch in DRY_COMBOS:
        with tempfile.TemporaryDirectory() as tmp:
            r = dryrun.run_combo(arch, "train_4k", False, "fsdp", tmp, device="cuda",
                                 verbose=False)
        if r["status"] != "ok":
            raise AssertionError(f"phase 4p (b): {arch} train_4k fsdp 16x16: {r['error']}\n"
                                 f"{r['traceback']}")
        cfg = ARCHS[arch]
        specs, dtype = registry.param_layout(cfg)
        mesh = _ProductionMesh()
        shards = sh.param_shardings(registry.param_axes(cfg), specs, mesh, "fsdp")
        want = sum(math.prod(sh.local_shape(shape, spec, mesh)) for shape, spec in
                   _spec_leaves(specs, shards)) * torch.empty((), dtype=dtype).element_size()
        errors = [f for f in r["launch_findings"] if f.startswith("[ERROR")]
        log(f"phase 4p (b): {arch} x train_4k (16x16, fsdp, fake CUDA): "
            f"{r['bytes_per_device'] / 1e9:.3f} GB a device (peak alive "
            f"{r['peak_bytes'] / 1e9:.3f} GB; parameters {r['param_bytes_per_device']!r} B, "
            f"the sharding's arithmetic {want} B), terms compute {r['compute_s'] * 1e3:.3f} "
            f"ms, memory {r['memory_s'] * 1e3:.3f} ms (unfused eager bytes), collective "
            f"{r['collective_s'] * 1e3:.3f} ms, bottleneck {r['bottleneck']}, useful "
            f"{r['useful_flops_ratio']:.4f}, collectives {r['collective_counts']}, flash "
            f"launches {r['flash_launches']} (lint: {r['launch_findings'] or 'pass'}), "
            f"replicated fallbacks {r['fallbacks']}, traced in {r['compile_s']:.3f} s ({card})")
        if r["param_bytes_per_device"] != want:
            raise AssertionError(f"phase 4p (b): {arch}: {r['param_bytes_per_device']} "
                                 f"parameter bytes a rank, the sharding says {want}")
        if errors or not r["flash_launches"]:
            raise AssertionError(f"phase 4p (b): {arch}: {r['flash_launches']} flash launches, "
                                 f"lint errors {errors}")
        out[arch] = r
    return out


def run_dry_run(device, card: str) -> dict:
    t0 = time.perf_counter()
    one = run_dry_world_of_one(device, card)
    prod = run_dry_production(card)
    prod["ep-a2a"] = run_dry_a2a(card)
    log(f"phase 4p: {time.perf_counter() - t0:.3f} s ({card})")
    return dict(one=one, production=prod)


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

    import tempfile

    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        rc = analysis_main(["--strict", "--json", os.path.join(d, "strict.json")])
        log(f"analysis: python -m repro_torch.analysis --strict (device cuda) exit {rc} in "
            f"{time.perf_counter() - t0:.3f} s")
        if rc != 0:
            raise AssertionError("the strict analysis pass found errors or warnings on the card")
        with open(os.path.join(d, "strict.json")) as f:
            strict = json.load(f)["findings"]

        ops.reset_launches()
        rc = analysis_main(["--selftest", "--json", os.path.join(d, "selftest.json")])
        torch.cuda.synchronize()
        launches = ops.launches()
        log(f"analysis: --selftest exit {rc}, launches {launches}")
        if rc != 0:
            raise AssertionError("the analyzer's selftest failed on the card")
        with open(os.path.join(d, "selftest.json")) as f:
            selftest = {x["subject"]: x for x in json.load(f)["findings"]
                        if x["pass_name"] == "selftest"}
    check_launches(launches, {"copy_vec4": 1, "scale": 1, "copy_smem": 1})
    # phase 4i (e): the active-set pass ran clean on its three variants, and
    # the selftest flagged the O(K) leak for its K-sized shape
    active = [x for x in strict if x["pass_name"] == "active"]
    leak = selftest.get("fixture/active-k-leak", {})
    clean = selftest.get("fixture/active-clean", {})
    log(f"analysis: active pass {[(x['level'], x['subject']) for x in active]}; "
        f"selftest: active-k-leak {leak.get('level')}: {leak.get('message', '')[:160]}; "
        f"active-clean {clean.get('level')}")
    if (len(active) != 3 or any(x["level"] != "ok" for x in active)
            or leak.get("level") != "ok" or "(193,)" not in leak.get("message", "")
            or clean.get("level") != "ok"):
        raise AssertionError("the active-set pass or its fixtures did not hold on the card")
    # phase 4j (e): the async pass ran clean on its five variants, reaching
    # the staleness hook where the decay is not 1, and the selftest flagged
    # the hook that computes its weights on the host
    asyn = [x for x in strict if x["pass_name"] == "async"]
    cb = selftest.get("fixture/async-staleness-callback", {})
    aclean = selftest.get("fixture/async-clean", {})
    log(f"analysis: async pass {[(x['level'], x['subject']) for x in asyn]}; selftest: "
        f"async-staleness-callback {cb.get('level')}: {cb.get('message', '')[:160]}; "
        f"async-clean {aclean.get('level')}")
    if (len(asyn) != 5 or any(x["level"] != "ok" for x in asyn)
            or sum("hook reached" in x["message"] for x in asyn) != 2
            or cb.get("level") != "ok" or aclean.get("level") != "ok"):
        raise AssertionError("the async pass or its fixture did not hold on the card")
    # phase 4k (d): the replication pass ran clean on its four variants (a
    # gloo world of two on the CPU), and the selftest flagged the carry
    # update keyed on a shard-local slice and passed its all-reduced twin
    rep = [x for x in strict if x["pass_name"] == "replication"]
    broken = selftest.get("fixture/broken-carry", {})
    fixed = selftest.get("fixture/fixed-carry", {})
    log(f"analysis: replication pass {[(x['level'], x['subject']) for x in rep]}; selftest: "
        f"broken-carry {broken.get('level')}: {broken.get('message', '')[:160]}; "
        f"fixed-carry {fixed.get('level')}")
    if (len(rep) != 4 or any(x["level"] != "ok" for x in rep)
            or broken.get("level") != "ok" or fixed.get("level") != "ok"):
        raise AssertionError("the replication pass or its fixtures did not hold")

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
    """``params`` with the q and k projections (whisper's cross-attention's
    too) of every family scaled by 1/8 (see WHISPER_SMALL_ATOL)."""
    for part in ("layers", "blocks", "encoder", "decoder"):
        for n in ("wq", "wk", "xwq", "xwk"):
            if n in params.get(part, {}):
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


def check_decode_cuda_vs_cpu() -> float:
    """Phase 5b: the reduced float32 whisper's decode on the card and on
    the CPU, DECODE_SMALL_S positions teacher-forced from the same tempered
    weights and cache, each step's logits to WHISPER_SMALL_ATOL."""
    from repro_torch.configs.whisper_large_v3 import CONFIG
    from repro_torch.launch.specs import make_batch
    from repro_torch.models import common as cm
    from repro_torch.models import registry, whisper

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = CONFIG.reduced()
    p = tempered(registry.init(cfg, torch.Generator().manual_seed(WHISPER_SEED), device="cpu"))
    batch = make_batch(cfg, 2, DECODE_SMALL_S, seed=WHISPER_SEED, device="cpu")
    outs = {}
    for dev in ("cpu", "cuda"):
        d = torch.device(dev)
        pd = cm.tree_map(lambda t: t.to(d), p)
        cache = registry.init_decode_cache(cfg, 2, DECODE_SMALL_S, device=d)
        cache["xk"], cache["xv"] = whisper.precompute_cross_kv(
            cfg, pd, whisper.encode(cfg, pd, batch["audio_embeds"].to(d)))
        logits = torch.empty(2, DECODE_SMALL_S, cfg.padded_vocab, device=d)
        _decode_steps(cfg, pd, cache, batch["tokens"].to(d),
                      torch.zeros((), dtype=torch.int64, device=d), logits)
        outs[dev] = logits.cpu()
    err = float((outs["cuda"] - outs["cpu"]).abs().max())
    log(f"whisper small ({cfg.name}, float32) decode, {DECODE_SMALL_S} positions, cuda vs "
        f"cpu: logits max_abs_err={err!r} (atol {WHISPER_SMALL_ATOL}), max |logit| "
        f"{float(outs['cpu'].abs().max())!r}")
    if not bool(torch.isfinite(outs["cuda"]).all()) or err > WHISPER_SMALL_ATOL:
        raise AssertionError(f"whisper small decode cuda vs cpu: err {err}")
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
            qt, kt, vt, is_causal=True)),
        shape=f"whisper-large-v3 decoder {(B, S, H, H, d)} bfloat16"))
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
    # 4i. the active-set engine: the slice's population, its kernels at the
    # gathered shapes, a million clients, restore
    run_active(dev, card)
    # 4j. the async engine: the synchronous regime against 4b, async traffic,
    # its kernels at staleness weights, restore with reports in flight
    run_async(dev, card, {"per-op": perop, "fused": fused})
    # 4k. the client-sharded engine: a world of one over NCCL against 4b,
    # worlds of 2 and 4 on the card over gloo, its kernels at their shapes
    run_shard(dev, card, {"per-op": perop, "fused": fused})
    # 4l. the paper's FL launcher, card vs CPU, its defaults, its configuration
    # on the device and async engines for 300 rounds
    la = run_launcher(dev, card)
    errs["era"] = max(errs["era"], la["errs"]["enhanced_era_fused"])
    errs["qdq"] = max(errs["qdq"], la["errs"]["quantize_dequantize"])
    # 4q. the jax key stream: the threefry kernel bit for bit at the path's
    # shapes, the slice on the jax stream card vs CPU, every engine's
    # ms/round under both streams
    ks = run_key_stream(dev, card)
    # 4c. whisper-large-v3 prefill at full width
    wh = run_whisper(dev)
    # 4d. the soft-label library's kernel seams at full width
    lib = run_library(dev, wh)
    # 4c-decode. whisper's KV-cache decode at full width against the prefill
    run_whisper_decode(dev, card, wh)
    del wh["logits"], wh["params"]
    # 4m. jamba-v0.1-52b (one block at full width) and mamba2-1.3b: prefill
    # through the flash kernel at d = 128, decode against the prefill
    ja = run_jamba(dev, card)
    run_jamba_decode(dev, card, ja)
    del ja["params"]
    run_mamba2(dev, card)
    # 4n. LM training: granite-3-2b at full width, the differentiable flash
    # Function, every family's step card vs CPU, the launcher's default
    tr = run_train(dev, card)
    # 4o. ResNet-20 card vs CPU; jamba's MoE layer through the all-to-all
    # dispatch on worlds of 1, 2 and 4
    run_last_modules(dev, card)
    # 4p. the production dry run: a world of one against the real step, and
    # granite-3-2b and kimi-k2-1t-a32b at train_4k on 256 fake ranks
    run_dry_run(dev, card)
    # 4e. the static analyzer on the card
    an = run_analysis(dev)
    # 5. card vs CPU on a small configuration, both engines
    check_small_cuda_vs_cpu("host")
    check_small_cuda_vs_cpu("scan")
    check_small_methods_cuda_vs_cpu()
    check_options_cuda_vs_cpu(opts["host loop"], tel["on"]["host loop"])
    # 5b. the reduced whisper prefill and decode, card vs CPU
    check_whisper_cuda_vs_cpu()
    check_decode_cuda_vs_cpu()
    # 5c. the reduced jamba and mamba2, card vs CPU
    check_reduced_hybrids_cuda_vs_cpu()
    # 6. kernel times and the kernel line: each kernel's launches from the
    # run of the path it serves (ERA and qdq: the host loop; fused_round:
    # the fused device engine; flash_attention: one whisper prefill;
    # enhanced_era and distill_loss: the library at full width; the
    # fixture kernels: the analyzer's selftest; flash_attention again at
    # jamba's shape: one jamba prefill)
    launches = dict(sl["launches"], fused_round=fused["launches"]["fused_round"],
                    flash_attention=wh["launches"]["flash_attention"],
                    enhanced_era=lib["launches"]["enhanced_era"],
                    distill_loss=lib["launches"]["distill_loss"],
                    **{k: an["launches"][k] for k in FIXTURE_REPLACES})
    kernels = kernel_report(launches, dict(errs, **an["errs"]))
    kernels.append(ja["flash"])
    kernels.append(tr["diff"]["flash"])
    # the threefry counter hash: no Pallas kernel stands behind it (the
    # reference's jax.random lowers to XLA's threefry2x32; its device
    # engine's round draw is the line named); launches from phase 4q's
    # fused device engine run on the jax stream; plain_ms on the host CPU
    kernels.append(dict(
        name="threefry", route="cuda", source="src/repro_torch/kernels/csrc/threefry.cu",
        replaces="src/repro/fl/scan_engine.py:107", launches=ks["launches"],
        max_abs_err=ks["max_abs_err"], ms=ks["ms"], plain_ms=ks["plain_ms"],
        bound_ms=ks["bound_ms"], bound_by=ks["bound_by"], library_ms=None))
    log(f"card: {card}; slice host loop {sl['per_round_ms']:.3f} ms/round, "
        f"device engine fused {fused['per_round_ms']:.3f}, "
        f"per-op {perop['per_round_ms']:.3f} ms/round; whisper-large-v3 prefill "
        f"({WHISPER_B},{WHISPER_S}) {wh['ms']:.3f} ms; jamba-v0.1-52b one-block prefill "
        f"({JAMBA_B},{JAMBA_S}) {ja['ms']:.3f} ms; granite-3-2b train_step ({TRAIN_B},{TRAIN_S}) "
        f"{tr['full']['ms']:.3f} ms")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
