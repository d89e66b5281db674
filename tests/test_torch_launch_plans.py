"""The port's launch plans and their lint, on the CPU (no card, nothing
launched).

Each kernel wrapper computes its launch in Python
(``repro_torch.kernels.*.launch_plan``) and the C launchers take it as it
is.  Here each module's plan, traced on fake CUDA tensors at the
reference's ``analysis_cases`` shapes and at the full-width shapes
``chip_smoke.py`` launches, is held against the grid, block and shared
memory that the C launchers derived for themselves before the plans
moved to Python, worked out by hand below:

- qdq: rows of n <= 32 values at a row stride ld <= 2n: a tile of 128
  rows a block (halved until it fits 48 KB), 128 threads, qdq_tile, grid
  ceil(rows / tile), shared memory 4 * (((tile - 1) * ld + n) rounded up
  to 4, + 4, + tile * n rounded up to 4, + 4) bytes; n <= 1024: a warp a
  row, 256 threads, grid ceil(rows / 8), kernel qdq_warp<V> with V the
  power of two of values a lane covering n; wider: 256 threads, a block a
  row, grid rows;
- era_fused: N <= 32 (the tile layout): 512 threads, a tile of the
  largest power of two of rows with at most 64 values, grid ceil(B /
  tile), G = min(K, 8) client subsets' sums of the tile's values in
  shared memory, 4 * G * tile * N bytes; N <= 12288 (the rows layout):
  128 threads, rpb = 1 if N >= 128 else 128 // N rows a block: grid
  ceil(B / rpb), rpb * N * 4 bytes of shared memory; above: the client
  mean, 256 threads with 4 elements each, grid ceil(B * N / 1024), then
  era_rows (below) over the (B, N) mean;
- era_rows: N <= 1024: 256 threads, a warp a row, grid ceil(B / 8);
  up to eight slices of 13312 values: a cluster of C blocks a row, the
  smallest C of 1, 2, 4, 8 whose slice (ceil(N / C) rounded up to 8) fits,
  grid B * C, a power of two near slice / 16 threads from 128 to
  1024 / C, 4 * (slice + 8) bytes of shared memory, opted in above 48 KB;
  above: 256 threads, a block a row, grid B;
- distill: 256 threads, a block a row: grid B;
- fused_round: a tile of rows a block, a thread a (client, row) pair:
  kc = min(256, K) clients a chunk, tile = max(1, 256 // kc) rows, both
  halved (tile first, kc down to min(K, 32)) until the block's shared
  memory fits 48 KB at the widest stride and table; threads kc * tile
  rounded up to 32, grid ceil(m / tile).  With outs = tile * N outputs
  and groups = max(1, threads // outs), shared memory is 8 * (outs +
  groups * outs) rounded up to 16 bytes (the sums) + 4 * kc * stride (the
  slab) + 4 * outs (base) + 4 * (levels + 1) for a 1- to 8-bit code (the
  table); stride is outs rounded up to 4 where every client's tile is
  16-byte aligned (m * N and tile * N multiples of 4: 16-byte copies),
  else outs | 1.  Where even one row and 32 clients do not fit (N > 331
  at K >= 32): 128 threads, a warp a row: grid ceil(m / 4);
- flash_attn, float32 (the tf32 Hopper kernel): a consumer warpgroup and
  a producer warp, 160 threads, grid (H * nb, B, ceil(Sq / 64)), D = 32
  output columns a block up to d = 32, else 64, nb = ceil(d / 64) column
  blocks past 64; 1024 bytes of alignment, S stages of 16 KB (S = 4 at D
  = 32, 3 at 64), 16 KB of low parts, v^T's two parts of 64 * D floats
  and 16 bytes a stage of mbarriers: 99392 / 99376 bytes at D = 32 / 64,
  opted in, two blocks a multiprocessor.
- flash_attn, bfloat16 (the Hopper kernel): a consumer warpgroup and
  a producer warp, 160 threads, grid (H, B, ceil(Sq / 64)); 1024 bytes of
  alignment, the q tile and 2 tiles a stage (2 * 64 * d bytes each) and 8
  bytes an mbarrier, at 4 stages for d = 32 and 2 otherwise:
  37960 / 42024 / 82984 bytes at d = 32 / 64 / 128.
- flash_attn, bfloat16, at other head dims d % 8 == 0: the instantiation
  D of 32, 64, 128 next at or above d, as above with D for d; past 128,
  nb = ceil(d / 128) column blocks: the column-block kernel, 160 threads,
  grid (H * nb, B, ceil(Sq / 64)), 1024 + 4 stages of two 8 KB boxes + 8
  mbarriers of 8 bytes = 66624 bytes.
- fixtures copy_smem: a block a (32, 128) tile, 256 threads, two tiles of
  shared memory; 16-byte copies (copy_smem_kernel<4>) where the columns,
  the tile's columns and the start are whole 16 bytes, else 4-byte ones.
"""
import ctypes

import pytest
import torch

from repro_torch.analysis import launch_checks
from repro_torch.analysis.traceutil import tensor_spec, trace
from repro_torch.kernels import (attn_kernel, distill_kernel, era_kernel, quant_kernel,
                                 round_kernel, runtime)

F32, BF16 = torch.float32, torch.bfloat16

# label -> (kernel, grid, block threads, dynamic shared memory, opt-in[, cluster]),
# or a list of them for a case of several launches
WANT = {
    "era/B1000-N10": ("era_rows_warp<float>", (125, 1, 1), 256, 0, False),
    "era/B10-N10": ("era_rows_warp<float>", (2, 1, 1), 256, 0, False),
    # tile 4, G 8: 4 * 8 * 40
    "era_fused/K200-B100-N10": ("era_fused_kernel", (25, 1, 1), 512, 1280, False),
    "era_fused/K1000-B1000-N100": ("era_fused_rows", (1000, 1, 1), 128, 400, False),
    "era_fused/K100-B1000-N10": ("era_fused_kernel", (250, 1, 1), 512, 1280, False),
    # G 1: 4 * 40
    "era_fused/K1-B9-N10": ("era_fused_kernel", (3, 1, 1), 512, 160, False),
    # tile 64, G 8 (a remainder of 5): 4 * 8 * 64
    "era_fused/K13-B37-N1": ("era_fused_kernel", (1, 1, 1), 512, 2048, False),
    # tile 16, G 7: 4 * 7 * 48
    "era_fused/K7-B33-N3": ("era_fused_kernel", (3, 1, 1), 512, 1344, False),
    "era_fused/K3-B33-N130": ("era_fused_rows", (33, 1, 1), 128, 520, False),
    "era_fused/K2-B3-N12288": ("era_fused_rows", (3, 1, 1), 128, 49152, False),
    # past 12288: the client mean (ceil(B * N / 1024) blocks of 256), then
    # era_rows at N (below)
    "era_fused/K2-B3-N12289": [("era_fused_mean", (37, 1, 1), 256, 0, False),
                               ("era_rows_onepass<float,1>", (3, 1, 1), 1024, 49216, True)],
    "era_fused/K8-B384-N51968": [("era_fused_mean", (19488, 1, 1), 256, 0, False),
                                 ("era_rows_onepass<float,4>", (1536, 1, 1), 256, 52000, True,
                                  (4, 1, 1))],
    "era_fused/K3-B5-N106497": [("era_fused_mean", (521, 1, 1), 256, 0, False),
                                ("era_rows_passes<float>", (5, 1, 1), 256, 0, False)],
    # 51968 classes: C = 4, slice 12992, 812 values / 16 -> 256 threads,
    # 4 * 13000 bytes
    "era/B1536-N51968": ("era_rows_onepass<float,4>", (6144, 1, 1), 256, 52000, True,
                         (4, 1, 1)),
    "era/B1536-N51968-bf16": ("era_rows_onepass<bf16,4>", (6144, 1, 1), 256, 52000, True,
                              (4, 1, 1)),
    # C = 1, slice 12296, 769 values / 16 -> 1024 threads, 4 * 12304 bytes
    "era/B64-N12289": ("era_rows_onepass<float,1>", (64, 1, 1), 1024, 49216, True),
    # C = 2, slice 10008, 512 threads, 4 * 10016 bytes
    "era/B9-N20001": ("era_rows_onepass<float,2>", (18, 1, 1), 512, 40064, False, (2, 1, 1)),
    # C = 8, slice 12504, 128 threads, 4 * 12512 bytes
    "era/B7-N100001-bf16": ("era_rows_onepass<bf16,8>", (56, 1, 1), 128, 50048, True,
                            (8, 1, 1)),
    "era/B3-N300001": ("era_rows_passes<float>", (3, 1, 1), 256, 0, False),
    "era/B1000-N10-beta-on-card": ("era_rows_warp<float>", (125, 1, 1), 256, 0, False),
    # 4 * (1280 + 4 + 1280 + 4)
    "quant/B1000-N10-bits8": ("qdq_tile", (8, 1, 1), 128, 10272, False),
    # 4 * (128 + 4 + 128 + 4)
    "quant/B10-N1-bits1": ("qdq_tile", (1, 1, 1), 128, 1056, False),
    # n 9 at ld 10: 4 * ((127 * 10 + 9 -> 1280) + 4 + 1152 + 4)
    "quant/residual-K100-M1000-N10-bits8": ("qdq_tile", (782, 1, 1), 128, 9760, False),
    "quant/B64-N130-bits8": ("qdq_warp<8>", (8, 1, 1), 256, 0, False),
    "quant/B16-N2000-bits8": ("qdq_block", (16, 1, 1), 256, 0, False),
    # kc 200, tile 1, 224 threads, 22 groups, 1-float copies (stride 11):
    # 8 * 230 + 4 * 200 * 11 + 40
    "round/identity-sharpen-K200": ("fused_round_tile<10>", (100, 1, 1), 224, 10680, False),
    # kc 256, tile 1, 25 groups: 8 * 260 + 4 * 256 * 11 + 40 + 4 * 256 (table)
    "round/quant8-sharpen-K1000": ("fused_round_tile<10>", (64, 1, 1), 256, 14408, False),
    # kc 50, tile 5, 5 groups: 8 * 300 + 4 * 50 * 51 + 200 + 4 * 256
    "round/delta8-linear-K50": ("fused_round_tile<10>", (5, 1, 1), 256, 13824, False),
    # kc 100, tile 2, 224 threads, 11 groups, 16-byte copies (stride 20):
    # 8 * 240 + 4 * 100 * 20 + 80 + 4 * 256
    "round/delta8-sharpen-K100-M1000-N10": ("fused_round_tile<10>", (500, 1, 1), 224, 11024,
                                            False),
    # kc 100 -> 50, tile 2 -> 1, 64 threads, 1 group: 8 * 260 + 4 * 50 * 131 + 520
    # + 4 * 256
    "round/quant8-sharpen-K100-M1001-N130": ("fused_round_tile<smem>", (1001, 1, 1), 64, 29824,
                                             False),
    "round/delta8-sharpen-K1000-M1000-N10": ("fused_round_tile<10>", (1000, 1, 1), 256, 14408,
                                             False),
    # 32 clients and one row of 700 classes need 92,608 bytes: the rows layout
    "round/identity-sharpen-K40-M3-N700": ("fused_round_rows", (1, 1, 1), 128, 0, False),
    "distill/B100-V163840": ("distill_kernel<float,float>", (100, 1, 1), 256, 0, False),
    "distill/B13-V1000-oddblocks": ("distill_kernel<float,float>", (13, 1, 1), 256, 0, False),
    "distill/B1536-V51968": ("distill_kernel<float,float>", (1536, 1, 1), 256, 0, False),
    "distill/B1536-V51968-bf16-teacher": ("distill_kernel<float,bf16>", (1536, 1, 1), 256, 0,
                                          False),
    "attn/S128-gqa-d64": ("flash_fwd_tf32_kernel<64>", (4, 2, 2), 160, 99376, True),
    "attn/small-Sq4": ("flash_fwd_tf32_kernel<64>", (2, 1, 1), 160, 99376, True),
    "attn/odd-S100-window": ("flash_fwd_tf32_kernel<64>", (2, 1, 2), 160, 99376, True),
    "attn/bf16-S64": ("flash_fwd_wgmma_kernel<64>", (2, 1, 1), 160, 42024, False),
    "attn/whisper-B4-S384-H20-d64-bf16": ("flash_fwd_wgmma_kernel<64>", (20, 4, 6), 160, 42024,
                                          False),
    # d = 128 in float32: two column blocks of 64
    "attn/S256-d128-f32": ("flash_fwd_tf32_kernel<64>", (8, 1, 4), 160, 99376, True),
    "attn/bf16-gqa-d32": ("flash_fwd_wgmma_kernel<32>", (4, 2, 3), 160, 37960, False),
    "attn/bf16-S2048-d128": ("flash_fwd_wgmma_kernel<128>", (4, 1, 32), 160, 82984, True),
    "attn/d96-f32": ("flash_fwd_tf32_kernel<64>", (8, 1, 3), 160, 99376, True),
    "attn/bf16-d96": ("flash_fwd_wgmma_kernel<128>", (4, 1, 3), 160, 82984, True),
    # column blocks on the head axis: H * 4 of 64 columns (f32), H * 2 of 128 (bf16)
    "attn/d256-f32": ("flash_fwd_tf32_kernel<64>", (8, 1, 4), 160, 99376, True),
    "attn/bf16-d256": ("flash_fwd_wgmma_cols_kernel<128>", (4, 1, 4), 160, 66624, True),
    "attn/f32-d8": ("flash_fwd_tf32_kernel<32>", (2, 1, 3), 160, 99392, True),
    "attn/f32-B4-S384-H20-d64": ("flash_fwd_tf32_kernel<64>", (20, 4, 6), 160, 99376, True),
    # three column blocks, the last's second box of v past d
    "attn/f32-d136-window": ("flash_fwd_tf32_kernel<64>", (12, 1, 4), 160, 99376, True),
    # threefry: 2^lanes_log2 threads a key (the count's power of two, at most
    # 256), the block's other threads on the next keys; grid y over chunks of
    # counts (at most 1024), at most 8192 blocks in all
    "threefry/fold-1x300": ("threefry_kernel<0>", (1, 2, 1), 256, 0, False),
    "threefry/split-300x2": ("threefry_kernel<0>", (3, 1, 1), 256, 0, False),
    "threefry/bits-300x10000": ("threefry_kernel<1>", (204, 40, 1), 256, 0, False),
    "threefry/bits-300x100": ("threefry_kernel<1>", (150, 1, 1), 256, 0, False),
    "threefry/uniform-300x1000": ("threefry_kernel<2>", (300, 4, 1), 256, 0, False),
    "threefry/split-1x1000001": ("threefry_kernel<0>", (1, 1024, 1), 256, 0, False),
    "threefry/bits-1x262144": ("threefry_kernel<1>", (1, 1024, 1), 256, 0, False),
}

CASES = {label: (fn, args) for label, fn, args in launch_checks.iter_cases()}


def test_every_module_case_has_a_worked_plan():
    assert set(CASES) == set(WANT)


def _want(label):
    want = WANT[label]
    return want if isinstance(want, list) else [want]


@pytest.mark.parametrize("label", sorted(WANT))
def test_plan_is_what_the_launcher_derived(label):
    fn, args = CASES[label]
    tr = trace(fn, *args)
    assert tr.ok, tr.error
    assert len(tr.launches) == len(_want(label))
    for launch, (kernel, grid, threads, smem, optin, *cluster) in zip(tr.launches, _want(label)):
        plan = launch.plan
        assert (plan.kernel, plan.grid, plan.block, plan.dyn_smem, plan.smem_optin,
                plan.cluster) == (kernel, grid, (threads, 1, 1), smem, optin,
                                  cluster[0] if cluster else (1, 1, 1))
        assert launch_checks.check_plan(label, plan) == []


@pytest.mark.parametrize("label", sorted(WANT))
def test_plan_operands_match_the_launch_arguments(label):
    """Each recorded launch passed one argument per operand of its plan,
    pointers for tensors: the recorder checks as ``runtime.launch`` does."""
    fn, args = CASES[label]
    tr = trace(fn, *args)
    assert len(tr.launches) == len(_want(label))
    for launch in tr.launches:
        ptrs = [op for op in launch.plan.operands if op.kind == "ptr"]
        assert ptrs and all(op.source in ("cuda tensor", "null") for op in ptrs)
        assert all(op.source == "python" for op in launch.plan.operands if op.kind == "value")


def test_era_fused_past_its_limit_is_refused_by_the_wrapper_and_the_lint():
    """One class past the row-block layout's limit: the row-block plan
    would be 4 bytes over 48 KB without opting in, and the lint refuses
    it; the wrapper takes the wide layout there instead (the client mean,
    then a cluster of one block a row of the per-row kernel, its slice
    opted in above 48 KB), whose plans the lint accepts."""
    fn, args = CASES["era_fused/K2-B3-N12289"]
    tr = trace(fn, *args)
    assert tr.ok, tr.error
    mean, rows = tr.launches
    assert (mean.lib, mean.plan.kernel) == ("era_fused", "era_fused_mean")
    assert (rows.lib, rows.plan.kernel) == ("era_rows", "era_rows_onepass<float,1>")
    assert rows.plan.smem_optin
    assert all(launch_checks.check_plan("N12289", x.plan) == [] for x in (mean, rows))
    # the row-block layout's own plan at that N
    n = era_kernel.MAX_CLASSES + 1
    rpb = era_kernel._fused_rows_per_block(n)
    plan = runtime.LaunchPlan("era_fused_rows", grid=(3, 1, 1),
                              block=(era_kernel.FUSED_THREADS, 1, 1), dyn_smem=rpb * n * 4)
    assert plan.dyn_smem == 49156 and not plan.smem_optin
    assert [f.level for f in launch_checks.check_plan("N12289", plan)] == ["error"]


@pytest.mark.parametrize("n,layout", [
    (1, ("tile", 1)), (10, ("tile", 1)), (32, ("tile", 1)), (33, ("rows", 1)),
    (12288, ("rows", 1)), (12289, ("onepass", 1)),
    (26624, ("onepass", 2)), (26625, ("onepass", 4)), (51968, ("onepass", 4)),
    (106496, ("onepass", 8)), (106497, ("passes", 1)), (10 ** 6, ("passes", 1)),
])
def test_era_fused_layout_takes_every_class_count(n, layout):
    """No N >= 1 is refused: each takes a layout chosen from N alone."""
    assert era_kernel.fused_layout(n) == layout
    tr = trace(lambda z: era_kernel.enhanced_era_fused(z, 1.5), tensor_spec((2, 3, n)))
    assert tr.ok, tr.error
    assert [x.lib for x in tr.launches] == (["era_fused"] if layout[0] in ("tile", "rows")
                                             else ["era_fused", "era_rows"])
    assert all(launch_checks.check_plan(f"N{n}", x.plan) == [] for x in tr.launches)


@pytest.mark.parametrize("n,ld,want", [
    (9, 10, ("tile", 128, 0)), (1, 1, ("tile", 128, 0)), (32, 64, ("tile", 128, 0)),
    (9, 19, ("warp", 0, 1)), (33, 33, ("warp", 0, 2)), (130, 130, ("warp", 0, 8)),
    (1024, 1024, ("warp", 0, 32)), (1025, 1025, ("block", 0, 0)),
])
def test_quant_layout_from_n_and_row_stride(n, ld, want):
    assert quant_kernel.layout(n, ld) == want
    if want[0] == "tile":
        assert quant_kernel.tile_smem(want[1], n, ld) <= runtime.HOPPER.smem_per_block


def test_flash_opts_in_exactly_above_48kb():
    """float32: every plan opts in (its stages, low parts and v^T take
    about 97 KB at every d) and leaves room for a second block on a
    multiprocessor (no lint warning)."""
    for d, dv in ((32, 32), (64, 64), (128, 64)):
        tr = trace(lambda q: attn_kernel.flash_attention(q, q, q),
                   tensor_spec((1, 64, 2, d)))
        plan = tr.launches[0].plan
        stages = attn_kernel.F32_STAGES[dv]
        assert plan.dyn_smem == 1024 + 16384 * (stages + 1) + 2 * 4 * 64 * dv + 16 * stages
        assert plan.smem_optin is (plan.dyn_smem > 48 * 1024) is True
        assert plan.dyn_smem <= runtime.HOPPER.smem_per_sm // 2
        assert launch_checks.check_plan(f"d{d}", plan) == []


def test_flash_bf16_plan_reads_pairs_and_copies_a_misaligned_view():
    """A bf16 view 2 bytes off a 16-byte boundary is copied by the wrapper
    (``_readable``), so the plan the kernel gets is aligned for TMA's
    16-byte accesses."""
    def fn(base):
        n = 1 * 128 * 2 * 64
        q = base.narrow(0, 1, n).view(1, 128, 2, 64)
        return attn_kernel.flash_attention(q, q, q)

    tr = trace(fn, tensor_spec((1 + 1 * 128 * 2 * 64,), BF16))
    plan = tr.launches[0].plan
    q_op = plan.operands[0]
    assert (q_op.vector_bytes, q_op.storage_offset) == (16, 0)
    assert launch_checks.check_plan("bf16", plan) == []


@pytest.mark.parametrize("d,optin", [(32, False), (64, False), (128, True)])
def test_flash_bf16_plan_shared_memory_fits_hopper(d, optin):
    """The Hopper kernel's q tile, stage ring and barriers fit a block's
    opt-in limit and leave room for a second block on a multiprocessor (no
    lint warning); the plan opts in exactly above 48 KB."""
    tr = trace(lambda q: attn_kernel.flash_attention(q, q, q), tensor_spec((1, 64, 2, d), BF16))
    plan = tr.launches[0].plan
    stages = attn_kernel.STAGES[d]
    assert plan.dyn_smem == attn_kernel.smem_bytes(BF16, d) == (
        1024 + 2 * 64 * d * (1 + 2 * stages) + 8 * (1 + 2 * stages))
    assert plan.dyn_smem <= runtime.HOPPER.smem_per_sm // 2
    assert plan.smem_optin is optin is (plan.dyn_smem > runtime.HOPPER.smem_per_block)
    assert launch_checks.check_plan(f"d{d}", plan) == []


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("d", [8, 16, 24, 40, 48, 56, 72, 96, 120, 136, 192, 256, 384, 520])
def test_flash_plans_for_every_head_dim_pass_the_lint(d, dtype):
    """Every d % 8 == 0 gets a plan (no head dim the routing admits is
    refused): the instantiation next at or above d, or past the largest
    column blocks on the head axis (bf16: 128 columns past 128; float32:
    64 past 64); each fits the card."""
    tr = trace(lambda q: attn_kernel.flash_attention(q, q, q), tensor_spec((2, 130, 3, d), dtype))
    assert tr.ok, tr.error
    plan = tr.launches[0].plan
    D = attn_kernel.instantiation(d, dtype)
    if dtype == F32:
        nb = -(-d // 64) if d > 64 else 1
        assert D == next((x for x in (32, 64) if d <= x), 0)
        assert plan.kernel == f"flash_fwd_tf32_kernel<{D or 64}>"
    else:
        nb = -(-d // 128) if d > 128 else 1
        assert D == next((x for x in (32, 64, 128) if d <= x), 0)
        assert plan.kernel == (f"flash_fwd_wgmma_kernel<{D}>" if D else
                               "flash_fwd_wgmma_cols_kernel<128>")
    assert plan.grid == (3 * nb, 2, 3)
    assert plan.dyn_smem == attn_kernel.smem_bytes(dtype, d)
    assert launch_checks.check_plan(f"d{d}", plan) == []


@pytest.mark.parametrize("d", [0, 4, 44, 100])
def test_flash_refuses_head_dims_off_multiples_of_8(d):
    tr = trace(lambda q: attn_kernel.flash_attention(q, q, q), tensor_spec((1, 64, 2, d)))
    assert isinstance(tr.error, ValueError) and not tr.launches


@pytest.mark.parametrize("row,offset,in_place", [
    (64, 0, True),    # contiguous
    (72, 0, True),    # head stride 144 bytes: a multiple of 16
    (68, 0, False),   # head stride 136 bytes
    (64, 4, False),   # 8 bytes off a 16-byte boundary
    (64, 8, True),    # 16 bytes off: aligned
    (0, 0, False),    # batch and sequence expanded from one row (stride 0)
])
def test_flash_bf16_reads_only_tma_aligned_views_in_place(row, offset, in_place):
    """TMA needs a 16-byte aligned start and strides that are multiples of
    16 bytes: a bf16 view that breaks either is copied to a contiguous
    tensor before the launch, any other is read in place."""
    n = 2 * 64 * 2 * max(row, 64)

    def fn(base):
        if row == 0:
            q = base.narrow(0, 0, 2 * 64).view(1, 1, 2, 64).expand(2, 64, 2, 64)
        else:
            q = base.narrow(0, offset, n).view(2, 64, 2, row)[..., :64]
        return attn_kernel.flash_attention(q, q, q)

    tr = trace(fn, tensor_spec((n + offset,), BF16))
    q_op = tr.launches[0].plan.operands[0]
    want = ((64 * 2 * row, 2 * row, row), offset) if in_place else ((64 * 2 * 64, 2 * 64, 64), 0)
    assert (q_op.strides[:3], q_op.storage_offset) == want
    assert launch_checks.check_plan("bf16", tr.launches[0].plan) == []


@pytest.mark.parametrize("row,offset,in_place", [
    (64, 0, True),    # contiguous
    (68, 0, True),    # head stride 272 bytes: a multiple of 16
    (66, 0, False),   # head stride 264 bytes
    (64, 2, False),   # 8 bytes off a 16-byte boundary
    (64, 4, True),    # 16 bytes off: aligned
])
def test_flash_f32_reads_only_tma_aligned_views_in_place(row, offset, in_place):
    """The float32 kernel reads through TMA too: a view off a 16-byte start
    or with a stride that is not a multiple of 16 bytes is copied, any
    other read in place."""
    n = 2 * 64 * 2 * row

    def fn(base):
        q = base.narrow(0, offset, n).view(2, 64, 2, row)[..., :64]
        return attn_kernel.flash_attention(q, q, q)

    tr = trace(fn, tensor_spec((n + offset,)))
    plan = tr.launches[0].plan
    q_op = plan.operands[0]
    want = ((64 * 2 * row, 2 * row, row), offset) if in_place else ((64 * 2 * 64, 2 * 64, 64), 0)
    assert (q_op.strides[:3], q_op.storage_offset, q_op.vector_bytes) == want + (16,)
    assert launch_checks.check_plan("f32", plan) == []


def test_quant_plan_reads_the_residual_view_in_place():
    tr = trace(lambda z, b: quant_kernel.quantize_dequantize((z - b)[..., :-1], 8),
               tensor_spec((7, 33, 10)), tensor_spec((33, 10)))
    z_op = tr.launches[0].plan.operands[0]
    assert z_op.shape == (7 * 33, 9) and z_op.strides == (10, 1)


def test_era_rows_beta_on_the_card_goes_by_pointer():
    tr = trace(lambda z, b: era_kernel.enhanced_era(z, b), tensor_spec((10, 10)),
               tensor_spec(()))
    ops = {op.name: op for op in tr.launches[0].plan.operands}
    assert ops["beta_ptr"].source == "cuda tensor" and ops["beta"].source == "python"
    assert tr.host_reads == []


def test_era_fused_wide_beta_on_the_card_goes_by_pointer():
    """Past the row-block layout the per-row kernel sharpens, and reads a
    card tensor's beta on the card: no host read."""
    tr = trace(lambda z, b: era_kernel.enhanced_era_fused(z, b), tensor_spec((2, 3, 12289)),
               tensor_spec(()))
    ops = {op.name: op for op in tr.launches[1].plan.operands}
    assert ops["beta_ptr"].source == "cuda tensor" and ops["beta"].source == "python"
    assert tr.host_reads == []


def test_fused_round_beta_read_from_the_card_is_an_error():
    """beta as a CUDA tensor goes through ``float()`` (the kernel takes it
    by value): a host read the trace records and the lint reports."""
    tr = trace(lambda z, w, b: round_kernel.fused_round(z, w, b), tensor_spec((4, 8, 10)),
               tensor_spec((4,)), tensor_spec(()))
    assert tr.host_reads
    levels = [f.level for f in launch_checks.check_plan("beta", tr.launches[0].plan)]
    assert levels == ["error"]


def _plan(**kw):
    base = dict(kernel="k", grid=(1, 1, 1), block=(128, 1, 1))
    base.update(kw)
    return runtime.LaunchPlan(**base)


def _ptr(shape, strides, offset=0, vb=4, itemsize=4):
    return runtime.Operand("x", "ptr", dtype="float32", shape=shape, strides=strides,
                           storage_offset=offset, vector_bytes=vb, source="cuda tensor",
                           itemsize=itemsize)


@pytest.mark.parametrize("plan,want", [
    (_plan(), []),
    (_plan(block=(2048, 1, 1)), ["error", "error"]),
    (_plan(block=(32, 32, 2)), ["error"]),
    (_plan(block=(1, 1, 128)), ["error"]),
    (_plan(grid=(1, 65536, 1)), ["error"]),
    (_plan(grid=(2 ** 31, 1, 1)), ["error"]),
    (_plan(grid=(0, 1, 1)), ["error"]),
    (_plan(block=(100, 1, 1)), ["warn"]),
    (_plan(dyn_smem=48 * 1024), []),
    (_plan(dyn_smem=48 * 1024 + 4), ["error"]),
    (_plan(dyn_smem=100 * 1024, smem_optin=True), []),
    (_plan(dyn_smem=120 * 1024, smem_optin=True), ["warn"]),
    (_plan(dyn_smem=232448, smem_optin=True), ["warn"]),
    (_plan(dyn_smem=232452, smem_optin=True), ["error"]),
    (_plan(operands=(_ptr((100, 128), (128, 1), 0, 16),)), []),
    (_plan(operands=(_ptr((100, 128), (128, 1), 1, 16),)), ["error"]),
    (_plan(operands=(_ptr((100, 130), (130, 1), 0, 16),)), ["error"]),
    (_plan(operands=(_ptr((100, 128), (129, 1), 0, 16),)), ["error"]),
    (_plan(operands=(_ptr((100, 128), (1, 100), 0, 16),)), ["error"]),
    (_plan(operands=(_ptr((1, 128), (7, 1), 0, 16),)), []),
    (_plan(operands=(_ptr((4, 64), (65, 1), 0, 4, 2),)), ["error"]),
    (_plan(operands=(_ptr((4, 64), (66, 1), 1, 4, 2),)), ["error"]),
    (_plan(operands=(_ptr((4, 64), (66, 1), 2, 4, 2),)), []),
    (_plan(operands=(runtime.Operand("x", "ptr", source="null"),)), []),
    (_plan(operands=(runtime.value("s", ctypes.c_float),)), []),
    (_plan(operands=(runtime.value("s", ctypes.c_float, "cpu tensor"),)), []),
    (_plan(operands=(runtime.value("s", ctypes.c_float, "cuda tensor"),)), ["error"]),
    (_plan(grid=(8, 1, 1), cluster=(2, 1, 1)), []),
    (_plan(grid=(16, 2, 1), cluster=(4, 2, 1)), []),
    (_plan(grid=(16, 1, 1), cluster=(16, 1, 1)), ["error"]),
    (_plan(grid=(16, 4, 1), cluster=(4, 4, 1)), ["error"]),
    (_plan(grid=(6, 1, 1), cluster=(4, 1, 1)), ["error"]),
    (_plan(grid=(8, 3, 1), cluster=(2, 2, 1)), ["error"]),
    (_plan(cluster=(0, 1, 1)), ["error"]),
])
def test_check_plan_levels(plan, want):
    assert [f.level for f in launch_checks.check_plan("p", plan)] == want


@pytest.mark.parametrize("attrs,want", [
    (dict(numRegs=32, localSizeBytes=0, sharedSizeBytes=0, maxThreadsPerBlock=1024), []),
    (dict(numRegs=255, localSizeBytes=0, sharedSizeBytes=0, maxThreadsPerBlock=1024),
     ["error"]),
    (dict(numRegs=32, localSizeBytes=0, sharedSizeBytes=0, maxThreadsPerBlock=256), ["error"]),
    (dict(numRegs=32, localSizeBytes=8, sharedSizeBytes=0, maxThreadsPerBlock=1024), ["warn"]),
    (dict(numRegs=32, localSizeBytes=0, sharedSizeBytes=16 * 1024, maxThreadsPerBlock=1024),
     ["error"]),
])
def test_check_plan_against_compiled_attributes(attrs, want):
    """512 threads with 40 KB of dynamic shared memory, held against a
    compiled kernel's registers (255 x 512 is past a block's 65536), thread
    limit, spills and static shared memory (static + dynamic past 48 KB
    without opting in)."""
    plan = _plan(block=(512, 1, 1), dyn_smem=40 * 1024)
    assert [f.level for f in launch_checks.check_plan("p", plan, attrs=attrs)] == want


def test_check_launches_reads_attributes_by_library_and_kernel():
    seen = []

    def attrs(lib, kernel):
        seen.append((lib, kernel))
        return dict(numRegs=30, localSizeBytes=0, sharedSizeBytes=0, maxThreadsPerBlock=1024)

    got = launch_checks.run(modules=("repro_torch.kernels.quant_kernel",), attrs=attrs)
    assert [f.level for f in got] == ["ok"] * 5
    assert seen == [("qdq", "qdq_tile"), ("qdq", "qdq_tile"), ("qdq", "qdq_tile"),
                    ("qdq", "qdq_warp<8>"), ("qdq", "qdq_block")]
    assert "30 registers" in got[0].message


def test_hopper_limits_are_the_compute_capability_9_table():
    h = runtime.HOPPER
    assert (h.max_threads_per_block, h.max_block, h.max_grid) == (
        1024, (1024, 1024, 64), (2 ** 31 - 1, 65535, 65535))
    assert (h.smem_per_block, h.smem_per_block_optin, h.smem_per_sm) == (
        49152, 232448, 233472)
    assert (h.regs_per_block, h.regs_per_sm, h.max_regs_per_thread, h.warp_size) == (
        65536, 65536, 255, 32)
    assert h.max_cluster_blocks == 8


def test_launch_checks_its_arguments_against_the_plan():
    plan = _plan(operands=(runtime.value("n", ctypes.c_int),))
    with pytest.raises(ValueError, match="arguments"):
        runtime.check_operands("f", plan, ())
    with pytest.raises(TypeError):
        runtime.check_operands("f", plan, (3,))
    with pytest.raises(ValueError, match="CUDA"):
        runtime.check_operands("f", plan, (ctypes.c_int(3),))
    ptr_plan = _plan(operands=(_ptr((4,), (1,)),))
    with pytest.raises(ValueError, match="CUDA"):
        runtime.check_operands("f", ptr_plan, (torch.zeros(4),))


def test_wrappers_on_cpu_tensors_make_no_plan(monkeypatch):
    """The CPU path is the plain version: no plan, no launch."""
    def boom(*a):
        raise AssertionError("launched")

    monkeypatch.setattr(runtime, "launch", boom)
    z = torch.rand(3, 4, 10)
    era_kernel.enhanced_era_fused(z, 1.5)
    quant_kernel.quantize_dequantize(z, 8)
    round_kernel.fused_round(z, torch.ones(3), 1.5)
    era_kernel.enhanced_era(z[0], 1.5)
    distill_kernel.distill_loss(z[0], z[1])
    attn_kernel.flash_attention(torch.rand(1, 8, 2, 32), *(torch.rand(1, 8, 2, 32),) * 2)
