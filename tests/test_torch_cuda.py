"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: without a CUDA device every test here skips (the CUDA
kernels have no CPU mode).  On a machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: as ``chip_smoke.py`` states them, atol 1e-6 for the ERA and
qdq kernels and zero quantization level flips; the fused round atol 1e-6
on probabilities and 2e-6 * sum|w| on its linear moment (a weighted sum
of up to K values in [0, 1], rounded in other orders on the two sides);
flash attention atol 1e-5 in float32 (three tf32 products a product) and
one bfloat16 step in bfloat16;
per-row Enhanced ERA atol 1e-6 in float32, and in bfloat16 bit for bit the
float32 kernel's result rounded once; the distillation loss 1e-5 of each
row's magnitude ``|lse| * |sum t| + sum |t * l|`` (float32 sums of V terms
in two orders); top-k's indices on the card equal the CPU's (a stable
sort on both), its decoded rows to atol 1e-6 (the simplex projection's
row sum runs in another order on the card); the threefry counter hash
bit for bit, and the jax key stream's functions on the card equal to the
CPU's bit for bit (``normal`` to 1e-6: the devices' float32 ``log1p`` may
differ in the last bit).
"""
import numpy as np
import pytest
import torch

import repro_torch.fl as pfl
from repro_torch.core import era as pera
from repro_torch.core import prng
from repro_torch.core import losses as plosses
from repro_torch.kernels import (attn_kernel, distill_kernel, era_kernel, fixture_kernel, ops,
                                 quant_kernel, round_kernel, runtime)

pytestmark = pytest.mark.cuda

ATOL = 1e-6


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _probs(seed, shape, dev):
    rng = np.random.default_rng(seed)
    z = rng.dirichlet(np.ones(shape[-1]), size=int(np.prod(shape[:-1])))
    return torch.from_numpy(z.astype(np.float32).reshape(shape)).to(dev)


# The fused ERA kernel's layouts: a tile of rows a block with the clients
# staged in shared memory (N <= 32: the slice's 10; K = 7 and 1000, whose
# client subsets of 8 have a remainder, K = 1000 also over three chunks of
# the slab; N = 1), rows of a block (N <= 12288); past it the client mean,
# then the per-row kernel's row over a cluster of 1 (12289), 2 (20001), 4
# (32000, 51968) and 8 (100001) blocks, and its multi-pass layout past
# eight slices (106497).
ERA_FUSED_SHAPES = [(1, 9, 10), (100, 1000, 10), (7, 333, 10), (1000, 1000, 10), (3, 33, 130),
                    (5, 7, 1), (2, 3, 4000), (4, 33, 12289), (2, 9, 20001), (100, 3, 32000),
                    (8, 16, 51968), (3, 5, 100001), (3, 5, 106497)]


@pytest.mark.parametrize("K,B,N", ERA_FUSED_SHAPES)
@pytest.mark.parametrize("beta", [0.5, 1.5, 4.0])
def test_era_kernel_matches_plain(dev, K, B, N, beta):
    z = _probs(K + B + N, (K, B, N), dev)
    ops.reset_launches()
    got = era_kernel.enhanced_era_fused(z, beta)
    torch.cuda.synchronize()
    assert ops.launches()["enhanced_era_fused"] == 1
    want = era_kernel.enhanced_era_fused_plain(z, beta)
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("K,B,N", [(100, 1000, 10), (7, 333, 10), (1000, 1000, 10),
                                   (3, 33, 130), (4, 33, 12289), (2, 9, 20001),
                                   (8, 16, 51968), (3, 5, 100001), (3, 5, 106497)])
def test_era_kernel_is_deterministic_and_row_split_invariant(dev, K, B, N):
    """Two launches give the same bits, and rows computed in two launches
    equal the same rows of one: the layout depends on N alone."""
    z = _probs(K * B + N, (K, B, N), dev)
    one = era_kernel.enhanced_era_fused(z, 1.5)
    assert torch.equal(one, era_kernel.enhanced_era_fused(z, 1.5))
    k = (B // 2) | 1
    two = torch.cat([era_kernel.enhanced_era_fused(z[:, :k], 1.5),
                     era_kernel.enhanced_era_fused(z[:, k:], 1.5)])
    assert torch.equal(one, two)


@pytest.mark.parametrize("bits", [1, 4, 8])
def test_qdq_kernel_matches_plain_on_residual_view(dev, bits):
    z = _probs(bits, (20, 300, 10), dev)
    base = _probs(bits + 1, (300, 10), dev)
    r = (z - base)[..., :-1]
    ops.reset_launches()
    got = quant_kernel.quantize_dequantize(r, bits)
    torch.cuda.synchronize()
    assert ops.launches()["quantize_dequantize"] == 1
    want = quant_kernel.quantize_dequantize_plain(r, bits)
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
    levels = 2 ** bits - 1
    scale = torch.clamp_min(r.amax(-1, keepdim=True) - r.amin(-1, keepdim=True), 1e-9)
    assert int(((got - want).abs() >= 0.5 * scale / levels).sum()) == 0


# The qdq kernel's layouts: a thread a row on staged tiles (N <= 32 at row
# strides up to 2N), a warp a row (N = 130), a block a row (N = 2000).
@pytest.mark.parametrize("rows,N", [(100000, 9), (1001, 10), (37, 1), (4097, 32), (513, 130),
                                    (33, 2000)])
@pytest.mark.parametrize("bits", [1, 4, 8])
def test_qdq_kernel_matches_plain_in_every_layout(dev, rows, N, bits):
    z = _probs(rows + N + bits, (rows, N), dev) - 0.5 / N
    ops.reset_launches()
    got = quant_kernel.quantize_dequantize(z, bits)
    torch.cuda.synchronize()
    assert ops.launches()["quantize_dequantize"] == 1
    want = quant_kernel.quantize_dequantize_plain(z, bits)
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
    levels = 2 ** bits - 1
    scale = torch.clamp_min(z.amax(-1, keepdim=True) - z.amin(-1, keepdim=True), 1e-9)
    assert int(((got - want).abs() >= 0.5 * scale / levels).sum()) == 0


@pytest.mark.parametrize("rows,N", [(100000, 9), (513, 130), (33, 2000)])
def test_qdq_kernel_is_deterministic_row_split_and_layout_invariant(dev, rows, N):
    """Two launches, rows split over two launches (the second tile starting
    off a 16-byte boundary), and the same rows read through a sparse row
    stride (another layout) give the same bits."""
    z = _probs(rows * N, (rows, N), dev)
    one = quant_kernel.quantize_dequantize(z, 8)
    assert torch.equal(one, quant_kernel.quantize_dequantize(z, 8))
    k = (rows // 2) | 1
    two = torch.cat([quant_kernel.quantize_dequantize(z[:k], 8),
                     quant_kernel.quantize_dequantize(z[k:], 8)])
    assert torch.equal(one, two)
    sparse = torch.zeros(rows, 3 * N + 1, device=dev)
    sparse[:, 1:N + 1] = z
    assert torch.equal(one, quant_kernel.quantize_dequantize(sparse[:, 1:N + 1], 8))


def test_kernels_reject_wrong_dtype(dev):
    with pytest.raises(TypeError):
        era_kernel.enhanced_era_fused(torch.ones(2, 3, 4, device=dev,
                                                 dtype=torch.float64), 1.5)
    with pytest.raises(TypeError):
        quant_kernel.quantize_dequantize(torch.ones(3, 4, device=dev,
                                                    dtype=torch.float16), 8)


# The tile layout with the class row in registers (N <= 16) and in the slab
# (N = 130, 400), one chunk of all K clients and several (1000 clients:
# four chunks of 256; 300 at N = 130: five of 64), one row (m = 1), and
# the rows layout (N = 700).
ROUND_SHAPES = [(1, 1, 2), (7, 1001, 10), (100, 1000, 10), (3, 40, 130), (1000, 64, 10),
                (150, 1, 10), (300, 7, 130), (7, 5, 400), (40, 3, 700)]


@pytest.mark.parametrize("mode,bits", [("identity", None), ("quant", 8), ("quant", 1),
                                       ("delta", None), ("delta", 8)])
@pytest.mark.parametrize("K,m,N", ROUND_SHAPES)
def test_fused_round_kernel_matches_plain(dev, mode, bits, K, m, N):
    rng = np.random.default_rng(K + m + N)
    z = _probs(K * m, (K, m, N), dev)
    part = (rng.random(K) < 0.6).astype(np.float32)
    part[0] = 1.0
    w = torch.from_numpy(part * np.float32(K / part.sum())).to(dev)
    base = _probs(m, (m, N), dev) if mode == "delta" else None
    for sharpen, beta in [(False, None), (True, 0.5), (True, 1.5), (True, 4.0)]:
        ops.reset_launches()
        kw = dict(mode=mode, bits=bits, sharpen=sharpen)
        got = round_kernel.fused_round(z, w, beta, base, **kw)
        torch.cuda.synchronize()
        assert ops.launches()["fused_round"] == 1
        want = round_kernel.fused_round_plain(z, w, beta, base, **kw)
        atol = ATOL if sharpen else 2e-6 * float(w.sum())
        torch.testing.assert_close(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("K,m,N", [(100, 1000, 10), (1000, 64, 10), (300, 7, 130),
                                   (7, 5, 400), (40, 3, 700)])
def test_fused_round_kernel_is_deterministic_and_row_split_invariant(dev, K, m, N):
    """Two launches give the same bits, and rows computed in two launches
    (the first k rows, then the rest) equal the same rows of one launch:
    the client sum's order depends on K and N alone."""
    z = _probs(K + m, (K, m, N), dev)
    w = torch.from_numpy(np.linspace(0.0, 2.0, K, dtype=np.float32)).to(dev)
    base = _probs(m + 1, (m, N), dev)
    k = m // 3
    for sharpen, beta in [(False, None), (True, 1.5)]:
        kw = dict(mode="delta", bits=8, sharpen=sharpen)
        one = round_kernel.fused_round(z, w, beta, base, **kw)
        assert torch.equal(one, round_kernel.fused_round(z, w, beta, base, **kw))
        two = torch.cat([round_kernel.fused_round(z[:, :k], w, beta, base[:k], **kw),
                         round_kernel.fused_round(z[:, k:], w, beta, base[k:], **kw)])
        assert torch.equal(one, two)


def test_fused_round_kernel_rejects_wrong_dtype(dev):
    z = torch.ones(2, 3, 4, device=dev, dtype=torch.float64)
    with pytest.raises(TypeError):
        round_kernel.fused_round(z, torch.ones(2, device=dev), 1.5)


_SMALL = dict(n_clients=8, n_classes=10, dim=16, hidden=32, rounds=3,
              local_steps=2, distill_steps=2, public_size=200,
              public_per_round=64, private_size=800, eval_every=1,
              participation=0.5, alpha=0.5, uplink_codec="cache_delta+quant8")
# threefry launches of one jax-stream leg of a device engine at _SMALL: the
# leg's round keys, its transmit keys and their split, two a sort round of
# P^t over 200 and of the half participation over 8
_SMALL_STREAM = 3 + 2 * prng.shuffle_rounds(200) + 2 * prng.shuffle_rounds(8)


def _init_launches(cfg) -> int:
    """Threefry launches of an engine's initial parameters on the card: the
    clients' and server's keys, then a split and a normal a layer."""
    return 1 + 2 * (cfg.mlp_depth + 1) * 2


@pytest.mark.parametrize("fused", [True, False])
def test_device_engine_runs_without_host_sync(dev, fused):
    cfg = pfl.FLConfig(**_SMALL, fused_round=fused)
    eng = pfl.ScannedFederatedDistillation(cfg, pfl.STRATEGIES["scarlet"](beta=1.5),
                                           cache_duration=2, device=dev)
    ops.reset_launches()
    h = eng.run()  # the rounds run under sync debug mode "error"
    assert torch.cuda.get_sync_debug_mode() == 0
    n = _SMALL["rounds"]
    want = ({"enhanced_era_fused": 0, "quantize_dequantize": 0, "fused_round": n}
            if fused else
            {"enhanced_era_fused": n, "quantize_dequantize": n, "fused_round": 0})
    assert ops.launches() == dict(want, flash_attention=0, enhanced_era=0, distill_loss=0,
                                  copy_vec4=0, scale=0, copy_smem=0, threefry=_SMALL_STREAM)
    assert h.ledger.summary()["rounds"] == float(n)
    assert all(0.0 <= a <= 1.0 for a in h.server_acc + h.client_acc)


@pytest.mark.parametrize("fused", [True, False])
def test_shard_engine_world_of_one_on_the_card(dev, fused):
    """``run_method(engine="shard")`` on the card with no process group: a
    world of one over NCCL, its rounds under the sync guard, its ledger the
    device engine's bit for bit; per-op: qdq once a round and ERA plain on
    the summed mean; fused: fused_round once a round (sharpen=False)."""
    import torch.distributed as dist

    cfg = pfl.FLConfig(**_SMALL, fused_round=fused)
    ops.reset_launches()
    h = pfl.run_method("scarlet", cfg, engine="shard", cache_duration=2, beta=1.5,
                       device=dev)
    got = ops.launches()
    assert not dist.is_initialized() and torch.cuda.get_sync_debug_mode() == 0
    hs = pfl.run_method("scarlet", cfg, engine="scan", cache_duration=2, beta=1.5,
                        device=dev)
    assert [(r.uplink, r.downlink) for r in h.ledger.rounds] == \
        [(r.uplink, r.downlink) for r in hs.ledger.rounds]
    n = _SMALL["rounds"]
    assert got["fused_round" if fused else "quantize_dequantize"] == n
    assert got["enhanced_era_fused"] == 0
    assert all(0.0 <= a <= 1.0 for a in h.server_acc + h.client_acc)


@pytest.mark.parametrize("method", ["cfd", "selective_fd", "mean"])
def test_comparison_methods_run_on_the_card_without_host_sync(dev, method):
    """CFD's uplink launches the qdq kernel once a round (identity codec);
    Selective-FD and mean launch none.  The device engine agrees with the
    card's host loop on the per-round ledger (rtol 2^-22: Selective-FD's
    fractional per-client count, rounded three times in float32)."""
    cfg = pfl.FLConfig(**dict(_SMALL, participation=1.0, uplink_codec="identity"))
    runs = []
    for engine in (pfl.FederatedDistillation, pfl.ScannedFederatedDistillation):
        # the same numpy draws on both engines; the launches counted from
        # after the initial parameters (threefry launches on the card)
        eng = engine(cfg, pfl.STRATEGIES[method](), rng_backend="numpy", device=dev)
        ops.reset_launches()
        h = eng.run()
        assert torch.cuda.get_sync_debug_mode() == 0
        got = ops.launches()
        assert got == dict(dict.fromkeys(got, 0),
                           quantize_dequantize=_SMALL["rounds"] if method == "cfd" else 0)
        runs.append(np.array([(r.uplink, r.downlink) for r in h.ledger.rounds]))
    np.testing.assert_allclose(runs[1], runs[0], rtol=2.0 ** -22, atol=0)


def test_cfd_transmit_on_the_card_matches_plain(dev):
    z = _probs(11, (100, 1000, 10), dev)
    got = pfl.STRATEGIES["cfd"]().transmit(z)
    want = pfl.STRATEGIES["cfd"]().transmit(z.cpu())
    assert got.device.type == "cuda"
    assert float((got.cpu() - want).abs().max()) <= ATOL


def test_topk_ties_on_the_card_select_the_cpu_indices(dev):
    """Top-k selects by a stable descending sort on the card too, so tied
    rows give the CPU's indices (the lower class index first) and keep
    the same entries."""
    from repro_torch.compress import get_codec

    rng = np.random.default_rng(4)
    # values on a coarse grid: most rows hold ties
    z = torch.from_numpy((rng.integers(0, 4, size=(3000, 10)) / 4.0).astype(np.float32))
    z[:3] = torch.tensor([[0.25] * 4 + [0.0] * 6, [0.1, 0.3, 0.3, 0.3] + [0.0] * 6,
                          [0.0, 0.0, 0.5, 0.5] + [0.0] * 6])
    for spec in ("topk2", "topk4", "cache_delta+topk2"):
        c = get_codec(spec)
        inner = getattr(c, "inner", c)
        for x in (z, z - 0.25):
            got = inner.encode(x.to(dev))["indices"].cpu()
            assert torch.equal(got, inner.encode(x)["indices"])
        # the same entries survive; their values to float32 rounding (the
        # simplex projection sums each row in another order on the card)
        got, want = c.roundtrip(z.to(dev)).cpu(), c.roundtrip(z)
        assert torch.equal(got != 0, want != 0)
        torch.testing.assert_close(got, want, rtol=0, atol=ATOL)


def test_comet_per_client_downlink_through_qdq_matches_plain(dev):
    """COMET's (100, 1000, 10) per-client stack through a quant8 downlink:
    one qdq launch, its plain version to atol 1e-6 with no level flips."""
    z = _probs(12, (100, 1000, 10), dev)
    _, per_client = pfl.STRATEGIES["comet"]().aggregate(z, None, 1)
    assert per_client.shape == (100, 1000, 10) and per_client.device.type == "cuda"
    ops.reset_launches()
    got = quant_kernel.quantize_dequantize(per_client, 8)
    torch.cuda.synchronize()
    assert ops.launches()["quantize_dequantize"] == 1
    want = quant_kernel.quantize_dequantize_plain(per_client, 8)
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
    scale = torch.clamp_min(per_client.amax(-1, keepdim=True)
                            - per_client.amin(-1, keepdim=True), 1e-9)
    assert int(((got - want).abs() >= 0.5 * scale / 255).sum()) == 0


def test_comet_and_fedavg_on_the_card_match_the_cpu(dev):
    """The same small COMET (quant8 downlink: three qdq launches a round
    with a lossy uplink) and FedAvg runs on the card and on the CPU:
    equal ledgers, accuracies within one test sample."""
    cfg = pfl.FLConfig(**dict(_SMALL, participation=1.0, downlink_codec="quant8"))
    for method, launches in (("comet", 3 * _SMALL["rounds"]), ("fedavg", 0)):
        c = cfg if method == "comet" else pfl.FLConfig(**dict(_SMALL, uplink_codec="identity"))
        ops.reset_launches()
        g = pfl.run_method(method, c, device=dev)
        got = ops.launches()
        assert got == dict(dict.fromkeys(got, 0), quantize_dequantize=launches,
                           threefry=_init_launches(c))
        h = pfl.run_method(method, c, device="cpu")
        assert g.ledger.summary() == h.ledger.summary()
        n_test = max(_SMALL["private_size"] // 5, 200)  # the synthetic test set
        for a, b in zip(g.server_acc + g.client_acc, h.server_acc + h.client_acc):
            assert abs(a - b) <= 1.0 / n_test + 1e-6


def test_host_sync_inside_a_device_round_raises(dev):
    class Syncing(pfl.ScannedFederatedDistillation):
        def _round_device(self, st, t, part, idx, do_eval, **kw):
            float(part.sum())
            return super()._round_device(st, t, part, idx, do_eval, **kw)

    eng = Syncing(pfl.FLConfig(**_SMALL), pfl.STRATEGIES["scarlet"](beta=1.5),
                  cache_duration=2, device=dev)
    with pytest.raises(RuntimeError):
        eng.run(1)
    assert torch.cuda.get_sync_debug_mode() == 0


@pytest.mark.parametrize("fused", [True, False])
def test_telemetry_on_device_run_without_host_sync(dev, fused):
    """Telemetry on, rounds under the sync guard: the launches of the
    telemetry-off run, plus the fused engine's server view (one qdq a
    round); a hook that reads the card raises inside the round."""
    from repro_torch.obs.device import STALENESS_BUCKETS

    n = _SMALL["rounds"]
    cfg = pfl.FLConfig(**_SMALL, fused_round=fused, telemetry=True)
    eng = pfl.ScannedFederatedDistillation(cfg, pfl.STRATEGIES["scarlet"](beta=1.5),
                                           cache_duration=2, device=dev)
    ops.reset_launches()
    h = eng.run()
    assert torch.cuda.get_sync_debug_mode() == 0
    got = ops.launches()
    want = ({"quantize_dequantize": n, "fused_round": n} if fused else
            {"enhanced_era_fused": n, "quantize_dequantize": n})
    assert got == dict(dict.fromkeys(got, 0), threefry=_SMALL_STREAM, **want)
    st = h.telemetry.stacks()
    assert st["staleness_hist"].shape == (n, STALENESS_BUCKETS)
    np.testing.assert_array_equal(st["participants"].sum(1), [4] * n)
    np.testing.assert_array_equal(
        st["uplink_bytes"], np.array([r.uplink for r in h.ledger.rounds], np.float32))

    leaky = pfl.ScannedFederatedDistillation(cfg, pfl.STRATEGIES["scarlet"](beta=1.5),
                                             cache_duration=2, device=dev)
    leaky.telemetry_hook = lambda tel, t: (tel.cache_hits.item(), tel)[1]
    with pytest.raises(RuntimeError):
        leaky.run(1)
    assert torch.cuda.get_sync_debug_mode() == 0


@pytest.mark.parametrize("engine,fused", [("host", False), ("scan", False), ("scan", True)])
def test_telemetry_rows_on_the_card_match_the_cpu(dev, engine, fused):
    """The same small telemetry-on run on the card and on the CPU: the
    counters and bytes equal (integer counts from the same draws); the
    gauges of round 1, where both start from the same parameters, to atol
    1e-5 (float32 means summed in other orders), and of every round to
    1e-3: the two devices may break a rounding tie of the 8-bit residual
    code differently, which moves a value by a level (range/255) and the
    trajectory after it (the caches are held to 1e-3 card vs CPU in
    ``chip_smoke.py`` for the same reason)."""
    from repro_torch.obs.device import EXACT_FIELDS, GAUGE_FIELDS

    cfg = pfl.FLConfig(**_SMALL, fused_round=fused, telemetry=True)
    g, c = (pfl.run_method("scarlet", cfg, engine=engine, cache_duration=2, beta=1.5,
                           device=d).telemetry.stacks() for d in (dev, "cpu"))
    for f in EXACT_FIELDS:
        assert g[f].dtype == c[f].dtype
        np.testing.assert_array_equal(g[f], c[f], err_msg=f)
    for f in GAUGE_FIELDS:
        np.testing.assert_allclose(g[f][0], c[f][0], rtol=0, atol=1e-5, err_msg=f)
        np.testing.assert_allclose(g[f], c[f], rtol=0, atol=1e-3, err_msg=f)


def test_divide_is_a_true_division_on_the_card(dev):
    """PyTorch's CUDA ``tensor / python_number`` multiplies by the float32
    reciprocal; ``runtime.divide`` divides, bit for bit as the CPU does."""
    x = torch.from_numpy(np.random.default_rng(0).random(1 << 16, dtype=np.float32))
    want = x / 255.0  # the CPU divides
    assert torch.equal(runtime.divide(x.to(dev), 255.0).cpu(), want)
    assert not torch.equal((x.to(dev) / 255.0).cpu(), want)


@pytest.mark.parametrize("D", [1, 3, 25])
def test_probabilistic_miss_mask_on_the_card_equals_the_cpu(dev, D):
    """The hazard (age - 1) / D is an IEEE division on the card too: for
    random uniforms, uniforms equal to each hazard and one float below
    it, the card's mask equals the CPU's with zero flips."""
    from repro_torch.core import cache as pcache

    ages = np.tile(np.arange(D + 3), 50)
    t = 100
    n = len(ages)
    ts = (t - ages).astype(np.int32)
    cache = pcache.CacheState(torch.zeros(n, 3), torch.from_numpy(ts),
                              torch.ones(n, dtype=torch.bool))
    f32 = np.float32
    hazard = np.clip((ages.astype(f32) - f32(1.0)) / f32(D), f32(0), f32(1))
    us = [np.random.default_rng(s).random(n, dtype=np.float32) for s in range(4)]
    us += [hazard, np.where(hazard > 0, np.nextafter(hazard, f32(-1)), f32(0))]
    idx = torch.arange(n)
    for u in us:
        u = torch.from_numpy(np.ascontiguousarray(u, np.float32))
        want = pcache.miss_mask(cache, idx, t, D, probabilistic=True, u=u)
        got = pcache.miss_mask(pcache.CacheState(*(a.to(dev) for a in cache)),
                               idx.to(dev), t, D, probabilistic=True, u=u.to(dev))
        assert int((got.cpu() != want).sum()) == 0
    assert not bool(want[ages <= 1].any())  # one float below a zero hazard: 0


@pytest.mark.parametrize("engine,fused", [("host", False), ("scan", False), ("scan", True)])
def test_restore_round_trip_on_the_card(dev, engine, fused, tmp_path):
    """Heterogeneous schedules and probabilistic expiry at half
    participation: 2 rounds, a checkpoint, a fresh card engine restored
    from it, 2 more, against 4 rounds in one engine: ledgers and state
    bit for bit (the kernels sum in a fixed order)."""
    from repro_torch.checkpoint import load_pytree, save_pytree
    from repro_torch.checkpoint.io import _flatten, _key

    cfg = pfl.FLConfig(**dict(_SMALL, rounds=4, fused_round=fused))
    scen = pfl.Scenario(participation=pfl.fixed_fraction(0.5),
                        heterogeneity=pfl.Heterogeneity(
                            local_steps=(0, 2, 5, 8) * 2, lr_scale=(0.5, 1.0, 2.0, 1.0) * 2,
                            lr_decay=0.95))
    Engine = pfl.FederatedDistillation if engine == "host" else pfl.ScannedFederatedDistillation

    def make():
        return Engine(cfg, pfl.STRATEGIES["scarlet"](beta=1.5), cache_duration=2,
                      probabilistic_expiry=True, scenario=scen, device=dev)

    full = make()
    hf = full.run(4)
    first = make()
    h1 = first.run(2)
    path = str(tmp_path / "engine.npz")
    save_pytree(path, first.state_dict())
    restored = make()
    restored.load_state_dict(load_pytree(path, restored.state_dict()))
    h2 = restored.run(2)
    assert torch.cuda.get_sync_debug_mode() == 0
    ledger = lambda h: [(r.uplink, r.downlink) for r in h.ledger.rounds]  # noqa: E731
    assert ledger(h1) + ledger(h2) == ledger(hf)
    a = {_key(k): v for k, v in _flatten(restored.state_dict())}
    b = {_key(k): v for k, v in _flatten(full.state_dict())}
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
        assert a[k].device == b[k].device


# ---------------------------------------------------------------------------
# Flash attention: kernel against its plain version, and the whisper
# prefill through it.  float32 to atol 1e-5 (the kernel sums with FMA in
# its own order and runs an online softmax; the plain version is the
# oracle's order); bfloat16 to one bfloat16 step, 2**-7 * max(|want|, 1)
# (both round one float32 value each).
# ---------------------------------------------------------------------------

def _attn_inputs(seed, B, Sq, Sk, H, Hkv, d, dtype, dev):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dev, dtype)
            for s in ((B, Sq, H, d), (B, Sk, Hkv, d), (B, Sk, Hkv, d))]


def _assert_attn_close(got, want):
    if got.dtype == torch.bfloat16:
        got, want = got.float(), want.float()
        assert bool(((got - want).abs() <= 2.0 ** -7 * want.abs().clamp_min(1.0)).all())
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,d,causal,window", [
    (4, 384, 384, 20, 20, 64, True, 0),   # whisper's decoder
    (2, 200, 200, 8, 2, 64, True, 64),    # GQA + window, ragged
    (2, 100, 300, 4, 4, 64, False, 0),    # non-causal, Sq != Sk
    (1, 300, 100, 4, 2, 64, False, 16),   # rows left with no key
    (1, 130, 130, 2, 1, 32, True, 7),
    (1, 129, 129, 4, 1, 128, True, 0),
    (1, 4, 4, 2, 1, 64, True, 0),
    (1, 2048, 2048, 4, 1, 128, True, 0),  # the bf16 kernel's stage ring wraps 16 times
    (2, 200, 257, 4, 2, 64, False, 0),    # Sk one past 4 key tiles
    (2, 256, 256, 8, 2, 32, True, 0),     # GQA at d = 32
    # head dims between and past the instantiations (bf16: D = 32, 64, 128
    # on tiles zero past d, column blocks of 128 past 128; float32: D = 32,
    # 64, column blocks of 64 past 64)
    (1, 130, 130, 2, 1, 8, True, 0),
    (2, 200, 200, 8, 2, 40, True, 0),     # GQA
    (1, 130, 130, 4, 4, 80, True, 0),
    (1, 300, 300, 4, 2, 96, True, 0),
    (1, 200, 257, 2, 2, 112, False, 0),
    (1, 200, 200, 4, 1, 136, True, 33),   # windowed
    (1, 130, 130, 2, 2, 192, True, 0),
    (1, 130, 130, 2, 1, 200, True, 0),    # the last column block's second half partly past d
    (1, 300, 100, 2, 1, 256, False, 16),  # rows left with no key
    (2, 256, 256, 4, 2, 256, True, 0),
])
def test_flash_kernel_matches_plain(dev, B, Sq, Sk, H, Hkv, d, causal, window, dtype):
    q, k, v = _attn_inputs(Sq + Sk + d, B, Sq, Sk, H, Hkv, d, dtype, dev)
    ops.reset_launches()
    got = attn_kernel.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.launches()["flash_attention"] == 1
    assert got.dtype == dtype and got.shape == q.shape
    _assert_attn_close(got, attn_kernel.flash_attention_plain(q, k, v, causal, window))


def test_flash_kernel_reads_strided_views_in_place(dev):
    """q, k, v as views of one (B, S, 3, H, d) projection: the kernel reads
    them through their strides."""
    g = torch.Generator(device=dev).manual_seed(0)
    qkv = torch.randn(2, 256, 3, 4, 64, device=dev, generator=g)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = qkv.to(dtype).unbind(2)
        assert not q.is_contiguous()
        got = attn_kernel.flash_attention(q, k, v, causal=True)
        _assert_attn_close(got, attn_kernel.flash_attention_plain(q, k, v, True, 0))


def test_flash_kernel_takes_a_misaligned_bf16_view(dev):
    """A bf16 view starting 2 bytes past a 4-byte boundary: the Hopper
    kernel reads through TMA (16-byte aligned), so the wrapper hands it an
    aligned copy."""
    B, S, H, d = 1, 128, 2, 64
    base = torch.randn(3 * B * S * H * d + 1, device=dev).to(torch.bfloat16)
    q, k, v = (base[1 + i * B * S * H * d:1 + (i + 1) * B * S * H * d].view(B, S, H, d)
               for i in range(3))
    assert q.data_ptr() % 4 == 2
    got = attn_kernel.flash_attention(q, k, v, causal=True)
    _assert_attn_close(got, attn_kernel.flash_attention_plain(q, k, v, True, 0))


def test_flash_kernel_copies_a_bf16_view_off_a_16_byte_boundary(dev):
    """A bf16 view starting 8 bytes past a 16-byte boundary: TMA needs a
    16-byte aligned start, so the wrapper hands the kernel an aligned copy,
    and the result is the plain version's."""
    B, S, H, d = 2, 192, 4, 64
    n = B * S * H * d
    base = torch.randn(3 * n + 4, device=dev).to(torch.bfloat16)
    q, k, v = (base[4 + i * n:4 + (i + 1) * n].view(B, S, H, d) for i in range(3))
    assert q.data_ptr() % 16 == 8
    ops.reset_launches()
    got = attn_kernel.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert ops.launches()["flash_attention"] == 1
    _assert_attn_close(got, attn_kernel.flash_attention_plain(q, k, v, True, 0))


def test_flash_bf16_kernels_are_wgmma_and_tma_kernels(dev):
    """The bf16 kernels' machine code issues wgmma (HGMMA), TMA loads and
    stores (UTMALDG, UTMASTG) and no mma.sync (HMMA); the three-piece split
    of p needs no conversion instruction (F2FP only in the epilogue's bf16
    rounding of o)."""
    counts = attn_kernel.sass_opcodes()
    assert {n for n in counts if "wgmma" in n} == set(attn_kernel.BF16_KERNELS)
    for name in attn_kernel.BF16_KERNELS:
        c, width = counts[name], int(name.split("<")[1].rstrip(">"))
        assert c["HGMMA"] > 0 and c["UTMALDG"] > 0 and c["UTMASTG"] > 0, c
        assert c["HMMA"] == 0 and c["F2FP"] <= width // 4, c


def test_flash_f32_kernels_are_wgmma_and_tma_kernels(dev):
    """The float32 kernels' machine code issues wgmma (HGMMA) and TMA
    loads and stores (UTMALDG, UTMASTG), and no mma.sync (HMMA): both
    products run on the tensor cores in tf32."""
    counts = attn_kernel.sass_opcodes()
    assert {n for n in counts if "tf32" in n} == set(attn_kernel.F32_KERNELS)
    for name in attn_kernel.F32_KERNELS:
        c = counts[name]
        assert c["HGMMA"] > 0 and c["UTMALDG"] > 0 and c["UTMASTG"] > 0, c
        assert c["HMMA"] == 0, c


def test_flash_wrapper_raises_on_a_refused_launch(dev):
    """A grid past the card's limit (batch 65536 on the grid's z axis) is
    refused at launch: the wrapper raises, counts no launch and does not
    fall back to the plain version."""
    q = torch.zeros(65536, 1, 1, 32, device=dev)
    ops.reset_launches()
    with pytest.raises(RuntimeError, match="cudaError"):
        attn_kernel.flash_attention(q, q, q)
    assert ops.launches()["flash_attention"] == 0
    torch.cuda.synchronize()  # the refusal left the context usable


def test_flash_wrapper_rejects_what_the_kernel_does_not_take(dev):
    with pytest.raises(TypeError):
        attn_kernel.flash_attention(*(torch.zeros(1, 8, 2, 64, device=dev,
                                                  dtype=torch.float16),) * 3)
    with pytest.raises(ValueError):
        attn_kernel.flash_attention(*(torch.zeros(1, 8, 2, 44, device=dev),) * 3)


def test_whisper_prefill_on_the_card_matches_the_cpu(dev):
    """The reduced whisper configuration at S=128 in float32: the card
    (through the kernel, once per decoder layer) against the CPU (plain
    version), q and k projections scaled by 1/8 as in
    tests/test_torch_whisper.py, atol 1e-4."""
    from repro_torch.configs.whisper_large_v3 import CONFIG
    from repro_torch.launch.specs import make_batch
    from repro_torch.models import common as cm
    from repro_torch.models import registry

    cfg = CONFIG.reduced()
    p = registry.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    for part, names in (("encoder", ("wq", "wk")), ("decoder", ("wq", "wk", "xwq", "xwk"))):
        for n in names:
            p[part][n] = p[part][n] / 8
    b = make_batch(cfg, 2, 128, seed=1, device="cpu")
    want = registry.prefill(cfg, p, b)
    p_dev = cm.tree_map(lambda t: t.to(dev), p)
    ops.reset_launches()
    got = registry.prefill(cfg, p_dev, {n: t.to(dev) for n, t in b.items()})
    torch.cuda.synchronize()
    assert ops.launches()["flash_attention"] == cfg.n_layers
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("B,S,H,Hkv,d,window,dtype", [
    (8, 128, 32, 8, 64, 0, torch.bfloat16),   # granite-3-2b's training shape
    (2, 256, 8, 2, 64, 64, torch.float32),
    (1, 130, 4, 1, 96, 7, torch.bfloat16),
])
def test_flash_diff_matches_autograd_through_plain(dev, B, S, H, Hkv, d, window, dtype):
    """The differentiable Function on the card: one kernel launch a
    forward, the output within one bf16 step (f32: 1e-5) of the plain
    version, dq, dk, dv within two bf16 steps of each gradient's largest
    value (f32: 1e-5 of it) of autograd through the plain version."""
    rng = np.random.default_rng(S + d)
    ins = [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dev, dtype)
           for s in ((B, S, H, d), (B, S, Hkv, d), (B, S, Hkv, d))]
    do = torch.from_numpy(rng.normal(size=(B, S, H, d)).astype(np.float32)).to(dev, dtype)
    outs = []
    for fn in (attn_kernel.flash_attention_diff, attn_kernel.flash_attention_plain):
        q, k, v = (t.clone().requires_grad_(True) for t in ins)
        ops.reset_launches()
        o = fn(q, k, v, True, window)
        launches = ops.launches()["flash_attention"]
        o.backward(do)
        torch.cuda.synchronize()
        outs.append((o.detach(), q.grad, k.grad, v.grad, launches))
    assert outs[0][4] == 1 and outs[1][4] == 0
    _assert_attn_close(outs[0][0], outs[1][0])
    step = 2 * 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    for g, w in zip(outs[0][1:4], outs[1][1:4]):
        assert g.dtype == dtype and bool(torch.isfinite(g).all())
        torch.testing.assert_close(g.float(), w.float(), rtol=0,
                                   atol=step * float(w.float().abs().max()))


def test_bare_flash_kernel_refuses_a_gradient_on_the_card(dev):
    """No path returns a detached result: the bare wrapper raises on a
    grad-requiring input; ``ops.flash_attention`` (the models' route)
    takes the Function and its gradients reach q, k and v."""
    q = torch.randn(1, 128, 4, 64, device=dev, requires_grad=True)
    k, v = (torch.randn(1, 128, 2, 64, device=dev, requires_grad=True) for _ in range(2))
    ops.reset_launches()
    with pytest.raises(RuntimeError, match="flash_attention_diff"):
        attn_kernel.flash_attention(q, k, v)
    assert ops.launches()["flash_attention"] == 0
    with torch.no_grad():
        attn_kernel.flash_attention(q, k, v)
    o = ops.flash_attention(q, k, v, causal=True, window=32)
    assert type(o.grad_fn).__name__ == "_FlashDiffBackward"
    o.sum().backward()
    assert ops.launches()["flash_attention"] == 2
    assert all(bool(t.grad.abs().amax() > 0) for t in (q, k, v))


@pytest.mark.parametrize("remat", [False, True])
def test_train_step_on_the_card_matches_the_cpu(dev, remat):
    """One launch.train.train_step of the reduced granite (float32, TF32
    off, q/k / 8): flash once a layer (twice with remat), the loss and the
    parameters after the AdamW step within 1e-4 of the CPU's (relative,
    the leaf's norm; chip_smoke.py phase 4n (c))."""
    from repro_torch.configs.granite_3_2b import CONFIG
    from repro_torch.launch import train
    from repro_torch.launch.specs import make_batch
    from repro_torch.models import common as cm
    from repro_torch.models import registry
    from repro_torch.optim import get

    cfg = CONFIG.reduced()
    p = registry.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    for n in ("wq", "wk"):
        p["layers"][n] = p["layers"][n] / 8
    b = make_batch(cfg, 2, 128, seed=1, device="cpu")
    b["labels"] = b["tokens"]
    opt = get("adamw", weight_decay=0.01)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        res = {}
        for d in ("cpu", dev):
            pd = cm.tree_map(lambda t: t.to(d), p)
            ops.reset_launches()
            loss, new, _ = train.train_step(cfg, opt, pd, opt.init(pd),
                                            {n: t.to(d) for n, t in b.items()}, 1e-3,
                                            remat=remat)
            res[str(d)] = (float(loss), cm.tree_map(lambda t: t.cpu(), new), ops.launches())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert res["cuda"][2]["flash_attention"] == cfg.n_layers * (2 if remat else 1)
    assert res["cuda"][0] == pytest.approx(res["cpu"][0], rel=1e-4)
    for n in res["cpu"][1]["layers"]:
        a, w = res["cuda"][1]["layers"][n], res["cpu"][1]["layers"][n]
        assert float((a - w).norm() / w.norm()) <= 1e-4, n


# ---------------------------------------------------------------------------
# Per-row Enhanced ERA and the distillation loss: each kernel against its
# plain version over chip_smoke.py's phase-3 cases.
# ---------------------------------------------------------------------------

# warp a row (N <= 1024); one block a row (12289); clusters of 2 (20001),
# of 4 (51968, and 51967, whose rows start off 16-byte boundaries) and of
# 8 (100001); the multi-pass layout past eight slices (300001)
ERA_ROWS_SHAPES = ((37, 1), (1000, 10), (333, 100), (64, 12289), (9, 20001), (48, 51968),
                   (7, 51967), (5, 100001), (3, 300001))
ERA_ROWS_BETAS = (0.5, 1.0, 1.5, 4.0, 200.0)
DISTILL_SHAPES = ((8, 100), (3, 131), (64, 32000), (100, 163840))
DISTILL_DTYPES = ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
                  (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16))
DISTILL_RTOL = 1e-5


def _rows_with_zeros(seed, B, N, dev):
    z = _probs(seed, (B, N), dev)
    z[0] = 0.0
    z[-1] = 0.0
    return z


@pytest.mark.parametrize("B,N", ERA_ROWS_SHAPES)
@pytest.mark.parametrize("beta", ERA_ROWS_BETAS)
def test_era_rows_kernel_matches_plain(dev, B, N, beta):
    z = _rows_with_zeros(B + N, B, N, dev)
    ops.reset_launches()
    got = era_kernel.enhanced_era(z, beta)
    torch.cuda.synchronize()
    assert ops.launches()["enhanced_era"] == 1
    torch.testing.assert_close(got, era_kernel.enhanced_era_plain(z, beta), rtol=0, atol=ATOL)
    torch.testing.assert_close(got[0], torch.full((N,), 1.0 / N, device=dev),
                               rtol=0, atol=ATOL)
    # bfloat16: the same float32 arithmetic, rounded once
    zb = z.to(torch.bfloat16)
    got_b = era_kernel.enhanced_era(zb, beta)
    assert got_b.dtype == torch.bfloat16
    assert torch.equal(got_b, era_kernel.enhanced_era(zb.float(), beta).to(torch.bfloat16))
    want_b = era_kernel.enhanced_era_plain(zb, beta).float()
    assert bool(((got_b.float() - want_b).abs() <= 2.0 ** -7 * want_b.abs() + ATOL).all())


@pytest.mark.parametrize("B,N", ERA_ROWS_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_era_rows_kernel_is_deterministic_and_row_split_invariant(dev, B, N, dtype):
    """Two launches give the same bits, and rows computed in two launches
    equal the same rows of one: the second launch's rows start k * N
    values into the input (off its 16-byte alignment for odd k and N) and
    its output is a fresh tensor, aligned otherwise."""
    z = _rows_with_zeros(B + N + 1, B, N, dev).to(dtype)
    one = era_kernel.enhanced_era(z, 1.5)
    assert torch.equal(one, era_kernel.enhanced_era(z, 1.5))
    k = (B // 2) | 1
    two = torch.cat([era_kernel.enhanced_era(z[:k], 1.5), era_kernel.enhanced_era(z[k:], 1.5)])
    assert torch.equal(one, two)


@pytest.mark.parametrize("B,N", [(1000, 10), (48, 51968)])
def test_era_rows_kernel_reads_beta_on_the_card_without_a_sync(dev, B, N):
    z = _probs(7, (B, N), dev)
    beta = torch.full((), 2.5, device=dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = pera.enhanced_era(z, beta, impl="kernel")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(got, era_kernel.enhanced_era(z, 2.5))


def _distill_inputs(seed, B, V, ldt, tdt, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    logits = 3.0 * torch.randn(B, V, device=dev, generator=g)
    teacher = torch.softmax(torch.randn(B, V, device=dev, generator=g), -1)
    return logits.to(ldt), teacher.to(tdt)


def _distill_scale(logits, teacher):
    l, t = logits.float(), teacher.float()
    return torch.logsumexp(l, -1).abs() * t.sum(-1).abs() + (t * l).abs().sum(-1)


@pytest.mark.parametrize("B,V", DISTILL_SHAPES)
@pytest.mark.parametrize("ldt,tdt", DISTILL_DTYPES)
def test_distill_kernel_matches_plain(dev, B, V, ldt, tdt):
    logits, teacher = _distill_inputs(B + V, B, V, ldt, tdt, dev)
    ops.reset_launches()
    got = distill_kernel.distill_loss(logits, teacher)
    torch.cuda.synchronize()
    assert ops.launches()["distill_loss"] == 1
    assert got.shape == (B,) and got.dtype == torch.float32
    want = distill_kernel.distill_loss_plain(logits, teacher)
    assert bool(((got - want).abs() <= DISTILL_RTOL * _distill_scale(logits, teacher)).all())
    mean = plosses.soft_cross_entropy(logits, teacher, impl="kernel")
    assert abs(float(mean) - float(want.mean())) <= DISTILL_RTOL * float(
        _distill_scale(logits, teacher).mean())


def test_row_kernels_reject_wrong_dtypes(dev):
    with pytest.raises(TypeError):
        era_kernel.enhanced_era(torch.ones(2, 3, device=dev, dtype=torch.float16), 1.5)
    with pytest.raises(TypeError):
        distill_kernel.distill_loss(torch.ones(2, 3, device=dev, dtype=torch.float64),
                                    torch.ones(2, 3, device=dev))


def test_row_kernel_wrappers_raise_on_a_refused_launch(dev, monkeypatch):
    """A block of 2048 threads is past the card's limit of 1024: the launch
    is refused, the wrapper raises, counts no launch and does not fall
    back to the plain version."""
    monkeypatch.setattr(era_kernel, "THREADS", 2048)
    monkeypatch.setattr(distill_kernel, "THREADS", 2048)
    z = _probs(1, (64, 10), dev)
    ops.reset_launches()
    with pytest.raises(RuntimeError, match="cudaError"):
        era_kernel.enhanced_era(z, 1.5)
    with pytest.raises(RuntimeError, match="cudaError"):
        distill_kernel.distill_loss(z, z)
    assert ops.launches()["enhanced_era"] == 0 and ops.launches()["distill_loss"] == 0
    torch.cuda.synchronize()  # the refusal left the context usable


# ---------------------------------------------------------------------------
# The static analyzer's fixture kernels and the compiled kernels' attributes
# ---------------------------------------------------------------------------

def _card_normal(seed, shape, dev):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev)


@pytest.mark.parametrize("shape", [(100, 128), (4096, 1024), (3, 4)])
def test_fixture_copies_match_plain(dev, shape):
    x = _card_normal(sum(shape), shape, dev)
    ops.reset_launches()
    assert torch.equal(fixture_kernel.copy_vec4(x), fixture_kernel.copy_plain(x))
    assert torch.equal(fixture_kernel.copy_smem(x), fixture_kernel.copy_plain(x))
    assert ops.launches()["copy_vec4"] == 1 and ops.launches()["copy_smem"] == 1


@pytest.mark.parametrize("shape,offset,tile", [
    ((33, 130), 0, (32, 128)),   # columns not whole 16 bytes: 4-byte copies
    ((65, 256), 1, (32, 128)),   # a start 4 bytes into its storage: 4-byte copies
    ((70, 300), 0, (16, 64)),    # ragged tiles on both axes, 16-byte copies
])
def test_fixture_copy_smem_takes_every_layout(dev, shape, offset, tile):
    base = _card_normal(7, (shape[0] * shape[1] + offset,), dev)
    x = base[offset:].view(shape)
    assert fixture_kernel.copy_smem_vec(x, tile) == (4 if shape[1] % 4 == 0 and not offset
                                                     else 1)
    assert torch.equal(fixture_kernel.copy_smem(x, tile), fixture_kernel.copy_plain(x))


@pytest.mark.parametrize("sync", [False, True])
def test_fixture_scale_matches_plain(dev, sync):
    x, s = _card_normal(1, (16, 128), dev), _card_normal(2, (1,), dev)
    assert torch.equal(fixture_kernel.scale(x, s, sync=sync), fixture_kernel.scale_plain(x, s))


def test_fixture_hog_is_refused_then_a_valid_launch_runs(dev):
    """32 MiB of shared memory: the card refuses the opt-in, nothing is
    launched or counted, and the error is not sticky."""
    x = _card_normal(3, (4096, 1024), dev)
    ops.reset_launches()
    with pytest.raises(RuntimeError, match=r"cudaError 1$"):
        fixture_kernel.copy_smem(x, fixture_kernel.HOG_TILE)
    assert ops.launches()["copy_smem"] == 0
    assert torch.equal(fixture_kernel.copy_smem(x), x)
    assert ops.launches()["copy_smem"] == 1


def test_fixture_misaligned_copy_faults_in_a_child_process(dev):
    """The float4 copy of a view 4 bytes into its storage stops on the card
    with cudaErrorMisalignedAddress (716), which is sticky: a child
    process runs it."""
    import os
    import subprocess
    import sys

    code = ("import torch\n"
            "from repro_torch.kernels import fixture_kernel\n"
            "base = torch.zeros(100 * 128 + 1, device='cuda')\n"
            "x = base[1:].view(100, 128)\n"
            "fixture_kernel.copy_vec4(x)\n"
            "torch.cuda.synchronize()\n")
    src = str(__import__("pathlib").Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=src)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                       timeout=300)
    assert p.returncode != 0
    assert "misaligned address" in p.stderr, p.stderr[-2000:]


def test_func_attrs_of_every_kernel(dev):
    for lib in runtime.SOURCES:
        names = runtime.kernel_names(lib)
        assert names
        for name in names:
            a = runtime.func_attrs(lib, name)
            assert 0 < a["numRegs"] <= 255 and a["localSizeBytes"] == 0
            assert a["maxThreadsPerBlock"] >= 128


def test_hopper_limits_are_the_cards(dev):
    assert runtime.device_limits(0) == runtime.HOPPER
    props = torch.cuda.get_device_properties(0)
    for field, prop in (("smem_per_block", "shared_memory_per_block"),
                        ("smem_per_block_optin", "shared_memory_per_block_optin"),
                        ("smem_per_sm", "shared_memory_per_multiprocessor"),
                        ("regs_per_sm", "regs_per_multiprocessor"),
                        ("warp_size", "warp_size"),
                        ("max_threads_per_block", "max_threads_per_block")):
        if hasattr(props, prop):
            assert getattr(props, prop) == getattr(runtime.HOPPER, field), prop


def test_analyzer_on_the_card(dev, capsys):
    from repro_torch.analysis.__main__ import main

    assert main(["--strict"]) == 0
    ops.reset_launches()
    assert main(["--selftest"]) == 0
    n = ops.launches()
    assert n["copy_vec4"] == 1 and n["scale"] == 1 and n["copy_smem"] == 1
    capsys.readouterr()


# ---------------------------------------------------------------------------
# The active-set engine on the card: the sorted catch-up count, the
# kernels at its gathered stack sizes (padding rows at weight 0), a run
# without a host sync inside its steps
# ---------------------------------------------------------------------------

def test_catch_up_bytes_sorted_matches_dense_on_the_card(dev):
    from repro_torch.core import cache as cache_lib

    rng = np.random.default_rng(5)
    for K, P in ((1, 7), (193, 41), (100_000, 1000)):
        ts = rng.integers(-3, 40, P).astype(np.int32)
        present = rng.random(P) < 0.6
        cache = cache_lib.CacheState(torch.zeros(P, 10, device=dev),
                                     torch.from_numpy(ts).to(dev),
                                     torch.from_numpy(present).to(dev))
        ls = rng.integers(0, 42, K).astype(np.int32)
        ls[rng.random(K) < 0.2] = cache_lib._NEVER
        ls = torch.from_numpy(ls).to(dev)
        part = torch.from_numpy(rng.random(K) < 0.5).to(dev)
        for t in (1, 20, 43):
            dense = cache_lib.catch_up_bytes_device(cache, ls, part, t)
            srt = cache_lib.catch_up_bytes_device(cache, ls, part, t, method="sorted")
            assert torch.equal(dense, srt)
            cpu = cache_lib.catch_up_bytes_device(
                cache_lib.CacheState(*(a.cpu() for a in cache)), ls.cpu(), part.cpu(), t,
                method="sorted")
            assert torch.equal(srt.cpu(), cpu)


def _gathered(K, n_part, m, N, dev, seed):
    z, base = _probs(seed, (K, m, N), dev), _probs(seed + 1, (m, N), dev)
    pv = torch.zeros(K, device=dev)
    pv[:n_part] = 1.0
    w = pv * (torch.full((), float(K), device=dev) / pv.sum())
    return z, base, w


@pytest.mark.parametrize("K", [1, 2, 64, 128])
@pytest.mark.parametrize("m,N", [(1000, 10), (64, 10)])
def test_kernels_at_the_gathered_stack_sizes(dev, K, m, N):
    for n_part in sorted({K // 2 + 1, K}):
        z, base, w = _gathered(K, n_part, m, N, dev, K + n_part)
        zw = z * w[:, None, None]
        torch.testing.assert_close(era_kernel.enhanced_era_fused(zw, 1.5),
                                   era_kernel.enhanced_era_fused_plain(zw, 1.5),
                                   rtol=0, atol=ATOL)
        r = (z - base)[..., :-1]
        got = quant_kernel.quantize_dequantize(r, 8)
        want = quant_kernel.quantize_dequantize_plain(r, 8)
        torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
        scale = torch.clamp_min(r.amax(-1, keepdim=True) - r.amin(-1, keepdim=True), 1e-9)
        assert int(((got - want).abs() >= 0.5 * scale / 255.0).sum()) == 0
        torch.testing.assert_close(
            round_kernel.fused_round(z, w, 1.5, base, mode="delta", bits=8),
            round_kernel.fused_round_plain(z, w, 1.5, base, mode="delta", bits=8),
            rtol=0, atol=ATOL)


@pytest.mark.parametrize("fused", [True, False])
def test_active_engine_runs_without_host_sync(dev, fused):
    cfg = pfl.FLConfig(**_SMALL, fused_round=fused)
    scen = pfl.Scenario(participation=pfl.bernoulli_participation(0.5))
    eng = pfl.ActiveSetFederatedDistillation(cfg, pfl.STRATEGIES["scarlet"](beta=1.5),
                                             cache_duration=2, scenario=scen, device=dev)
    ops.reset_launches()
    h = eng.run()  # each round's two steps run under sync debug mode "error"
    assert torch.cuda.get_sync_debug_mode() == 0
    n = _SMALL["rounds"]
    assert ops.launches()["fused_round" if fused else "enhanced_era_fused"] == n
    dense = pfl.ScannedFederatedDistillation(cfg, pfl.STRATEGIES["scarlet"](beta=1.5),
                                             cache_duration=2, scenario=scen, device=dev)
    hd = dense.run()
    assert [(r.uplink, r.downlink) for r in h.ledger.rounds] == \
        [(r.uplink, r.downlink) for r in hd.ledger.rounds]


# ---------------------------------------------------------------------------
# The async engine on the card: the kernels at staleness weights (decay^s
# on the arrivals, times K / sum w), catch_up_bytes_async card vs CPU, and
# a run with reports in flight without a host sync inside its rounds
# ---------------------------------------------------------------------------

def _staleness_weights(K, seed, dev, decay=0.5):
    """The SCARLET strategy's weights over a (K,) arrival mask whose
    arrivals are 0-3 rounds stale at ``decay``: fractional, summing to K."""
    from repro_torch.fl.strategies.scarlet import _participant_weights

    rng = np.random.default_rng(seed)
    arrive = rng.random(K) < 0.4
    arrive[rng.integers(K)] = True
    w = arrive * decay ** rng.integers(0, 4, K)
    return _participant_weights(torch.from_numpy(w.astype(np.float32)).to(dev))


@pytest.mark.parametrize("K,m,N", [(100, 1000, 10), (7, 333, 10), (1, 64, 10), (64, 64, 10)])
@pytest.mark.parametrize("decay", [0.5, 0.9])
def test_kernels_at_staleness_weights(dev, K, m, N, decay):
    w = _staleness_weights(K, K + m, dev, decay)
    z, base = _probs(K, (K, m, N), dev), _probs(K + 1, (m, N), dev)
    zw = z * w[:, None, None]
    torch.testing.assert_close(era_kernel.enhanced_era_fused(zw, 1.5),
                               era_kernel.enhanced_era_fused_plain(zw, 1.5), rtol=0, atol=ATOL)
    for sharpen, beta, atol in ((True, 1.5, ATOL), (False, None, 2e-6 * float(w.sum()))):
        kw = dict(mode="delta", bits=8, sharpen=sharpen)
        torch.testing.assert_close(round_kernel.fused_round(z, w, beta, base, **kw),
                                   round_kernel.fused_round_plain(z, w, beta, base, **kw),
                                   rtol=0, atol=atol)


def test_catch_up_bytes_async_card_equals_cpu(dev):
    from repro_torch.core import cache as cache_lib

    rng = np.random.default_rng(9)
    K, P, t = 1000, 500, 12
    ts = rng.integers(1, t, P).astype(np.int32)
    present = rng.random(P) < 0.6
    ls = rng.integers(0, t, K).astype(np.int32)
    dispatch = rng.random(K) < 0.3
    arrive = (rng.random(K) < 0.3) | (dispatch & (rng.random(K) < 0.25))
    host = (cache_lib.CacheState(torch.zeros(P, 10), torch.from_numpy(ts),
                                 torch.from_numpy(present)),
            torch.from_numpy(ls), torch.from_numpy(dispatch), torch.from_numpy(arrive))
    card = (cache_lib.CacheState(*(a.to(dev) for a in host[0])),) + tuple(a.to(dev)
                                                                          for a in host[1:])
    for method in ("dense", "sorted"):
        want = cache_lib.catch_up_bytes_async(*host, t, method=method)
        got = cache_lib.catch_up_bytes_async(*card, t, method=method)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("fused", [True, False])
def test_async_engine_runs_without_host_sync(dev, fused):
    cfg = pfl.FLConfig(**_SMALL, fused_round=fused)
    traffic = pfl.TrafficModel(arrivals=pfl.ArrivalProcess("poisson", rate=1.5),
                               latency=pfl.LatencyModel("uniform", lo=0, hi=2), seed=3)
    eng = pfl.AsyncFederatedDistillation(cfg, pfl.STRATEGIES["scarlet"](beta=1.5,
                                                                        staleness_decay=0.5),
                                         cache_duration=2, traffic=traffic, device=dev)
    ops.reset_launches()
    h = eng.run()  # its rounds run under sync debug mode "error"
    assert torch.cuda.get_sync_debug_mode() == 0
    n_arr = int(eng.last_plan.arrive.any(axis=1).sum())
    assert n_arr and ops.launches()["fused_round" if fused else "enhanced_era_fused"] == n_arr
    cpu = pfl.AsyncFederatedDistillation(cfg, pfl.STRATEGIES["scarlet"](beta=1.5,
                                                                        staleness_decay=0.5),
                                         cache_duration=2, traffic=traffic, device="cpu")
    hc = cpu.run()
    assert [(r.uplink, r.downlink) for r in h.ledger.rounds] == \
        [(r.uplink, r.downlink) for r in hc.ledger.rounds]
    np.testing.assert_array_equal(eng.last_plan.arrive, cpu.last_plan.arrive)


@pytest.mark.parametrize("hw", [(32, 32), (31, 27)], ids=["32x32", "31x27"])
def test_resnet20_forward_card_equals_cpu(dev, hw):
    """ResNet-20's logits on the card (cuDNN's convolutions, TF32 off)
    against the CPU's from the same weights and images, to 1e-4 of their
    norm; on 31x27 the stride-2 convolutions pad (1, 1)."""
    from repro_torch.models import common as cm
    from repro_torch.models import resnet

    p, _ = resnet.init(torch.Generator().manual_seed(0), device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((8, *hw, 3))
                         .astype(np.float32))
    want = resnet.apply(p, x)
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = resnet.apply(cm.tree_map(lambda t: t.to(dev), p), x.to(dev)).cpu()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-4 * float(want.norm()))


# ---------------------------------------------------------------------------
# The threefry counter hash and the jax key stream on the card
# ---------------------------------------------------------------------------

# (keys, counts, first count, mode): one key's fold over a leg of 300 rounds;
# a split of 300 keys; a leg's sort bits over |P| = 10^4 and K = 100; its
# expiry uniforms at m = 1000; the slice's 100 clients' MLP init (the
# 64 x 64 layer); one 4096-key chunk of the active store's init (dim 8,
# hidden 8: 64 normals); the clients' keys at K = 10^6; counts past 2^32
THREEFRY_CASES = [(1, 300, 1, "pair"), (300, 2, 0, "pair"), (9, 10000, 0, "bits"),
                  (9, 100, 0, "bits"), (9, 1000, 0, "uniform"), (100, 4096, 0, "uniform"),
                  (4096, 64, 0, "uniform"), (1, 10 ** 6 + 1, 0, "pair"),
                  (7, 3, 2 ** 32 - 2, "bits"), (3, 5, 2 ** 40 + 7, "pair")]


@pytest.mark.parametrize("n,count,start,mode", THREEFRY_CASES)
def test_threefry_kernel_is_the_plain_hash_bit_for_bit(dev, n, count, start, mode):
    keys = torch.from_numpy(np.random.default_rng(n + count).integers(0, 2 ** 32, (n, 2)))
    ops.reset_launches()
    got = ops.threefry(keys.to(dev), start, count, mode)
    torch.cuda.synchronize()
    assert ops.launches()["threefry"] == 1
    want = prng.counter_hash(keys, start, count, mode)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got.cpu(), want)


def test_key_stream_on_the_card_is_the_cpus(dev):
    k = prng.key(123456)
    for f in (lambda k: prng.split(k, 5), lambda k: prng.fold_in(k, 43, count=7),
              lambda k: prng.random_bits(k, (3, 5, 11)), lambda k: prng.uniform(k, (1000,)),
              lambda k: prng.permutation(k, 10000),
              lambda k: prng.choice(prng.split(k, 9), 10000, 1000)):
        assert torch.equal(f(k.to(dev)).cpu(), f(k))
    keys = prng.split(k, 100)
    np.testing.assert_allclose(prng.normal(keys.to(dev), (32, 64)).cpu().numpy(),
                               prng.normal(keys, (32, 64)).numpy(), rtol=0, atol=1e-6)
    scen = pfl.Scenario(participation=pfl.fixed_fraction(0.3),
                        outages=(pfl.Outage(3, 1, 2),), min_participants=2)
    off = torch.from_numpy(scen.offline_masks(4, 100))
    assert torch.equal(scen.participation_mask_device(keys[:4].to(dev), off.to(dev)).cpu(),
                       scen.participation_mask_device(keys[:4], off))
    with pytest.raises(ValueError, match="CPU tensors"):
        prng.counter_hash(keys.to(dev), 0, 3, "bits")


def test_choice_by_selection_on_the_card_is_the_cpus(dev):
    """One key over K = 10^6: the active engine's participation draw,
    chunk by chunk on the card, the CPU's choice bit for bit, in two
    passes of the chunks a sort round."""
    k, n = prng.key(7), 10 ** 6
    chunks = -(-n // prng.SELECT_CHUNK)
    for m in (1, 64, 5000):
        ops.reset_launches()
        got = prng.choice(k.to(dev), n, m)
        torch.cuda.synchronize()
        assert ops.launches()["threefry"] == prng.shuffle_rounds(n) * (1 + 2 * chunks)
        assert torch.equal(got.cpu(), prng.choice(k, n, m))


@pytest.mark.parametrize("engine", ["host", "scan", "active", "async"])
def test_jax_stream_runs_on_the_card_as_on_the_cpu(dev, engine):
    """The same small jax-stream run on the card (threefry kernel) and on
    the CPU (plain hash), probabilistic expiry on: equal ledgers, round by
    round (every draw is the same bits)."""
    cfg = pfl.FLConfig(**_SMALL)
    runs = [pfl.run_method("scarlet", cfg, engine=engine, rng_backend="jax", cache_duration=2,
                           probabilistic_expiry=True, beta=1.5, device=d)
            for d in (dev, "cpu")]
    assert runs[0].ledger.summary() == runs[1].ledger.summary()
    assert [(r.uplink, r.downlink) for r in runs[0].ledger.rounds] == \
        [(r.uplink, r.downlink) for r in runs[1].ledger.rounds]
