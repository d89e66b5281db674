"""The port's comparison strategies (``cfd``, ``mean``, ``selective_fd``,
``comet``) against the JAX package's, hook by hook, on the same numpy
inputs.

Tolerances:

- Selective-FD's upload mask must be equal.  It compares a float32
  normalized entropy with ``1 - tau``; the inputs are seeded Dirichlet
  stacks of mixed confidence, and a failure reports the entries that
  differ and the closest entry's distance from the threshold, so a
  rounding flip shows with its cause.
- Teachers agree to atol 1e-6 (float32 sums in other orders).
- COMET's k-means runs in host numpy on the same float64 copy of the
  float32 stack in both packages, so the clusters are the same; its
  cluster teachers (float32 sums of a few rows over a count) agree to
  atol 1e-7, and the clients share teachers exactly as in the reference.
- CFD's ``transmit`` at 1, 2 and 8 bits: the same elementwise arithmetic
  as the reference's Pallas kernel (interpret mode), so atol 1e-6 and
  zero level flips, rows on exact half levels included.
"""
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.fl as P
from repro.fl.strategies import STRATEGIES as JS
from repro.kernels import ops as jops
from repro_torch.kernels import ops as pops

ATOL = 1e-6
BASE = dict(n_clients=6, n_classes=5, dim=8, rounds=3, local_steps=3,
            distill_steps=3, public_size=60, public_per_round=24,
            private_size=120, hidden=16, eval_every=1, alpha=0.5)
NEW = ("cfd", "mean", "selective_fd")


def _probs(rng, shape, alpha=1.0):
    z = rng.dirichlet(np.full(shape[-1], alpha), size=int(np.prod(shape[:-1])))
    return z.astype(np.float32).reshape(shape)


def _stack(seed, shape):
    """Soft-labels of mixed confidence: Dirichlet rows at concentrations
    0.2 (peaked), 1 and 20 (near uniform), interleaved along the sample
    axis."""
    rng = np.random.default_rng(seed)
    parts = [_probs(rng, shape, a) for a in (0.2, 1.0, 20.0)]
    z = np.stack(parts, axis=-2).reshape(shape[:-2] + (3 * shape[-2], shape[-1]))
    return z


def _pair(method, **kw):
    return JS[method](**kw), P.STRATEGIES[method](**kw)


# ---------------------------------------------------------------------------
# Selective-FD
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tau", [0.0625, 0.25])
@pytest.mark.parametrize("shape", [(6, 8, 5), (6, 8, 10), (3, 5, 2)])
def test_selective_fd_upload_mask_equals_reference(shape, tau):
    js, ps = _pair("selective_fd", tau_client=tau)
    z = _stack(1, shape)
    want = np.asarray(js.upload_mask(jnp.asarray(z)))
    got = ps.upload_mask(torch.from_numpy(z))
    assert got.dtype == torch.bool and tuple(got.shape) == want.shape
    p = np.clip(z.astype(np.float64), 1e-12, 1.0)
    h = -(p * np.log(p)).sum(-1) / math.log(shape[-1])
    gap = float(np.abs(h - (1.0 - tau)).min())
    differ = np.argwhere(got.numpy() != want)
    assert differ.size == 0, (f"{len(differ)} mask entries differ, at {differ.tolist()}; "
                              f"closest entry {gap:.3e} from the threshold")
    assert want.any() and not want.all()  # the gate withholds some, not all


def test_selective_fd_aggregate_with_a_withheld_sample():
    js, ps = _pair("selective_fd")
    z = _stack(2, (5, 4, 6))
    um = _stack(3, (5, 4, 6))[..., 0] > 0.15
    um[:, 3] = False                     # nobody uploads sample 3
    um[:, 5] = True                      # everybody uploads sample 5
    um[0, 7], um[1:, 7] = True, False    # one uploader
    jt, jpc = js.aggregate(jnp.asarray(z), jnp.asarray(um), 1)
    pt, ppc = ps.aggregate(torch.from_numpy(z), torch.from_numpy(um), 1)
    assert jpc is None and ppc is None
    np.testing.assert_allclose(pt.numpy(), np.asarray(jt), rtol=0, atol=ATOL)
    np.testing.assert_allclose(pt[3].numpy(), z[:, 3].mean(0), rtol=0, atol=ATOL)
    np.testing.assert_allclose(pt[7].numpy(), z[0, 7], rtol=0, atol=ATOL)


@pytest.mark.parametrize("tau", [0.0625, 0.25])
def test_selective_fd_two_phase_split_equals_aggregate_masked(tau):
    """The linear moments of two client shards, summed and finalized,
    equal ``aggregate_masked`` on the whole stack; that equals the
    reference's, and ``aggregate`` on the participants."""
    js, ps = _pair("selective_fd", tau_client=tau)
    z = _stack(4, (8, 6, 10))
    part = np.array([1, 0, 1, 1, 0, 1, 1, 0], np.float32)
    pz, pp = torch.from_numpy(z), torch.from_numpy(part)
    um = ps.upload_mask(pz)
    um[np.flatnonzero(part), 2] = False  # a sample no participant uploads
    whole = ps.aggregate_masked(pz, pp, um, 1)
    a = ps.partial_aggregate(pz[:3], pp[:3], um[:3], 1)
    b = ps.partial_aggregate(pz[3:], pp[3:], um[3:], 1)
    assert set(a) == {"zsum", "wsum", "up_num", "up_den"}
    split = ps.finalize_aggregate({k: a[k] + b[k] for k in a}, 1)
    np.testing.assert_allclose(split.numpy(), whole.numpy(), rtol=0, atol=ATOL)
    ref = js.aggregate_masked(jnp.asarray(z), jnp.asarray(part),
                              jnp.asarray(um.numpy()), 1)
    np.testing.assert_allclose(whole.numpy(), np.asarray(ref), rtol=0, atol=ATOL)
    sel = pp > 0
    subset, _ = ps.aggregate(pz[sel], um[sel], 1)
    np.testing.assert_allclose(whole.numpy(), subset.numpy(), rtol=0, atol=ATOL)
    np.testing.assert_allclose(whole[2].numpy(), z[part > 0, 2].mean(0), rtol=0, atol=ATOL)


# ---------------------------------------------------------------------------
# CFD and mean
# ---------------------------------------------------------------------------

def _half_level_rows(bits, N):
    """Rows with a value exactly on a half level of the row's range (min 0,
    max ``levels``, and ``k + 0.5`` between): the ties that round to even."""
    levels = 2 ** bits - 1
    rows = np.zeros((min(levels, 4), N), np.float32)
    rows[:, 0] = levels
    rows[:, 1] = np.arange(len(rows)) + 0.5
    return rows


@pytest.mark.parametrize("bits", [1, 2, 8])
def test_cfd_transmit_equals_reference(bits):
    js, ps = _pair("cfd", b_up=bits)
    ties = _half_level_rows(bits, 10)
    z = np.concatenate([_stack(5, (6, 8, 10)),
                        np.broadcast_to(ties, (6,) + ties.shape)], axis=1)
    # the kernel's own output: every value on the reference's level
    raw_want = np.asarray(jops.quantize_dequantize(jnp.asarray(z), bits))
    raw_got = pops.quantize_dequantize(torch.from_numpy(z), bits).numpy()
    levels = float(2 ** bits - 1)
    scale = np.maximum(z.max(-1, keepdims=True) - z.min(-1, keepdims=True), 1e-9)
    flips = int((np.abs(raw_got - raw_want) >= 0.5 * scale / levels).sum())
    assert flips == 0
    np.testing.assert_allclose(raw_got, raw_want, rtol=0, atol=ATOL)
    got = ps.transmit(torch.from_numpy(z)).numpy()
    want = np.asarray(js.transmit(jnp.asarray(z)))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=0, atol=ATOL)
    if bits == 1:  # each value at its row's min or max before renormalizing
        lo, hi = z.min(-1, keepdims=True), z.max(-1, keepdims=True)
        assert np.all((raw_got == lo) | (raw_got == hi))


def test_cfd_transmit_calls_the_qdq_wrapper_once(monkeypatch):
    calls = []
    real = pops.quantize_dequantize

    def counted(z, bits):
        calls.append((tuple(z.shape), bits))
        return real(z, bits)

    monkeypatch.setattr(pops, "quantize_dequantize", counted)
    P.STRATEGIES["cfd"]().transmit(torch.from_numpy(_stack(6, (4, 3, 10))))
    assert calls == [((4, 9, 10), 1)]


@pytest.mark.parametrize("method", ["cfd", "mean"])
def test_mean_aggregates_equal_reference(method):
    js, ps = _pair(method)
    z = _stack(7, (6, 5, 10))
    part = np.array([1, 1, 0, 1, 0, 1], np.float32)
    jt, _ = js.aggregate(jnp.asarray(z), None, 1)
    pt, pc = ps.aggregate(torch.from_numpy(z), None, 1)
    assert pc is None
    np.testing.assert_allclose(pt.numpy(), np.asarray(jt), rtol=0, atol=ATOL)
    assert ps.upload_mask(torch.from_numpy(z)) is None
    masked = ps.aggregate_masked(torch.from_numpy(z), torch.from_numpy(part), None, 1)
    ref = js.aggregate_masked(jnp.asarray(z), jnp.asarray(part), None, 1)
    np.testing.assert_allclose(masked.numpy(), np.asarray(ref), rtol=0, atol=ATOL)


# ---------------------------------------------------------------------------
# COMET
# ---------------------------------------------------------------------------

def _comet_stacks():
    """(label, (K, m, N) stack): seeded Dirichlet stacks, and two with
    tied distances: every client alike (every center starts on the same
    point, so all clients join the first and the other clusters stay
    empty through every iteration), and five alike beside one."""
    rng = np.random.default_rng(21)
    alike = np.broadcast_to(_probs(rng, (1, 8, 5)), (6, 8, 5)).copy()
    five = alike.copy()
    five[5] = _probs(rng, (8, 5))
    return [("seeded", _stack(8, (6, 4, 5))), ("wide", _stack(9, (10, 8, 10))),
            ("all alike", alike), ("five alike", five)]


def _groups(per_client):
    """The partition of clients by equal teacher rows."""
    flat = per_client.reshape(per_client.shape[0], -1)
    return [[bool(np.array_equal(a, b)) for b in flat] for a in flat]


@pytest.mark.parametrize("n_clusters", [2, 3])
@pytest.mark.parametrize("t", [1, 2, 7])
@pytest.mark.parametrize("label,z", _comet_stacks(), ids=lambda v: v if isinstance(v, str) else "")
def test_comet_aggregate_equals_reference(label, z, t, n_clusters):
    js, ps = _pair("comet", n_clusters=n_clusters)
    jt, jpc = js.aggregate(jnp.asarray(z), None, t)
    pt, ppc = ps.aggregate(torch.from_numpy(z), None, t)
    jpc, ppc = np.asarray(jpc), ppc.numpy()
    assert ppc.shape == jpc.shape == z.shape and ppc.dtype == np.float32
    np.testing.assert_allclose(pt.numpy(), np.asarray(jt), rtol=0, atol=ATOL)
    np.testing.assert_allclose(ppc, jpc, rtol=0, atol=1e-7)
    assert _groups(ppc) == _groups(jpc)
    if label == "all alike":  # one cluster holds every client, the others empty
        assert all(all(row) for row in _groups(ppc))
    if label == "five alike":  # the five always share a cluster
        assert all(_groups(ppc)[0][:5])


def test_comet_contract_equals_reference():
    assert P.STRATEGIES["comet"].analysis_variants == JS["comet"].analysis_variants
    for kw in P.STRATEGIES["comet"].analysis_variants:
        js, ps = JS["comet"](**kw), P.STRATEGIES["comet"](**kw)
        assert ps.declared_contract() == js.declared_contract()
        assert ps.declared_contract()["scan_safe"] is False
    assert P.STRATEGIES["comet"]().c == 2


# ---------------------------------------------------------------------------
# Declared contracts and the engines' refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", NEW)
def test_declared_contracts_equal_reference(method):
    jcls, pcls = JS[method], P.STRATEGIES[method]
    assert pcls.analysis_variants == jcls.analysis_variants
    for kw in pcls.analysis_variants:
        js, ps = jcls(**kw), pcls(**kw)
        assert ps.declared_contract() == js.declared_contract()
        assert (ps.uplink_bits, ps.downlink_bits) == (js.uplink_bits, js.downlink_bits)
    assert pcls().declared_contract()["scan_safe"] is True
    assert P.STRATEGIES["cfd"](b_up=4, b_down=16).uplink_bits == 4.0


@pytest.mark.parametrize("method", ["cfd", "selective_fd", "mean"])
def test_fused_round_is_refused_without_a_fused_path(method):
    cfg = P.FLConfig(**BASE, fused_round=True)
    with pytest.raises(ValueError, match="fused round path"):
        P.ScannedFederatedDistillation(cfg, P.STRATEGIES[method](), device="cpu")
    with pytest.raises(ValueError, match="fused round path"):
        P.run_method(method, cfg, engine="scan", device="cpu")
    # without it, both engines run the method
    cfg = dataclasses.replace(cfg, fused_round=False, rounds=1)
    for engine in ("host", "scan"):
        h = P.run_method(method, cfg, engine=engine, device="cpu")
        assert h.ledger.summary()["rounds"] == 1.0
