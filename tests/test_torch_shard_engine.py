"""The port's client-sharded engine (``engine="shard"``) on a gloo world
of two ranks on the CPU, against the port's device engine
(``engine="scan"``) and the JAX package's scan engine.

The reference's own shard engine does not run under this jax (its
``shard_map(check_rep=False)``); its contract is that a sharded run's
ledger is byte-identical to ``engine="scan"``'s and its metrics allclose
(``repro/fl/shard_engine.py:40-48``), so the port is held to that.  The
module spawns its world once (``torch_shard_worker.run_cases``: every
cell on both ranks, ``torch.set_num_threads(1)`` a rank) while the parent
runs the device engine and the reference on the same cells, then
compares:

- the ledger of each cell equal to ``engine="scan"``'s on the same numpy
  draws (and, for the reference cells, to the reference scan engine's
  float32 values on its own jax-stream draws, from its initial
  parameters);
- both ranks' History, replicated state and gathered client parameters
  equal bit for bit;
- states allclose: cache timestamps, presence and ``last_sync`` equal,
  cache values to atol 1e-5 (5e-3 under an 8-bit codec: a rounding
  difference on a tie of the code moves one value by a level, the
  reference's conformance band), server and client parameters to atol
  1e-4, accuracies within one test sample, validation losses to rtol
  1e-4; the moments are summed in another order, and SCARLET's per-op
  path sharpens the summed mean with the plain Enhanced ERA where the
  device engine runs the fused ERA kernel;
- telemetry: counters and bytes equal, gauges to atol 1e-5 (5e-3 for
  the post-sharpening entropy on the fused path under an 8-bit codec).
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.fl as R
import repro_torch.fl as P
import torch_shard_worker as W
from repro.fl.scan_engine import ScannedFederatedDistillation as RScan
from repro_torch.launch import mesh as mesh_lib

METHODS = ("scarlet", "dsfl", "cfd", "mean", "selective_fd")
CODECS = ("identity", "quant8", "cache_delta+quant8")
LOSSY = "cache_delta+quant8"

CELLS = {f"{m}-{s}-{c}": W.case(m, c, s)
         for m in METHODS for s in ("full", "bernoulli") for c in CODECS}
CELLS.update({f"scarlet-fused-{s}-{c}": W.case("scarlet", c, s, fused=True)
              for s in ("full", "bernoulli") for c in ("identity", LOSSY)})
CELLS.update({
    "scarlet-cohorts": W.case("scarlet", LOSSY, cohorts=((4, 16, 2), (2, 8, 1))),
    "scarlet-het-expiry": W.case("scarlet", LOSSY, "het", prob=True),
    "scarlet-telemetry": W.case("scarlet", LOSSY, telemetry=True),
    "scarlet-fused-telemetry": W.case("scarlet", LOSSY, fused=True, telemetry=True),
    "selective_fd-telemetry": W.case("selective_fd", "quant8", telemetry=True),
})
# held against the reference's scan engine on its own draws and parameters
REF_CELLS = {f"ref-{k}": W.case(*a, **kw) for k, a, kw in (
    ("scarlet", ("scarlet", LOSSY), {}),
    ("scarlet-fused", ("scarlet", LOSSY), {"fused": True}),
    ("selective_fd", ("selective_fd", "identity"), {}),
)}
WORLD_CELL = "scarlet-bernoulli-cache_delta+quant8"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread in this process too, as in the ranks: the
    cells are tiny, and on a machine whose cores are all busy (parallel
    test workers) a pool of a thread a core spends most of each small
    operation waiting at its barrier."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_scenario(K):
    return R.Scenario(participation=R.bernoulli_participation(0.6),
                      outages=tuple(R.Outage(k, 2, 2) for k in range(K)))


def _reference(c):
    """The reference's scan engine of a cell, its draws and its initial
    parameters (numpy, for the ranks)."""
    ref = RScan(R.FLConfig(**c["cfg"]), R.STRATEGIES[c["method"]](**c["skw"]),
                cache_duration=c["D"], scenario=_ref_scenario(c["cfg"]["n_clients"]))
    T = c["cfg"]["rounds"]
    draws = [ref._draw_round(t) for t in range(1, T + 1)]
    part = np.stack([np.asarray(p) for p, _ in draws])
    idx = np.stack([np.asarray(i) for _, i in draws])
    params = ([{k: np.array(v) for k, v in p.items()} for p in ref.client_params],
              {k: np.array(v) for k, v in ref.server_params.items()})
    return ref, dict(c, draws=(part, idx), params=params)


@pytest.fixture(scope="module")
def world():
    refs = {k: _reference(c) for k, c in REF_CELLS.items()}
    cases = dict(CELLS, **{k: c for k, (_, c) in refs.items()})
    names = list(cases)

    def parent():
        scan = {}
        for k in names:
            eng = W.build(cases[k], "scan")
            scan[k] = W.outcome(eng, W.run(eng, cases[k]))
        ref = {}
        for k, (r, _) in refs.items():
            h = r.run()
            ref[k] = dict(r=r, h=h)
        return scan, ref

    ranks, (scan, ref) = mesh_lib.run_world(2, W.run_cases, [cases[k] for k in names],
                                            during=parent)
    return dict(names=names, cases=cases, ranks=[dict(zip(names, r)) for r in ranks],
                scan=scan, ref=ref)


@pytest.mark.parametrize("name", list(CELLS))
def test_shard_matches_the_device_engine(world, name):
    c = world["cases"][name]
    r0, r1 = world["ranks"][0][name], world["ranks"][1][name]
    # both ranks: the same History and replicated state, bit for bit (the
    # clients each rank holds are its own)
    W.equal_trees({k: v for k, v in r0.items() if k != "held"},
                 {k: v for k, v in r1.items() if k != "held"}, name)
    want = world["scan"][name]
    fused_lossy = c["cfg"]["fused_round"] and "quant" in c["cfg"]["uplink_codec"]
    W.hold(r0, want, "quant" in c["cfg"]["uplink_codec"] or c["method"] == "cfd",
          tel_post_atol=5e-3 if fused_lossy else 1e-5)
    if c["scen"] == "bernoulli":  # round 2 is a total outage
        assert r0["ledger"][1] == (0.0, 0.0)
    # each rank holds its half of every cohort, in order
    for coh in range(len(r0["clients"])):
        for k, v in r0["clients"][coh].items():
            n = len(v) // 2
            np.testing.assert_array_equal(r0["held"][coh][k], v[:n])
            np.testing.assert_array_equal(world["ranks"][1][name]["held"][coh][k], v[n:])


@pytest.mark.parametrize("name", list(CELLS))
def test_no_full_width_client_tensor_stays_on_a_rank(world, name):
    """After the run, every tensor a rank's engine holds that has a client
    axis has the shard's K/2 clients on it: the clients' parameters and
    their private, validation and test arrays.  No tensor keeps all K
    (the replicated ``last_sync`` is host numpy)."""
    K = world["cases"][name]["cfg"]["n_clients"]
    client = ("client_params", "xs", "ys", "mask", "xts", "yts", "tmask",
              "train_mask_c", "val_mask_c", "xs_c", "ys_c", "xts_c", "yts_c",
              "tmask_c", "_lr_k", "_steps_k")
    for rank in world["ranks"]:
        census = rank[name]["census"]
        assert not [(p, s) for p, s in census if s and s[0] == K], name
        held = [(p, s) for p, s in census if p.split(".")[1].split("[")[0] in client]
        assert held and all(s[0] < K for _, s in held), held
        assert sum(s[0] for p, s in held if p.startswith("eng.client_params[")
                   and p.endswith(".b0")) == K // 2


@pytest.mark.parametrize("name", list(REF_CELLS))
def test_shard_matches_the_reference_scan_engine(world, name):
    c = world["cases"][name]
    ref, h = world["ref"][name]["r"], world["ref"][name]["h"]
    got = world["ranks"][0][name]
    want = dict(
        ledger=[(r.uplink, r.downlink) for r in h.ledger.rounds], rounds=h.rounds,
        cumulative_mb=h.cumulative_mb, server_acc=h.server_acc, client_acc=h.client_acc,
        cohort_acc=h.cohort_client_acc, server_val=h.server_val_loss,
        client_val=h.client_val_loss,
        cache={k: np.asarray(getattr(ref.cache_g, k)) for k in ("ts", "present", "values")},
        last_sync=np.asarray(ref.last_sync),
        server={k: np.asarray(v) for k, v in ref.server_params.items()},
        clients=[{k: np.asarray(v) for k, v in p.items()} for p in ref.client_params],
        one_sample=1.0 / len(ref.y_test))
    W.hold(got, want, "quant" in c["cfg"]["uplink_codec"])
    assert got["ledger"][1] == (0.0, 0.0)


def test_worlds_of_one_and_two_agree(world):
    """The same cell in this process as a world of one: the ledger bit for
    bit the world of two's, the state to the module's tolerances."""
    c = world["cases"][WORLD_CELL]
    with mesh_lib.world_of_one("gloo"):
        one = W.shard_outcome(c)
    assert not dist.is_initialized()
    W.hold(one, world["ranks"][0][WORLD_CELL], True)


def test_run_method_shard_is_a_world_of_one_through_its_group(monkeypatch):
    """With no process group, ``run_method(engine="shard")`` starts a world
    of one and tears it down; its collectives still go through the group:
    one all-reduce at construction and one a round (telemetry adds its
    two gauges' sums under a lossy codec), never skipped at n = 1."""
    calls = []
    real = dist.all_reduce

    def counting(t, *a, **kw):
        calls.append((tuple(t.shape), dist.get_world_size(kw.get("group"))))
        return real(t, *a, **kw)

    monkeypatch.setattr(dist, "all_reduce", counting)
    cfg = P.FLConfig(**W.BASE)
    h = P.run_method("scarlet", cfg, engine="shard", cache_duration=1, beta=1.5,
                     device="cpu")
    hs = P.run_method("scarlet", cfg, engine="scan", cache_duration=1, beta=1.5,
                      device="cpu")
    assert not dist.is_initialized()
    assert [(r.uplink, r.downlink) for r in h.ledger.rounds] == \
        [(r.uplink, r.downlink) for r in hs.ledger.rounds]
    T = cfg.rounds
    assert len(calls) == 1 + T and all(n == 1 for _, n in calls)
    calls.clear()
    P.run_method("scarlet", cfg, engine="shard", cache_duration=1, beta=1.5,
                 telemetry=True, codec="cache_delta+quant8", device="cpu")
    assert len(calls) == 1 + 3 * T


def test_shard_engine_raises_without_a_card():
    """No fallback hides the device: the default ``device="cuda"`` raises
    on a machine without one, before any process group starts."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.run_method("scarlet", P.FLConfig(**W.BASE), engine="shard")
    assert not dist.is_initialized()


def test_shard_sizes_match_the_reference():
    from repro.fl.cohorts import ClientModels as RModels, CohortSpec as RSpec

    from repro_torch.fl.cohorts import ClientModels, CohortSpec

    for sizes, n in (((4, 2), 2), ((8,), 4), ((6, 3), 3)):
        port = ClientModels([CohortSpec(s, 8) for s in sizes], 4, 3)
        ref = RModels([RSpec(s, 8) for s in sizes], 4, 3)
        assert port.shard_sizes(n) == ref.shard_sizes(n)
    port = ClientModels([CohortSpec(5, 8), CohortSpec(3, 8)], 4, 3)
    ref = RModels([RSpec(5, 8), RSpec(3, 8)], 4, 3)
    with pytest.raises(ValueError) as pe:
        port.shard_sizes(2)
    with pytest.raises(ValueError) as re_:
        ref.shard_sizes(2)
    assert str(pe.value) == str(re_.value)
