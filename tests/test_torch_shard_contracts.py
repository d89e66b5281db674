"""The sharded engine's contracts on other worlds (gloo on the CPU): a
world of four ranks as a "4" and a "2x2" mesh, the refusals, a checkpoint
split, the cost's ``group``, the analyzer's replication pass, the mesh
constructors, a failing rank and a world past its timeout.

The world of four is spawned once for the module
(``torch_shard_worker.contracts_rank``) while the parent runs the device
engine on the same cell.  Its cell is SCARLET with the 8-bit delta
uplink under Bernoulli participation with an outage, K = 8 (two clients a
rank on "4", four on "2x2"): the ledger is the device engine's bit for
bit, every rank's History and replicated state are equal bit for bit,
the two replicas of each data coordinate on "2x2" hold the same clients
bit for bit, and the state is held to ``test_torch_shard_engine``'s
tolerances.  The refusals carry the reference's ``ValueError`` texts
(``tests/test_engine_conformance.py::test_shard_engine_rejects_*``).
"""
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro_torch.fl as P
import torch_shard_worker as W
from repro_torch.fl.shard_engine import resolve_mesh
from repro_torch.launch import mesh as mesh_lib

BASE8 = dict(W.BASE, n_clients=8)
CELL = W.case("scarlet", "cache_delta+quant8", base=BASE8)
MESHES = ("4", "2x2")
# (label, case, mesh, the error's text)
REFUSALS = (
    ("indivisible-clients", W.case("scarlet", base=dict(BASE8, n_clients=6)), "4",
     "divide evenly"),
    ("indivisible-cohorts", W.case("scarlet", cohorts=((5, 16, 2), (3, 8, 1)), base=BASE8),
     "4", "not divisible over"),
    ("wider-than-the-world", CELL, "8", "needs 8 ranks, but the process group has 4"),
    ("production-on-a-small-world", CELL, "production",
     "needs 256 ranks, but the process group has 4"),
    ("no-data-axis", CELL, "model-only", "has no 'data' axis"),
    ("unknown-spec", CELL, "not-a-mesh", "unknown mesh_spec"),
    ("device-engine-modes", W.case("comet", base=BASE8), "4", "scan-safe"),
)
SPLIT_AT = 1


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


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ckpt"))

    def parent():
        eng = W.build(CELL, "scan")
        return W.outcome(eng, W.run(eng, CELL))

    ranks, scan = mesh_lib.run_world(
        4, W.contracts_rank, [(m, CELL) for m in MESHES],
        [(c, mesh) for _, c, mesh, _ in REFUSALS], (CELL, "4", SPLIT_AT), d, MESHES,
        during=parent)
    return dict(ranks=ranks, scan=scan)


@pytest.mark.parametrize("i,spec", list(enumerate(MESHES)))
def test_a_world_of_four_matches_the_device_engine(world4, i, spec):
    runs = [r["runs"][i] for r in world4["ranks"]]
    for r in runs[1:]:
        W.equal_trees({k: v for k, v in runs[0].items() if k != "held"},
                     {k: v for k, v in r.items() if k != "held"}, spec)
    W.hold(runs[0], world4["scan"], True)
    n_data = int(spec[0])
    kloc = BASE8["n_clients"] // n_data
    for rank, r in enumerate(runs):
        s = rank // (4 // n_data)  # the rank's data coordinate
        for k, v in r["clients"][0].items():
            np.testing.assert_array_equal(r["held"][0][k], v[s * kloc:(s + 1) * kloc])


def test_replicas_along_model_hold_the_same_clients(world4):
    runs = [r["runs"][MESHES.index("2x2")] for r in world4["ranks"]]
    for a, b in ((0, 1), (2, 3)):
        W.equal_trees(runs[a]["held"], runs[b]["held"], f"ranks {a} and {b}")
    assert not np.array_equal(runs[0]["held"][0]["w0"], runs[2]["held"][0]["w0"])


def test_mesh_coordinates_and_data_groups(world4):
    facts = [r["mesh"] for r in world4["ranks"]]
    assert [f["4"] for f in facts] == [((r, 0), [0, 1, 2, 3]) for r in range(4)]
    assert [f["2x2"] for f in facts] == [((0, 0), [0, 2]), ((0, 1), [1, 3]),
                                         ((1, 0), [0, 2]), ((1, 1), [1, 3])]


def test_the_cost_sums_the_shards_participants_over_its_group(world4):
    """``distillation_round_cost_device(group=)`` (the reference's
    ``axis_name``): rank r counts r + 1 participants; every rank is charged
    for the world's 10, and its own count is left as it was."""
    from repro_torch.core import comm

    up, down = comm.distillation_round_cost_device(
        n_clients=torch.full((), 10.0), n_selected=24.0, n_up_samples=10.0,
        n_down_samples=10.0, n_classes=5, with_cache_signals=True, catch_up_down=96.0)
    assert [r["cost"] for r in world4["ranks"]] == [(float(up), float(down), r + 1.0)
                                                     for r in range(4)]


def test_no_rank_imports_jax_or_the_reference(world4):
    assert [r["modules"] for r in world4["ranks"]] == [[]] * 4


@pytest.mark.parametrize("i,label", [(i, r[0]) for i, r in enumerate(REFUSALS)])
def test_refusals(world4, i, label):
    want = REFUSALS[i][3]
    for r in world4["ranks"]:
        got = r["refusals"][i]
        assert got.startswith("ValueError") and want in got, got


def test_a_checkpoint_split_is_the_uninterrupted_run_bit_for_bit(world4):
    for r in world4["ranks"]:
        s = r["split"]
        assert s["first"] + s["split"]["ledger"] == s["whole"]["ledger"]
        k = len(s["split"]["server_acc"])
        for f in ("server_acc", "client_acc", "server_val", "client_val", "cohort_acc"):
            assert s["split"][f] == s["whole"][f][-k:], f
        for f in ("cache", "server", "prev_teacher", "last_sync", "clients", "held"):
            W.equal_trees(s["split"][f], s["whole"][f], f)


def test_world_of_one_refuses_wider_meshes():
    with mesh_lib.world_of_one("gloo"):
        for spec, text in (("2", "needs 2 ranks"), ("production", "needs 256 ranks"),
                           ("production_multipod", "needs 512 ranks")):
            with pytest.raises(ValueError, match=text):
                W.build(W.case("scarlet"), "shard", spec)
        with pytest.raises(ValueError, match="unknown mesh_spec"):
            resolve_mesh("auto")  # "auto" only through the constructor
    with pytest.raises(RuntimeError, match="initialised torch.distributed"):
        W.build(W.case("scarlet"), "shard")
    with pytest.raises(ValueError, match="needs 2 ranks"):
        P.run_method("scarlet", P.FLConfig(**dict(W.BASE, mesh_spec="2")), engine="shard",
                     device="cpu")
    assert not dist.is_initialized()


def test_replication_pass_clean_on_the_repo_and_its_fixtures_flagged():
    from repro_torch.analysis import replication_checks as rc

    found = rc.check([("engine", label, name, tel) for label, name, tel in rc.ENGINE_CASES]
                     + [("fixture", label, name) for label, name in rc.FIXTURE_CASES])
    for label, _, _ in rc.ENGINE_CASES:
        assert [f.level for f in found[label]] == ["ok"], found[label]
    broken = found["fixture-broken"]
    assert {f.level for f in broken} == {"error"}
    assert any("tainted by mesh axes ['data']" in f.message for f in broken)
    assert any("differs across the 2 ranks" in f.message for f in broken)
    assert [f.level for f in found["fixture-fixed"]] == ["ok"]


def test_a_world_past_its_timeout_is_stopped():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="a world of 1 ranks ran past 2.0 s"):
        mesh_lib.run_world(1, W.hang, timeout=2.0)
    assert time.monotonic() - t0 < 30


def test_a_failing_rank_fails_the_run():
    """Rank 2 raises before its engine's first collective: the others,
    waiting in it, fail after it or are stopped, and the call raises rank
    2's error, whichever failure the join saw first."""
    with pytest.raises(torch.multiprocessing.ProcessRaisedException,
                       match="rank 2 fails") as info:
        mesh_lib.run_world(3, W.fail_on_rank_two)
    assert str(info.value).startswith("rank 2 of 3 raised first")
    assert info.value.error_index == 2


def test_the_error_names_the_rank_that_raised_first():
    """Rank 1 raises first but lingers; rank 0 raises a second later and
    exits, so the join sees rank 0's failure first.  The call still names
    rank 1, with rank 0 among the ranks that raised after it."""
    with pytest.raises(torch.multiprocessing.ProcessRaisedException,
                       match="rank 1 fails first") as info:
        mesh_lib.run_world(2, W.fail_early_and_late)
    msg = str(info.value)
    assert msg.startswith("rank 1 of 2 raised first") and "after it: [0]" in msg
    assert "rank 0 fails later" not in msg
    assert isinstance(info.value.__cause__, torch.multiprocessing.ProcessRaisedException)
