"""The expert-parallel all-to-all MoE (``repro_torch.models.moe_a2a``)
against the reference's ``repro.models.moe_a2a.moe_ffn_a2a``.

One gloo world of four ranks on the CPU (spawned once for the module,
``torch_moe_worker.a2a_rank``) holds the ("data", "model") meshes (4, 1)
and (2, 2); each rank runs ``moe_ffn_a2a`` and ``common.moe_ffn`` under
``MOE_A2A_MESH`` on its rows of the batch and its shards of the expert
stacks (``expert_shard``), and ``common.moe_ffn`` on DTensors over a
``DeviceMesh`` of the same shape (the dry run's seam).  Meanwhile this
process runs the reference's ``shard_map`` on ``make_test_mesh(4, 1)`` /
``(2, 2)`` over the 8 host devices that ``tests/conftest.py`` forces.
Float32 at capacity factor 1.25 (a skewed router, so experts overflow and
entries drop) and 8.0 (nothing drops): the gathered outputs and the aux
loss to 1e-5, and the gradients of a loss of both against ``jax.grad`` of
the reference: a rank's shards' gradients against their slices, x's and
the router's summed over the ranks that hold a copy.  Full stacks or a
wrong shard width raise before any collective.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_moe_worker as W
from repro.launch.mesh import make_test_mesh
from repro.models import moe_a2a as jmoe_a2a
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import common as cm

B, S, D, F, E, TOP_K = 8, 64, 32, 64, 8, 2
MESHES = ((4, 1), (2, 2))
FACTORS = (1.25, 8.0)
CASES = [(m, cf) for m in MESHES for cf in FACTORS]
IDS = [f"{m[0]}x{m[1]}-cf{cf}" for m, cf in CASES]
ATOL = 1e-5
AUX_WEIGHT = 0.7


def _inputs():
    rng = np.random.default_rng(0)
    # a shared offset on every token skews the experts' popularity, so at
    # 1.25 every rank drops entries
    x = rng.standard_normal((B, S, D)).astype(np.float32) + 0.3
    router = rng.standard_normal((D, E)).astype(np.float32)
    w1, w3 = (rng.standard_normal((E, D, F)).astype(np.float32) * 0.1 for _ in range(2))
    w2 = rng.standard_normal((E, F, D)).astype(np.float32) * 0.1
    return x, router, w1, w3, w2


def _cotangent():
    return np.random.default_rng(1).standard_normal((B, S, D)).astype(np.float32)


def _reference():
    """The reference's (out, aux) of every case, under jit on its mesh,
    and ``jax.grad`` of ``sum(out * cotangent) + AUX_WEIGHT * aux`` with
    respect to x, the router and the three stacks."""
    inputs = [jnp.asarray(a) for a in _inputs()]
    ct = jnp.asarray(_cotangent())
    out = []
    for shape, cf in CASES:
        mesh = make_test_mesh(*shape)

        def f(*a, mesh=mesh, cf=cf):
            return jmoe_a2a.moe_ffn_a2a(*a, top_k=TOP_K, mesh=mesh, capacity_factor=cf)

        def loss(*a, f=f):
            y, aux = f(*a)
            return jnp.sum(y * ct) + AUX_WEIGHT * aux

        with mesh:
            y, aux = jax.jit(f)(*inputs)
            grads = jax.jit(jax.grad(loss, argnums=tuple(range(5))))(*inputs)
        out.append((np.asarray(y), float(aux),
                    dict(zip(W.GRAD_LEAVES, (np.asarray(g) for g in grads)))))
    return out


@pytest.fixture(scope="module")
def world():
    ranks, ref = mesh_lib.run_world(4, W.a2a_rank, _inputs(), TOP_K, CASES, _cotangent(),
                                    AUX_WEIGHT, during=_reference)
    return dict(ranks=ranks, ref=ref)


def _gathered(world, i, route):
    """The batch's output from the ranks of each data coordinate along
    model 0, in the data axis's order; the replicas along "model" equal
    them bit for bit."""
    rows = [r["cases"][i] for r in world["ranks"]]
    by_coord = {}
    for c in rows:
        d = c["coords"][0]
        if d in by_coord:
            np.testing.assert_array_equal(c[route]["out"], by_coord[d][route]["out"])
        else:
            by_coord[d] = c
    return np.concatenate([by_coord[d][route]["out"] for d in sorted(by_coord)]), rows


@pytest.mark.parametrize("route", ["direct", "via"])
@pytest.mark.parametrize("i,case", list(enumerate(CASES)), ids=IDS)
def test_matches_the_reference(world, i, case, route):
    """``moe_ffn_a2a`` itself ("direct") and ``common.moe_ffn`` under
    ``MOE_A2A_MESH`` ("via") equal the reference's shard_map on the same
    mesh, output and aux."""
    want, want_aux, _ = world["ref"][i]
    got, rows = _gathered(world, i, route)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    for c in rows:
        assert abs(c[route]["aux"] - want_aux) <= ATOL


@pytest.mark.parametrize("i,case", list(enumerate(CASES)), ids=IDS)
def test_dropped_counts_match_a_host_recount(world, i, case):
    """Each rank's device count of dropped entries is the host's recount
    from its routing: an expert keeps its first cap_e entries.  Entries
    drop on every rank at 1.25 (the inputs skew the routing) and none at
    8.0."""
    for c in (r["cases"][i] for r in world["ranks"]):
        r = c["direct"]
        counts = np.bincount(r["eidx"].ravel(), minlength=E)
        want = int(np.sum(np.maximum(counts - r["capacity"], 0)))
        assert r["dropped"] == want == c["via"]["dropped"]
        assert (want > 0) == (case[1] == 1.25)


def test_nothing_dropped_equals_the_single_device_moe(world):
    """At capacity factor 8 the gathered output is the port's
    single-device ``moe_ffn`` of the whole batch; the aux loss is the mean
    of the single-device loss over each data coordinate's rows."""
    x, *w = (torch.from_numpy(a) for a in _inputs())
    for i, (shape, cf) in enumerate(CASES):
        if cf != 8.0:
            continue
        want, _ = cm.moe_ffn(x, *w, top_k=TOP_K, capacity_factor=cf)
        got, rows = _gathered(world, i, "direct")
        np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=ATOL)
        b = B // shape[0]
        aux = np.mean([float(cm.moe_ffn(x[d * b:(d + 1) * b], *w, top_k=TOP_K,
                                        capacity_factor=cf)[1]) for d in range(shape[0])])
        assert abs(rows[0]["direct"]["aux"] - aux) <= ATOL


def _shard_slices(coords, shape):
    """The slices of w1/w3 and of w2 that the rank at ``coords`` holds on
    a mesh of ``shape``: its E / n experts and, where M divides F, its F /
    M columns of the FFN dim."""
    (d, m), (n, M) = coords, shape
    e, f = E // n, (F // M if M > 1 and F % M == 0 else F)
    c = m * f if f != F else 0
    return ((slice(d * e, (d + 1) * e), slice(None), slice(c, c + f)),
            (slice(d * e, (d + 1) * e), slice(c, c + f)))


@pytest.mark.parametrize("i,case", list(enumerate(CASES)), ids=IDS)
def test_each_rank_holds_only_its_shards(world, i, case):
    """Every rank ran on (E / n, D, F_loc) and (E / n, F_loc, D), F_loc =
    F / M: a quarter of the stacks on (4, 1) and on (2, 2)."""
    n, M = case[0]
    for c in (r["cases"][i] for r in world["ranks"]):
        assert c["shard_shapes"] == [(E // n, D, F // M), (E // n, D, F // M),
                                     (E // n, F // M, D)]


@pytest.mark.parametrize("i,case", list(enumerate(CASES)), ids=IDS)
def test_gradients_match_jax_grad(world, i, case):
    """The gradients through both all-to-alls, the model-axis sum and the
    aux loss's data-axis mean: each rank's gradient of its share of the
    loss equals ``jax.grad`` of the reference's loss, each leaf to 1e-5 of
    its largest magnitude: for its shards of w1, w3 and w2 the matching
    slices with no sum over ranks, for its rows of x summed over "model",
    for the router summed over every rank."""
    want = world["ref"][i][2]
    cases = [r["cases"][i] for r in world["ranks"]]
    n = case[0][0]
    got = {"router": sum(c["grads"]["router"] for c in cases),
           "x": np.concatenate([sum(c["grads"]["x"] for c in cases if c["coords"][0] == d)
                                for d in range(n)])}
    for k in W.GRAD_LEAVES:
        scale = float(np.abs(want[k]).max())
        assert scale > 0, k
        if k in got:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=ATOL * scale, err_msg=k)
            continue
        for c in cases:
            sl = _shard_slices(c["coords"], case[0])[k == "w2"]
            np.testing.assert_allclose(c["grads"][k], want[k][sl], rtol=0, atol=ATOL * scale,
                                       err_msg=f"{k} at {c['coords']}")


@pytest.mark.parametrize("i,case", list(enumerate(CASES)), ids=IDS)
def test_dtensor_seam_matches_the_reference(world, i, case):
    """``common.moe_ffn`` on DTensors (the dry run's ``_local_a2a``) on a
    ``DeviceMesh`` of the case's shape: the global output and aux, and the
    gradients of the global loss with respect to all five inputs, equal
    the reference's at the same tolerances; the stacks' gradients stay
    sharded as the stacks are (no rank holds a whole stack's gradient)."""
    want, want_aux, want_grads = world["ref"][i]
    split = case[0][1] > 1
    for c in (r["cases"][i] for r in world["ranks"]):
        got = c["dtensor"]
        np.testing.assert_allclose(got["out"], want, rtol=0, atol=ATOL)
        assert abs(got["aux"] - want_aux) <= ATOL
        for k in W.GRAD_LEAVES:
            scale = float(np.abs(want_grads[k]).max())
            np.testing.assert_allclose(got["grads"][k], want_grads[k], rtol=0,
                                       atol=ATOL * scale, err_msg=k)
        assert [p[0] for p in got["placements"].values()] == ["Shard(0)"] * 3
        if split:
            assert got["placements"] == {"w1": ["Shard(0)", "Shard(2)"],
                                         "w3": ["Shard(0)", "Shard(2)"],
                                         "w2": ["Shard(0)", "Shard(1)"]}


def _refusals():
    """(label, call) pairs that must raise ``ValueError`` before any
    collective: on a (2, 2) mesh a rank's shards are (4, D, F / 2) and (4,
    F / 2, D)."""
    from repro_torch.models import moe_a2a

    mesh = mesh_lib.Mesh((2, 2), ("data", "model"), (0, 1))
    x, router, w1, w3, w2 = (torch.from_numpy(a) for a in _inputs())
    xs = x[:B // 2]
    s1, s3, s2 = moe_a2a.expert_shard(w1, w3, w2, mesh)

    def a2a(*w, d_ff=F):
        return lambda: moe_a2a.moe_ffn_a2a(xs, router, *w, top_k=TOP_K, mesh=mesh, d_ff=d_ff)

    def via():
        cm.MOE_A2A_MESH = mesh
        try:
            cm.moe_ffn(xs, router, s1, s3, s2, top_k=TOP_K)
        finally:
            cm.MOE_A2A_MESH = None

    return [("full stacks", a2a(w1, w3, w2)),
            ("the rank's experts, F unsplit", a2a(w1[:4], w3[:4], w2[:4])),
            ("F_loc of another F", a2a(s1, s3, s2, d_ff=2 * F)),
            ("a (4, 1) rank's shards", a2a(*moe_a2a.expert_shard(
                w1, w3, w2, mesh_lib.Mesh((4, 1), ("data", "model"), (0, 0))))),
            ("moe_ffn without d_ff", via)]


@pytest.mark.parametrize("k", range(5), ids=[lbl for lbl, _ in _refusals()])
def test_full_stacks_or_a_wrong_shard_width_raise(k):
    with pytest.raises(ValueError):
        _refusals()[k][1]()


def test_expert_shard_cuts_own_copies():
    """``expert_shard`` gives each rank of (2, 2) new tensors holding
    exactly its slices, which together tile the stacks."""
    from repro_torch.models import moe_a2a

    w = [torch.from_numpy(a) for a in _inputs()[2:]]
    for d in range(2):
        for m in range(2):
            mesh = mesh_lib.Mesh((2, 2), ("data", "model"), (d, m))
            sl = _shard_slices((d, m), (2, 2))
            for t, full, s in zip(moe_a2a.expert_shard(*w, mesh), w, (sl[0], sl[0], sl[1])):
                assert torch.equal(t, full[s])
                assert t.untyped_storage().nbytes() == t.numel() * t.element_size()


def test_mesh_groups_follow_the_axes(world):
    """(4, 1): the data group is the world and no model group (an axis of
    one rank); (2, 2): data groups {0, 2} and {1, 3}, model groups {0, 1}
    and {2, 3}."""
    facts = [[(c["coords"], c["data_ranks"], c["model_ranks"]) for c in r["cases"]]
             for r in world["ranks"]]
    assert [f[0] for f in facts] == [((r, 0), [0, 1, 2, 3], None) for r in range(4)]
    assert [f[2] for f in facts] == [((0, 0), [0, 2], [0, 1]), ((0, 1), [1, 3], [0, 1]),
                                     ((1, 0), [0, 2], [2, 3]), ((1, 1), [1, 3], [2, 3])]


def test_all_to_all_sends_block_i_to_rank_i(world):
    for r, out in enumerate(world["ranks"]):
        want = (10 * np.arange(4, dtype=np.float32) + r)[:, None].repeat(3, 1)
        np.testing.assert_array_equal(out["exchanged"], want)
        assert "first axis 5, the group has 4 ranks" in out["refusal"]


def test_no_rank_imports_jax_or_the_reference(world):
    assert [r["modules"] for r in world["ranks"]] == [[]] * 4
