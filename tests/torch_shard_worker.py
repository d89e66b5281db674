"""What each rank of a test world runs for the sharded-engine tests
(``tests/test_torch_shard_*.py``).  A plain module, not a test file: the
spawned ranks import it by name, and it imports neither ``jax`` nor the
reference, so no rank does.

A case is a dict (it crosses the process boundary pickled): the
configuration, the strategy, the scenario by name, the engine options,
and optionally the reference's draws and initial parameters as numpy
arrays.  :func:`build` makes the engine of a case (``engine="shard"`` on
the rank's world, or ``"scan"`` in the parent); :func:`outcome` is what
the parent compares, with :func:`equal_trees` and :func:`hold`.
"""
from __future__ import annotations

import os
import sys
from typing import Any, Dict, List

import numpy as np
import torch
import torch.distributed as dist

import repro_torch.fl as P
from repro_torch.checkpoint import load_pytree, save_pytree
from repro_torch.launch import mesh as mesh_lib
from repro_torch.obs.device import EXACT_FIELDS, GAUGE_FIELDS

BASE = dict(n_clients=6, n_classes=5, dim=8, rounds=3, local_steps=3,
            distill_steps=3, public_size=60, public_per_round=24,
            private_size=120, hidden=16, eval_every=1, alpha=0.5)
# per-client E_k (client 0 frozen) and rate scales, with a decay
HET = dict(local_steps=(0, 2, 3, 1, 3, 2), lr_scale=(0.5, 1.0, 2.0, 1.0, 0.5, 2.0),
           lr_decay=0.9)


def scenario(name: str, K: int):
    """``full``; ``bernoulli``: p = 0.6 a round, every client offline in
    round 2 (a total outage); ``het``: bernoulli's with the heterogeneous
    schedules of :data:`HET`."""
    if name == "full":
        return P.Scenario()
    het = P.Heterogeneity(**HET) if name == "het" else None
    return P.Scenario(participation=P.bernoulli_participation(0.6),
                      outages=tuple(P.Outage(k, 2, 2) for k in range(K)),
                      heterogeneity=het)


def case(method: str, codec: str = "identity", scen: str = "bernoulli", *, fused=False,
         telemetry=False, cohorts=None, prob=False, base=None) -> Dict[str, Any]:
    """A cell: ``method`` (SCARLET at beta 1.5 with the cache at D = 1, so
    entries expire within the run) on ``base`` (default :data:`BASE`)
    with the uplink ``codec`` under :func:`scenario` ``scen``;
    ``cohorts`` as ``CohortSpec`` argument tuples; ``prob`` probabilistic
    expiry."""
    cfg = dict(base or BASE, uplink_codec=codec, fused_round=fused, telemetry=telemetry)
    if cohorts is not None:
        cfg["cohorts"] = tuple(P.CohortSpec(*c) for c in cohorts)
    return dict(method=method, cfg=cfg, scen=scen, prob=prob,
                skw={"beta": 1.5} if method == "scarlet" else {},
                D=1 if method == "scarlet" else 0)


def build(c: Dict[str, Any], engine: str, mesh=None):
    cfg = P.FLConfig(**c["cfg"])
    kw = dict(cache_duration=c["D"], scenario=scenario(c["scen"], cfg.n_clients),
              probabilistic_expiry=c["prob"], device="cpu")
    if engine == "shard":
        eng = P.ShardedFederatedDistillation(cfg, P.STRATEGIES[c["method"]](**c["skw"]),
                                             mesh=mesh or c.get("mesh"), **kw)
    else:
        eng = P.ScannedFederatedDistillation(cfg, P.STRATEGIES[c["method"]](**c["skw"]), **kw)
    if c.get("params") is not None:
        eng.load_params(*c["params"])
    return eng


def run(eng, c: Dict[str, Any], rounds=None, t0=0):
    """A leg of ``rounds`` (default the configured count) from round
    ``t0 + 1``, on the case's own draws when it has them."""
    T = eng.cfg.rounds if rounds is None else rounds
    kw = {}
    if c.get("draws") is not None:
        part, idx = c["draws"]
        kw["draws"] = (part[t0:t0 + T], idx[t0:t0 + T])
    return eng.run(T, **kw)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def outcome(eng, hist, clients=None) -> Dict[str, Any]:
    """The History and the state after a run, as numpy: ``clients`` is
    every client's parameters (the sharded engine's gathered
    ``state_dict``), ``held`` the clients this process holds."""
    out = dict(
        ledger=[(r.uplink, r.downlink) for r in hist.ledger.rounds],
        rounds=hist.rounds, server_acc=hist.server_acc, client_acc=hist.client_acc,
        server_val=hist.server_val_loss, client_val=hist.client_val_loss,
        cohort_acc=hist.cohort_client_acc, cumulative_mb=hist.cumulative_mb,
        one_sample=1.0 / len(eng.y_test),
        cache={k: _np(v) for k, v in eng.cache_g._asdict().items()},
        server={k: _np(v) for k, v in eng.server_params.items()},
        prev_teacher=_np(eng.prev_teacher[1]) if eng.prev_teacher is not None else None,
        last_sync=np.asarray(eng.last_sync).copy(),
        held=[{k: _np(v) for k, v in p.items()} for p in eng.client_params],
        clients=[{k: _np(v) for k, v in p.items()}
                 for p in (clients if clients is not None else eng.client_params)])
    if hist.telemetry is not None:
        out["telemetry"] = hist.telemetry.stacks()
    return out


def tensor_census(obj, path: str = "eng", out=None, seen=None) -> List[tuple]:
    """(path, shape) of every tensor reachable from ``obj`` through the
    attributes of the port's objects, dicts, lists and tuples."""
    out = [] if out is None else out
    seen = set() if seen is None else seen
    if id(obj) in seen:
        return out
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        out.append((path, tuple(obj.shape)))
    elif isinstance(obj, dict):
        for k, v in obj.items():
            tensor_census(v, f"{path}.{k}", out, seen)
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            tensor_census(v, f"{path}[{i}]", out, seen)
    elif hasattr(obj, "__dict__") and type(obj).__module__.startswith("repro_torch"):
        for k, v in vars(obj).items():
            tensor_census(v, f"{path}.{k}", out, seen)
    return out


def shard_outcome(c: Dict[str, Any], mesh=None) -> Dict[str, Any]:
    eng = build(c, "shard", mesh)
    hist = run(eng, c)
    census = tensor_census(eng)  # before state_dict's gather
    return dict(outcome(eng, hist, eng.state_dict()["client_params"]), census=census)


def run_cases(cases: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Every case on this rank (a rank of the parity world)."""
    return [shard_outcome(c) for c in cases]


def refusal(c: Dict[str, Any], mesh) -> str:
    """The message of the error constructing the case's engine on
    ``mesh`` raises ("" when it does not raise).  ``mesh="model-only"``
    is a mesh of the whole world along "model" alone."""
    if mesh == "model-only":
        mesh = mesh_lib.make_mesh((dist.get_world_size(),), ("model",))
    try:
        build(c, "shard", mesh)
    except ValueError as e:
        return f"ValueError: {e}"
    return ""


def run_contracts(cases, refusals, split, ckpt_dir) -> Dict[str, Any]:
    """A rank of the contracts world: each (mesh, case) of ``cases``; each
    (case, mesh) of ``refusals``; then ``split`` = (case, mesh, at): the
    run uninterrupted, and again split after ``at`` rounds by a
    checkpoint that rank 0 writes in the reference's npz format under
    ``ckpt_dir`` and every rank restores into a fresh engine."""
    out = dict(runs=[shard_outcome(c, mesh) for mesh, c in cases],
               refusals=[refusal(c, mesh) for c, mesh in refusals])
    c, mesh, at = split
    whole = build(c, "shard", mesh)
    hw = run(whole, c)
    a = build(c, "shard", mesh)
    h1 = run(a, c, at)
    state = a.state_dict()  # every rank takes part in the gather
    path = os.path.join(ckpt_dir, "ckpt.npz")
    if dist.get_rank() == 0:
        save_pytree(path, state)
    dist.barrier()
    b = build(c, "shard", mesh)
    b.load_state_dict(load_pytree(path, b.state_dict()))
    h2 = run(b, c, c["cfg"]["rounds"] - at, t0=at)
    out["split"] = dict(whole=outcome(whole, hw, whole.state_dict()["client_params"]),
                        split=outcome(b, h2, b.state_dict()["client_params"]),
                        first=[(r.uplink, r.downlink) for r in h1.ledger.rounds])
    return out


def equal_trees(a, b, what):
    """``a`` and ``b`` (nested dicts, lists, numpy arrays, numbers) equal,
    arrays bit for bit."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            equal_trees(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            equal_trees(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, what
        assert a.tobytes() == b.tobytes(), what
    else:
        assert a == b, what


def hold(got, want, lossy, *, tel_post_atol=1e-5):
    """A shard outcome against a device-engine (or reference-mapped)
    outcome, at the tolerances of ``test_torch_shard_engine``'s
    docstring (``lossy``: an 8-bit codec on the path)."""
    assert got["ledger"] == want["ledger"]
    assert got["rounds"] == want["rounds"]
    assert got["cumulative_mb"] == want["cumulative_mb"]
    for k in ("ts", "present"):
        np.testing.assert_array_equal(got["cache"][k], want["cache"][k])
    np.testing.assert_allclose(got["cache"]["values"], want["cache"]["values"], rtol=0,
                               atol=5e-3 if lossy else 1e-5)
    np.testing.assert_array_equal(got["last_sync"], want["last_sync"])
    for k, v in want["server"].items():
        np.testing.assert_allclose(got["server"][k], v, rtol=0, atol=1e-4, err_msg=k)
    for gc, wc in zip(got["clients"], want["clients"]):
        for k, v in wc.items():
            np.testing.assert_allclose(gc[k], v, rtol=0, atol=1e-4, err_msg=k)
    one = want["one_sample"]
    for k in ("server_acc", "client_acc", "cohort_acc"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=one, err_msg=k)
    for k in ("server_val", "client_val"):
        assert len(got[k]) == len(want[k]), k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    if "telemetry" in want:
        for f in EXACT_FIELDS:
            np.testing.assert_array_equal(got["telemetry"][f], want["telemetry"][f], err_msg=f)
        for f in GAUGE_FIELDS:
            atol = tel_post_atol if f == "teacher_entropy_post" else 1e-5
            np.testing.assert_allclose(got["telemetry"][f], want["telemetry"][f], rtol=1e-5,
                                       atol=atol, err_msg=f)


def mesh_facts(specs):
    """This rank's coordinates and data-axis group ranks on each mesh."""
    from repro_torch.fl.shard_engine import resolve_mesh

    out = {}
    for spec in specs:
        m = resolve_mesh(spec)
        out[spec] = (m.coords, dist.get_process_group_ranks(m.group))
    return out


def contracts_rank(cases, refusals, split, ckpt_dir, specs):
    """:func:`run_contracts`, then :func:`mesh_facts` of ``specs`` and the
    JAX or reference modules this rank has imported (none)."""
    out = run_contracts(cases, refusals, split, ckpt_dir)
    out["mesh"] = mesh_facts(specs)
    out["modules"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro"))
    out["cost"] = shard_cost()
    return out


def shard_cost():
    """One round's bytes from this rank's participant count (rank + 1) with
    the world as the cost's ``group``: every rank gets the cost of the
    world's total count."""
    from repro_torch.core import comm

    count = torch.full((), float(dist.get_rank() + 1))
    up, down = comm.distillation_round_cost_device(
        n_clients=count, n_selected=24.0, n_up_samples=10.0, n_down_samples=10.0,
        n_classes=5, with_cache_signals=True, catch_up_down=96.0, group=dist.group.WORLD)
    return float(up), float(down), float(count)


def fail_on_rank_two():
    """Rank 2 raises; the others build an engine over the world of three
    (K = 6) and wait in its first collective."""
    if dist.get_rank() == 2:
        raise RuntimeError("rank 2 fails")
    c = case("scarlet")
    return run(build(c, "shard", "3"), c)


def hang():
    """A rank that never finishes."""
    import time

    time.sleep(3600)


def fail_early_and_late():
    """Rank 1 raises at once but its process lingers 3 s (a non-daemon
    thread holds its exit); rank 0 raises 1 s later and exits at once, so
    the join sees rank 0 fail first."""
    import threading
    import time

    if dist.get_rank() == 1:
        threading.Thread(target=time.sleep, args=(3.0,)).start()
        raise RuntimeError("rank 1 fails first")
    time.sleep(1.0)
    raise RuntimeError("rank 0 fails later")
