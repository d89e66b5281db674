"""Replication of the sharded engine's state (counterpart of
``repro.analysis.replication_checks``).

The client-sharded engine (:mod:`repro_torch.fl.shard_engine`) keeps its
server-side state replicated: every rank computes the cache, the teacher,
the server's parameters, ``last_sync``, telemetry and the round's results
from the same inputs, with no communication, and nothing checks that they
stay equal.  A leaf whose update reads a shard's own data without a sum
over the shards first (the reference's old ``last_sync`` bug: an update
keyed on the shard-local participation slice) silently varies from rank
to rank.

The pass runs one real round of a small sharded engine on each rank of a
gloo world of two on the CPU, under :class:`TaintMode`, a
``TorchDispatchMode`` that carries the set of mesh axes each value varies
over, by storage:

- the declared shard-local leaves
  (:meth:`~repro_torch.fl.shard_engine.ShardedFederatedDistillation.shard_local_leaves`)
  and what the engine's slicing seam (``_shard_local``) returns are
  tainted ``{"data"}``;
- a c10d all-reduce (the engine's only collective in a round) clears
  ``"data"`` from the tensors it reduces;
- every other operation unions its inputs' taints into its outputs and
  into the arguments it writes.

A leaf of the new state other than the clients' parameters, or of the
round's results, that ends up tainted is an **error**.  Beside the taint,
every such leaf is compared across the two ranks, bit for bit.

``--strict`` runs it on scarlet and mean, each with telemetry off and on,
as the reference's ``check_engine`` does; ``--selftest`` holds the
deliberately broken carry update (:func:`repro_torch.analysis.fixtures.
broken_carry_fn`) and its repaired twin to the same check.
"""
from __future__ import annotations

from typing import Any, Dict, FrozenSet, List, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.report import Finding

__all__ = ["TaintMode", "ENGINE_CASES", "FIXTURE_CASES", "WORLD", "check", "check_engine",
           "run"]

Taint = FrozenSet[str]
_EMPTY: Taint = frozenset()
_DATA = "data"
WORLD = 2  # ranks of the gloo world the pass runs on

# (label, strategy, telemetry): the reference's check_engine variants
ENGINE_CASES = tuple((name + ("+telemetry" if tel else ""), name, tel)
                     for name in ("scarlet", "mean") for tel in (False, True))
# (label, fixtures function)
FIXTURE_CASES = (("fixture-broken", "broken_carry_fn"), ("fixture-fixed", "fixed_carry_fn"))


class TaintMode(TorchDispatchMode):
    """Carries mesh-axis taints through every operation run under it,
    keyed by storage, so a write through a view taints what the view's
    base holds.  Every storage it has seen is kept alive until the mode is
    dropped, so no key is reused."""

    def __init__(self):
        super().__init__()
        self._taint: Dict[int, Taint] = {}
        self._keep: Dict[int, Any] = {}

    def _key(self, t: torch.Tensor) -> int:
        st = t.untyped_storage()
        k = st._cdata
        self._keep.setdefault(k, st)
        return k

    def of(self, t: torch.Tensor) -> Taint:
        return self._taint.get(self._key(t), _EMPTY)

    def mark(self, tree, axes=(_DATA,)) -> None:
        """Add ``axes`` to the taint of every tensor in ``tree``."""
        for t in pytree.tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                k = self._key(t)
                self._taint[k] = self._taint.get(k, _EMPTY) | frozenset(axes)

    def _set(self, t: torch.Tensor, taint: Taint) -> None:
        self._taint[self._key(t)] = taint

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        tensors = [a for a in pytree.tree_leaves((args, kwargs)) if isinstance(a, torch.Tensor)]
        base = frozenset().union(*(self.of(t) for t in tensors))
        out = func(*args, **kwargs)
        if func.namespace == "c10d" and func._opname.startswith("allreduce"):
            for t in pytree.tree_leaves(args[0]):  # the reduced tensors
                self._set(t, self.of(t) - {_DATA})
            return out
        for i, a in enumerate(func._schema.arguments):
            if a.alias_info is not None and a.alias_info.is_write:
                val = args[i] if i < len(args) else kwargs.get(a.name)
                for t in pytree.tree_leaves(val):
                    if isinstance(t, torch.Tensor):
                        self._set(t, self.of(t) | base)
        for t in pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._set(t, self.of(t) | base)
        return out


def _labelled(tree, prefix: str) -> List[Tuple[str, torch.Tensor]]:
    leaves, _ = pytree.tree_flatten_with_path(tree)
    return [(prefix + pytree.keystr(path), t) for path, t in leaves
            if isinstance(t, torch.Tensor)]


def build_engine(method: str, telemetry: bool):
    """The pass's engine: K = 8 over the world's data axis (4 clients a
    rank), m = 8 of |P| = 32, N = 4, half the clients a round, SCARLET
    with the cache, on the CPU."""
    from repro_torch.fl.config import FLConfig
    from repro_torch.fl.scenarios import Scenario, bernoulli_participation
    from repro_torch.fl.shard_engine import ShardedFederatedDistillation
    from repro_torch.fl.strategies import STRATEGIES

    cfg = FLConfig(n_clients=8, rounds=1, public_size=32, public_per_round=8, n_classes=4,
                   dim=8, hidden=8, private_size=64, local_steps=1, distill_steps=1,
                   seed=0, telemetry=telemetry)
    return ShardedFederatedDistillation(
        cfg, STRATEGIES[method](), cache_duration=2 if method == "scarlet" else 0,
        scenario=Scenario(participation=bernoulli_participation(0.5)),
        mesh=str(dist.get_world_size()), device="cpu")


def _trace_engine_round(method: str, telemetry: bool):
    """One evaluated round of the pass's engine under :class:`TaintMode`:
    (taint of each replicated leaf, its value)."""
    eng = build_engine(method, telemetry)
    leg = eng._start_leg(1, None)
    mode = TaintMode()
    mode.mark(eng.shard_local_leaves())
    seam = eng._shard_local

    def tainted_seam(x):  # a copy, so the full-width input stays clean
        y = seam(x).clone()
        mode.mark(y)
        return y

    eng._shard_local = tainted_seam
    with mode:
        st, out = eng._round_device(leg.state, leg.ts[0], leg.part[0], leg.idx[0], True)
    st = {k: v for k, v in st.items() if k != "client_params"}
    leaves = _labelled(st, "state") + _labelled(out, "out")
    return ({k: sorted(mode.of(t)) for k, t in leaves},
            {k: t.numpy().copy() for k, t in leaves})


def _trace_fixture(name: str):
    """A fixture's carry update (``last_sync`` of 8 clients, round 1) with
    this rank's data coordinate as its shard-local input."""
    from repro_torch.analysis import fixtures

    body = getattr(fixtures, name)()
    last_sync, t = torch.zeros(8, dtype=torch.int32), torch.tensor(1, dtype=torch.int32)
    six = torch.tensor(dist.get_rank(), dtype=torch.int32)
    mode = TaintMode()
    mode.mark(six)
    with mode:
        new = body(last_sync, t, six, dist.group.WORLD)
    return {"last_sync": sorted(mode.of(new))}, {"last_sync": new.numpy().copy()}


def _rank_cases(cases: Sequence[tuple]) -> list:
    """Each case on this rank: ("engine", label, strategy, telemetry) or
    ("fixture", label, fixtures function)."""
    out = []
    for case in cases:
        if case[0] == "engine":
            out.append(_trace_engine_round(case[2], case[3]))
        else:
            out.append(_trace_fixture(case[2]))
    return out


def check(cases: Sequence[tuple], pass_name: str = "replication") -> Dict[str, List[Finding]]:
    """Run ``cases`` on a gloo world of :data:`WORLD` ranks (one spawn for
    all of them) and turn each into findings, by its label."""
    from repro_torch.launch.mesh import run_world

    results = run_world(WORLD, _rank_cases, list(cases))
    found: Dict[str, List[Finding]] = {}
    for i, case in enumerate(cases):
        label = case[1]
        taints, values = results[0][i]
        got = []
        for leaf, taint in taints.items():
            if taint:
                got.append(Finding(
                    "error", pass_name, f"{label}:{leaf}",
                    f"declared replicated but its update is tainted by mesh axes {taint}: "
                    "it reads a shard's own data with no all-reduce in between, so the "
                    "ranks disagree"))
        for leaf, v in values.items():
            others = [r[i][1][leaf] for r in results[1:]]
            if not all(o.dtype == v.dtype and o.shape == v.shape
                       and o.tobytes() == v.tobytes() for o in others):
                got.append(Finding("error", pass_name, f"{label}:{leaf}",
                                   f"differs across the {WORLD} ranks"))
        if not got:
            got.append(Finding(
                "ok", pass_name, label,
                f"all {len(taints)} replicated leaves untainted and equal bit for bit on "
                f"{WORLD} ranks"))
        found[label] = got
    return found


def check_engine() -> List[Finding]:
    """The repo's engines: :data:`ENGINE_CASES` in one world."""
    found = check([("engine", label, name, tel) for label, name, tel in ENGINE_CASES])
    return [f for label, _, _ in ENGINE_CASES for f in found[label]]


def run() -> List[Finding]:
    return check_engine()
