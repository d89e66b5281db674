"""Active-set engine contracts: the O(m)/O(K) split (counterpart of
``repro.analysis.active_checks``).

The active-set engine (:mod:`repro_torch.fl.active_engine`) promises two
properties that its runs do not check:

1. **Scan safety** of both round steps: the O(K) bookkeeping step and the
   O(m) gathered client step run under the sync guard on the card and must
   not read the card on the host, copy to the host or draw from a host
   RNG.  Each step is traced on fake CUDA tensors
   (:func:`repro_torch.analysis.traceutil.trace`) with the shapes of the
   engine's own example arguments (``active_round_fns``): nothing
   executes.
2. **K-separation**: the client step must hold **no tensor with a K-sized
   dimension**, as an argument, as a tensor the engine holds, or as an
   intermediate.  One ``(K,)`` operand (say the device ``last_sync``
   mirror folded into a cost expression) and device memory grows with the
   population again, at K = 10^6 as at K = 100, while every test at small
   K still passes.  The bookkeeping step, conversely, must hold one: else
   the check is looking at the wrong function and proves nothing.

   The reference reads every aval of each step's jaxpr, closed-over
   constants included.  A fake-tensor trace does not see the engine's own
   tensors (``x_pub``, the cache, the ``last_sync`` mirror) that a step
   reads from ``self``, so this pass runs each step once, for real, on the
   CPU, under a dispatch mode that records the shape of every input and
   output of every aten op, and looks for a dimension equal to K.

The pass builds its engines at a **prime** population (K = 193), so no
other dimension (the public subset, the classes, the widths, a
power-of-two gather capacity) can equal K by chance.
"""
from __future__ import annotations

from typing import Any, List, Optional, Set, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch.analysis.report import Finding
from repro_torch.analysis.traceutil import tensor_spec, trace

__all__ = ["K_ANALYSIS", "ANALYSIS_VARIANTS", "analysis_config", "build_engine",
           "k_shapes", "check_engine", "run"]

# prime, so gather capacities (powers of two), data dims and public sizes
# can never equal it by coincidence
K_ANALYSIS = 193

# (label, strategy, strategy kwargs, engine kwargs, uplink codec): cache on
# and off and the delta+quant codec path, as the reference's; the cache
# tensors are O(|P|) and legal inside the client step, the O(K)
# bookkeeping is not
ANALYSIS_VARIANTS = (
    ("scarlet", "scarlet", {}, {"cache_duration": 2}, "identity"),
    ("scarlet+cache_delta+quant8", "scarlet", {}, {"cache_duration": 2},
     "cache_delta+quant8"),
    ("dsfl", "dsfl", {}, {}, "identity"),
)


def analysis_config(codec: str = "identity"):
    """The reference's configuration for this pass: K = 193 clients, two
    private rows each, m = 8 of |P| = 32, N = 4."""
    from repro_torch.fl.config import FLConfig

    return FLConfig(
        n_clients=K_ANALYSIS, rounds=2, public_size=32, public_per_round=8,
        n_classes=4, dim=8, hidden=8, private_size=2 * K_ANALYSIS,
        local_steps=1, distill_steps=1, seed=0, partition="uniform",
        uplink_codec=codec)


def build_engine(strategy: str, strat_kw: dict, eng_kw: dict, codec: str):
    """One variant's active engine on the CPU, under bernoulli(0.3)
    participation."""
    from repro_torch.fl.active_engine import ActiveSetFederatedDistillation
    from repro_torch.fl.scenarios import Scenario, bernoulli_participation
    from repro_torch.fl.strategies import STRATEGIES

    return ActiveSetFederatedDistillation(
        analysis_config(codec), STRATEGIES[strategy](**strat_kw),
        scenario=Scenario(participation=bernoulli_participation(0.3)),
        device="cpu", **eng_kw)


class _ShapeRecorder(TorchDispatchMode):
    """The shape of every tensor going into or out of each aten op."""

    def __init__(self):
        super().__init__()
        self.shapes: List[Tuple[str, Tuple[int, ...]]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        for x in tree_flatten((args, kwargs, out))[0]:
            if isinstance(x, torch.Tensor):
                self.shapes.append((str(func.overloadpacket.__name__), tuple(x.shape)))
        return out


def k_shapes(fn, args, K: int) -> List[str]:
    """Run ``fn(*args)`` for real and return the distinct shapes with a
    K-sized dimension among every aten op's inputs and outputs (``shape
    in op``)."""
    rec = _ShapeRecorder()
    with rec:
        fn(*args)
    hits: Set[str] = {f"{shape} in {op}" for op, shape in rec.shapes if K in shape}
    return sorted(hits)


def _trace_on_fakes(fn, args: Tuple[Any, ...]):
    """Trace ``fn(*args)`` with every tensor in ``args`` (nested in dicts,
    lists, tuples) replaced by a fake CUDA tensor of its shape and dtype."""
    leaves, spec = tree_flatten(args)
    slots = [i for i, x in enumerate(leaves) if isinstance(x, torch.Tensor)]

    def rebuilt(*fakes):
        vals = list(leaves)
        for i, f in zip(slots, fakes):
            vals[i] = f
        return fn(*tree_unflatten(vals, spec))

    return trace(rebuilt, *[tensor_spec(leaves[i].shape, leaves[i].dtype) for i in slots])


def check_engine(subject: str, eng, plans: Optional[List] = None) -> List[Finding]:
    """Both round steps of one active engine: scan safety on fake CUDA
    tensors (their launches, at the gathered shapes, go to ``plans`` for
    the launch lint); K absent from the client step and present in the
    bookkeeping, from a real CPU run of each."""
    K = eng.cfg.n_clients
    findings: List[Finding] = []
    for label, fn, args in eng.active_round_fns():
        where = f"{subject}/{label}"
        hits = k_shapes(fn, args, K)
        if label == "client-step" and hits:
            findings.append(Finding(
                "error", "active", where,
                f"K-sized tensors (K={K}) inside the gathered O(m) client step: "
                f"{hits[:4]} — O(K) bookkeeping leaked into the per-round device "
                "hot path, so device cost scales with the population again"))
        if label == "bookkeeping" and not hits:
            findings.append(Finding(
                "error", "active", where,
                f"bookkeeping step holds no K-sized tensor (K={K}) — the "
                "K-separation check is tracing the wrong function and proves "
                "nothing"))
        tr = _trace_on_fakes(fn, args)
        if plans is not None:
            plans.extend((f"{where}#{i}", launch) for i, launch in enumerate(tr.launches))
        for v in tr.scan_safety_violations():
            findings.append(Finding("error", "active", where, v))
    if not findings:
        findings.append(Finding(
            "ok", "active", subject,
            f"both round steps host-sync free; no K={K} tensor in the gathered "
            "client step (the bookkeeping carries the O(K) state)"))
    return findings


def run(plans: Optional[List] = None) -> List[Finding]:
    findings: List[Finding] = []
    for label, strategy, strat_kw, eng_kw, codec in ANALYSIS_VARIANTS:
        eng = build_engine(strategy, strat_kw, eng_kw, codec)
        findings.extend(check_engine(f"active[{label}]", eng, plans))
    return findings
