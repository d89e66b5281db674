"""Telemetry contracts of the device engine (counterpart of
``repro.analysis.obs_checks``).

``FLConfig.telemetry`` adds a ``RoundTelemetry`` row to every device
round.  Two things must stay true, and the runs check neither alone:

1. **Round-body safety**: the telemetry code of the round (the fused
   path's codec round trip, :meth:`FederatedDistillation._telemetry_row`
   with the strategy's ``sharpen_gauge`` and any ``telemetry_hook`` an
   experiment installs, the outage gate and the running totals:
   :meth:`ScannedFederatedDistillation._telemetry_device`) must not read
   the card on the host, copy to the host or draw from a host RNG: one
   ``.item()`` in a hook turns the run's single read-back into one a
   round (on the card the sync guard raises there).  This pass traces
   that code on fake CUDA tensors (:func:`repro_torch.analysis.traceutil.
   trace`).  It traces the telemetry block and not the whole
   ``_round_device``: the engine's data and parameters are real tensors
   on its own device, which a fake-tensor trace cannot mix with fake CUDA
   ones; the rest of the round is the strategy and codec hooks the
   contract pass already traces.
2. **Off-path inertness**: one ``_round_device`` of the tiny engine on the
   CPU, from the same state with telemetry off and on: the state and
   output dicts must differ by exactly the ``"telemetry"`` entry, and
   every other entry must be equal bit for bit (the reference checks the
   same structure by ``jax.eval_shape``; here the round runs, so the
   values are held too).
"""
from __future__ import annotations

from typing import Any, Iterator, List, Optional, Tuple

import torch

from repro_torch.analysis.report import Finding
from repro_torch.analysis.traceutil import tensor_spec, trace

__all__ = ["ANALYSIS_VARIANTS", "build_engine", "check_round_body", "check_off_on", "run"]

# engine variants traced with telemetry on: strategy name, constructor
# kwargs, engine kwargs, uplink codec — the distinct telemetry paths
# (static vs adaptive beta gauge, identity vs delta+quant codec error,
# cache on/off), as the reference's
ANALYSIS_VARIANTS: Tuple[Tuple[str, dict, dict, str], ...] = (
    ("scarlet", {}, {"cache_duration": 2}, "identity"),
    ("scarlet", {"beta": "adaptive"}, {"cache_duration": 2}, "identity"),
    ("scarlet", {}, {"cache_duration": 2}, "cache_delta+quant8"),
    ("dsfl", {}, {}, "identity"),
)

# the reference's FLConfig for this pass: K=4 clients, m=8, N=4
_CFG = dict(n_clients=4, rounds=2, public_size=32, public_per_round=8, n_classes=4,
            dim=8, hidden=8, private_size=32, local_steps=1, distill_steps=1, seed=0)


def build_engine(strategy: str, strat_kw: dict, eng_kw: dict, codec: str,
                 telemetry: bool, fused: bool = False):
    """The tiny device engine of one variant, on the CPU."""
    from repro_torch.fl.config import FLConfig
    from repro_torch.fl.scan_engine import ScannedFederatedDistillation
    from repro_torch.fl.strategies import STRATEGIES

    cfg = FLConfig(**_CFG, uplink_codec=codec, telemetry=telemetry, fused_round=fused)
    return ScannedFederatedDistillation(cfg, STRATEGIES[strategy](**strat_kw),
                                        device="cpu", **eng_kw)


def _label(strategy: str, strat_kw: dict, codec: str, fused: bool) -> str:
    return (strategy + ("+adaptive" if strat_kw.get("beta") == "adaptive" else "")
            + (f"+{codec}" if codec != "identity" else "") + ("+fused" if fused else ""))


def check_round_body(subject: str, eng, plans: Optional[List] = None) -> List[Finding]:
    """Safety of one engine's telemetry round code on fake CUDA tensors;
    its launches (the fused path's codec round trip) go to ``plans``."""
    from repro_torch.obs import device as obs_device

    c = eng.cfg
    K, m, N = c.n_clients, c.public_per_round, c.n_classes
    f32 = torch.float32

    def body(part, any_p, miss, base, base_present, z_tx, z_all, fresh, last_sync,
             uplink, downlink, catch_up):
        totals = obs_device.zeros(eng.models.n_cohorts, device=part.device)
        return eng._telemetry_device(
            totals, 1, part, any_p, miss=miss, base=base, base_present=base_present,
            z_tx=z_tx, z_all=z_all, fresh=fresh, last_sync=last_sync, uplink=uplink,
            downlink=downlink, catch_up=catch_up)

    tr = trace(body, tensor_spec((K,), torch.bool), tensor_spec((), torch.bool),
               tensor_spec((m,), torch.bool), tensor_spec((m, N)),
               tensor_spec((m,), torch.bool), tensor_spec((K, m, N)), tensor_spec((K, m, N)),
               tensor_spec((m, N)), tensor_spec((K,), torch.int32), tensor_spec((), f32),
               tensor_spec((), f32), tensor_spec((), f32))
    if plans is not None:
        plans.extend((f"{subject}#{i}", launch) for i, launch in enumerate(tr.launches))
    violations = tr.scan_safety_violations()
    if violations:
        return [Finding("error", "obs", subject, v) for v in violations]
    return [Finding("ok", "obs", subject,
                    "telemetry round code is host-sync free (no host read, no copy "
                    "to the host, no host RNG)")]


def _leaves(tree, path: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) of a nest of dicts, lists and tuples."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}.{k}" if path else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def _same(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    return a == b


def check_off_on(subject: str, make) -> List[Finding]:
    """Telemetry is additive: from the same state, the off round's state
    and outputs hold no telemetry entry, and the on round's differ from
    them by exactly that entry, every other leaf equal bit for bit."""
    findings: List[Finding] = []
    rounds = {}
    for tel in (False, True):
        eng = make(tel)
        leg = eng._start_leg(1, None)
        rounds[tel] = eng._round_device(leg.state, leg.ts[0], leg.part[0], leg.idx[0],
                                        leg.do_eval[0])
    for name, i in (("state", 0), ("outputs", 1)):
        off, on = rounds[False][i], rounds[True][i]
        if "telemetry" in off:
            findings.append(Finding("error", "obs", subject,
                                    f"telemetry-OFF round emits a telemetry entry in its "
                                    f"{name}: the off path must be untouched"))
        if "telemetry" not in on:
            findings.append(Finding("error", "obs", subject,
                                    f"telemetry-ON round has no telemetry entry in its {name}"))
        rest = {k: v for k, v in on.items() if k != "telemetry"}
        if sorted(rest) != sorted(off):
            findings.append(Finding("error", "obs", subject,
                                    f"telemetry changes the {name} beyond its own entry "
                                    f"(off={sorted(off)}, on-minus-telemetry={sorted(rest)})"))
            continue
        a, b = dict(_leaves(off)), dict(_leaves(rest))
        differ = [k for k in a if k not in b or not _same(a[k], b[k])]
        if differ or a.keys() != b.keys():
            findings.append(Finding("error", "obs", subject,
                                    f"telemetry moves the round's {name}: {differ[:5]} "
                                    "differ from the telemetry-off round"))
    if not findings:
        findings.append(Finding(
            "ok", "obs", subject,
            "telemetry is additive (off round untouched; the on round differs by exactly "
            "the telemetry entry, every other leaf equal bit for bit)"))
    return findings


def run(plans: Optional[List] = None) -> List[Finding]:
    findings: List[Finding] = []
    for strategy, strat_kw, eng_kw, codec in ANALYSIS_VARIANTS:
        variants = [False]
        if strategy == "scarlet" and strat_kw.get("beta") != "adaptive":
            variants.append(True)  # the fused path's own codec round trip
        for fused in variants:
            eng = build_engine(strategy, strat_kw, eng_kw, codec, telemetry=True, fused=fused)
            findings.extend(check_round_body(
                f"telemetry[{_label(strategy, strat_kw, codec, fused)}]", eng, plans))
    # one off/on round per path: the wiring is shared by the variants
    for fused in (False, True):
        findings.extend(check_off_on(
            "telemetry[structure" + ("+fused]" if fused else "]"),
            lambda tel, fused=fused: build_engine(
                "scarlet", {}, {"cache_duration": 2}, "cache_delta+quant8",
                telemetry=tel, fused=fused)))
    return findings
