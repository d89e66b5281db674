"""Strategy and codec contracts, proved by tracing (counterpart of
``repro.analysis.jaxpr_checks``).

Every registered strategy declares flags the engines trust at
construction (``scan_safe``, ``supports_fused_round``); every codec
declares ``scan_safe`` and may have a fused-kernel equivalent
(``round_kernel.codec_kernel_spec``).  This pass runs the hooks on fake
CUDA tensors (:func:`repro_torch.analysis.traceutil.trace`: nothing
executes) and diffs what they do against the declarations:

- ``scan_safe=True`` demands that every hook the device engine calls
  inside its rounds traces without reading a device value on the host,
  copying to the host, or constructing a host numpy RNG.  A violation is
  an **error**: the round would sync the host (the engine's rounds run
  under ``torch.cuda.set_sync_debug_mode("error")`` on the card, which
  PyTorch documents as not catching every sync) or bake one draw in.
  One finding a hook, naming each thing the hook did.
- ``scan_safe=False`` on a strategy whose hooks all trace clean is a
  **warn**: a stale conservative flag that locks it out of the device
  engine.
- ``supports_fused_round=True`` demands that the fused hooks trace for
  the kernel's codec modes and launch the ``fused_round`` kernel.
- a codec with a kernel spec must be accepted by ``round_kernel.fused_round``
  under that spec.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch.analysis.report import Finding
from repro_torch.analysis.traceutil import tensor_spec, trace

__all__ = ["check_strategy", "check_codec", "run"]

# Shapes for the trace: small but non-degenerate (K clients, m public
# samples a round, N classes), as the reference's.  Values never exist.
_K, _M, _N = 8, 16, 10
# The round index: a host int, as the device engine passes it.
_T = 1

# codec modes the fused round kernel supports, in codec_kernel_spec form
_FUSED_SPECS = (
    {"mode": "identity", "bits": None},
    {"mode": "quant", "bits": 8},
    {"mode": "delta", "bits": 8},
)


def _record(plans: Optional[List], subject: str, hook: str, tr) -> None:
    """Add the trace's launches to ``plans`` as (label, Launch)."""
    if plans is not None:
        plans.extend((f"{subject}/{hook}#{i}", launch) for i, launch in enumerate(tr.launches))


def _scan_hooks(s, um):
    """(hook name, fn, args) for everything the device engine calls inside
    its rounds."""
    z, part = tensor_spec((_K, _M, _N)), tensor_spec((_K,))
    return [
        ("transmit", lambda z_: s.transmit(z_), (z,)),
        ("upload_mask", lambda z_: s.upload_mask(z_), (z,)),
        ("aggregate_masked", lambda z_, p_, u_: s.aggregate_masked(z_, p_, u_, _T),
         (z, part, um)),
        ("two_phase", lambda z_, p_, u_: s.finalize_aggregate(
            s.partial_aggregate(z_, p_, u_, _T), _T), (z, part, um)),
    ]


def check_strategy(name: str, ctor, plans: Optional[List] = None) -> List[Finding]:
    """All contract findings for one registered strategy class; the launches
    its hooks make are added to ``plans`` for the launch lint."""
    findings: List[Finding] = []
    for kw in tuple(getattr(ctor, "analysis_variants", ({},))):
        subject = f"strategy:{name}" + (f"{kw!r}" if kw else "")
        try:
            s = ctor(**dict(kw))
        except Exception as e:  # noqa: BLE001
            findings.append(Finding("error", "contract", subject,
                                    f"analysis_variants kwargs rejected by constructor: {e}"))
            continue
        findings.extend(_check_instance(subject, s, plans))
    return findings


def _check_instance(subject, s, plans) -> List[Finding]:
    findings: List[Finding] = []
    contract = s.declared_contract()
    z = tensor_spec((_K, _M, _N))

    tr = trace(lambda z_: s.upload_mask(z_), z)
    um = None
    if not tr.ok:
        findings.append(Finding("error", "contract", subject,
                                f"upload_mask failed to trace: {tr.error}"))
    elif tr.output is not None:
        um = tensor_spec(tuple(tr.output.shape), tr.output.dtype)

    # --- scan-safety -------------------------------------------------
    violations = []
    for hook, fn, args in _scan_hooks(s, um):
        tr = trace(fn, *args)
        _record(plans, subject, hook, tr)
        v = tr.scan_safety_violations()
        if v:
            violations.append(f"{hook}: " + "; ".join(v))
        if tr.ok and hook in ("aggregate_masked", "two_phase"):
            shape = tuple(tr.output.shape)
            if shape != (_M, _N):
                findings.append(Finding("error", "contract", subject,
                                        f"{hook}: teacher shape {shape} != {(_M, _N)}"))

    if contract["scan_safe"]:
        if violations:
            findings.extend(Finding("error", "contract", subject,
                                    f"declared scan_safe=True but {v}") for v in violations)
        else:
            findings.append(Finding("ok", "contract", subject,
                                    "scan_safe=True verified by trace"))
    else:
        # a declared-unsafe strategy should have *something* unsafe: the
        # hooks above, or the host loop's dynamic-subset ``aggregate``
        agg = trace(lambda z_: s.aggregate(z_, None, _T), z)
        agg_viol = agg.scan_safety_violations()
        if not agg_viol and isinstance(agg.output, tuple) and len(agg.output) > 1:
            per_client = agg.output[1]
            if per_client is not None and per_client.shape and per_client.shape[0] == _K:
                agg_viol = ["aggregate returns per-client teachers "
                            "(K-leading output, not one fixed-shape teacher)"]
        if violations or agg_viol:
            findings.append(Finding("ok", "contract", subject,
                                    "scan_safe=False justified: "
                                    + "; ".join((violations + agg_viol)[:2])))
        else:
            findings.append(Finding(
                "warn", "contract", subject,
                "declared scan_safe=False but every hook traces clean on fake CUDA "
                "tensors — stale flag? (locks the strategy out of the device engine)"))

    # --- fused round -------------------------------------------------
    fused_ok, fused_errs = _trace_fused(subject, s, plans)
    if contract["supports_fused_round"]:
        if fused_errs:
            findings.extend(Finding("error", "contract", subject,
                                    f"declared supports_fused_round=True but {msg}")
                            for msg in fused_errs)
        else:
            findings.append(Finding(
                "ok", "contract", subject,
                "supports_fused_round=True verified (fused hooks launch fused_round for "
                "all kernel codec modes)"))
    elif fused_ok:
        findings.append(Finding(
            "info", "contract", subject,
            "supports_fused_round=False but the fused hooks trace clean — consider "
            "advertising the fast path"))
    return findings


def _trace_fused(subject, s, plans):
    """(every mode traces to a fused_round launch, error messages) for the
    fused hooks."""
    errs = []
    any_ok = False
    z, part = tensor_spec((_K, _M, _N)), tensor_spec((_K,))
    for spec in _FUSED_SPECS:
        base = tensor_spec((_M, _N)) if spec["mode"] == "delta" else None
        for hook in ("aggregate_masked_fused", "partial_aggregate_fused"):
            fn = getattr(s, hook)
            tr = trace(lambda z_, p_, b_: fn(z_, p_, spec, b_, _T), z, part, base)
            _record(plans, subject, f"{hook}[{spec['mode']}]", tr)
            if not tr.ok:
                errs.append(f"{hook}[{spec['mode']}] failed to trace: "
                            f"{type(tr.error).__name__}")
                continue
            if not tr.launched("fused_round"):
                errs.append(f"{hook}[{spec['mode']}] traces but launches no fused_round "
                            "kernel — not actually fused")
                continue
            any_ok = True
    return any_ok and not errs, errs


def check_codec(name: str, factory, plans: Optional[List] = None) -> List[Finding]:
    """Contract findings for one registered codec."""
    from repro_torch.kernels.round_kernel import MODES, codec_kernel_spec, fused_round

    subject = f"codec:{name}"
    try:
        codec = factory()
    except Exception as e:  # noqa: BLE001
        return [Finding("error", "contract", subject, f"factory failed: {e}")]

    findings: List[Finding] = []
    z, base = tensor_spec((_M, _N)), tensor_spec((_M, _N))
    present = tensor_spec((_M,), torch.bool)
    viol = []
    for hook, fn, args in (
            ("roundtrip", lambda z_: codec.roundtrip(z_), (z,)),
            ("roundtrip+base",
             lambda z_, b_, p_: codec.roundtrip(z_, base=b_, present=p_), (z, base, present)),
    ):
        tr = trace(fn, *args)
        _record(plans, subject, hook, tr)
        v = tr.scan_safety_violations()
        if v:
            viol.append(f"{hook}: " + "; ".join(v))
        if tr.ok and tuple(tr.output.shape) != (_M, _N):
            findings.append(Finding(
                "error", "contract", subject,
                f"{hook} output shape {tuple(tr.output.shape)} != input {(_M, _N)} "
                "(receiver view must be shape-preserving)"))

    if codec.scan_safe and viol:
        findings.extend(Finding("error", "contract", subject,
                                f"declared scan_safe=True but {v}") for v in viol)
    elif not codec.scan_safe and not viol:
        findings.append(Finding("warn", "contract", subject,
                                "declared scan_safe=False but roundtrip traces clean — "
                                "stale flag?"))
    else:
        findings.append(Finding("ok", "contract", subject,
                                f"scan_safe={codec.scan_safe} verified"))

    # --- kernel spec consistency -------------------------------------
    spec = codec_kernel_spec(codec)
    if spec is not None:
        if spec["mode"] not in MODES:
            findings.append(Finding("error", "contract", subject,
                                    f"codec_kernel_spec mode {spec['mode']!r} not in kernel "
                                    f"MODES {MODES}"))
        elif (spec["mode"] == "identity") != codec.is_identity:
            findings.append(Finding("error", "contract", subject,
                                    f"codec_kernel_spec mode {spec['mode']!r} disagrees with "
                                    f"is_identity={codec.is_identity}"))
        else:
            z3, w = tensor_spec((_K, _M, _N)), tensor_spec((_K,))
            b = base if spec["mode"] == "delta" else None
            tr = trace(lambda z_, w_, b_: fused_round(z_, w_, None, b_, mode=spec["mode"],
                                                      bits=spec["bits"], sharpen=False),
                       z3, w, b)
            _record(plans, subject, "fused_round", tr)
            if not tr.ok:
                findings.append(Finding("error", "contract", subject,
                                        f"codec_kernel_spec {spec} rejected by fused_round: "
                                        f"{type(tr.error).__name__}: {tr.error}"))
            else:
                findings.append(Finding("ok", "contract", subject,
                                        f"codec_kernel_spec {spec} accepted by fused_round"))
    return findings


def run(strategies=None, codecs=None, plans: Optional[List] = None) -> List[Finding]:
    """The full pass over both registries (or explicit dict overrides: the
    selftest injects deliberately broken entries here).  Launches the
    hooks make are added to ``plans`` as (label, Launch)."""
    if strategies is None:
        from repro_torch.fl.strategies import STRATEGIES
        strategies = STRATEGIES
    if codecs is None:
        from repro_torch.compress.codecs import CODECS
        codecs = CODECS
    findings: List[Finding] = []
    for name, ctor in strategies.items():
        findings.extend(check_strategy(name, ctor, plans))
    for name, factory in codecs.items():
        findings.extend(check_codec(name, factory, plans))
    return findings
