"""CLI: ``python -m repro_torch.analysis [--strict] [--fast] [--selftest]
[--json PATH] [-v] [--device cuda|cpu]``.

Runs the static passes over the real registries and every kernel's
launch cases and prints a structured report.  Exit code: nonzero on any
error; ``--strict`` also fails on warnings.  ``--selftest`` instead runs
the passes over the deliberately broken fixtures and fails unless every
one is flagged at its expected level and every valid twin is not.

The passes trace on fake CUDA tensors: nothing executes.  ``--device
cuda`` (the default; it raises without a card) also reads each compiled
kernel's attributes and, under ``--selftest``, runs the fixture kernels'
valid plans on the card and has the card refuse the shared-memory hog.
``--device cpu`` runs every static pass and says what it did not read.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch.analysis import (active_checks, async_checks, contract_checks, fixtures,
                                  launch_checks, obs_checks, replication_checks)
from repro_torch.analysis.report import Report
from repro_torch.kernels import fixture_kernel, runtime


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static contract analyzer (trace-time proofs)")
    ap.add_argument("--strict", action="store_true", help="warnings also fail the build")
    ap.add_argument("--fast", action="store_true",
                    help="skip the engine passes (the telemetry, active-set, async and "
                         "replication passes and their fixtures)")
    ap.add_argument("--selftest", action="store_true",
                    help="run the passes over the broken fixtures and verify each is flagged")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="also write the structured report as JSON")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="include ok/info findings in the printed report")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default): also read the compiled kernels' attributes and "
                         "run the fixtures' valid plans on the card; cpu: static passes only")
    args = ap.parse_args(argv)
    device = runtime.resolve_device(args.device)
    attrs = runtime.func_attrs if device.type == "cuda" else None

    report = Report()
    if device.type == "cpu":
        report.add("info", "launch", "device", "compiled attributes not read: device=cpu")
    if args.selftest:
        rc = _selftest(report, device, fast=args.fast)
        print(report.render(verbose=True))
        if args.json:
            _dump(report, args.json)
        return rc

    plans = []
    report.extend(contract_checks.run(plans=plans))
    if not args.fast:
        report.extend(obs_checks.run(plans=plans))
        report.extend(active_checks.run(plans=plans))
        report.extend(async_checks.run(plans=plans))
        report.extend(replication_checks.run())
    else:
        report.add("info", "analysis", "engine passes",
                   "skipped under --fast: telemetry, active-set, async and replication")
    report.extend(launch_checks.run(attrs=attrs))
    report.extend(launch_checks.check_launches(plans, attrs=attrs))
    print(report.render(verbose=args.verbose))
    if args.json:
        _dump(report, args.json)
    return report.exit_code(strict=args.strict)


def _dump(report, path: str) -> None:
    with open(path, "w") as f:
        f.write(report.to_json())


def _expect(report, failures, label, got, want) -> None:
    """At least one finding of ``got`` at level ``want``."""
    hit = [f for f in got if f.level == want]
    if hit:
        report.add("ok", "selftest", label, f"flagged as expected ({want}): {hit[0].message}")
    else:
        failures.append(label)
        report.add("error", "selftest", label,
                   f"NOT flagged at level {want!r} (got {[f.level for f in got]})")


def _selftest(report, device, fast: bool = False) -> int:
    """Every broken fixture must be flagged at its expected level, and the
    kernels' valid plans must lint clean (and, on a card, run)."""
    attrs = runtime.func_attrs if device.type == "cuda" else None
    failures = []
    for name, ctor in fixtures.BROKEN_STRATEGIES.items():
        _expect(report, failures, name, contract_checks.check_strategy(name, ctor),
                fixtures.EXPECTED_STRATEGY_LEVEL[name])
    for label, fn, fargs, want in fixtures.broken_kernel_cases():
        _expect(report, failures, label, launch_checks.check_case(label, fn, fargs, attrs=attrs),
                want)
    for label, fn, fargs in fixtures.valid_kernel_cases():
        got = launch_checks.check_case(label, fn, fargs, attrs=attrs)
        bad = [f for f in got if f.level in ("error", "warn")]
        if bad:
            failures.append(label)
            report.add("error", "selftest", label, "valid plan falsely flagged: " + bad[0].message)
        else:
            report.add("ok", "selftest", label, "valid plan passes (no false positive)")
    # telemetry fixture: a hook that reads the card on the host inside the
    # round must be caught by the obs pass
    if not fast:
        label = "fixture/telemetry-callback"
        _expect(report, failures, label,
                obs_checks.check_round_body(label, fixtures.telemetry_callback_engine()),
                "error")
    # active-set fixture: the numerically invisible O(K) leak into the
    # gathered client step must be flagged for its K-sized shape, and the
    # real engines must pass (no false positive)
    if not fast:
        label = "fixture/active-k-leak"
        K = active_checks.K_ANALYSIS
        got = active_checks.check_engine(label, fixtures.leaky_active_engine())
        hit = [f for f in got if f.level == "error" and f"({K},)" in f.message]
        if hit:
            report.add("ok", "selftest", label, f"flagged as expected: {hit[0].message}")
        else:
            failures.append(label)
            report.add("error", "selftest", label,
                       "O(K) state leaked into the client step NOT flagged for its "
                       f"({K},) shape (got {[f.message[:80] for f in got]})")
        bad = [f for f in active_checks.run() if f.level == "error"]
        if bad:
            failures.append("fixture/active-clean")
            report.add("error", "selftest", "fixture/active-clean",
                       "real active engine falsely flagged: " + bad[0].message)
        else:
            report.add("ok", "selftest", "fixture/active-clean",
                       "real active engines pass (no false positive)")
    # async fixture: a staleness hook that computes its weights on the host
    # must be flagged, and the real async engines must pass
    if not fast:
        label = "fixture/async-staleness-callback"
        _expect(report, failures, label,
                async_checks.check_engine(label, fixtures.async_staleness_callback_engine()),
                "error")
        bad = [f for f in async_checks.run() if f.level == "error"]
        if bad:
            failures.append("fixture/async-clean")
            report.add("error", "selftest", "fixture/async-clean",
                       "real async engine falsely flagged: " + bad[0].message)
        else:
            report.add("ok", "selftest", "fixture/async-clean",
                       "real async engines pass (no false positive)")
    # replication fixtures (one gloo world of two ranks): the carry update
    # keyed on a shard-local slice must be flagged, its summed twin not
    if not fast:
        found = replication_checks.check(
            [("fixture", label, name) for label, name in replication_checks.FIXTURE_CASES])
        _expect(report, failures, "fixture/broken-carry", found["fixture-broken"], "error")
        bad = [f for f in found["fixture-fixed"] if f.level == "error"]
        if bad:
            failures.append("fixture/fixed-carry")
            report.add("error", "selftest", "fixture/fixed-carry",
                       "all-reduced carry falsely flagged: " + bad[0].message)
        else:
            report.add("ok", "selftest", "fixture/fixed-carry",
                       "all-reduced twin passes (no false positive)")
    if device.type == "cuda":
        _card_selftest(report, failures, device)
    return 1 if failures else 0


def _card_selftest(report, failures, device) -> None:
    """The lint's verdicts are the card's own: each valid plan runs and
    equals its plain version bit for bit; the hog plan is refused without
    a launch, and a valid launch follows it.  (The misaligned plan's fault
    is sticky, so it is not run here: ``chip_smoke.py`` runs it in a child
    process.)"""
    rng = np.random.default_rng(0)

    def card(shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device)

    def check(label, ok, what):
        report.add("ok" if ok else "error", "selftest", label, what)
        if not ok:
            failures.append(label)

    x = card((100, 128))
    check("card/aligned-vec4",
          torch.equal(fixture_kernel.copy_vec4(x), fixture_kernel.copy_plain(x)),
          "copy_vec4 on the card equals the plain copy")
    x, s = card((16, 128)), card((1,))
    check("card/scalar-by-pointer",
          torch.equal(fixture_kernel.scale(x, s), fixture_kernel.scale_plain(x, s)),
          "scale with s by pointer equals x * s")
    x = card((4096, 1024))
    n = fixture_kernel.copy_smem.launches
    try:
        fixture_kernel.copy_smem(x, fixture_kernel.HOG_TILE)
        refused = None
    except RuntimeError as e:
        refused = str(e)
    check("card/smem-hog", refused is not None and "cudaError" in refused
          and fixture_kernel.copy_smem.launches == n,
          f"the card refused the hog plan without a launch: {refused}")
    check("card/smem-tiles",
          torch.equal(fixture_kernel.copy_smem(x), fixture_kernel.copy_plain(x)),
          "after the refusal, copy_smem on its valid tiles equals the plain copy")


if __name__ == "__main__":
    sys.exit(main())
