"""The paper's federated-distillation launcher (the port of
``repro.launch.fl_train``).

  PYTHONPATH=src python -m repro_torch.launch.fl_train --method scarlet \
      --rounds 300 --alpha 0.05 --cache-duration 25 --beta 1.5

Runs any implemented method with exact communication accounting and
writes a JSON history (accuracy vs cumulative bytes) for analysis.
``--telemetry`` additionally records device-plane round telemetry
(:mod:`repro_torch.obs`) into the history and exports the host-plane
span trace as a Perfetto-loadable ``*.trace.json`` sibling.  The run
goes through ``run_method``'s host loop on ``--device`` (``cuda`` by
default, which raises without a card; ``--device cpu`` runs the plain
PyTorch path).  The flags, defaults and files are the reference's, plus
``--device``.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional

from repro_torch.fl import FLConfig, run_method
from repro_torch.obs import SpanTracer
from repro_torch.obs import export as obs_export

METHOD_DEFAULTS = {
    "scarlet": dict(cache_duration=50, beta=1.5),
    "dsfl": dict(T=0.1),
    "cfd": dict(),
    "comet": dict(n_clusters=2),
    "selective_fd": dict(tau_client=0.0625),
    "mean": dict(),
    "fedavg": dict(),
    "individual": dict(),
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--method", choices=sorted(METHOD_DEFAULTS), default="scarlet")
    ap.add_argument("--rounds", type=int, default=300)
    ap.add_argument("--clients", type=int, default=12)
    ap.add_argument("--alpha", type=float, default=0.05)
    ap.add_argument("--participation", type=float, default=1.0)
    ap.add_argument("--cache-duration", type=int, default=None)
    ap.add_argument("--beta", type=float, default=None)
    ap.add_argument("--temperature", type=float, default=None)
    ap.add_argument("--use-cache", action="store_true",
                    help="plug the soft-label cache into a non-SCARLET method")
    ap.add_argument("--telemetry", action="store_true",
                    help="record device-plane round telemetry (repro_torch.obs) "
                         "and export the span trace")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="experiments/fl_runs")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    return ap


def config_from_args(args: argparse.Namespace) -> FLConfig:
    """The launcher's run configuration: the paper's synthetic task at 12
    clients by default, an eval every twentieth of the run."""
    return FLConfig(
        n_clients=args.clients, n_classes=10, dim=16, rounds=args.rounds,
        public_size=1200, public_per_round=120, private_size=1500,
        alpha=args.alpha, participation=args.participation,
        cluster_scale=2.0, noise=2.5,
        eval_every=max(args.rounds // 20, 1), seed=args.seed,
    )


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    kw = dict(METHOD_DEFAULTS[args.method])
    if args.beta is not None:
        kw["beta"] = args.beta
    if args.temperature is not None:
        kw["T"] = args.temperature
    if args.cache_duration is not None:
        kw["cache_duration"] = args.cache_duration
    if args.use_cache:
        kw["use_cache"] = True
        kw.setdefault("cache_duration", 25)
    if args.telemetry:
        kw["telemetry"] = True

    # monotonic span clock (obs.trace.now, never jumps on NTP/DST)
    tracer = SpanTracer("fl_train", meta={"method": args.method})
    with tracer.span("run", method=args.method, rounds=args.rounds) as sp:
        hist = run_method(args.method, cfg, device=args.device, **kw)
    dt = sp.dur_s
    s = hist.ledger.summary()

    def _acc(v):  # None = never evaluated (e.g. Individual's server)
        return "n/a" if v is None else f"{v:.3f}"

    print(f"{args.method}: server_acc={_acc(hist.final_server_acc)} "
          f"client_acc={_acc(hist.final_client_acc)} "
          f"uplink={s['uplink_mean']/1e3:.1f}KB/rnd "
          f"cum={s['cumulative_total']/1e6:.2f}MB wall={dt:.1f}s")

    os.makedirs(args.out, exist_ok=True)
    fname = f"{args.method}_a{args.alpha}_p{args.participation}_s{args.seed}.json"
    with open(os.path.join(args.out, fname), "w") as f:
        json.dump({"config": cfg.__dict__, "method": args.method,
                   "strategy_kwargs": dict(kw),
                   "history": hist.as_dict(), "wall_s": dt,
                   "spans": tracer.jsonl_lines()}, f, indent=2)
    print(f"history -> {os.path.join(args.out, fname)}")
    if args.telemetry:
        tpath = os.path.join(args.out, fname[:-5] + ".trace.json")
        obs_export.write_chrome_trace(tpath, tracer)
        print(f"trace -> {tpath}")


if __name__ == "__main__":
    main()
