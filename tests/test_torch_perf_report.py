"""The dry run's perf variants and report (``repro_torch.launch.perf``,
``repro_torch.launch.report``) against the reference's, and the MoE
dispatch's sharding switches on a fake world.

- ``variant_plan`` equals the reference's for every variant name, MoE and
  dense (the reference's ``perf`` sets ``XLA_FLAGS`` on import; the
  import is wrapped, as its own tests wrap it).
- The report's summary, dry-run and roofline tables print the reference's
  text on the same rows (the reference's ``report`` imports no JAX); rows
  that name their card (``hw``) get that card's peaks in the roofline
  heading.
- ``perf.main`` runs each variant through ``dryrun.run_combo`` with its
  scheme, overrides and dispatch spec, and resets the spec after.
- ``common.MOE_DISPATCH_SPEC`` leaves the single-device MoE bit for bit as
  it is, and on DTensors pins the dispatch buffer; the ``ep-a2a`` variant
  sends a reduced MoE through the all-to-all dispatch on each rank's
  shard, whose exchanges count as all-to-all.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro.launch import report as ref_report
from repro_torch.configs.base import InputShape
from repro_torch.configs.registry import ARCHS
from repro_torch.launch import dryrun, perf, report
from repro_torch.models import common as cm

NAMES = ("ep-a2a", "baseline-tp", "tp-ep", "tp-dots-remat", "tp-lse-ce", "tp-bf16logits",
         "tp-bf16attn", "tp-all", "fsdp", "fsdp-bf16logits", "fsdp-dots-remat", "fsdp-ep",
         "fsdp-all")


def _ref_variant_plan():
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.perf import variant_plan
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return variant_plan


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("is_moe", (True, False), ids=("moe", "dense"))
def test_variant_plan_matches_reference(name, is_moe):
    assert perf.variant_plan(name, is_moe) == _ref_variant_plan()(name, is_moe)


def test_variant_plan_unknown_name_raises():
    with pytest.raises(ValueError, match="no-such-variant"):
        perf.variant_plan("no-such-variant", False)


ROWS = [
    {"arch": "a", "shape": "train_4k", "mesh": "16x16", "scheme": "tp",
     "status": "ok", "compile_s": 10.0, "bytes_per_device": 1e9,
     "hlo_gflops_per_device": 100.0, "hlo_gbytes_per_device": 10.0,
     "collective_gbytes_per_device": 1.0, "collective_counts": {"all-reduce": 3},
     "compute_s": 0.1, "memory_s": 0.2, "collective_s": 0.02,
     "bottleneck": "memory", "model_gflops": 90.0, "hlo_gflops": 25600.0,
     "useful_flops_ratio": 0.9},
    {"arch": "a", "shape": "decode_32k", "mesh": "16x16", "scheme": "tp",
     "status": "ok", "compile_s": 3.0, "bytes_per_device": 2e9,
     "hlo_gflops_per_device": 1.0, "hlo_gbytes_per_device": 40.0,
     "collective_gbytes_per_device": 5.0, "collective_counts": {"all-gather": 2},
     "compute_s": 1e-4, "memory_s": 2e-3, "collective_s": 3.0,
     "bottleneck": "collective", "model_gflops": 1.0, "hlo_gflops": 256.0,
     "useful_flops_ratio": 0.004},
    {"arch": "a", "shape": "prefill_32k", "mesh": "2x16x16", "scheme": "fsdp",
     "status": "ok", "compile_s": 7.0, "bytes_per_device": 3e9},
    {"arch": "a", "shape": "long_500k", "mesh": "16x16", "scheme": "tp",
     "status": "skipped", "reason": "pure full-attention arch: 500k dense KV cache"},
    {"arch": "b", "shape": "train_4k", "mesh": "16x16", "scheme": "tp",
     "status": "error", "error": "boom"},
]


def test_report_prints_the_reference_text(tmp_path, capsys):
    d = tmp_path / "arts"
    d.mkdir()
    for i, r in enumerate(ROWS):
        (d / f"{i}.json").write_text(json.dumps(r))
    rows = report.load(str(d))
    assert rows == ref_report.load(str(d))
    assert report.summarize(rows) == ref_report.summarize(rows)
    for mesh, scheme in (("16x16", "tp"), ("2x16x16", "fsdp")):
        assert report.dryrun_table(rows, mesh, scheme) == ref_report.dryrun_table(rows, mesh,
                                                                                   scheme)
        assert report.roofline_table(rows, mesh, scheme) == \
            ref_report.roofline_table(rows, mesh, scheme)
    for mod in (report, ref_report):
        import sys
        argv = sys.argv
        sys.argv = ["report", "--artifacts", str(d)]
        try:
            mod.main()
        finally:
            sys.argv = argv
    out = capsys.readouterr().out
    half = len(out) // 2
    assert out[:half] == out[half:]
    hw_rows = [dict(r, hw="h100_sxm") for r in rows]
    heading = report.roofline_table(hw_rows, "16x16", "tp").splitlines()[0]
    assert "989 TF/s bf16, 3350 GB/s HBM, 450 GB/s link (h100_sxm)" in heading


def test_perf_main_runs_each_variant(monkeypatch, capsys):
    seen = []

    def fake_combo(arch, shape, multi_pod, scheme, out_dir, cfg_overrides, variant, moe_a2a,
                   device):
        seen.append((variant, scheme, cfg_overrides, cm.MOE_DISPATCH_SPEC, moe_a2a, device))
        return {"status": "ok", "compute_s": 1e-3, "memory_s": 2e-3, "collective_s": 3e-3,
                "bottleneck": "collective", "bytes_per_device": 4e9}

    monkeypatch.setattr(dryrun, "run_combo", fake_combo)
    assert perf.main(["--arch", "kimi-k2-1t-a32b", "--shape", "train_4k", "--device", "cpu",
                      "--variants", "baseline-tp,fsdp-all,ep-a2a"]) == 0
    assert seen == [
        ("baseline-tp", "tp", {}, None, False, "cpu"),
        ("fsdp-all", "fsdp", {"fp32_logits": False, "remat_policy": "dots_saveable"},
         ("data", None, "model"), False, "cpu"),
        ("ep-a2a", "ep", {}, None, True, "cpu"),
    ]
    assert cm.MOE_DISPATCH_SPEC is None
    assert "fsdp-all" in capsys.readouterr().out


def _moe_cfg():
    return ARCHS["grok-1-314b"].reduced()


def test_dispatch_spec_keeps_the_single_device_moe(monkeypatch):
    cfg, rng = _moe_cfg(), np.random.default_rng(0)
    D, E, F = cfg.d_model, cfg.n_experts, cfg.expert_d_ff
    x = torch.from_numpy(rng.standard_normal((2, 16, D)).astype(np.float32))
    w = [torch.from_numpy(rng.standard_normal(s).astype(np.float32) * 0.1)
         for s in ((D, E), (E, D, F), (E, D, F), (E, F, D))]
    want = cm.moe_ffn(x, *w, top_k=cfg.top_k)
    monkeypatch.setattr(cm, "MOE_DISPATCH_SPEC", ("data", None, "model"))
    got = cm.moe_ffn(x, *w, top_k=cfg.top_k)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("variant", ["fsdp-ep", "ep-a2a"])
def test_moe_variants_trace(monkeypatch, variant):
    scheme, _, spec, a2a = perf.variant_plan(variant, True)
    seen = []
    redistribute = torch.distributed.tensor.DTensor.redistribute

    def spy(self, mesh=None, placements=None, **kw):
        if tuple(self.shape)[1:] and self.ndim == 3 and self.shape[0] == _moe_cfg().n_experts:
            seen.append(tuple(placements))
        return redistribute(self, mesh, placements, **kw)

    monkeypatch.setattr(torch.distributed.tensor.DTensor, "redistribute", spy)
    monkeypatch.setattr(cm, "MOE_DISPATCH_SPEC", spec)
    s, _ = dryrun.trace_one(dataclasses.replace(_moe_cfg(), n_layers=1),
                            InputShape("t", 128, 8, "prefill"), (2, 4), scheme, device="cpu",
                            moe_a2a=a2a)
    if a2a:
        assert s.collective_counts.get("all-to-all", 0) >= 2  # there and back
    else:
        from torch.distributed.tensor import Shard

        assert (Shard(0), Shard(2)) in seen  # the buffer pinned to ("data", None, "model")
