"""The port's FL launcher (``repro_torch.launch.fl_train``) against the JAX
package's (``repro.launch.fl_train``), on the CPU.

Both launchers run in process on the same flags, the reference's with
``sys.argv`` set.  Both take the host loop on the numpy draws, so
SCARLET's per-round ledger (the cumulative bytes at every eval, here
every round, and the ledger's summary) is byte-identical in the two JSON
histories.  The accuracies are not compared: the reference draws its
initial parameters from ``jax.random``.
"""
import argparse
import json
import os
import sys

import pytest
import torch

from repro.launch import fl_train as jfl_train
from repro_torch.launch import fl_train
from repro_torch.obs.__main__ import main as obs_main

LEDGER_FIELDS = ("rounds", "cumulative_mb", "comm")
FLAGS = ["--method", "scarlet", "--rounds", "3"]


def _history(out, method="scarlet"):
    with open(os.path.join(out, f"{method}_a0.05_p1.0_s0.json")) as f:
        return json.load(f)


def _reference_parser(monkeypatch) -> argparse.ArgumentParser:
    """The reference's parser, taken at its parse_args call."""
    class Taken(Exception):
        pass

    seen = []

    def take(self, *a, **k):
        seen.append(self)
        raise Taken

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", take)
    with pytest.raises(Taken):
        jfl_train.main()
    return seen[0]


def _flags(ap: argparse.ArgumentParser) -> dict:
    return {a.dest: (tuple(a.option_strings), type(a).__name__, a.default, a.type,
                     None if a.choices is None else tuple(a.choices))
            for a in ap._actions if a.dest != "help"}


def test_scarlet_ledger_is_byte_identical_to_the_reference(tmp_path, monkeypatch, capsys):
    ref, port = tmp_path / "ref", tmp_path / "port"
    monkeypatch.setattr(sys, "argv", ["fl_train"] + FLAGS + ["--out", str(ref)])
    jfl_train.main()
    fl_train.main(FLAGS + ["--device", "cpu", "--out", str(port)])
    want, got = _history(ref), _history(port)
    assert got["history"]["rounds"] == [1, 2, 3]
    for name in LEDGER_FIELDS:
        assert json.dumps(got["history"][name]) == json.dumps(want["history"][name]), name
    assert got["config"] == want["config"]
    for key in ("method", "strategy_kwargs"):
        assert got[key] == want[key]
    assert [s["name"] for s in got["spans"]] == [s["name"] for s in want["spans"]] == ["run"]
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == f"history -> {os.path.join(str(port), 'scarlet_a0.05_p1.0_s0.json')}"


def test_flags_and_method_defaults_are_the_reference_plus_device(monkeypatch):
    assert fl_train.METHOD_DEFAULTS == jfl_train.METHOD_DEFAULTS
    want = _flags(_reference_parser(monkeypatch))
    got = _flags(fl_train.build_parser())
    assert got.pop("device") == (("--device",), "_StoreAction", "cuda", None, None)
    assert got == want


def test_use_cache_plugs_the_cache_into_dsfl(tmp_path):
    fl_train.main(["--method", "dsfl", "--use-cache", "--rounds", "2", "--device", "cpu",
                   "--out", str(tmp_path)])
    h = _history(tmp_path, "dsfl")
    assert h["strategy_kwargs"] == {"T": 0.1, "use_cache": True, "cache_duration": 25}
    assert h["history"]["rounds"] == [1, 2]
    assert h["history"]["comm"]["cumulative_total"] > 0


def test_telemetry_writes_a_valid_trace(tmp_path, capsys):
    fl_train.main(FLAGS[:2] + ["--rounds", "2", "--telemetry", "--device", "cpu",
                               "--out", str(tmp_path)])
    h = _history(tmp_path)
    assert h["strategy_kwargs"]["telemetry"] is True
    assert h["history"]["telemetry"]["rounds"] == 2
    trace = tmp_path / "scarlet_a0.05_p1.0_s0.trace.json"
    assert obs_main(["validate", str(trace)]) == 0
    assert "ok:" in capsys.readouterr().out


def test_default_device_raises_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fl_train.main(["--rounds", "1", "--out", str(tmp_path)])
    assert not os.listdir(tmp_path)
