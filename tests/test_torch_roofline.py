"""The port's hardware model (``repro_torch.launch.roofline``) and the
model counts it reads (``repro_torch.configs.base``) against the
reference's ``repro.launch.roofline`` and ``repro.configs.base``."""
import dataclasses
from types import SimpleNamespace

import pytest

from repro.configs import base as jbase
from repro.configs import registry as jcreg
from repro.launch import roofline as jrl
from repro_torch.configs import base
from repro_torch.configs import registry as creg
from repro_torch.launch import roofline as rl

ARCHS = sorted(jcreg.ARCHS)


def _pair(name, reduced):
    c, j = creg.ARCHS[name], jcreg.ARCHS[name]
    return (c.reduced(), j.reduced()) if reduced else (c, j)


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("name", ARCHS)
def test_param_counts_match_the_reference(name, reduced):
    c, j = _pair(name, reduced)
    assert (c.param_count(), c.active_param_count()) == (j.param_count(),
                                                         j.active_param_count())


def test_input_shapes_match_the_reference():
    assert [dataclasses.asdict(s) for s in base.INPUT_SHAPES] == \
        [dataclasses.asdict(s) for s in jbase.INPUT_SHAPES]
    assert list(base.SHAPES_BY_NAME) == list(jbase.SHAPES_BY_NAME)
    assert all(base.SHAPES_BY_NAME[n] == base.InputShape(**dataclasses.asdict(s))
               for n, s in jbase.SHAPES_BY_NAME.items())


@pytest.mark.parametrize("name", ARCHS)
def test_model_flops_match_the_reference(name):
    c, j = _pair(name, False)
    for s, js in zip(base.INPUT_SHAPES, jbase.INPUT_SHAPES):
        assert rl.model_flops_for(c, s) == jrl.model_flops_for(j, js), s.name


def _summary(**kw):
    d = dict(dot_flops=3.2e15, collective_bytes=4.5e10,
             collective_by_kind={"all-gather": 3.0e10, "all-reduce": 1.5e10,
                                 "all-to-all": 0.0},
             collective_counts={"all-gather": 12, "all-reduce": 3, "all-to-all": 0},
             residual_while_loops=1)
    d.update(kw)
    return SimpleNamespace(**d)


@pytest.mark.parametrize("summary,bottleneck", [
    (_summary(), "compute"),
    (_summary(dot_flops=1e12), "collective"),
    (_summary(dot_flops=1e9, collective_bytes=1.0, collective_by_kind={}), "memory"),
    (_summary(dot_flops=0.0), "collective"),  # no FLOPs: the useful ratio is 0
], ids=["compute", "collective", "memory", "no-flops"])
def test_roofline_from_summary_matches_the_reference(summary, bottleneck):
    kw = dict(arch="granite-3-2b", shape="train_4k", mesh_name="16x16", scheme="fsdp",
              chips=256, summary=summary, bytes_accessed=2.1e11, xla_flops=3.0e15,
              model_flops=2.5e17, bytes_per_device=6.4e10)
    spec = rl.HW_PRESETS["h100_sxm"]
    jspec = jrl.HardwareSpec(*dataclasses.astuple(spec))
    got = rl.compute_roofline_from_summary(**kw, hw=spec).as_dict()
    assert got == jrl.compute_roofline_from_summary(**kw, hw=jspec).as_dict()
    assert (got["hw"], got["bottleneck"]) == ("h100_sxm", bottleneck)
    assert rl.compute_roofline_from_summary(**kw).as_dict() == got  # the default card


def test_the_default_is_the_h100_preset():
    h100 = rl.resolve_hw(None)
    assert h100 is rl.DEFAULT_HW is rl.HW_PRESETS["h100_sxm"] is rl.resolve_hw("h100_sxm")
    assert (h100.peak_flops, h100.hbm_bw, h100.link_bw) == (989e12, 3.35e12, 450e9)
    assert (rl.PEAK_FLOPS, rl.HBM_BW, rl.LINK_BW) == (989e12, 3.35e12, 450e9)
    assert list(rl.HW_PRESETS) == ["h100_sxm"]  # no TPU preset
    spec = rl.HardwareSpec("custom", 1e12, 1e11, 1e10)
    assert rl.resolve_hw(spec) is spec


def test_an_unknown_preset_names_the_presets():
    with pytest.raises(ValueError, match=r"unknown hardware preset 'tpu_v5e' "
                                         r"\(want one of \['h100_sxm'\]\)"):
        rl.resolve_hw("tpu_v5e")
