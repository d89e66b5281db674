"""The port's sharding rules (``repro_torch.launch.sharding``) and logical
axes (``models.registry.param_axes``) against the reference's, and the
sharded model's numerics on a real world.

- ``param_axes`` equals the axes the reference's ``registry.init``
  returns (``jax.eval_shape``), leaf by leaf, for every assigned
  architecture at full width.
- ``spec_for_param``, ``spec_for_activation`` and ``batch_spec`` give the
  reference's PartitionSpec entries for every parameter and decode-cache
  leaf, under tp, fsdp and ep, on the production meshes 16x16 and
  2x16x16 (the reference's functions take a duck mesh, as its own tests
  do), and ``placements`` turns them into DTensor placements.
- On a gloo world of four ranks (``tests/torch_dryrun_worker.py``) with
  real CPU DTensors, a reduced GQA transformer (8 query heads, 2 KV heads)
  gives the single-device prefill logits, train loss and every gradient
  on the meshes (2, 2) under fsdp and (1, 4) under tp.  The second has
  the query heads split over "model" and the KV heads not: each rank's
  flash launch must take the KV head of its own query heads (rank r of 4
  holds query heads 2r, 2r + 1, of KV head r // 2), and the KV heads'
  gradients are partial sums, which fake tensors cannot show.  A one-layer
  reduced mamba2 does the same on (2, 2): its mixer's core runs on each
  rank's rows (``common.on_batch_rows``), the gradients of its
  parameters partial sums over the data axis.
"""
import dataclasses

import jax
import pytest
import torch

import torch_dryrun_worker as W
from repro.configs.registry import ARCHS as REF_ARCHS
from repro.configs.registry import ASSIGNED
from repro.launch import sharding as ref_sh
from repro.models import registry as ref_registry
from repro_torch.configs.registry import ARCHS
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import run_world
from repro_torch.models import registry

SCHEMES = ("tp", "fsdp", "ep")
NUMERICS_RTOL = 1e-5


class _DuckMesh:
    """axis_names + devices.shape, as the reference's tests build it."""

    def __init__(self, sizes):
        self.axis_names = tuple(sizes)
        self.devices = type("A", (), {"shape": tuple(sizes.values())})()


MESHES = {"16x16": _DuckMesh({"data": 16, "model": 16}),
          "2x16x16": _DuckMesh({"pod": 2, "data": 16, "model": 16})}


def _leaves(axes, shapes, prefix=""):
    for k, ax in axes.items():
        if isinstance(ax, dict):
            yield from _leaves(ax, shapes[k], f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", tuple(ax), tuple(shapes[k].shape)


@pytest.fixture(scope="module")
def reference_trees():
    """arch -> (param axes, param shapes, {decode shape: (cache axes, cache
    shapes)}) of the reference, abstract."""
    out = {}
    for a in ASSIGNED:
        cfg, got = REF_ARCHS[a], {}

        def init(key, cfg=cfg, got=got):
            p, ax = ref_registry.init(cfg, key)
            got["axes"] = ax
            return p

        shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
        caches = {}
        for name, (b, s) in (("decode_32k", (128, 32768)), ("long_500k", (1, 524288))):
            c = jax.eval_shape(lambda cfg=cfg, b=b, s=s: ref_registry.init_decode_cache(cfg, b, s))
            caches[name] = (ref_registry.cache_axes(cfg, name), c)
        out[a] = (got["axes"], shapes, caches)
    return out


@pytest.mark.parametrize("arch", ASSIGNED)
def test_param_axes_match_reference(reference_trees, arch):
    assert registry.param_axes(ARCHS[arch]) == reference_trees[arch][0]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED)
def test_specs_match_reference(reference_trees, arch, mesh):
    ax, shapes, caches = reference_trees[arch]
    m = MESHES[mesh]
    n = 0
    for scheme in SCHEMES:
        for name, a, shape in _leaves(ax, shapes):
            want = tuple(ref_sh.spec_for_param(a, shape, m, scheme))
            assert sh.spec_for_param(a, shape, m, scheme) == want, (scheme, name)
            n += 1
    for shape_name, (cax, cshapes) in caches.items():
        for name, a, shape in _leaves(cax, cshapes):
            want = tuple(ref_sh.spec_for_activation(a, shape, m))
            assert sh.spec_for_activation(a, shape, m) == want, (shape_name, name)
    assert sh.batch_spec(m) == tuple(ref_sh.batch_spec(m))
    assert n > 0


def test_shardings_trees_and_fallbacks():
    m = MESHES["16x16"]
    cfg = ARCHS["granite-3-2b"]
    specs = registry.param_layout(cfg)[0]
    tree = sh.param_shardings(registry.param_axes(cfg), specs, m, "fsdp")
    # kv=8 on model=16: replicated KV (GQA fallback), embed rows over data
    assert tree["layers"]["wk"] == (None, "data", None, None)
    assert tree["layers"]["wq"] == (None, "data", "model", None)
    assert tree["embed"] == ("model", "data")
    opt = {"m": specs, "v": specs, "t": ((), torch.int32)}
    assert sh.opt_state_shardings(tree, opt, m) == {"m": tree, "v": tree, "t": ()}
    assert sh.opt_state_shardings(tree, (), m) == ()
    cache = {"k": ((40, 128, 32768, 8, 64), torch.bfloat16)}
    assert sh.cache_shardings({"k": ("layers", "batch", None, "kv", None)}, cache, m) == \
        {"k": (None, "data", None, None, None)}
    assert sh.local_shape((49408, 2048), ("model", "data"), m) == (3088, 128)
    assert sh.local_shape((256, 4096), (("pod", "data"), None),
                          MESHES["2x16x16"]) == (8, 4096)
    with pytest.raises(ValueError, match="unknown scheme"):
        sh.spec_for_param(("embed",), (16,), m, "zero3")


def test_placements():
    from torch.distributed.tensor import Replicate, Shard

    class _Mesh:
        mesh_dim_names = ("pod", "data", "model")

    assert sh.placements((("pod", "data"), None, "model"), _Mesh()) == \
        [Shard(0), Shard(0), Shard(2)]
    assert sh.placements((None, None), _Mesh()) == [Replicate()] * 3
    with pytest.raises(ValueError, match="names mesh axis 'expert'"):
        sh.placements(("expert",), _Mesh())


GQA = dataclasses.replace(ARCHS["granite-3-2b"].reduced(), n_heads=8, n_kv_heads=2, head_dim=32)
SSM = dataclasses.replace(ARCHS["mamba2-1.3b"].reduced(), n_layers=1)


JOBS = {"gqa-transformer": (GQA, [((2, 2), "fsdp"), ((1, 4), "tp")]),
        "mamba2": (SSM, [((2, 2), "fsdp")])}


@pytest.fixture(scope="module")
def gloo_numerics():
    """Every job's errors from rank 0 of one gloo world of 4."""
    return run_world(4, W.numerics_rank, JOBS, 0, 4, 128)[0]


@pytest.mark.parametrize("job", sorted(JOBS))
def test_sharded_numerics_on_a_gloo_world(gloo_numerics, job):
    cfg, cases = JOBS[job]
    assert len(gloo_numerics[job]) == len(cases)
    for case, errs in gloo_numerics[job].items():
        errs.pop("fallbacks")
        assert len(errs) == 2 + _count(registry.param_axes(cfg))
        for name, (err, scale) in errs.items():
            assert err <= NUMERICS_RTOL * scale, (case, name, err, scale)


def _count(axes) -> int:
    return sum(_count(v) if isinstance(v, dict) else 1 for v in axes.values())
