"""The port's production dry run (``repro_torch.launch.dryrun``) and its
counters (``launch/trace_analysis.py``), on the CPU with fake tensors.

- Reduced granite, jamba and whisper, one layer deep (jamba one block of
  2 sublayers, as the train tests cut it), trace a train, a prefill and a
  decode step as rank 0 of a fake world of 8 ranks on the mesh (2, 4)
  under fsdp: each ends with a summary, and its argument bytes equal the
  arithmetic of the reference's own specs (``repro.launch.sharding`` on
  a duck mesh, the shapes from ``jax.eval_shape`` of the reference's
  ``init`` and ``init_decode_cache``): the rank's local parameters,
  AdamW's bfloat16 moments and step, and the inputs or the cache.
- A dense train step on the mesh (8, 1) (pure data parallelism: nothing
  but the batch is split) counts exactly the matrix-product FLOPs of its
  shapes: with remat the layers' products run twice forward (the
  recompute stops once the backward has what it saved, so without the
  down projection) and twice in the backward, the head's once and twice,
  and attention (the plain route on the CPU) two score-sized products
  forward, twice, and five in its recompute backward.
- The memory plan does not depend on what ran before; a refused op's
  traceback releases its inputs.
- The collective conventions on hand-built redistributions
  (``tests/test_hlo_analysis.py``'s counterpart): an all-gather moves its
  output, an all-reduce twice its input, a reduce-scatter its input, an
  all-to-all its size; a trace of nothing is all zeros.
- ``run_combo`` and ``main``: artifacts with the reference's keys, the
  reference's skips, a failed combo recorded with its traceback and exit
  code 1, ``--device cuda`` refused without a card, and a trace refused
  inside an initialised process group.
"""
import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as REF_ARCHS
from repro.launch import sharding as ref_sh
from repro.models import registry as ref_registry
from repro_torch.configs.base import InputShape
from repro_torch.configs.registry import ARCHS
from repro_torch.launch import dryrun
from repro_torch.launch import trace_analysis as ta
from repro_torch.launch.fake import fake_mode, fake_world

B, S = 8, 128
MESH = (2, 4)


class _DuckMesh:
    def __init__(self, shape):
        self.axis_names = ("data", "model")
        self.devices = type("A", (), {"shape": tuple(shape)})()


def _cut(cfg):
    """One layer (jamba: one block of two sublayers; whisper: one encoder
    and one decoder layer) of the reduced configuration."""
    cut = {"hybrid": dict(n_layers=2, attn_layer_period=2),
           "encdec": dict(n_layers=1, n_encoder_layers=1)}.get(cfg.family, dict(n_layers=1))
    return dataclasses.replace(cfg, **cut)


def _local_bytes(shape, dtype, spec, mesh) -> int:
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    n = 1
    for d, e in zip(shape, tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))):
        div = 1
        for a in (e if isinstance(e, tuple) else (() if e is None else (e,))):
            div *= sizes[a]
        n *= d // div
    return n * np.dtype(dtype).itemsize


def _tree_bytes(axes, shapes, mesh, spec_fn, dtype=None):
    total = 0
    for k, ax in axes.items():
        if isinstance(ax, dict):
            total += _tree_bytes(ax, shapes[k], mesh, spec_fn, dtype)
        else:
            sh = shapes[k]
            total += _local_bytes(sh.shape, dtype or sh.dtype, spec_fn(tuple(ax), sh.shape),
                                  mesh)
    return total


def _reference_argument_bytes(arch, mode) -> int:
    """A rank's argument bytes from the reference's specs and shapes."""
    cfg, mesh, got = _cut(REF_ARCHS[arch].reduced()), _DuckMesh(MESH), {}

    def init(key):
        p, ax = ref_registry.init(cfg, key)
        got["axes"] = ax
        return p

    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    pspec = lambda ax, shape: ref_sh.spec_for_param(ax, shape, mesh, "fsdp")  # noqa: E731
    total = _tree_bytes(got["axes"], shapes, mesh, pspec)
    batch = tuple(ref_sh.batch_spec(mesh))
    if mode == "train":  # AdamW's bfloat16 m and v, and its int32 step
        total += 2 * _tree_bytes(got["axes"], shapes, mesh, pspec, jnp.bfloat16) + 4
    if mode in ("train", "prefill"):
        names = ["tokens"] + (["labels"] if mode == "train" else [])
        total += len(names) * _local_bytes((B, S), np.int32, batch, mesh)
        stub = {"vlm": ("patch_embeds", cfg.n_patches),
                "encdec": ("audio_embeds", cfg.encoder_len)}.get(cfg.family)
        if stub:
            total += _local_bytes((B, stub[1], cfg.d_model), np.float32, batch, mesh)
        return total
    cache = jax.eval_shape(lambda: ref_registry.init_decode_cache(cfg, B, S))
    cspec = lambda ax, shape: ref_sh.spec_for_activation(ax, shape, mesh)  # noqa: E731
    total += _tree_bytes(ref_registry.cache_axes(cfg, ""), cache, mesh, cspec)
    return total + _local_bytes((B, 1), np.int32, batch, mesh) + 4


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["granite-3-2b", "jamba-v0.1-52b", "whisper-large-v3"])
def test_reduced_steps_trace_on_a_fake_world(arch, mode):
    summary, meta = dryrun.trace_one(_cut(ARCHS[arch].reduced()), InputShape("t", S, B, mode),
                                     MESH, "fsdp", device="cpu")
    assert summary.argument_bytes == _reference_argument_bytes(arch, mode)
    assert summary.dot_flops > 0 and summary.bytes_accessed > 0 and summary.n_ops > 0
    assert summary.collective_counts, "a sharded step moves shards"
    assert summary.temp_bytes > 0 and summary.peak_bytes >= summary.argument_bytes
    assert summary.bytes_per_device == (summary.argument_bytes + summary.temp_bytes
                                        + summary.output_bytes)
    assert meta["flash_plans"] == []  # fake CPU tensors take the plain route
    if mode == "decode":  # the cache's rows are written in place
        assert summary.alias_bytes > 0 and summary.output_bytes < summary.argument_bytes
    if mode == "train":  # new parameters and moments come out
        assert summary.output_bytes > meta["param_bytes_per_device"]


def _dense_train_flops(cfg, b: int, s: int) -> float:
    """Matrix-product FLOPs of one remat train step of a dense transformer
    on b rows of s tokens (see module doc)."""
    D, H, Hkv, dh, F, V = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.dh, cfg.d_ff,
                           cfg.padded_vocab)
    T = b * s
    layer = 2 * T * D * (2 * H * dh + 2 * Hkv * dh) + 3 * 2 * T * D * F
    down = 2 * T * F * D  # the recompute stops once the backward has its inputs
    unit = 2 * b * H * s * s * dh
    return cfg.n_layers * (4 * layer - down + 9 * unit) + 3 * 2 * T * D * V


def test_dense_train_flops_equal_the_count_from_shapes():
    cfg = ARCHS["granite-3-2b"].reduced()
    summary, _ = dryrun.trace_one(cfg, InputShape("t", S, B, "train"), (8, 1), "tp",
                                  device="cpu")
    assert summary.dot_flops == _dense_train_flops(cfg, B // 8, S)
    assert summary.kernel_flops == 0


def test_memory_plan_does_not_depend_on_what_ran_before():
    """The same step traced twice, the collector's state moved between,
    gives the same plan (it used to depend on when the garbage collector
    ran: refused ops' tracebacks held their inputs in cycles).  The first
    trace of a process fills DTensor's caches and is not compared."""
    import gc

    cfg, shape = _cut(ARCHS["grok-1-314b"].reduced()), InputShape("t", S, B, "prefill")
    dryrun.trace_one(cfg, shape, MESH, "fsdp", device="cpu")  # DTensor's caches filled
    first, _ = dryrun.trace_one(cfg, shape, MESH, "fsdp", device="cpu")
    assert first.fallbacks  # the MoE's counts into plain zeros
    junk = [[i] for i in range(100_000)]  # moves the collector's counters
    gc.disable()
    try:
        again, _ = dryrun.trace_one(cfg, shape, MESH, "fsdp", device="cpu")
    finally:
        gc.enable()
    del junk
    assert (again.temp_bytes, again.peak_bytes, again.output_bytes, again.temp_by_op) == \
        (first.temp_bytes, first.peak_bytes, first.output_bytes, first.temp_by_op)


def test_release_frees_what_a_refusal_holds():
    """``_release`` clears a refused op's traceback frames (and those of
    the exceptions it chains), whose locals hold the op's inputs."""
    import gc
    import weakref

    def refuse(x):
        try:
            raise ValueError("no rule")
        except ValueError as e:
            raise RuntimeError("refused") from e

    gc.disable()
    try:
        t = torch.empty(16)
        alive = weakref.ref(t.untyped_storage())
        try:
            refuse(t)
        except RuntimeError as e:
            error = e
        del t
        assert alive() is not None  # the traceback's frame holds it
        ta._release(error)
        assert alive() is None
    finally:
        gc.enable()


def _sharded(mesh, shape, placements):
    from torch.distributed.tensor import DTensor, Shard

    local = list(shape)
    for p in placements:
        if isinstance(p, Shard):
            local[p.dim] //= mesh.size()
    return DTensor.from_local(torch.empty(local), mesh, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=tuple(math.prod(shape[i + 1:]) for i in range(len(shape))))


def test_collective_conventions():
    from torch.distributed.tensor import Partial, Replicate, Shard

    assert ta.collective_bytes("all-reduce", 512, 512) == 1024
    assert ta.collective_bytes("all-gather", 128, 512) == 512
    assert ta.collective_bytes("reduce-scatter", 512, 128) == 512
    assert ta.collective_bytes("all-to-all", 512, 512) == 512
    assert ta.attended_pairs(4, 4, True) == 10
    assert ta.attended_pairs(4, 4, True, window=2) == 7
    assert ta.attended_pairs(3, 5, False) == 15
    assert ta.flash_flops(2, 3, 8, 4, 4, True) == 4 * 2 * 3 * 8 * 10
    with fake_world((4,), ("data",), "cpu") as mesh, fake_mode():
        full = 64 * 32 * 4
        cases = [
            ([Shard(0)], [Replicate()], {"all-gather": full}),
            ([Partial()], [Replicate()], {"all-reduce": 2 * full}),
            ([Partial()], [Shard(0)], {"reduce-scatter": full}),
        ]
        for src, dst, want in cases:
            x = _sharded(mesh, (64, 32), src)
            _, s = ta.trace(lambda x=x, dst=dst: x.redistribute(mesh, dst), x, "cpu")
            assert s.collective_by_kind == want, (src, dst)
            assert s.collective_counts == {k: 1 for k in want}
            assert s.collective_bytes == sum(want.values())
        _, s = ta.trace(lambda: None, (), "cpu")
        assert (s.dot_flops, s.bytes_accessed, s.collective_bytes, s.collective_counts,
                s.argument_bytes, s.temp_bytes, s.residual_while_loops) == (0, 0, 0, {}, 0, 0, 0)
        # an all-to-all made by hand (the all-to-all MoE's exchange) is its size
        x = torch.empty(4, 16)

        def exchange():
            out = torch.empty_like(x)
            torch.distributed.all_to_all_single(out, x)
            return out

        _, s = ta.trace(exchange, x, "cpu")
        assert s.collective_by_kind == {"all-to-all": 4 * 16 * 4}


def test_run_combo_artifacts_and_main(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(dryrun.ARCHS, "granite-3-2b", ARCHS["granite-3-2b"].reduced())
    r = dryrun.run_combo("granite-3-2b", "prefill_32k", False, "fsdp", str(tmp_path),
                         device="cpu", verbose=False)
    assert r["status"] == "ok", r.get("traceback")
    for k in ("compile_s", "bytes_per_device", "memory_analysis", "hlo_gflops_per_device",
              "hlo_gbytes_per_device", "collective_gbytes_per_device", "compute_s",
              "memory_s", "collective_s", "bottleneck", "model_gflops", "useful_flops_ratio",
              "collective_counts", "device", "hw", "peak_bytes", "param_bytes_per_device"):
        assert k in r, k
    assert r["hw"] == "h100_sxm" and r["chips"] == 256 and r["residual_while_loops"] == 0
    on_disk = json.loads((tmp_path / "granite-3-2b__prefill_32k__16x16__fsdp.json").read_text())
    assert on_disk["status"] == "ok"
    proof = dryrun.run_combo("granite-3-2b", "decode_32k", True, "fsdp", str(tmp_path),
                             device="cpu", verbose=False, roofline=False)
    assert proof["status"] == "ok" and "compute_s" not in proof and proof["mesh"] == "2x16x16"
    skip = dryrun.run_combo("granite-3-2b", "long_500k", False, "fsdp", str(tmp_path),
                            device="cpu", verbose=False)
    assert skip["status"] == "skipped" and skip["reason"] == dryrun.SKIPS[
        ("granite-3-2b", "long_500k")]

    def broken(*args, **kwargs):
        raise RuntimeError("no layout")

    monkeypatch.setattr(dryrun, "trace_one", broken)
    assert dryrun.main(["--arch", "granite-3-2b", "--shape", "train_4k", "--device", "cpu",
                        "--out", str(tmp_path)]) == 1
    failed = json.loads((tmp_path / "granite-3-2b__train_4k__16x16__fsdp.json").read_text())
    assert failed["status"] == "error" and "no layout" in failed["traceback"]
    assert "[FAIL]" in capsys.readouterr().out


@pytest.mark.skipif(torch.cuda.is_available(), reason="the card is present")
def test_device_cuda_refused_without_a_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["--arch", "granite-3-2b", "--shape", "train_4k"])


def test_trace_refuses_an_initialised_world():
    with fake_world((2,), ("data",), "cpu"):
        with pytest.raises(RuntimeError, match="already initialised"):
            dryrun.trace_one(ARCHS["granite-3-2b"].reduced(), InputShape("t", S, B, "prefill"),
                             MESH, "fsdp", device="cpu")


def _a2a_cfg():
    """Reduced kimi-k2 one layer deep with 8 experts of F = 144: on the
    mesh (4, 2) a rank holds 2 experts and 72 of their FFN columns, a
    shape no other tensor of the step ends in."""
    return dataclasses.replace(ARCHS["kimi-k2-1t-a32b"].reduced(), n_layers=1, n_experts=8,
                               moe_d_ff=144)


def test_ep_a2a_step_holds_each_ranks_expert_shards(monkeypatch):
    """A reduced MoE train step under the ep scheme through the
    all-to-all dispatch on a fake world of 8 ((4, 2) over ("data",
    "model")): every call of ``moe_ffn_a2a`` gets the rank's (E / n, D, F /
    M) shards; a rank holds 3 (E / n) D (F / M) expert elements a MoE
    layer, the sharding's arithmetic; no all-gather or all-reduce moves an
    expert stack or a shard of one; the all-to-alls run; and the stacks'
    gradients reach the optimizer sharded as the stacks are."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch import sharding as sh
    from repro_torch.models import moe_a2a
    from repro_torch.models import registry

    cfg, mesh = _a2a_cfg(), (4, 2)
    (n, M), E, D, Fe = mesh, cfg.n_experts, cfg.d_model, cfg.expert_d_ff
    seen, grads = [], {}
    real_a2a, real_opt = moe_a2a.moe_ffn_a2a, dryrun.get_opt

    def spy(x, router, w1, w3, w2, **kw):
        seen.append(tuple(tuple(t.shape) for t in (w1, w3, w2)))
        return real_a2a(x, router, w1, w3, w2, **kw)

    def get_opt(*a, **kw):
        opt = real_opt(*a, **kw)

        def update(g, state, params, lr):
            for k in ("w1", "w3", "w2"):
                assert isinstance(g["layers"][k], DTensor)
                grads[k] = [str(p) for p in g["layers"][k].placements]
            return opt.update(g, state, params, lr)

        return type(opt)(opt.init, update)

    monkeypatch.setattr(moe_a2a, "moe_ffn_a2a", spy)
    monkeypatch.setattr(dryrun, "get_opt", get_opt)
    summary, meta = dryrun.trace_one(cfg, InputShape("t", S, B, "train"), mesh, "ep",
                                     device="cpu", moe_a2a=True)
    shard = ((E // n, D, Fe // M), (E // n, D, Fe // M), (E // n, Fe // M, D))
    assert seen and set(seen) == {shard}
    specs, dtype = registry.param_layout(cfg)
    itemsize = torch.empty((), dtype=dtype).element_size()
    duck = _DuckMesh(mesh)
    by_sharding = sum(math.prod(sh.local_shape(
        specs["layers"][k][0], sh.spec_for_param(registry.param_axes(cfg)["layers"][k],
                                                  specs["layers"][k][0], duck, "ep"), duck))
        for k in ("w1", "w3", "w2")) * itemsize
    assert meta["expert_param_bytes_per_device"] == by_sharding == \
        cfg.n_layers * 3 * (E // n) * D * (Fe // M) * itemsize
    assert dryrun.stack_collectives(summary.collective_shapes, cfg, mesh) == {}
    assert summary.collective_counts.get("all-to-all", 0) >= 2
    shard_1_3 = [str(p) for p in (torch.distributed.tensor.Shard(1),
                                  torch.distributed.tensor.Shard(3))]
    assert grads == {"w1": shard_1_3, "w3": shard_1_3,
                     "w2": shard_1_3[:1] + [str(torch.distributed.tensor.Shard(2))]}


def test_stack_collectives_picks_the_expert_stacks():
    """On (4, 2) with E 8, D 256, F 144: a stack or shard gathered or
    summed is named; the shared expert's (L, D, F / M), an all-to-all of a
    shard's shape and a dense model are not."""
    cfg = _a2a_cfg()
    shapes = {("all-gather", (2, 256, 72), (8, 256, 72)): 2,
              ("all-reduce", (1, 2, 72, 256), (1, 2, 72, 256)): 1,
              ("all-gather", (8, 256, 72), (8, 256, 144)): 1,
              ("all-reduce", (1, 256, 72), (1, 256, 72)): 3,
              ("all-to-all", (2, 256, 72), (2, 256, 72)): 2,
              ("all-gather", (2, 128, 256), (8, 128, 256)): 1}
    assert dryrun.stack_collectives(shapes, cfg, (4, 2)) == {
        "all-gather (2, 256, 72) -> (8, 256, 72)": 2,
        "all-reduce (1, 2, 72, 256) -> (1, 2, 72, 256)": 1,
        "all-gather (8, 256, 72) -> (8, 256, 144)": 1}
    assert dryrun.stack_collectives(shapes, ARCHS["granite-3-2b"].reduced(), (4, 2)) == {}
