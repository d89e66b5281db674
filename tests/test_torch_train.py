"""The port's LM training path against the JAX package's, on the CPU:
the differentiable flash attention, the SSD's gradients, every family's
``loss_fn`` and its gradients, activation checkpointing, a whole
``train_step`` and the launcher (``repro_torch.launch.train``).

Inputs are numpy draws from fixed seeds handed to both packages; the
reduced configurations run in float32 with ``wq`` and ``wk`` (and
whisper's ``xwq``, ``xwk``) scaled by QK_SCALE = 1/8 before both get
them (the reference's fan-in rule makes the attention scores peaked
enough that near-ties turn float32 roundings into large differences
between any two implementations; ``tests/test_torch_jamba.py``).  The
reference runs under ``jax.jit`` (at XLA's backend optimisation level
0, see ``_jit``), with ``ATTN_IMPL`` at its default
("xla"): the port's eligible layers take the flash routing, whose CPU
forward is the kernel's plain version and whose backward is the
reference's recompute.  Tolerances:

- the loss, rtol LOSS_RTOL = 1e-6 (measured 1.5e-7);
- each parameter's gradient, atol GRAD_RTOL = 2e-5 of the leaf's largest
  reference gradient (measured up to 8.6e-6, whisper's);
- the flash Function's dq, dk, dv against the reference's
  ``flash_attention_diff`` (Pallas in interpret mode, as
  ``tests/test_kernels.py:256`` runs it), atol 1e-5 (float32 sums of
  128 keys in other orders);
- ``ssd_chunked``'s and ``moe_ffn``'s (with dropped entries) gradients
  against ``jax.grad`` of the reference's, atol 2e-5 of the largest;
- remat on against remat off in the port: the loss bit for bit, the
  gradients to 1e-6 of the largest (the recompute runs the same
  operations; the selective policies' saved products are the same
  values);
- granite's parameters and moments after two AdamW steps: each leaf's
  ``|p - p_ref| / |p_ref|`` (norms of the whole leaf) at most STEP_RTOL =
  1e-4.  A step moves each weight by lr g / (|g| + eps), so an element
  whose gradient is a few float32 roundings from zero can move quite
  differently; the leaf's norm keeps such elements well inside the
  bound, which any systematic fault exceeds.  (A leaf that starts at
  zero is its step alone, and where its gradients sit near eps it cannot
  be held so, as mamba2's ``conv_b``; granite's zero-initialised norms
  have gradients far above eps.  The card's phase 4n (c) holds every
  family's gradients and whole parameter tree instead.)
"""
import dataclasses
import functools
import io
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jcreg
from repro.kernels import attn_kernel as jattn
from repro.launch import specs as jspecs
from repro.launch import train as jtrain
from repro.models import mamba2 as jm2
from repro.models import registry as jreg
from repro.optim import optimizers as joptim
from repro_torch.analysis import traceutil
from repro_torch.checkpoint import load_pytree
from repro_torch.configs import registry as creg
from repro_torch.kernels import attn_kernel, ops
from repro_torch.launch import train
from repro_torch.launch.specs import make_batch
from repro_torch.models import common as cm
from repro_torch.models import convert, mamba2, registry
from repro_torch.optim import get as get_opt

LOSS_RTOL = 1e-6
GRAD_RTOL = 2e-5
FLASH_ATOL = 1e-5
STEP_RTOL = 1e-4
QK_SCALE = np.float32(1 / 8)
B = 2
LR = 1e-3
REF_COMPILE = {"xla_backend_optimization_level": 0}


def _jit(fn):
    """``jax.jit`` at XLA's backend optimisation level 0: the reference's
    programs here are small and run once, and their compiles are most of
    this module's time (a quarter less at level 0)."""
    return jax.jit(fn, compiler_options=REF_COMPILE)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread (the reduced models' operations are tiny; see
    ``tests/test_torch_jamba.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(name):
    """(port config, reference config) of ``name`` reduced; jamba's block
    cut to 2 sublayers (attention + dense FFN, one Mamba2 mixer + MoE
    FFN), which holds every kind of sublayer and compiles in a fifth of
    the reference's 8-sublayer block."""
    cfg, jcfg = creg.ARCHS[name].reduced(), jcreg.ARCHS[name].reduced()
    if cfg.family == "hybrid":
        cut = dict(n_layers=2, attn_layer_period=2)
        cfg, jcfg = dataclasses.replace(cfg, **cut), dataclasses.replace(jcfg, **cut)
    return cfg, jcfg


def _seq(cfg) -> int:
    """128 positions in all (the flash routing's multiple), the VLM's 16
    patches included."""
    return 128 - cfg.n_patches


def _tempered(tree):
    tree = jax.tree.map(np.array, tree)
    for part in ("layers", "blocks", "encoder", "decoder"):
        for n in ("wq", "wk", "xwq", "xwk"):
            if n in tree.get(part, {}):
                tree[part][n] = tree[part][n] * QK_SCALE
    return tree


@functools.lru_cache(maxsize=None)
def _case(name):
    """Tempered weights of ``name`` (numpy, drawn by the port's ``init``:
    the same names and shapes as the reference's), the reference's batch
    and its jitted ``value_and_grad(loss_fn)``, remat off; one trace a
    family for the module."""
    cfg, jcfg = _configs(name)
    drawn = registry.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    tree = _tempered(cm.tree_map(lambda t: t.numpy(), drawn))
    jbatch = jspecs.make_batch(jcfg, B, _seq(cfg), seed=3)
    vg = _jit(jax.value_and_grad(lambda p, b: jreg.loss_fn(jcfg, p, b, remat=False)))
    return cfg, jcfg, tree, jbatch, vg


def _port_batch(cfg, seed=3):
    b = make_batch(cfg, B, _seq(cfg), seed=seed, device="cpu")
    return dict(b, labels=b["tokens"])


def _loss_and_grads(cfg, params, batch, remat=False):
    leaves = cm.tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
    loss = registry.loss_fn(cfg, leaves, batch, remat=remat)
    loss.backward()
    return loss.detach(), cm.tree_map(lambda t: t.grad, leaves)


def _leaves(tree, prefix=""):
    """{path: array} of a nested dict of tensors or arrays."""
    out = {}
    for n, t in tree.items():
        if isinstance(t, dict):
            out.update(_leaves(t, f"{prefix}{n}/"))
        else:
            out[prefix + n] = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return out


def _assert_tree_close(got, want, rtol, what):
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    for n, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(got[n], w, rtol=0, atol=rtol * scale, err_msg=f"{what} {n}")


def _assert_steps_close(got, want, what):
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    for n, w in want.items():
        g = got[n].astype(np.float64)
        w = w.astype(np.float64)
        rel = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        assert rel <= STEP_RTOL, f"{what} {n}: relative difference {rel}"


# ---------------------------------------------------------------------------
# flash attention: the differentiable Function and the guard
# ---------------------------------------------------------------------------

def _qkv(seed, shapes, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=s).astype(np.float32) for s in shapes]
    return arrs, [torch.from_numpy(a).to(dtype).requires_grad_(True) for a in arrs]


def test_flash_diff_gradients_match_the_reference_vjp():
    """GQA 4:2 with a window of 48 over 128 positions: the Function's
    output and dq, dk, dv for a fixed cotangent against the reference's
    ``flash_attention_diff`` VJP (the Pallas forward in interpret mode,
    its jnp recompute backward)."""
    shapes = ((1, 128, 4, 32), (1, 128, 2, 32), (1, 128, 2, 32))
    arrs, (q, k, v) = _qkv(0, shapes)
    do = np.random.default_rng(1).normal(size=shapes[0]).astype(np.float32)
    o = attn_kernel.flash_attention_diff(q, k, v, True, 48)
    o.backward(torch.from_numpy(do))

    def ref(a, b, c, cot):
        out, vjp = jax.vjp(lambda *x: jattn.flash_attention_diff(*x, True, 48, 64, 64, True),
                           a, b, c)
        return (out, *vjp(cot))

    for got, want in zip((o.detach(), q.grad, k.grad, v.grad), _jit(ref)(*arrs, do)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=FLASH_ATOL)


@pytest.mark.parametrize("dtype,window", [(torch.float32, 0), (torch.bfloat16, 7)])
def test_flash_diff_backward_is_autograd_through_the_plain_version(dtype, window):
    """The recompute backward equals autograd through
    ``flash_attention_plain`` (float32 to 1e-5; bfloat16 gradients to two
    bfloat16 steps of the largest: autograd through the plain version also
    rounds the repeated heads' dk and dv to bfloat16 before summing each
    group), and its gradients have the inputs' dtypes."""
    shapes = ((2, 64, 4, 16), (2, 64, 1, 16), (2, 64, 1, 16))
    _, ins = _qkv(2, shapes, dtype)
    _, ref = _qkv(2, shapes, dtype)
    attn_kernel.flash_attention_diff(*ins, True, window).float().square().sum().backward()
    attn_kernel.flash_attention_plain(*ref, True, window).float().square().sum().backward()
    for a, b in zip(ins, ref):
        assert a.grad.dtype == dtype
        tol = FLASH_ATOL if dtype == torch.float32 else 2.0 ** -6 * float(b.grad.abs().max())
        torch.testing.assert_close(a.grad.float(), b.grad.float(), rtol=0, atol=tol)


def test_ops_route_a_gradient_through_the_function():
    """``ops.flash_attention`` (and so ``common.attention``) is the
    Function: a graph when a gradient is needed, none under ``no_grad`` or
    for detached inputs; on the CPU it gives the plain version's values
    and counts no launch."""
    _, (q, k, v) = _qkv(3, ((1, 128, 4, 32), (1, 128, 2, 32), (1, 128, 2, 32)))
    ops.reset_launches()
    o = ops.flash_attention(q, k, v, causal=True, window=9)
    assert type(o.grad_fn).__name__ == "_FlashDiffBackward"
    with torch.no_grad():
        assert ops.flash_attention(q, k, v, causal=True, window=9).grad_fn is None
    assert ops.flash_attention(q.detach(), k.detach(), v.detach()).grad_fn is None
    a = cm.attention(q, k, v, causal=True, window=9)
    assert type(a.grad_fn).__name__ == "_FlashDiffBackward"
    assert torch.equal(a, o)
    assert ops.launches()["flash_attention"] == 0


def test_bare_kernel_on_the_card_refuses_a_gradient():
    """On a (fake) CUDA tensor that requires a gradient, the bare
    ``attn_kernel.flash_attention`` raises through ``runtime.forward_only``
    before launching, so it never returns a detached result; without a
    gradient, and inside the Function's forward, it launches."""
    S = traceutil.tensor_spec
    shapes = (S((1, 128, 4, 32)), S((1, 128, 2, 32)), S((1, 128, 2, 32)))

    def bare(q, k, v):
        with torch.set_grad_enabled(True):
            return attn_kernel.flash_attention(q.requires_grad_(True), k, v)

    tr = traceutil.trace(bare, *shapes)
    assert isinstance(tr.error, RuntimeError) and tr.launches == []
    assert "no backward" in str(tr.error) and "flash_attention_diff" in str(tr.error)
    for fn in (attn_kernel.flash_attention, attn_kernel.flash_attention_diff):
        tr = traceutil.trace(fn, *shapes)
        assert tr.ok and [launch.lib for launch in tr.launches] == ["flash_attn"]
    with pytest.raises(TypeError, match="window"):
        attn_kernel.flash_attention_diff(*(torch.zeros(s[0]) for s in shapes), True, 2.0)


# ---------------------------------------------------------------------------
# the SSD: forward unchanged, gradients
# ---------------------------------------------------------------------------

def _ssd_in_place(x, dt, A, Bm, Cm, chunk):
    """``mamba2.ssd_chunked`` as it was before its gradient was repaired:
    the intra-chunk decay's ``exp_`` result multiplied in place."""
    B_, S, nh, hd = x.shape
    N, nc = Bm.shape[-1], S // chunk
    xc, dtc = x.reshape(B_, nc, chunk, nh, hd).float(), dt.reshape(B_, nc, chunk, nh).float()
    Bc, Cc = Bm.reshape(B_, nc, chunk, N).float(), Cm.reshape(B_, nc, chunk, N).float()
    a_cs = torch.cumsum(dtc * A, dim=2)
    a_tot, x_dt, a_h = a_cs[:, :, -1], xc * dtc[..., None], a_cs.transpose(2, 3)
    cb = Cc @ Bc.transpose(-1, -2)
    causal = torch.ones(chunk, chunk, dtype=torch.bool).tril()
    att = (a_h[..., :, None] - a_h[..., None, :]).masked_fill_(~causal, float("-inf"))
    y = att.exp_().mul_(cb[:, :, None]) @ x_dt.transpose(2, 3)
    sdecay = torch.exp(a_tot[:, :, None, :] - a_cs)
    w = (x_dt * sdecay[..., None]).reshape(B_, nc, chunk, nh * hd)
    states = (Bc.transpose(-1, -2) @ w).reshape(B_, nc, N, nh, hd).transpose(2, 3)
    decay = torch.exp(a_tot)[..., None, None]
    h, h_in = torch.zeros((B_, nh, N, hd)), []
    for c in range(nc):
        h_in.append(h)
        h = decay[:, c] * h + states[:, c]
    y = y + (Cc[:, :, None] @ torch.stack(h_in, dim=1)) * torch.exp(a_h)[..., None]
    return y.transpose(2, 3).reshape(B_, S, nh, hd).to(x.dtype), h


def _ssd_inputs(seed, S=64, nh=4, hd=8, N=16):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, nh, hd)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(B, S, nh)))).astype(np.float32)  # softplus
    A = -np.exp(rng.normal(size=(nh,)) * 0.5).astype(np.float32)
    Bm, Cm = (rng.normal(size=(B, S, N)).astype(np.float32) for _ in range(2))
    return x, dt, A, Bm, Cm


def test_ssd_forward_is_unchanged_and_its_gradients_match_the_reference():
    arrs = _ssd_inputs(4)
    ins = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    y, h = mamba2.ssd_chunked(*ins, chunk=16)
    with torch.no_grad():
        y0, h0 = _ssd_in_place(*(torch.from_numpy(a) for a in arrs), chunk=16)
    assert torch.equal(y.detach(), y0) and torch.equal(h.detach(), h0)
    (y.square().sum() + h.sum()).backward()

    def ref(*a):
        yy, hh = jm2.ssd_chunked(*a, chunk=16)
        return jnp.sum(jnp.square(yy)) + jnp.sum(hh)

    want = _jit(jax.grad(ref, argnums=tuple(range(5))))(*map(jnp.asarray, arrs))
    for t, w in zip(ins, want):
        w = np.asarray(w)
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=0,
                                   atol=GRAD_RTOL * float(np.abs(w).max()))


# ---------------------------------------------------------------------------
# every family's loss and gradients
# ---------------------------------------------------------------------------

FAMILIES = ["granite-3-2b", "gemma2-27b", "grok-1-314b", "kimi-k2-1t-a32b", "internvl2-26b",
            "whisper-large-v3", "jamba-v0.1-52b", "mamba2-1.3b"]


@pytest.mark.parametrize("name", FAMILIES)
def test_loss_and_gradients_match_the_reference(name):
    cfg, _jcfg, tree, jbatch, vg = _case(name)
    want_loss, want_grads = vg(jax.tree.map(jnp.asarray, tree), jbatch)
    batch = _port_batch(cfg)
    for n, t in batch.items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(jbatch[n]))
    params = convert.params_from_numpy(cfg, tree, device="cpu")
    ops.reset_launches()
    loss, grads = _loss_and_grads(cfg, params, batch)
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert float(loss) == pytest.approx(float(want_loss), rel=LOSS_RTOL)
    _assert_tree_close(grads, jax.tree.map(np.asarray, want_grads), GRAD_RTOL, name)


def test_moe_backward_with_dropped_entries_matches_the_reference():
    """``common.moe_ffn``'s gradients at capacity_factor 0.5 (half the
    entries dropped, all sent to the dispatch buffer's spare row by one
    ``index_copy_`` with duplicate indices) against ``jax.grad`` of the
    reference's: a dropped entry contributes nothing, forward or back."""
    from repro.models import common as jcm

    rng = np.random.default_rng(8)
    arrs = [rng.normal(size=s).astype(np.float32) / np.sqrt(s[-2] if len(s) > 2 else 1)
            for s in ((2, 16, 32), (32, 4), (4, 32, 24), (4, 32, 24), (4, 24, 32))]
    cot = rng.normal(size=(2, 16, 32)).astype(np.float32)
    ins = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    routing = []
    out, aux = cm.moe_ffn(*ins, top_k=2, capacity_factor=0.5, routing=routing)
    assert int(routing[0]["dropped"]) > 0
    ((out * torch.from_numpy(cot)).sum() + aux).backward()

    def ref(*a):
        o, ax = jcm.moe_ffn(*a, top_k=2, capacity_factor=0.5)
        return jnp.sum(o * cot) + ax

    want = _jit(jax.grad(ref, argnums=tuple(range(5))))(*map(jnp.asarray, arrs))
    for t, w in zip(ins, want):
        w = np.asarray(w)
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=0,
                                   atol=GRAD_RTOL * float(np.abs(w).max()))


@pytest.mark.parametrize("policy", ["nothing_saveable", "dots_saveable",
                                    "dots_with_no_batch_dims_saveable", "none"])
def test_remat_matches_no_remat(policy):
    """granite's loss and gradients with each layer checkpointed under
    each policy equal the plain backward's; the flash routing runs once a
    layer in the forward and again in each layer's recompute."""
    cfg, _, tree, _, _ = _case("granite-3-2b")
    cfg = dataclasses.replace(cfg, remat_policy=policy)
    params = convert.params_from_numpy(cfg, tree, device="cpu")
    batch = _port_batch(cfg)
    want_loss, want = _loss_and_grads(cfg, params, batch)
    calls = []
    real = ops.flash_attention

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    ops.flash_attention = counting
    try:
        loss, grads = _loss_and_grads(cfg, params, batch, remat=True)
    finally:
        ops.flash_attention = real
    assert torch.equal(loss, want_loss)
    _assert_tree_close(grads, want, 1e-6, policy)
    assert len(calls) == cfg.n_layers * (1 if policy == "none" else 2)


def test_remat_wrap_policies():
    body = lambda x: x  # noqa: E731
    assert cm.remat_wrap(body, "none") is body
    with pytest.raises(KeyError):
        cm.remat_wrap(body, "everything_saveable")


@pytest.mark.parametrize("impl", ["logp", "lse"])
def test_next_token_ce_matches_the_reference(impl):
    from repro.models import common as jcm

    cfg = dataclasses.replace(creg.ARCHS["granite-3-2b"].reduced(), ce_impl=impl)
    rng = np.random.default_rng(5)
    logits = (rng.normal(size=(2, 9, 40)) * 3).astype(np.float32)
    labels = rng.integers(0, 40, size=(2, 9)).astype(np.int32)
    got = cm.next_token_ce(cfg, torch.from_numpy(logits), torch.from_numpy(labels))
    want = _jit(functools.partial(jcm.next_token_ce, cfg))(logits, labels)
    assert float(got) == pytest.approx(float(want), rel=LOSS_RTOL)


# ---------------------------------------------------------------------------
# train_step and the launcher
# ---------------------------------------------------------------------------

def test_train_step_matches_the_reference():
    """Two steps of granite with the launcher's AdamW (weight decay 0.01)
    against the reference launcher's step (``value_and_grad`` of
    ``loss_fn`` without remat, then ``opt.update``) on the same tokens."""
    cfg, jcfg, tree, jbatch, vg = _case("granite-3-2b")
    jopt = joptim.adamw(weight_decay=0.01)
    jupdate = _jit(functools.partial(jopt.update, lr=LR))
    jp = jax.tree.map(jnp.asarray, tree)
    jstate = jopt.init(jp)
    opt = get_opt("adamw", weight_decay=0.01)
    params = convert.params_from_numpy(cfg, tree, device="cpu")
    state = opt.init(params)
    batch = _port_batch(cfg)
    for _ in range(2):
        want_loss, g = vg(jp, jbatch)
        jp, jstate = jupdate(g, jstate, jp)
        loss, params, state = train.train_step(cfg, opt, params, state, batch, LR)
        assert float(loss) == pytest.approx(float(want_loss), rel=LOSS_RTOL)
        assert not any(t.requires_grad for t in _leaves_t(params))
    _assert_steps_close(params, jax.tree.map(np.asarray, jp), "params")
    _assert_steps_close({"m": state["m"], "v": state["v"]},
                        jax.tree.map(np.asarray, {"m": jstate["m"], "v": jstate["v"]}), "state")
    assert int(state["t"]) == int(jstate["t"]) == 2 and state["t"].dtype == torch.int32


def _leaves_t(tree):
    for t in tree.values():
        yield from (_leaves_t(t) if isinstance(t, dict) else (t,))


def test_token_stream_is_the_references_bit_for_bit():
    got = train.token_stream(97, 3, 21, seed=1, device="cpu")
    want = jtrain.token_stream(97, 3, 21, seed=1)
    for _ in range(2):
        g, w = next(got), next(want)
        assert g["tokens"].dtype == torch.int32 and g["labels"] is g["tokens"]
        np.testing.assert_array_equal(g["tokens"].numpy(), np.asarray(w["tokens"]))


def test_launcher_runs_on_the_cpu_and_writes_the_references_checkpoint(tmp_path):
    """``--device cpu --steps 3`` prints the reference's lines; its
    checkpoint holds the reference launcher's npz keys and loads back."""
    ckpt = str(tmp_path / "ck.npz")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        train.main(["--device", "cpu", "--steps", "3", "--ckpt", ckpt])
    lines = out.getvalue().splitlines()
    assert lines[0] == "training granite-3-2b-smoke: 2L d=256 vocab=512 family=dense"
    assert lines[1].startswith("params: ") and lines[-1] == f"checkpoint -> {ckpt}"
    assert [ln.split()[:2] for ln in lines[2:5]] == [["step", str(i)] for i in range(3)]
    assert lines[-2].startswith("loss ") and lines[-2].endswith(
        ("(improved)", "(NO IMPROVEMENT)"))
    cfg = creg.ARCHS["granite-3-2b"].reduced()
    like = registry.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    opt = get_opt("adamw", weight_decay=0.01)
    tree = load_pytree(ckpt, {"params": like, "opt": opt.init(like)})
    assert int(tree["opt"]["t"]) == 3
    jp = jax.eval_shape(lambda: jreg.init(jcreg.ARCHS["granite-3-2b"].reduced(),
                                          jax.random.PRNGKey(0))[0])
    with np.load(ckpt) as z:
        want = {"/".join(f"d:{k.key}" for k in path) for path, _ in
                jax.tree_util.tree_flatten_with_path(
                    {"params": jp, "opt": {"m": jp, "v": jp, "t": 0}})[0]}
        assert set(z.files) == want


def test_launcher_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--steps", "1"])
    assert train.build_parser().parse_args([]).arch == "granite-3-2b"
    assert sorted(creg.ASSIGNED) == sorted(jcreg.ASSIGNED)
