"""The port's optimizers (``repro_torch.optim``) against the JAX
package's (``repro.optim``), on the CPU.

The same parameters and gradients (numpy draws from fixed seeds) go
through a few steps of both packages' ``update``, the reference's under
``jax.jit``.  Tolerances: float32 parameters and moments to rtol 1e-6,
atol 1e-7 (both compute the same float32 expression; the two libraries'
``pow``, ``sqrt`` and divisions may round the last bit apart);
bfloat16 parameters and moments to one bfloat16 step of each value
(2^-7 of its magnitude: both round the same float32 update once, and a
float32 value within rounding of a bfloat16 tie may round either way).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizers as joptim
from repro_torch.analysis import traceutil
from repro_torch.models import common as cm
from repro_torch.optim import adamw, get, momentum, sgd

LR = 1e-2
STEPS = 3
SHAPES = {"w": (5, 7), "blocks": {"u": (3, 4, 2), "b": (9,)}}


def _draw(rng, shapes):
    return {n: _draw(rng, s) if isinstance(s, dict) else
            rng.normal(size=s).astype(np.float32) for n, s in shapes.items()}


def _to_torch(tree, dtype):
    return cm.tree_map(lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dtype), tree)


def _to_jax(tree, dtype):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def _flat(tree):
    """Leaves of a nested dict as float32 numpy arrays, in key order."""
    return [np.asarray(t.float() if isinstance(t, torch.Tensor) else
                       jnp.asarray(t, jnp.float32)) for t in jax.tree.leaves(tree)]


def _close(got, want, dtype):
    for g, w in zip(_flat(got), _flat(want), strict=True):
        if dtype == torch.bfloat16:
            np.testing.assert_allclose(g, w, rtol=2.0 ** -7, atol=1e-30)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)


def _run(port, ref, dtype, jdtype):
    rng = np.random.default_rng(0)
    params = _draw(rng, SHAPES)
    grads = [_draw(rng, SHAPES) for _ in range(STEPS)]
    p, jp = _to_torch(params, dtype), _to_jax(params, jdtype)
    state, jstate = port.init(p), ref.init(jp)
    jupdate = jax.jit(lambda g, s, q: ref.update(g, s, q, LR))
    for g in grads:
        before = [t.clone() for t in jax.tree.leaves(p)]
        new_p, state = port.update(_to_torch(g, dtype), state, p, LR)
        for t, b in zip(jax.tree.leaves(p), before):
            assert torch.equal(t, b)  # the update makes new tensors
        p = new_p
        jp, jstate = jupdate(_to_jax(g, jdtype), jstate, jp)
        _close(p, jp, dtype)
        _close(state, jstate, dtype if dtype == torch.bfloat16 else torch.float32)
    return p, state


@pytest.mark.parametrize("name,port,ref", [
    ("sgd", sgd(), joptim.sgd()),
    ("momentum", momentum(0.8), joptim.momentum(0.8)),
    ("adamw", adamw(), joptim.adamw()),
    ("adamw-wd", adamw(weight_decay=0.01), joptim.adamw(weight_decay=0.01)),
])
def test_float32_steps_match_the_reference(name, port, ref):
    p, state = _run(port, ref, torch.float32, jnp.float32)
    assert all(t.dtype == torch.float32 for t in jax.tree.leaves(p))
    if name.startswith("adamw"):
        assert state["t"].dtype == torch.int32 and state["t"].shape == () and int(state["t"]) == 3


def test_bfloat16_params_keep_bfloat16_moments():
    p, state = _run(adamw(weight_decay=0.01), joptim.adamw(weight_decay=0.01),
                    torch.bfloat16, jnp.bfloat16)
    assert all(t.dtype == torch.bfloat16 for t in jax.tree.leaves((p, state["m"], state["v"])))


def test_state_dtype_bfloat16_over_float32_params():
    rng = np.random.default_rng(0)
    params = _to_torch(_draw(rng, SHAPES), torch.float32)
    state = adamw(state_dtype="bfloat16").init(params)
    assert all(t.dtype == torch.bfloat16 for t in jax.tree.leaves((state["m"], state["v"])))
    p, state = _run(adamw(state_dtype="bfloat16"), joptim.adamw(state_dtype="bfloat16"),
                    torch.float32, jnp.float32)
    assert all(t.dtype == torch.float32 for t in jax.tree.leaves(p))


def test_adamw_step_reads_nothing_back_on_the_card():
    """One AdamW update on (fake) CUDA tensors: no host read of a device
    value and no device-to-host copy (the step count and the bias
    corrections stay on the card), no kernel launch."""
    S = traceutil.tensor_spec
    opt = adamw(weight_decay=0.01)

    def step(w, u, g1, g2):
        params, grads = {"w": w, "b": {"u": u}}, {"w": g1, "b": {"u": g2}}
        new, state = opt.update(grads, opt.init(params), params, LR)
        return opt.update(grads, state, new, LR)

    tr = traceutil.trace(step, S((5, 7)), S((3, 4), torch.bfloat16), S((5, 7)),
                         S((3, 4), torch.bfloat16))
    assert tr.ok, tr.error
    assert tr.scan_safety_violations() == [] and tr.launches == []
    new, state = tr.output
    assert state["t"].device.type == "cuda" and state["t"].dtype == torch.int32
    assert new["b"]["u"].dtype == torch.bfloat16


def test_get_and_unknown_names():
    assert get("sgd").init({"a": torch.zeros(2)}) == ()
    assert set(get("adamw", b2=0.99).init({"a": torch.zeros(2)})) == {"m", "v", "t"}
    assert get("momentum", beta=0.5).init({"a": torch.ones(2)})["a"].sum() == 0
    with pytest.raises(ValueError, match="unknown optimizer 'lion'"):
        get("lion")
