"""The ResNet of ``repro_torch.models.resnet`` (``init`` / ``apply``)
against the reference's ``repro.models.resnet`` on the CPU.

The reference's parameters, drawn from ``jax.random``, are carried into
the port (``models/convert.py``); both packages run the same images from
a seeded numpy Generator.  Logits to 1e-5 in float32 at depth 20 and 8,
on CIFAR's 32x32 and on 31x27, where the stride-2 convolutions' "SAME"
padding is (1, 1) and (0, 1) where 32 gives (0, 1).

The gradients of ``mean(logits**2)`` are held in float64 (weights and
images; GroupNorm's statistics stay float32 in both packages, as each
writes them) to 1e-5 of each leaf's norm.  In float32 this gradient is
ill-conditioned: GroupNorm's backward subtracts nearly equal terms, so
on some seeded inputs either package's float32 gradient lies far more
than 1e-5 of a leaf's norm from the float64 one, and a float32
comparison would measure rounding, not the port.  The float32 gradient
is held to the float64 reference at ``F32_GRAD_RTOL``.
"""
import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jcreg
from repro.models import registry as jreg
from repro.models import resnet as jresnet
from repro_torch.configs import registry as creg
from repro_torch.configs.resnet20_cifar import CONFIG
from repro_torch.models import common as cm
from repro_torch.models import convert, registry, resnet

SIZES = ((32, 32), (31, 27))
DEPTHS = (20, 8)
ATOL = 1e-5
GRAD_RTOL = 1e-5
F32_GRAD_RTOL = 1e-3
B = 4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _weights(depth):
    """The reference's parameters and axes, as numpy, and the port's
    conversion (shared: tests copy before they change a tree)."""
    params, axes = jresnet.init(jax.random.PRNGKey(depth), depth=depth)
    tree = jax.tree.map(np.asarray, params)
    cfg = dataclasses.replace(CONFIG, n_layers=depth)
    return params, axes, tree, convert.params_from_numpy(cfg, tree, device="cpu")


def _images(hw, seed=0):
    return np.random.default_rng(seed).standard_normal((B, *hw, 3)).astype(np.float32)


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("depth", DEPTHS)
def test_tree_has_the_reference_keys_shapes_and_axes(depth):
    jp, jaxes, _, _ = _weights(depth)
    p, axes = resnet.init(torch.Generator().manual_seed(0), depth=depth, device="cpu")
    assert axes == jaxes
    got = [(path, tuple(t.shape), t.dtype) for path, t in _leaves(p)]
    want = [(path, a.shape, torch.float32) for path, a in _leaves(jp)]
    assert got == want
    # the reference's initialisers: norms ones/zeros, biases zeros, He-normal convs
    assert all(bool((_at(p, path) == 1).all()) for path, _ in _leaves(p)
               if path[-1] in ("stem_scale", "g1s", "g2s"))
    assert all(bool((_at(p, path) == 0).all()) for path, _ in _leaves(p)
               if path[-1] in ("stem_bias", "g1b", "g2b", "head_b"))
    w = p["s2b0"]["c1"]
    assert abs(float(w.std()) - np.sqrt(2.0 / (9 * w.shape[2]))) < 0.05 * float(w.std())


@pytest.mark.parametrize("hw", SIZES, ids=["32x32", "31x27"])
@pytest.mark.parametrize("depth", DEPTHS)
def test_apply_matches_the_reference(depth, hw):
    jp, _, _, p = _weights(depth)
    x = _images(hw)
    want = np.asarray(jax.jit(lambda p, x: jresnet.apply(p, x, depth))(jp, jnp.asarray(x)))
    got = resnet.apply(p, torch.from_numpy(x), depth)
    assert got.shape == (B, 10) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def _jax_grads(tree, x, depth, dtype):
    f = jax.jit(jax.grad(lambda p, x: jnp.mean(jresnet.apply(p, x, depth) ** 2)))
    with jax.enable_x64(dtype == np.float64):
        g = f(jax.tree.map(lambda a: jnp.asarray(a, dtype), tree), jnp.asarray(x, dtype))
        return jax.tree.map(np.asarray, g)


def _port_grads(p, x, depth, dtype):
    pt = cm.tree_map(lambda t: t.detach().to(dtype).requires_grad_(), p)
    (resnet.apply(pt, torch.from_numpy(x).to(dtype), depth) ** 2).mean().backward()
    return cm.tree_map(lambda t: t.grad.numpy(), pt)


@pytest.mark.parametrize("hw", SIZES, ids=["32x32", "31x27"])
def test_gradients_match_jax_grad_in_float64(hw):
    _, _, tree, p = _weights(20)
    x = _images(hw)
    want = _jax_grads(tree, x, 20, np.float64)
    got = _port_grads(p, x, 20, torch.float64)
    for path, w in _leaves(want):
        np.testing.assert_allclose(_at(got, path), w, rtol=0,
                                   atol=GRAD_RTOL * np.linalg.norm(w), err_msg=str(path))


def test_float32_gradients_hold_to_the_float64_reference():
    _, _, tree, p = _weights(20)
    x = _images(SIZES[0], seed=1)
    want = _jax_grads(tree, x, 20, np.float64)
    got = _port_grads(p, x, 20, torch.float32)
    for path, w in _leaves(want):
        np.testing.assert_allclose(_at(got, path), w, rtol=0,
                                   atol=F32_GRAD_RTOL * np.linalg.norm(w), err_msg=str(path))


def test_same_padding_is_xla_s():
    """A 3x3 stride-2 conv pads (0, 1) on an even axis and (1, 1) on an
    odd one; stride 1 pads (1, 1); a 1x1 conv pads nothing."""
    assert resnet._same_pad(32, 3, 2) == (0, 1)
    assert resnet._same_pad(31, 3, 2) == (1, 1)
    assert resnet._same_pad(27, 3, 1) == (1, 1)
    assert resnet._same_pad(16, 1, 2) == (0, 0)


def test_refusals():
    with pytest.raises(ValueError, match="depth 6n \\+ 2"):
        resnet.init(torch.Generator(), depth=21, device="cpu")
    tree = copy.deepcopy(_weights(8)[2])
    del tree["s1b0"]["proj"]
    with pytest.raises(ValueError, match="missing \\['proj'\\]"):
        convert.params_from_numpy(dataclasses.replace(CONFIG, n_layers=8), tree, device="cpu")


def test_init_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resnet.init(torch.Generator())


def test_the_config_and_registries_are_the_reference_s():
    assert dataclasses.asdict(CONFIG) == dataclasses.asdict(jcreg.ARCHS["resnet20-cifar"])
    assert list(creg.ARCHS) == list(jcreg.ARCHS)
    assert creg.ASSIGNED == jcreg.ASSIGNED
    assert creg.get("resnet20-cifar") is CONFIG
    # neither model registry has an LM entry for the CNN
    for reg in (registry, jreg):
        with pytest.raises(ValueError, match="unknown family 'resnet' for resnet20-cifar"):
            reg.module_for(CONFIG)
