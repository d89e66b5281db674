"""The port's codec wire forms and its top-k codec against the JAX
package's, on the same numpy inputs.

Held bit for bit on the CPU (``assert_array_equal``):

- top-k's ``roundtrip`` and ``decode(encode(z))``, and the indices it
  puts on the wire, for ``topk``, ``topk4`` and ``cache_delta+topk2``,
  at the default 4-byte and at 1-byte indices.  The inputs hold tied
  rows (uniform rows, ``[0.1, 0.3, 0.3, 0.3]``, ``[0, 0, 0.5, 0.5]``),
  which ``jax.lax.top_k`` resolves to the lower class index;
- the payload that ``encode`` puts on the wire for identity, ``quant1``,
  ``quant8`` and ``cache_delta+quant8`` (quant codes are float32 levels
  in both packages), and ``decode`` up to the simplex projection;
  ``decode(encode(z))`` also equals the port's ``roundtrip`` (the
  quantize-dequantize kernel's plain version on the CPU);
- ``payload_bytes``.

The simplex projection after a renormalizing decode is held to one
float32 ulp at 1.0 (2^-23): XLA sums a row left to right, PyTorch in its
vectorized order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.compress as jcodecs
import repro_torch.compress as pcodecs

N = 4
TIED = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.3, 0.3, 0.3],
                 [0.0, 0.0, 0.5, 0.5], [0.5, 0.5, 0.0, 0.0],
                 [0.4, 0.2, 0.2, 0.2]], np.float32)
TOPK_SPECS = ["topk", "topk4", "cache_delta+topk2"]
WIRE_SPECS = ["identity", "quant1", "quant8", "cache_delta+quant8"]


def _inputs(seed=3):
    """(z, base, present): a (3, 10, N) stack whose rows are the tied rows
    then Dirichlet rows; a base whose first rows are uniform (so the
    tied rows' residuals tie as well) and present half the time."""
    rng = np.random.default_rng(seed)
    z = rng.dirichlet(np.ones(N), size=(3, 10)).astype(np.float32)
    z[:, :len(TIED)] = TIED
    base = rng.dirichlet(np.ones(N), size=10).astype(np.float32)
    base[:len(TIED)] = 0.25
    present = np.arange(10) % 2 == 0
    present[:len(TIED)] = True
    return z, base, present


def _both(codec_j, codec_p, fn_j, fn_p, *arrays):
    want = fn_j(codec_j, *[None if a is None else jnp.asarray(a) for a in arrays])
    got = fn_p(codec_p, *[None if a is None else torch.from_numpy(np.asarray(a))
                          for a in arrays])
    return want, got


def _roundtrip(c, z, b, p):
    return c.roundtrip(z, base=b, present=p)


def _wire(c, z, b, p):
    return c.decode(c.encode(z, b, p), b, p)


@pytest.mark.parametrize("index_bytes", [None, 1])
@pytest.mark.parametrize("spec", TOPK_SPECS)
def test_topk_equals_reference_bit_for_bit(spec, index_bytes):
    jc = jcodecs.get_codec(spec, index_bytes=index_bytes)
    pc = pcodecs.get_codec(spec, index_bytes=index_bytes)
    z, base, present = _inputs()
    for b, pr in [(None, None), (base, present)]:
        for fn in (_roundtrip, _wire):
            want, got = _both(jc, pc, fn, fn, z, b, pr)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        # the same indices on the wire, ties to the lower class index
        inner_j = getattr(jc, "inner", jc)
        inner_p = getattr(pc, "inner", pc)
        if spec.startswith("cache_delta"):
            rj = np.asarray(z - jc._base(jnp.asarray(z), None if b is None else jnp.asarray(b),
                                         None if pr is None else jnp.asarray(pr)))[..., :-1]
        else:
            rj = z
        pj = inner_j.encode(jnp.asarray(rj))
        pp = inner_p.encode(torch.from_numpy(np.ascontiguousarray(rj)))
        np.testing.assert_array_equal(pp["indices"].numpy(), np.asarray(pj["indices"]))
        np.testing.assert_array_equal(pp["values"].numpy(), np.asarray(pj["values"]))
        assert pp["n_classes"] == pj["n_classes"]
    for n in (24, 17.5):
        assert pc.payload_bytes(n, N) == jc.payload_bytes(n, N)


def test_topk_ties_pick_the_lower_class_index():
    c = pcodecs.get_codec("topk2")
    got = c.encode(torch.from_numpy(TIED))["indices"].tolist()
    assert got == [[0, 1], [1, 2], [2, 3], [0, 1], [0, 1]]


def test_topk_never_calls_torch_topk(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("torch.topk breaks ties in no fixed order")

    monkeypatch.setattr(torch, "topk", refuse)
    monkeypatch.setattr(torch.Tensor, "topk", refuse)
    z, base, present = _inputs()
    for spec in TOPK_SPECS:
        pcodecs.get_codec(spec).roundtrip(torch.from_numpy(z), torch.from_numpy(base),
                                          torch.from_numpy(present))


def _payload_np(payload):
    if isinstance(payload, dict):
        return {k: np.asarray(v) for k, v in payload.items()}
    return np.asarray(payload)


@pytest.mark.parametrize("spec", WIRE_SPECS)
def test_wire_form_equals_reference_and_roundtrip(spec):
    jc, pc = jcodecs.get_codec(spec), pcodecs.get_codec(spec)
    rng = np.random.default_rng(5)
    z = rng.dirichlet(np.ones(7), size=(5, 16)).astype(np.float32)
    base = rng.dirichlet(np.ones(7), size=16).astype(np.float32)
    present = rng.random(16) < 0.5
    renormalized = spec in ("quant1", "quant8") or spec.startswith("cache_delta")
    for b, pr in [(None, None), (base, present)]:
        jz, jb, jp = (None if a is None else jnp.asarray(a) for a in (z, b, pr))
        tz, tb, tp = (None if a is None else torch.from_numpy(a) for a in (z, b, pr))
        # the payload on the wire: bit for bit
        want_p, got_p = _payload_np(jc.encode(jz, jb, jp)), pc.encode(tz, tb, tp)
        if isinstance(want_p, dict):
            assert set(got_p) == set(want_p)
            for k in want_p:
                assert got_p[k].dtype == torch.float32
                np.testing.assert_array_equal(got_p[k].numpy(), want_p[k])
        else:
            np.testing.assert_array_equal(got_p.numpy(), want_p)
        got = pc.decode(got_p, tb, tp)
        # on the CPU the wire form is the port's roundtrip, bit for bit
        np.testing.assert_array_equal(got.numpy(), pc.roundtrip(tz, tb, tp).numpy())
        # against the reference's decode: bit for bit up to the simplex
        # projection, whose row sum XLA takes left to right and PyTorch in
        # its vectorized order (an ulp at 1.0 apart)
        want = np.asarray(jc.decode(jc.encode(jz, jb, jp), jb, jp))
        if renormalized:
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2.0 ** -23)
        else:
            np.testing.assert_array_equal(got.numpy(), want)
    if spec.startswith("quant"):
        q = pc.encode(torch.from_numpy(z))["q"]
        assert float(q.max()) == 2 ** pc.bits - 1
        # the dequantized levels before the projection: bit for bit
        jr, pr_ = jcodecs.QuantCodec(pc.bits, False), pcodecs.QuantCodec(pc.bits, False)
        np.testing.assert_array_equal(
            pr_.decode(pr_.encode(torch.from_numpy(z))).numpy(),
            np.asarray(jr.decode(jr.encode(jnp.asarray(z)))))
