"""The fused round's plain version against the JAX package's jnp oracle
(``repro.kernels.ref.fused_round``) over the full product of every mode x
bits x sharpen x K in {1, 3, 8} x m in {1, 5, 24} x N in {2, 5, 10}, on
the CPU.  ``test_torch_round_kernel.py`` holds the same inputs to the
Pallas kernel on an orthogonal array of those shapes; this file is apart
so the two run on separate test workers (the oracle's eager operations
compile once per shape, most of this file's time).

Tolerances as there: atol 1e-6 on probabilities at beta >= 1, and
2e-6 * sum|w| on the linear moment (``sharpen=False``), float32 rounding
of sums taken in other orders.  The oracle has no pad lanes, so no beta
< 1 case differs by construction; beta in {1.0, 1.5, 4.0} as there.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels import ref as jref
from test_torch_round_kernel import ATOL, BETAS, KS, MODES, MS, NS, _inputs, _linear_atol, _port


@pytest.mark.parametrize("sharpen", [True, False])
@pytest.mark.parametrize("mode,bits", MODES)
def test_fused_round_plain_matches_oracle_on_every_shape(mode, bits, sharpen):
    for K, m, N in itertools.product(KS, MS, NS):
        z, w, base = _inputs(K * 1000 + m * 10 + N, K, m, N, mode)
        kw = dict(mode=mode, bits=bits, sharpen=sharpen)
        jb = None if base is None else jnp.asarray(base)
        for beta in (BETAS if sharpen else (None,)):
            want = np.asarray(jref.fused_round(jnp.asarray(z), jnp.asarray(w), beta,
                                               jb, **kw))
            atol = ATOL if sharpen else _linear_atol(w)
            np.testing.assert_allclose(_port(z, w, beta, base, **kw), want,
                                       rtol=0, atol=atol, err_msg=f"{(K, m, N)}")
