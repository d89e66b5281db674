"""``repro_torch.core.cache.request_list`` (Alg. 3's request list)
against the reference's ``repro.core.cache.request_list`` on seeded
caches: the same present entries and caching rounds, the same requested
ids, the same round and durations, so the same ``(miss_mask, I_req)``,
bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cache as ref
from repro_torch.core import cache

P, N = 64, 5


def _caches(seed: int):
    rng = np.random.default_rng(seed)
    present = rng.random(P) < 0.6
    ts = np.where(present, rng.integers(0, 12, P), -(2 ** 30)).astype(np.int32)
    values = rng.random((P, N)).astype(np.float32)
    idx = rng.choice(P, size=24, replace=False).astype(np.int64)
    mine = cache.CacheState(torch.from_numpy(values), torch.from_numpy(ts),
                            torch.from_numpy(present))
    theirs = ref.CacheState(jnp.asarray(values), jnp.asarray(ts), jnp.asarray(present))
    return mine, theirs, idx


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("D", [0, 1, 3, 10])
def test_request_list_matches_reference(seed, D):
    mine, theirs, idx = _caches(seed)
    t = 12
    m, req = cache.request_list(mine, torch.from_numpy(idx), t, D)
    rm, rreq = ref.request_list(theirs, jnp.asarray(idx), t, D)
    np.testing.assert_array_equal(m.numpy(), np.asarray(rm))
    np.testing.assert_array_equal(req.numpy(), np.asarray(rreq))
    assert req.dtype == torch.int64 and len(req) == int(m.sum())
    if D == 0:
        assert bool(m.all())
