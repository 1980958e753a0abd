"""The port's payload packing and audit chain against the JAX package.

Tolerance: exact equality (int32/int64 bit patterns, wrapping arithmetic).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_tpu.core import soa as jsoa
from shadow_tpu.obs import audit as jaudit
from shadow_tpu_torch.core import soa as tsoa
from shadow_tpu_torch.obs import audit as taudit

I64 = np.iinfo(np.int64)


@pytest.mark.parametrize("P", [1, 2, 3, 12])
def test_pack_unpack_match_jax(P):
    rs = np.random.default_rng(P)
    a = rs.integers(-2**31, 2**31, size=(40, 3, P)).astype(np.int32)
    a[0, 0] = -1
    a[0, 1] = np.iinfo(np.int32).min
    want = np.asarray(jsoa.pack_words(jnp.asarray(a)))
    got = tsoa.pack_words(torch.from_numpy(a)).numpy()
    assert got.dtype == want.dtype == np.int64
    assert np.array_equal(got, want)
    assert tsoa.packed_words(P) == jsoa.packed_words(P) == got.shape[-1]
    back = tsoa.unpack_words(torch.from_numpy(got), P).numpy()
    assert np.array_equal(back, np.asarray(jsoa.unpack_words(want, P)))
    assert np.array_equal(back, a)


def _events(seed, n=2000):
    rs = np.random.default_rng(seed)
    t = rs.integers(I64.min, I64.max, n, dtype=np.int64)
    # negative, zero and near-overflow times
    t[:6] = [I64.max, I64.min, -1, 0, I64.max - 1, I64.min + 1]
    src = rs.integers(-2**31, 2**31, n).astype(np.int32)
    dst = rs.integers(-2**31, 2**31, n).astype(np.int32)
    src[:2] = [np.iinfo(np.int32).max, -1]
    kind = rs.integers(-3, 9, n).astype(np.int32)
    return t, src, dst, kind


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_event_key_and_fold_match_jax(seed):
    t, s, d, k = _events(seed)
    want = np.asarray(jaudit.event_key(t, s, d, k))
    got = taudit.event_key(*map(torch.from_numpy, (t, s, d, k))).numpy()
    assert np.array_equal(got, want)
    rs = np.random.default_rng(seed + 10)
    dg = rs.integers(I64.min, I64.max, t.size, dtype=np.int64)
    mask = rs.random(t.size) < 0.6
    want = np.asarray(jaudit.fold(jnp.asarray(dg), jnp.asarray(mask),
                                  t, s, d, k))
    got = taudit.fold(*map(torch.from_numpy, (dg, mask, t, s, d, k))).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("n", [0, 1, 5, 1000])
def test_combine_matches_jax(n):
    d = np.random.default_rng(n).integers(I64.min, I64.max, n,
                                          dtype=np.int64)
    assert taudit.combine(d) == jaudit.combine(d)
