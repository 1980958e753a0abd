"""The port's threefry RNG (shadow_tpu_torch/core/rng.py) against jax.random.

Tolerance: exact equality. Keys are uint32 words and the uniforms are
float32 values built from bits, so any difference is a fault.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_tpu.core import rng as jrng
from shadow_tpu_torch.core import rng as trng

SEEDS = (0, 1, 42, 2**31 + 5, 987654321)
H = 64


def test_roadmap_test_vectors():
    k = trng.root_key(42)
    assert k.tolist() == [0, 42]
    f = trng.fold_in(k, 3)
    assert f.tolist() == [3134548294, 894150801]
    u = trng.bits_to_uniform(trng.random_bits32(trng.fold_in(f, 7)))
    assert u.dtype == torch.float32
    assert np.float32(u.item()) == np.float32(0.21911132)
    ju = jax.random.uniform(jax.random.fold_in(jax.random.fold_in(
        jax.random.PRNGKey(42), 3), 7), dtype=jnp.float32)
    assert np.asarray(ju).view(np.uint32) == u.numpy().view(np.uint32)


@pytest.mark.parametrize("seed", SEEDS)
def test_host_keys_match_jax(seed):
    want = np.asarray(jrng.host_keys(seed, H))
    got = trng.host_keys(seed, H).numpy()
    assert want.dtype == np.uint32
    assert np.array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_uniform_matrix_and_per_host_match_jax(seed):
    rs = np.random.default_rng(seed)
    ctr = rs.integers(0, 2**32, size=(H, 8), dtype=np.int64)
    # counters at 0, 1, 2**31 and the wrap point 2**32 - 1
    ctr[:, :4] = [0, 1, 2**31, 2**32 - 1]
    hk_j = jrng.host_keys(seed, H)
    hk_t = trng.host_keys(seed, H)
    want = np.asarray(jrng.uniform_matrix(hk_j, jnp.asarray(
        ctr.astype(np.uint32))))
    got = trng.uniform_matrix(hk_t, torch.from_numpy(ctr)).numpy()
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    want1 = np.asarray(jrng.uniform_per_host(hk_j, jnp.asarray(
        ctr[:, 3].astype(np.uint32))))
    got1 = trng.uniform_per_host(hk_t, torch.from_numpy(ctr[:, 3])).numpy()
    assert np.array_equal(got1.view(np.uint32), want1.view(np.uint32))
    wantb = np.asarray(jrng.bits_per_host(hk_j, jnp.asarray(
        ctr[:, 2].astype(np.uint32))))
    gotb = trng.bits_per_host(hk_t, torch.from_numpy(ctr[:, 2])).numpy()
    assert np.array_equal(gotb, wantb.astype(np.int64))


def test_counter_wraps_like_uint32():
    """c + 1 at 2**32 - 1 draws the same as counter 0, as uint32 does."""
    hk = trng.host_keys(7, 4)
    a = trng.uniform_matrix(hk, torch.full((4, 1), 2**32 - 1) + 1 & trng.M32)
    b = trng.uniform_matrix(hk, torch.zeros((4, 1), dtype=torch.int64))
    assert torch.equal(a, b)


@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_torch_and_numpy_paths_match_jax(seed):
    """The CPU (numpy) and card (torch) forms of threefry2x32 give JAX's
    bits, here both on CPU tensors: keys and counters across the uint32
    range, including the wrap point."""
    from jax._src import prng as jprng

    rs = np.random.default_rng(seed)
    n = 257
    count = rs.integers(0, 2**32, size=2 * n, dtype=np.int64)
    count[:3] = [0, 1, 2**32 - 1]
    for k0, k1 in ((0, seed & 0xFFFFFFFF), (2**32 - 1, 12345),
                   tuple(rs.integers(0, 2**32, 2))):
        want = np.asarray(jprng.threefry_2x32(
            (np.uint32(k0), np.uint32(k1)),
            jnp.asarray(count.astype(np.uint32)))).astype(np.int64)
        for fn in (trng.threefry2x32, trng.threefry2x32_torch):
            y0, y1 = fn(torch.tensor(int(k0)), torch.tensor(int(k1)),
                        torch.from_numpy(count[:n]),
                        torch.from_numpy(count[n:]))
            assert y0.dtype == y1.dtype == torch.int64
            assert np.array_equal(np.concatenate([y0.numpy(), y1.numpy()]),
                                  want)
