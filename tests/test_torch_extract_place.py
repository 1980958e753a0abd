"""The closed-form placement of ``extract_slots``'s kernel against the JAX
package's window extraction, on the CPU.

The kernel (``shadow_tpu_torch/csrc/extract_slots.cu``) does not sort by
dense slot: every host run of the first sort holds at least Kc rows (its
Kc fillers), so it moves sorted row i straight to ``key * Kc + rank``
(the dense window) or ``H * Kc + i - min(key + 1, H) * Kc`` (the tail),
with the rank found in a block's tile of keys and its halo of the Kc keys
before it. ``place`` below transcribes that in numpy, block by block and
search step by step, together with the first sort of
``engine.window_keys``; each case holds it, and the port's plain version,
to ``shadow_tpu.core.engine._dense_extract`` on the same seeded pool.

Tolerance: exact equality, every column and every row.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_tpu.core import engine as jengine
from shadow_tpu.core import state as jstate
from shadow_tpu_torch import kernels
from shadow_tpu_torch.core import engine as tengine
from shadow_tpu_torch.core import state as tstate

NEVER = np.iinfo(np.int64).max
# the JAX package runs _dense_extract jitted (make_window_step); one
# compile a shape costs less than the ops dispatched one by one
_jax_dense_extract = jax.jit(jengine._dense_extract,
                             static_argnums=(3, 4, 5))
MS = 1_000_000
DT_BITS, DT_MAX = kernels.DT_BITS, kernels.DT_MAX
# the kernel's block of rows, as its source sets it
BLOCK = kernels.csrc_constant("extract_slots.cu", "kBlock")
M32 = 0xFFFFFFFF


def first_sort(cols, ws, we, H, Kc):
    """``engine.window_keys`` in numpy: the sorted k1 keys of the pool rows
    and H·Kc fillers, and the row each sorted position came from."""
    t, d = cols["time"], cols["dst"]
    inwin = (t < we) & (d >= 0) & (d < H)
    run_key = np.where(inwin, d.astype(np.int64), H)
    dt = np.clip(t - ws, 0, DT_MAX)  # no overflow: t - ws stays in int64
    k1 = np.concatenate([(run_key << DT_BITS) | dt,
                         np.repeat((np.arange(H) << DT_BITS) | DT_MAX, Kc)])
    k2 = np.concatenate([(cols["src"].astype(np.int64) << 32)
                         | (cols["seq"].astype(np.int64) & M32),
                         np.zeros(H * Kc, np.int64)])
    p2 = np.argsort(k2, kind="stable")
    p1 = np.argsort(k1[p2], kind="stable")
    return k1[p2][p1], p2[p1]


def place(k1, perm, cols, H, Kc):
    """The kernel's placement: ({column: [N] placed rows}, tail dst)."""
    N, C = k1.shape[0], cols["time"].shape[0]
    HK = H * Kc
    key = k1 >> DT_BITS
    PP = cols["payload"].shape[1]
    o_t = np.empty(N, np.int64)
    o_i32 = {f: np.empty(N, np.int32) for f in ("src", "seq", "kind")}
    o_p = np.empty((N, PP), np.int64)
    o_d = np.empty(C, np.int32)
    for b0 in range(0, N, BLOCK):
        g = np.arange(b0 - Kc, b0 + BLOCK)
        skey = np.where((g >= 0) & (g < N), key[np.clip(g, 0, N - 1)], -1)
        tid = np.arange(min(BLOCK, N - b0))
        i, me = b0 + tid, Kc + tid
        k = skey[me]
        dense = (k < H) & (skey[tid] != k)
        lo, hi = tid + 1, me.copy()
        while (lo < hi).any():
            mid = (lo + hi) >> 1
            less = skey[mid] < k
            lo = np.where((lo < hi) & less, mid + 1, lo)
            hi = np.where((lo < hi) & ~less, mid, hi)
        o = np.where(dense, k * Kc + (me - lo),
                     HK + i - np.minimum(k + 1, H) * Kc)
        r = perm[i]
        pool = r < C
        rc = np.where(pool, r, 0)
        o_t[o] = np.where(pool, cols["time"][rc], NEVER)
        for f, v in o_i32.items():
            v[o] = np.where(pool, cols[f][rc], 0)
        o_p[o] = np.where(pool[:, None], cols["payload"][rc], 0)
        tail = ~dense
        o_d[o[tail] - HK] = np.where(pool, cols["dst"][rc],
                                     (r - C) // Kc)[tail]
    return dict(time=o_t, payload=o_p, **o_i32), o_d


def _pool(rs, C, H, ws, we, PP, case):
    u = rs.random(C)
    span = we - ws
    time = np.where(u < 0.5, ws + rs.integers(0, 6, C) * (span // 6),
                    np.where(u < 0.8, we + rs.integers(0, 3 * span, C),
                             NEVER)).astype(np.int64)
    time[rs.random(C) < 0.05] = ws - rs.integers(1, span, 1)  # dt 0
    dst = rs.integers(0, H, C).astype(np.int32)
    dst[rs.random(C) < 0.15] = rs.choice([-3, -1, H, H + 2])  # not a host
    dst[rs.random(C) < 0.2] = 0  # a hot host, past Kc
    src = rs.integers(0, 4, C).astype(np.int32)
    seq = rs.integers(0, 2**31 - 1, C).astype(np.int32)
    if case == "clamped":  # in-window dt clamped to DT_MAX: ties the
        # fillers' k1; src = seq = 0 ties their k2 as well
        hit = rs.random(C) < 0.3
        time[hit] = ws + DT_MAX + rs.integers(0, 3, hit.sum())
        dst[hit] = rs.integers(0, H, hit.sum())
        src[hit & (rs.random(C) < 0.5)] = 0
        seq[hit & (rs.random(C) < 0.5)] = 0
    elif case == "outside":  # no row extracts
        time = np.where(rs.random(C) < 0.5, we + rs.integers(0, span, C),
                        NEVER)
        time[rs.random(C) < 0.3] = ws
        dst = np.where(time == ws, H + 1, dst).astype(np.int32)
    elif case == "full":  # no free row, every row in the window
        time = ws + rs.integers(0, span, C)
        dst = rs.integers(0, H, C).astype(np.int32)
    return dict(
        time=time.astype(np.int64), dst=dst, src=src, seq=seq,
        kind=rs.integers(0, 4, C).astype(np.int32),
        payload=rs.integers(-2**63, 2**63 - 1, (C, PP), dtype=np.int64),
    )


CASES = {
    "mixed": (0, 700, 20, 5, 1),
    "mixed_wide_payload": (1, 600, 30, 4, 6),
    "clamped": (2, 500, 8, 3, 1),
    "outside": (3, 300, 10, 4, 2),
    "h1_kc1": (4, 200, 1, 1, 1),
    "full": (5, 512, 16, 6, 1),
    "halo_past_a_block": (6, 900, 3, 300, 1),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_placement_matches_jax(case):
    seed, C, H, Kc, PP = CASES[case]
    rs = np.random.default_rng(seed)
    ws = 1_000 * MS
    we = ws + DT_MAX + 8 if case == "clamped" else ws + 50 * MS
    cols = _pool(rs, C, H, ws, we, PP, "mixed" if case.startswith(
        ("mixed", "h1", "halo")) else case)
    k1, perm = first_sort(cols, ws, we, H, Kc)
    placed, tail_dst = place(k1, perm, cols, H, Kc)
    jd, jt = _jax_dense_extract(
        jstate.EventPool(**{k: jnp.asarray(v) for k, v in cols.items()}),
        ws, we, H, Kc, PP,
    )
    HK = H * Kc
    for f in ("time", "src", "seq", "kind"):
        want_d, want_t = np.asarray(getattr(jd, f)), np.asarray(getattr(jt, f))
        assert placed[f].dtype == want_d.dtype
        assert np.array_equal(placed[f][:HK].reshape(H, Kc), want_d), f
        assert np.array_equal(placed[f][HK:], want_t), f
    assert np.array_equal(placed["payload"][:HK].reshape(H, Kc, PP),
                          np.asarray(jd.payload))
    assert np.array_equal(placed["payload"][HK:],
                          np.stack([np.asarray(p) for p in jt.payload], -1))
    assert tail_dst.dtype == np.int32
    assert np.array_equal(tail_dst, np.asarray(jt.dst))

    # the port's plain version, the kernel's yardstick on the card
    td, tt = tengine.dense_extract(
        tstate.EventPool(**{k: torch.from_numpy(v) for k, v in cols.items()}),
        ws, we, H, Kc, kernels.PLAIN_OPS,
    )
    for f in ("time", "src", "seq", "kind", "payload"):
        got = getattr(td, f).reshape(HK, -1).squeeze(-1).numpy()
        assert np.array_equal(got, placed[f][:HK].reshape(got.shape)), f
        assert np.array_equal(getattr(tt, f).numpy(), placed[f][HK:]), f
    assert np.array_equal(tt.dst.numpy(), tail_dst)

    # the case reaches what it is named for
    n_real = (np.asarray(jd.time) != NEVER).sum(axis=1)
    if case == "outside":
        assert n_real.sum() == 0
    elif case == "clamped":
        tie = (k1 & DT_MAX) == DT_MAX
        assert (tie & (perm < C) & ((k1 >> DT_BITS) < H)).any()
    else:
        assert n_real.max() == Kc or case == "halo_past_a_block"
    if case == "full":
        assert (cols["time"] != NEVER).all()
