"""The window's two sorts, on the CPU: the plain versions against the JAX
package, and numpy models of the card's designs against the plain
versions.

* ``window_sort_plain`` (K19's plain version) against
  ``shadow_tpu.core.engine._dense_extract``: the pool rows carry their
  row index in a payload word, so the JAX package's dense window and tail
  name the order its two-key sort left them in; the port places its
  sorted rows with ``extract_slots``' plain version and must leave every
  column and every row the same.
* ``pool_merge_plain`` (K20's) against the sort of the JAX package's
  ``assemble`` (``make_window_step``, the global engine):
  ``jax.lax.sort`` of time, dst, src, seq, kind and the payload words,
  ``num_keys=1, is_stable=True``, its first C rows and the count of
  rows past C whose time is not NEVER; with the matrix path's two blocks
  and the loop path's four (the dense cells with a cursor of consumed
  cells, a dst a host).
* The loop path's merge as the engine builds its blocks: the port's
  ``step_loop`` against the JAX package's own jitted window step, window
  by window from the same state, on a pool kept nearly full so that
  hosts stop part way through their dense cells; the whole state and
  the counters equal after every window.
* ``window_sort_model`` and ``pool_merge_model`` transcribe the kernels
  (``csrc/window_sort.cu``, ``csrc/pool_merge.cu``): digit histograms,
  constant digits skipped, each pass a stable scatter of tiles of
  ``kTile`` rows whose buckets start at the digit's offset plus the
  counts of the tiles before (the look-back); K19's unsorted fillers
  placed by the rows' filler groups and a binary search; K20's NEVER
  rows split off in the first pass and the rows below C written by the
  last.
* ``tournament_walk`` transcribes ``loop_select``'s tournament for an
  inbox wider than its registers hold, against ``kernels.inbox_min``.

Pools hold ties in (dst, time) and in (src, seq), NEVER rows whose other
columns differ, dst outside [0, H), times whose dt clips at DT_MAX (in
and out of the window), and more live rows than the pool holds.

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

NEVER = np.iinfo(np.int64).max
# the JAX package runs _dense_extract jitted (make_window_step); one
# compile a shape costs less than the ops dispatched one by one
_jax_dense_extract = jax.jit(jengine._dense_extract,
                             static_argnums=(3, 4, 5))
MS = 1_000_000
DT_BITS, DT_MAX = kernels.DT_BITS, kernels.DT_MAX
SIGN = np.uint64(1 << 63)
# the kernels' tile of rows, as radix_common.cuh sets it
TILE = (kernels.csrc_constant("radix_common.cuh", "kThreads")
        * kernels.csrc_constant("radix_common.cuh", "kItems"))


def _pool(rs, C, H, ws, we, PP, case="mixed"):
    """Pool columns with every tie the sort must keep in order."""
    span = we - ws
    u = rs.random(C)
    time = np.where(u < 0.45, ws + rs.integers(0, 5, C) * (span // 5),
                    np.where(u < 0.75, we + rs.integers(0, 3 * span, C),
                             NEVER)).astype(np.int64)
    time[rs.random(C) < 0.05] = ws - rs.integers(1, span)  # dt clips at 0
    dst = rs.integers(0, H, C).astype(np.int32)
    dst[rs.random(C) < 0.1] = rs.choice([-4, -1, H, H + 7])  # not a host
    dst[rs.random(C) < 0.2] = 0  # a hot host
    src = rs.integers(-2, 4, C).astype(np.int32)
    seq = rs.integers(-5, 9, C).astype(np.int32)
    seq[rs.random(C) < 0.2] = rs.integers(-2**31, 2**31 - 1)
    if case == "clamped":
        # dt clipped at DT_MAX inside a window wider than 2^44 ns: rows
        # that tie the fillers' k1, before and after them by k2
        hit = rs.random(C) < 0.3
        time[hit] = ws + DT_MAX + rs.integers(0, 3, hit.sum())
        dst[hit] = rs.integers(0, H, hit.sum())
        src[hit & (rs.random(C) < 0.5)] = 0
        seq[hit & (rs.random(C) < 0.5)] = 0
    elif case == "narrow":
        # src and seq in one byte each: most digits the same on every row
        src, seq = src & 3, seq & 7
    payload = rs.integers(-2**63, 2**63 - 1, (C, PP), dtype=np.int64)
    payload[:, 0] = np.arange(C)  # the row, to follow it through the sort
    return dict(time=time, dst=dst, src=src, seq=seq,
                kind=rs.integers(0, 4, C).astype(np.int32), payload=payload)


SORT_CASES = {  # seed, C, H, Kc, PP, pool case
    "mixed": (0, 3000, 24, 5, 2, "mixed"),
    "clamped": (1, 2500, 9, 3, 1, "clamped"),
    "narrow": (2, 4500, 40, 4, 1, "narrow"),
    "one_host": (3, 300, 1, 1, 1, "mixed"),
}


def _window(case):
    ws = 1_000 * MS
    return ws, (ws + DT_MAX + 8 if case == "clamped" else ws + 50 * MS)


# against the JAX package: the cases whose orders differ in kind (each
# shape compiles the JAX extraction once); the models take all four
@pytest.mark.parametrize("case", ["clamped", "mixed"])
def test_window_sort_plain_matches_jax(case):
    seed, C, H, Kc, PP, kind = SORT_CASES[case]
    rs = np.random.default_rng(seed)
    ws, we = _window(case)
    cols = _pool(rs, C, H, ws, we, PP, kind)
    jd, jt = _jax_dense_extract(
        jstate.EventPool(**{k: jnp.asarray(v) for k, v in cols.items()}),
        ws, we, H, Kc, PP)
    t = {k: torch.from_numpy(v) for k, v in cols.items()}
    s_k1, perm = kernels.window_sort_plain(t["time"], t["dst"], t["src"],
                                           t["seq"], ws, we, H, Kc)
    assert bool((s_k1[1:] >= s_k1[:-1]).all())
    assert torch.equal(torch.sort(perm).values, torch.arange(C + H * Kc))
    pd, pt = kernels.extract_slots_plain(s_k1, perm, t["time"], t["dst"],
                                         t["src"], t["seq"], t["kind"],
                                         t["payload"], H, Kc)
    for f in ("time", "src", "seq", "kind", "payload"):
        want = np.asarray(getattr(jd, f))
        assert np.array_equal(getattr(pd, f).numpy(), want), f
    for f in ("time", "dst", "src", "seq", "kind"):
        assert np.array_equal(getattr(pt, f).numpy(),
                              np.asarray(getattr(jt, f))), f
    assert np.array_equal(pt.payload.numpy(),
                          np.stack([np.asarray(p) for p in jt.payload], -1))
    # the empty rows' order, which the next pool keeps, is the JAX one
    never = pt.time.numpy() == NEVER
    assert never.sum() > 1 and len(set(pt.src.numpy()[never])) > 1


def _blocks(rs, C, H, PP, four: bool):
    """The merge's candidate blocks as numpy columns (dst one a host where
    given so), with more live rows than C."""
    def block(n, per_host=False, cut=False, never=0.4):
        t = rs.integers(0, 40, n).astype(np.int64) * MS
        t[rs.random(n) < never] = NEVER
        b = dict(time=t,
                 dst=rs.integers(-1, H + 1, H if per_host else n
                                 ).astype(np.int32),
                 src=rs.integers(0, H, n).astype(np.int32),
                 seq=rs.integers(0, 5, n).astype(np.int32),
                 kind=rs.integers(0, 3, n).astype(np.int32),
                 payload=rs.integers(-2**63, 2**63 - 1, (n, PP),
                                     dtype=np.int64),
                 cut=None)
        if cut:
            b["cut"] = rs.integers(0, n // H + 1, H).astype(np.int32)
        return b
    if four:  # leftover, tail, outbox, inbox
        return [block(H * 6, per_host=True, cut=True), block(C, never=0.05),
                block(H * 8), block(H * 3, per_host=True, never=0.7)]
    return [block(C, never=0.1), block(H * 9, never=0.2)]


def _rows(b):
    """A numpy block's rows as the merge sees them."""
    n = b["time"].shape[0]
    t, d = b["time"].copy(), b["dst"]
    if b["cut"] is not None:
        w = n // b["cut"].shape[0]
        t.reshape(-1, w)[np.arange(w)[None, :] < b["cut"][:, None]] = NEVER
    if d.shape[0] != n:
        d = np.repeat(d, n // d.shape[0])
    return dict(time=t, dst=d, src=b["src"], seq=b["seq"], kind=b["kind"],
                payload=b["payload"])


def _torch_blocks(blocks):
    return [kernels.MergeBlock(**{k: None if v is None else
                                  torch.from_numpy(v) for k, v in b.items()})
            for b in blocks]


MERGE_CASES = {  # seed, C, H, PP, four blocks
    "matrix": (0, 2500, 64, 2, False),
    "loop": (1, 2000, 50, 1, True),
    "loop_wide_payload": (2, 1500, 40, 6, True),
}


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_pool_merge_plain_matches_jax(case):
    seed, C, H, PP, four = MERGE_CASES[case]
    rs = np.random.default_rng(seed)
    blocks = _blocks(rs, C, H, PP, four)
    rows = [_rows(b) for b in blocks]
    cat = {k: np.concatenate([r[k] for r in rows]) for k in rows[0]}
    # assemble's sort (shadow_tpu/core/engine.py, make_window_step)
    ops = jax.lax.sort(
        [jnp.asarray(cat[k]) for k in ("time", "dst", "src", "seq", "kind")]
        + [jnp.asarray(cat["payload"][:, w]) for w in range(PP)],
        num_keys=1, is_stable=True)
    M = cat["time"].shape[0]
    # C: live rows dropped past it; M: every row kept, the NEVER ones last
    for cap in (C, M):
        dropped = int(jnp.sum(ops[0][cap:] != NEVER, dtype=jnp.int64))
        got = kernels.pool_merge_plain(_torch_blocks(blocks), cap)
        for i, f in enumerate(("time", "dst", "src", "seq", "kind")):
            assert np.array_equal(getattr(got, f).numpy(),
                                  np.asarray(ops[i][:cap])), f
        assert np.array_equal(got.payload.numpy(), np.stack(
            [np.asarray(o[:cap]) for o in ops[5:]], -1))
        assert int(got.dropped) == dropped
        assert (dropped > 0) == (cap == C)
    never = got.time.numpy() == NEVER
    assert len(set(got.src.numpy()[never])) > 1


# ---------------------------------------------------------------------------
# numpy models of the card's designs
# ---------------------------------------------------------------------------


def radix_pass(buckets, nb):
    """Each row's place after one pass: the digit's offset (the exclusive
    scan of its histogram) plus the bucket's count in the tiles before
    (the look-back) plus the row's stable rank in its tile."""
    n = buckets.shape[0]
    hist = np.bincount(buckets, minlength=nb)
    offset = np.cumsum(hist) - hist
    before = np.zeros(nb, np.int64)
    dest = np.empty(n, np.int64)
    for t0 in range(0, n, TILE):
        b = buckets[t0:t0 + TILE]
        cnt = np.bincount(b, minlength=nb)
        order = np.argsort(b, kind="stable")
        rank = np.empty(b.shape[0], np.int64)
        rank[order] = np.arange(b.shape[0]) - (np.cumsum(cnt) - cnt)[b[order]]
        dest[t0:t0 + TILE] = offset[b] + before[b] + rank
        before += cnt
    assert np.array_equal(np.sort(dest), np.arange(n))
    return dest


def _scatter(order, dest):
    out = np.empty_like(order)
    out[dest] = order
    return out


def _digit(word, d):
    return ((word >> np.uint64(8 * d)) & np.uint64(0xFF)).astype(np.int64)


def window_sort_model(time, dst, src, seq, ws, we, H, Kc):
    """K19: (s_k1, perm, the digits skipped, whether a row sorts after its
    host's fillers)."""
    C = time.shape[0]
    inwin = (time < we) & (dst >= 0) & (dst < H)
    run_key = np.where(inwin, dst, H).astype(np.uint64)
    with np.errstate(over="ignore"):
        dt = np.clip(time - np.int64(ws), 0, DT_MAX).astype(np.uint64)
    hi = (run_key << np.uint64(DT_BITS)) | dt
    lo = ((src.astype(np.int64).astype(np.uint64) << np.uint64(32))
          | seq.astype(np.uint32).astype(np.uint64)) ^ SIGN
    words = [lo] * 8 + [hi] * 8
    skipped, order = [], np.arange(C)
    for d in range(16):
        if (np.bincount(_digit(words[d], d % 8), minlength=256) == C).any():
            skipped.append(d)  # its pass returns at once
            continue
        order = _scatter(order, radix_pass(_digit(words[d][order], d % 8),
                                           256))
    h_s, l_s = hi[order], lo[order]
    key = (h_s >> np.uint64(DT_BITS)).astype(np.int64)
    after = (key < H) & ((h_s & np.uint64(DT_MAX)) == DT_MAX) & (l_s > SIGN)
    g = np.where(key < H, key + after, H)
    assert (np.diff(g) >= 0).all()
    N = C + H * Kc
    s_k1 = np.empty(N, np.int64)
    perm = np.empty(N, np.int64)
    out = np.arange(C) + Kc * g
    s_k1[out], perm[out] = h_s.astype(np.int64), order
    # filler j of host h: the first place whose row has g > h, by the
    # kernel's binary search, then h * Kc + j
    f = np.arange(H * Kc)
    h = f // Kc
    first = np.searchsorted(g, np.arange(H), side="right")
    s_k1[first[h] + f] = (h << DT_BITS) | DT_MAX
    perm[first[h] + f] = C + f
    return s_k1, perm, skipped, bool(after.any())


@pytest.mark.parametrize("case", sorted(SORT_CASES))
def test_window_sort_design_matches_plain(case):
    seed, C, H, Kc, PP, kind = SORT_CASES[case]
    rs = np.random.default_rng(100 + seed)
    ws, we = _window(case)
    cols = _pool(rs, C, H, ws, we, PP, kind)
    s_k1, perm, skipped, after = window_sort_model(
        cols["time"], cols["dst"], cols["src"], cols["seq"], ws, we, H, Kc)
    want = kernels.window_sort_plain(
        *(torch.from_numpy(cols[k]) for k in ("time", "dst", "src", "seq")),
        ws, we, H, Kc)
    assert np.array_equal(s_k1, want[0].numpy())
    assert np.array_equal(perm, want[1].numpy())
    # what each case is for
    assert C > TILE or case == "one_host"
    assert after == (case == "clamped")
    if case == "narrow":  # seq's bytes 1-3, src's 1-3 and run_key's top
        assert len(skipped) >= 6, skipped
    assert len(skipped) < 16


def pool_merge_model(blocks, C):
    """K20: (the next pool's columns, dropped, the passes skipped)."""
    rows = [_rows(b) for b in blocks]
    cat = {k: np.concatenate([r[k] for r in rows]) for k in rows[0]}
    t = cat["time"]
    fin = t != NEVER
    F = int(fin.sum())
    key = t.astype(np.uint64) ^ SIGN
    # pass 0 splits off the NEVER rows (bucket 256), in row order
    order = _scatter(np.arange(t.shape[0]), radix_pass(
        np.where(fin, _digit(key, 0), 256), 257))
    assert (~fin[order[F:]]).all()
    skipped = []
    for d in range(1, 8):
        if d < 7 and (np.bincount(_digit(key[fin], d), minlength=256)
                      == F).any():
            skipped.append(d)
            continue
        order[:F] = _scatter(order[:F], radix_pass(_digit(key[order[:F]], d),
                                                   256))
    keep = order[:C]
    out = {k: v[keep] for k, v in cat.items()}
    return out, max(F - C, 0), skipped


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_pool_merge_design_matches_plain(case):
    seed, C, H, PP, four = MERGE_CASES[case]
    rs = np.random.default_rng(200 + seed)
    blocks = _blocks(rs, C, H, PP, four)
    M = sum(b["time"].shape[0] for b in blocks)
    for cap in (C, M):
        out, dropped, skipped = pool_merge_model(blocks, cap)
        want = kernels.pool_merge_plain(_torch_blocks(blocks), cap)
        for f, v in out.items():
            assert np.array_equal(v, getattr(want, f).numpy()), f
        assert dropped == int(want.dropped)
        assert (dropped > 0) == (cap == C)
    # times below 2^32 ns: the top digits but the last are skipped
    assert skipped == [4, 5, 6]


def _lt(a, b):
    return a[:3] < b[:3]


def tournament_walk(t, s, q):
    """``loop_select``'s tournament over one host's slots for an inbox
    wider than its registers hold (``tournament_wide``): the tree of
    rounds walked depth first, each pending first value on a stack."""
    N = [len(t)]
    while N[-1] > 1:
        N.append((N[-1] + 1) // 2)
    stack, p, r = [], 0, len(N) - 1
    while True:
        while r > 0:
            stack.append([p, r, False, None])
            r -= 1
        cur = (t[p], s[p], q[p], p)
        while True:
            if not stack:
                return cur
            top = stack[-1]
            if not top[2]:
                second = top[0] + N[top[1]]
                if second < N[top[1] - 1]:
                    top[2], top[3] = True, cur
                    p, r = second, top[1] - 1
                    break
                if _lt((NEVER, 0, 0), cur):  # the pad
                    cur = (NEVER, 0, 0, 0)
            elif not _lt(cur, top[3]):
                cur = top[3]
            stack.pop()


@pytest.mark.parametrize("B", [1, 2, 3, 33, 64, 100])
def test_wide_inbox_tournament_matches_inbox_min(B):
    rs = np.random.default_rng(B)
    H = 40
    t = np.where(rs.random((H, B)) < 0.5, NEVER,
                 rs.integers(0, 3, (H, B)) * MS).astype(np.int64)
    t[:4] = NEVER  # all empty: the stale src and seq, and the pad, decide
    s = rs.integers(0, 3, (H, B)).astype(np.int32)
    q = rs.integers(0, 3, (H, B)).astype(np.int32)
    want = kernels.inbox_min(*(torch.from_numpy(x) for x in (t, s, q)))
    for h in range(H):
        got = tournament_walk(list(t[h]), list(s[h]), list(q[h]))
        assert got == tuple(int(w[h]) for w in want), h


# ---------------------------------------------------------------------------
# the loop path's merge through the JAX package's own window step
# ---------------------------------------------------------------------------


def _filling_handlers(H, xp, kinds):
    """A timer emits a message to the next host past the window and a
    timer of its own inside it; a message emits nothing. Each host keeps
    about 60 / 7 messages in flight, so a small pool fills and the
    pool-headroom gate stalls hosts part way through their dense cells.
    ``xp`` is jnp or torch; ``kinds`` the message's and the timer's."""
    hosts = xp.arange(H, dtype=xp.int32)

    def on_timer(state, ev, emitter, params):
        emitter.emit(ev.mask, ev.time + 60 * MS, (hosts + 1) % H,
                     kinds[0], ev.payload)
        emitter.emit(ev.mask, ev.time + 7 * MS, hosts, kinds[1],
                     ev.payload)
        return state

    def on_msg(state, ev, emitter, params):
        return state

    return on_timer, on_msg


def test_loop_finish_matches_jax_window_step():
    """The loop path's merge, four blocks (each host's dense cells behind
    its cursor, a dst a host; the tail; the outbox; the inbox, a dst a
    host), through the port's ``step_loop`` and the JAX package's jitted
    window step (``make_window_step``, as ``run_stepwise`` calls it),
    window by window from the same state: the whole state (the next pool
    with its empty rows' columns) and the counters (``pool_overflow_
    dropped`` among them) equal after every window."""
    from shadow_tpu.core.engine import Simulation as JaxSimulation
    from shadow_tpu.core.state import KIND_APP_MSG as J_MSG
    from shadow_tpu.core.state import KIND_APP_TIMER as J_TIMER
    from shadow_tpu.core.state import NetParams as JaxNetParams
    from shadow_tpu_torch import interop
    from shadow_tpu_torch.core.engine import Simulation
    from shadow_tpu_torch.core.state import KIND_APP_MSG, KIND_APP_TIMER
    from shadow_tpu_torch.core.state import NetParams
    from test_torch_phold import assert_states_equal, jax_state_to_numpy

    H, LAT, STOP = 6, 50 * MS, 600 * MS
    kw = dict(num_hosts=H, host_vertex=np.zeros(H, np.int32), seed=5,
              stop_time=STOP, runahead=LAT, event_capacity=64, K=4, B=2,
              O=3)
    initial = [((1 + h % 3) * MS, h, h, J_TIMER, []) for h in range(H)]
    jt, jm = _filling_handlers(H, jnp, (J_MSG, J_TIMER))
    jsim = JaxSimulation(
        handlers={J_TIMER: jt, J_MSG: jm},
        params=JaxNetParams(
            latency_vv=jnp.full((1, 1), LAT, dtype=jnp.int64),
            reliability_vv=jnp.ones((1, 1), dtype=jnp.float32),
            bootstrap_end=jnp.int64(0)),
        initial_events=initial, **kw)
    blocks = []

    def merge_spy(bl, capacity):
        blocks.append(bl)
        return kernels.pool_merge(bl, capacity)

    pt, pm = _filling_handlers(H, torch, (KIND_APP_MSG, KIND_APP_TIMER))
    port = Simulation(
        handlers={KIND_APP_TIMER: pt, KIND_APP_MSG: pm},
        params=NetParams(
            latency_vv=torch.full((1, 1), LAT, dtype=torch.int64),
            reliability_vv=torch.ones((1, 1), dtype=torch.float32),
            bootstrap_end=0),
        initial_events=initial, device="cpu",
        ops=kernels.KERNEL_OPS._replace(pool_merge=merge_spy), **kw)
    paths = interop.state_paths(port.state)
    assert_states_equal(interop.state_to_numpy(port.state),
                        jax_state_to_numpy(jsim.state, paths))
    windows = 0
    with torch.inference_mode():
        while True:
            f = port._frontier(STOP)
            if f.mn >= STOP:
                break
            ws, we = f.mn, min(f.mn + LAT, STOP)
            port.window_step(ws, we, f)
            jsim.state, _ = jsim._step(jsim.state, jsim.params, ws, we)
            windows += 1
            assert_states_equal(interop.state_to_numpy(port.state),
                                jax_state_to_numpy(jsim.state, paths))
            assert port.counters() == jsim.counters(), windows
    assert windows > 5 and len(blocks) == windows
    # what the run is for: every merge took four blocks, some host was cut
    # part way through its dense cells, and the pool filled with live rows
    assert all(len(b) == 4 and b[0].cut is not None for b in blocks)
    assert any(((b[0].cut > 0) & (b[0].cut < kw["K"])).any()
               for b in blocks)
    live = int((port.state.pool.time != NEVER).sum())
    assert live > kw["event_capacity"] // 2
