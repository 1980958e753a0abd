// K24 island_route: the islands engine's merge, the bounded exchange of
// cross-shard rows and each shard's next pool.
//
// Replaces shadow_tpu/core/engine.py:_island_route (283-386) under
// jax.vmap over S shards on one card, where the all_to_all is a
// transpose: per shard s, the window's M candidate rows (the tail, then
// the emissions of the shard's Hl hosts), each with
//   group = dst's shard (clip(dst / Hl, 0, S - 1)) where the row is real
//           (time != NEVER) and that shard is not s, else S
//   dt    = clip(time - win_start, 0, DT_MAX)       (44 bits)
// and X filler rows a group (time NEVER, every other column 0). The JAX
// function sorts them stably by (group, dt), sends the first X rows of
// each foreign group g (rank < X) to shard g, where they land at place
// s*X + rank of its pool's last S*X rows, and sorts the rest stably by
// dt: the remainder, ordered by (dt, group, input index) with the
// fillers after a group's real rows. The next pool is the remainder's
// first C_keep = C - S*X rows, then the S*X received rows. Counts per
// shard: sent (real rows sent), dropped (real rows of the remainder past
// C_keep), deferred (real foreign rows of the remainder below C_keep)
// and deferred_min (their earliest time, NEVER if none).
//
// The output is fixed without sorting the fillers or the rows of the
// largest key (dt = DT_MAX, group S: the NEVER rows, and real local rows
// 2^44 ns away), B below:
// * F, every other candidate, is sorted by (dt, group); restricted to one
//   group this is (dt, index), the first sort's order within the group,
//   so a row's rank in its group is its count of earlier same-group rows
//   in F's order. Group g holds n_g rows of F: min(n_g, X) are sent,
//   then X - min(n_g, X) fillers; min(n_g, X) fillers stay.
// * The remainder is F's unsent rows in F's order, with group g's staying
//   fillers after its unsent rows at dt = DT_MAX, then B in input order.
//   The fillers that stay are as many as the real rows sent, so B starts
//   at place |F|.
//
// Bound: bytes. The least is each candidate's time and dst read once,
// the moved rows' other columns read once, and the S*C cells of the next
// pool written once (chip_smoke's kernel_bound). Design, for a kernel
// that is right first: one block a shard (route_rank_kernel) compacts F
// in input order, radix-sorts it by (dt << gbits | group) with 8-bit
// digits in device memory, tile after tile (radix_common.cuh's warp
// rank; a digit with one value on every row of F keeps its order and
// skips its pass), ranks each row in its group in one more sweep, and
// writes for every cell of every shard's next pool the candidate it
// takes (or -1: a zero row at time NEVER); route_write_kernel, one thread
// a cell over the whole card, then copies the rows: a call is two device
// launches (the first writes every cell's source, so nothing is cleared
// before it).

#include <cuda_runtime.h>

#include "radix_common.cuh"

namespace {

using radix::kItems;
using radix::kRadix;
using radix::kThreads;
using radix::kTile;
using radix::kWarps;
using u64 = unsigned long long;

constexpr int kDtBits = 44;
constexpr long long kDtMax = (1LL << kDtBits) - 1;
constexpr long long kNever = 0x7FFFFFFFFFFFFFFFLL;
constexpr int kMaxShards = kRadix - 1;  // groups 0..S in one digit
constexpr int kMaxDigits = 8;
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Block {  // one block of candidates: [S, n] rows
  const long long* t;
  const int* d;
  const int* s;
  const int* q;
  const int* k;
  const long long* p;
  long long n;  // rows a shard
};

struct Args {
  Block tail, em;
  int S, X, Hl, PP, gbits, digits;
  long long M, C, C_keep, win_start;
  long long* o_t;
  int* o_d;
  int* o_s;
  int* o_q;
  int* o_k;
  long long* o_p;
  long long* stats;  // [S][4]: dropped, sent, deferred, deferred_min
  long long* src;    // [S * C]: the candidate s*M + i a cell takes, or -1
  u64* key[2];       // [S * M] each: F's keys, a shard's M at s*M
  unsigned* val[2];  // F's candidate indices
};

// candidate i of shard sh: whether it is an emission row, and its row in
// its block
__device__ __forceinline__ bool locate(const Args& a, long long i, int sh,
                                       long long& row) {
  if (i < a.tail.n) {
    row = (long long)sh * a.tail.n + i;
    return false;
  }
  row = (long long)sh * a.em.n + (i - a.tail.n);
  return true;
}

struct Cand {
  long long t;
  int group;
  long long dt;
  bool in_b;  // the largest key: dt = DT_MAX and group S
};

__device__ __forceinline__ Cand classify(const Args& a, int sh,
                                         long long i) {
  long long row;
  const bool em = locate(a, i, sh, row);
  Cand c;
  c.t = (em ? a.em.t : a.tail.t)[row];
  const bool real = c.t != kNever;
  // dst's shard: the JAX function's int32 `//` then clip (C's division
  // truncates, but any negative dst clips to shard 0 either way)
  int ds = (em ? a.em.d : a.tail.d)[row] / a.Hl;
  ds = ds < 0 ? 0 : (ds > a.S - 1 ? a.S - 1 : ds);
  c.group = real && ds != sh ? ds : a.S;
  // time - win_start wraps as int64 arithmetic does, then clips
  long long dt = (long long)((u64)c.t - (u64)a.win_start);
  c.dt = dt < 0 ? 0 : (dt > kDtMax ? kDtMax : dt);
  c.in_b = c.group == a.S && c.dt == kDtMax;
  return c;
}

__device__ __forceinline__ long long time_of(const Args& a, int sh,
                                             long long i) {
  long long row;
  return (locate(a, i, sh, row) ? a.em.t : a.tail.t)[row];
}

// The tile's flagged rows counted in tile order (warp, round, lane):
// pos[r] the row's index among them, the return value their number.
// wsum holds kWarps words.
__device__ __forceinline__ unsigned tile_prefix(const bool (&f)[kItems],
                                                unsigned (&pos)[kItems],
                                                unsigned* wsum) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  unsigned run = 0;
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const unsigned b = __ballot_sync(kFull, f[r]);
    pos[r] = run + __popc(b & below);
    run += __popc(b);
  }
  if (lane == 0) wsum[w] = run;
  __syncthreads();
  unsigned before = 0, total = 0;
  for (int j = 0; j < kWarps; ++j) {
    if (j < w) before += wsum[j];
    total += wsum[j];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kItems; ++r) pos[r] += before;
  return total;
}

// The row of round r of a tile starting at t0 (radix::tile_row's layout).
__device__ __forceinline__ long long row_at(long long t0, int r) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return t0 + (long long)w * 32 * kItems + r * 32 + lane;
}

// After radix::warp_rank: each bucket's warp offsets in the tile, and
// base[b] = run[b] (the rows of bucket b before the tile), run[b] then
// advanced by the tile's count.
__device__ __forceinline__ void tile_buckets(radix::TileShared<kRadix>& sh,
                                             unsigned* run) {
  __syncthreads();
  const int b = threadIdx.x;  // kThreads == kRadix
  unsigned tot = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const unsigned c = sh.wc[w][b];
    sh.wc[w][b] = tot;
    tot += c;
  }
  sh.base[b] = run[b];
  run[b] += tot;
  __syncthreads();
}

__device__ __forceinline__ void zero_wc(radix::TileShared<kRadix>& sh) {
  for (int i = threadIdx.x; i < kWarps * kRadix; i += kThreads)
    (&sh.wc[0][0])[i] = 0;
  __syncthreads();
}

__device__ __forceinline__ int digit_of(u64 key, int d) {
  return (int)((key >> (8 * d)) & 0xFF);
}

// one block a shard
__global__ void __launch_bounds__(kThreads) route_rank_kernel(Args a) {
  const int sh = blockIdx.x;
  const int S = a.S, X = a.X;
  const long long M = a.M, C = a.C, C_keep = a.C_keep;
  const long long ref0 = (long long)sh * M;
  __shared__ radix::TileShared<kRadix> ts;
  __shared__ unsigned hist[kMaxDigits][kRadix];
  __shared__ unsigned run[kRadix];
  __shared__ unsigned ngrp[kRadix];   // n_g: F's rows of group g
  __shared__ unsigned udmax[kRadix];  // unsent rows of F at dt = DT_MAX
  __shared__ unsigned ucum[kRadix];   // staying fillers of groups < g
  __shared__ unsigned wsum[kWarps];
  __shared__ unsigned long long n_sent, n_def, n_drop;
  __shared__ long long dmin;
  __shared__ int varies[kMaxDigits];
  for (int i = threadIdx.x; i < kMaxDigits * kRadix; i += kThreads)
    (&hist[0][0])[i] = 0;
  ngrp[threadIdx.x] = 0;
  udmax[threadIdx.x] = 0;
  if (threadIdx.x == 0) {
    n_sent = n_def = n_drop = 0;
    dmin = kNever;
  }
  __syncthreads();
  u64* key0 = a.key[0] + ref0;
  unsigned* val0 = a.val[0] + ref0;

  // 1. F in input order, its digits counted, n_g
  unsigned nF = 0;  // in every thread
  for (long long t0 = 0; t0 < M; t0 += kTile) {
    bool f[kItems];
    u64 k[kItems];
    unsigned pos[kItems];
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      const long long i = row_at(t0, r);
      f[r] = false;
      k[r] = 0;
      if (i < M) {
        const Cand c = classify(a, sh, i);
        f[r] = !c.in_b;
        k[r] = ((u64)c.dt << a.gbits) | (u64)c.group;
        if (f[r] && c.group < S) atomicAdd(&ngrp[c.group], 1u);
      }
#pragma unroll
      for (int d = 0; d < kMaxDigits; ++d)
        if (d < a.digits) radix::warp_count(hist[d], f[r] ? digit_of(k[r], d)
                                                          : -1);
    }
    const unsigned tot = tile_prefix(f, pos, wsum);
#pragma unroll
    for (int r = 0; r < kItems; ++r)
      if (f[r]) {
        key0[nF + pos[r]] = k[r];
        val0[nF + pos[r]] = (unsigned)row_at(t0, r);
      }
    nF += tot;
  }
  __syncthreads();
  for (int d = 0; d < a.digits; ++d) {
    const int same = __syncthreads_or(hist[d][threadIdx.x] == nF);
    if (threadIdx.x == 0) varies[d] = !same;
  }
  __syncthreads();

  // 2. F sorted by key, one stable pass a varying digit, least first
  int cur = 0;
  for (int d = 0; d < a.digits; ++d) {
    if (!varies[d]) continue;
    // the pass's bucket offsets
    run[threadIdx.x] = radix::block_excl_scan(hist[d][threadIdx.x], wsum);
    __syncthreads();
    const u64* ki = a.key[cur] + ref0;
    const unsigned* vi = a.val[cur] + ref0;
    u64* ko = a.key[cur ^ 1] + ref0;
    unsigned* vo = a.val[cur ^ 1] + ref0;
    for (long long t0 = 0; t0 < nF; t0 += kTile) {
      zero_wc(ts);
      u64 k[kItems];
      unsigned v[kItems], rank[kItems];
      int bucket[kItems];
#pragma unroll
      for (int r = 0; r < kItems; ++r) {
        const long long i = row_at(t0, r);
        bucket[r] = -1;
        if (i < nF) {
          k[r] = ki[i];
          v[r] = vi[i];
          bucket[r] = digit_of(k[r], d);
        }
      }
      radix::warp_rank(ts, bucket, rank);
      tile_buckets(ts, run);
      const int w = threadIdx.x >> 5;
#pragma unroll
      for (int r = 0; r < kItems; ++r) {
        const int b = bucket[r];
        if (b < 0) continue;
        const long long q = (long long)ts.base[b] + ts.wc[w][b] + rank[r];
        ko[q] = k[r];
        vo[q] = v[r];
      }
      __syncthreads();
    }
    cur ^= 1;
  }

  // staying fillers of the groups before each group
  if (threadIdx.x == 0) {
    unsigned c = 0;
    for (int g = 0; g <= S; ++g) {
      ucum[g] = c;
      if (g < S) c += min(ngrp[g], (unsigned)X);
    }
  }
  run[threadIdx.x] = 0;  // now each group's rows so far
  __syncthreads();

  // 3. each row of F in order: its rank in its group, sent or where it
  // stays
  const u64 gmask = (1ULL << a.gbits) - 1;
  const u64* ks = a.key[cur] + ref0;
  const unsigned* vs = a.val[cur] + ref0;
  unsigned unsent = 0;  // F's unsent rows before the tile, every thread
  for (long long t0 = 0; t0 < nF; t0 += kTile) {
    zero_wc(ts);
    int bucket[kItems];
    unsigned rank[kItems], pos[kItems];
    bool stay[kItems];
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      const long long i = row_at(t0, r);
      bucket[r] = i < nF ? (int)(ks[i] & gmask) : -1;
    }
    radix::warp_rank(ts, bucket, rank);
    tile_buckets(ts, run);
    const int w = threadIdx.x >> 5;
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      const int g = bucket[r];
      if (g >= 0) rank[r] += ts.base[g] + ts.wc[w][g];
      stay[r] = g >= 0 && !(g < S && rank[r] < (unsigned)X);
    }
    const unsigned tot = tile_prefix(stay, pos, wsum);
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      const int g = bucket[r];
      if (g < 0) continue;
      const long long i = row_at(t0, r);
      const unsigned cand = vs[i];
      const long long ref = ref0 + cand;
      if (!stay[r]) {  // sent: to group g's pool, after the rows from
                       // the shards before this one
        a.src[(long long)g * C + C_keep + (long long)sh * X + rank[r]] = ref;
        atomicAdd(&n_sent, 1ull);
        continue;
      }
      const bool far = (long long)(ks[i] >> a.gbits) == kDtMax;
      if (far) atomicAdd(&udmax[g], 1u);
      const long long p = (long long)unsent + pos[r] + (far ? ucum[g] : 0);
      const long long t = time_of(a, sh, cand);
      if (p < C_keep) {
        a.src[(long long)sh * C + p] = ref;
        if (g < S) {  // a real foreign row: deferred
          atomicAdd(&n_def, 1ull);
          atomicMin(&dmin, t);
        }
      } else if (t != kNever) {
        atomicAdd(&n_drop, 1ull);
      }
    }
    unsent += tot;
  }
  __syncthreads();

  // 4. the fillers: group g's sent ones to shard g, the staying ones
  // after g's unsent rows at DT_MAX
  unsigned far_all = 0;
  for (int g = 0; g < S; ++g) far_all += udmax[g];
  const long long near_unsent = (long long)unsent - far_all;
  unsigned far_le = 0;
  for (int g = 0; g < S; ++g) {
    far_le += udmax[g];
    const int n = (int)ngrp[g];
    const int stay = n < X ? n : X;
    const long long start = near_unsent + far_le + ucum[g];
    for (int j = threadIdx.x; j < X; j += kThreads) {
      if (j < X - stay)
        a.src[(long long)g * C + C_keep + (long long)sh * X + stay + j] = -1;
      if (j < stay && start + j < C_keep)
        a.src[(long long)sh * C + start + j] = -1;
    }
  }

  // 5. B after F's places, in input order
  unsigned nb = 0;
  for (long long t0 = 0; t0 < M; t0 += kTile) {
    bool f[kItems];
    unsigned pos[kItems];
    long long tt[kItems];
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      const long long i = row_at(t0, r);
      f[r] = false;
      if (i < M) {
        const Cand c = classify(a, sh, i);
        f[r] = c.in_b;
        tt[r] = c.t;
      }
    }
    const unsigned tot = tile_prefix(f, pos, wsum);
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      if (!f[r]) continue;
      const long long p = (long long)nF + nb + pos[r];
      if (p < C_keep)
        a.src[(long long)sh * C + p] = ref0 + row_at(t0, r);
      else if (tt[r] != kNever)
        atomicAdd(&n_drop, 1ull);
    }
    nb += tot;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    long long* st = a.stats + 4LL * sh;
    st[0] = (long long)n_drop;
    st[1] = (long long)n_sent;
    st[2] = (long long)n_def;
    st[3] = dmin;
  }
}

// one thread a cell of the next pools: the row its candidate holds
__global__ void __launch_bounds__(kThreads) route_write_kernel(Args a) {
  const long long cell = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long n = (long long)a.S * a.C;
  long long ref = -1, row = 0;
  bool em = false;
  if (cell < n) {
    ref = a.src[cell];
    if (ref >= 0) {
      const int s = (int)(ref / a.M);
      em = locate(a, ref - (long long)s * a.M, s, row);
      a.o_t[cell] = (em ? a.em.t : a.tail.t)[row];
      a.o_d[cell] = (em ? a.em.d : a.tail.d)[row];
      a.o_s[cell] = (em ? a.em.s : a.tail.s)[row];
      a.o_q[cell] = (em ? a.em.q : a.tail.q)[row];
      a.o_k[cell] = (em ? a.em.k : a.tail.k)[row];
    } else {
      a.o_t[cell] = kNever;
      a.o_d[cell] = 0;
      a.o_s[cell] = 0;
      a.o_q[cell] = 0;
      a.o_k[cell] = 0;
    }
  }
  // the payload words, a warp's 32 rows together: lane j copies word
  // j % PP of row j / PP (its cell, block and row by shuffle)
  for (int j = threadIdx.x & 31; j < 32 * a.PP; j += 32) {
    const int r = j / a.PP, w = j - r * a.PP;
    const long long c = __shfl_sync(kFull, cell, r);
    const long long rr = __shfl_sync(kFull, ref, r);
    const long long rw = __shfl_sync(kFull, row, r);
    const bool re = __shfl_sync(kFull, (int)em, r) != 0;
    if (c >= n) continue;
    a.o_p[c * a.PP + w] = rr >= 0 ? (re ? a.em.p : a.tail.p)[rw * a.PP + w]
                                  : 0;
  }
}

struct Layout {
  long long src, key, val, end;
};

Layout layout(long long S, long long M, long long C) {
  Layout L;
  L.src = 0;
  L.key = L.src + 8 * S * C;
  L.val = L.key + 16 * S * M;
  L.end = (L.val + 8 * S * M + 7) & ~7LL;
  return L;
}

}  // namespace

// the scratch bytes of a call: S shards, M candidates and C pool rows a
// shard (kernels.island_route allocates them)
extern "C" long long island_route_scratch(long long S, long long M,
                                          long long C) {
  return layout(S, M, C).end;
}

// a: S, X, Hl, PP, C, win_start; the tail block's rows a shard, time,
// dst, src, seq, kind, payload; the emission block's likewise; the
// outputs time, dst, src, seq, kind, payload and stats; scratch and its
// bytes (kernels.island_route packs them in this order)
extern "C" int island_route(const long long* a, void* stream) {
  Args k{};
  k.S = (int)a[0];
  k.X = (int)a[1];
  k.Hl = (int)a[2];
  k.PP = (int)a[3];
  k.C = a[4];
  k.win_start = a[5];
  Block* blocks[2] = {&k.tail, &k.em};
  for (int b = 0; b < 2; ++b) {
    const long long* x = a + 6 + 7 * b;
    Block& B = *blocks[b];
    B.n = x[0];
    B.t = (const long long*)x[1];
    B.d = (const int*)x[2];
    B.s = (const int*)x[3];
    B.q = (const int*)x[4];
    B.k = (const int*)x[5];
    B.p = (const long long*)x[6];
  }
  k.M = k.tail.n + k.em.n;
  k.C_keep = k.C - (long long)k.S * k.X;
  const Layout L = layout(k.S, k.M, k.C);
  if (k.S < 1 || k.S > kMaxShards || k.X < 1 || k.Hl < 1 || k.PP < 0 ||
      k.C_keep < 1 || k.M < k.C || k.M > 0xFFFFFFFFLL || a[28] < L.end)
    return (int)cudaErrorInvalidValue;
  k.gbits = 32 - __builtin_clz((unsigned)k.S);
  k.digits = (kDtBits + k.gbits + 7) / 8;
  k.o_t = (long long*)a[20];
  k.o_d = (int*)a[21];
  k.o_s = (int*)a[22];
  k.o_q = (int*)a[23];
  k.o_k = (int*)a[24];
  k.o_p = (long long*)a[25];
  k.stats = (long long*)a[26];
  char* s = (char*)a[27];
  k.src = (long long*)(s + L.src);
  for (int b = 0; b < 2; ++b) {
    k.key[b] = (u64*)(s + L.key) + b * k.S * k.M;
    k.val[b] = (unsigned*)(s + L.val) + b * k.S * k.M;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  route_rank_kernel<<<k.S, kThreads, 0, st>>>(k);
  const long long cells = (long long)k.S * k.C;
  route_write_kernel<<<(unsigned)((cells + kThreads - 1) / kThreads),
                       kThreads, 0, st>>>(k);
  return (int)cudaGetLastError();
}
