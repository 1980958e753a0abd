// K19 window_sort: the window's first sort, keys built on the card.
//
// Replaces the two key sorts of shadow_tpu/core/engine.py:_dense_extract
// (its lax.sort(num_keys=2, is_stable=True) over the pool rows and H*Kc
// filler rows) and the key building before them.
//
// Inputs: the pool's time, dst, src and seq columns (C rows), the window
// [win_start, win_end), H and Kc. Each pool row's keys are
//   k1 = run_key << 44 | clip(time - win_start, 0, DT_MAX)
//   k2 = src << 32 | seq zero-extended          (compared as int64)
// with run_key = dst where the row is in the window (time < win_end and
// dst in [0, H)), else H. Filler j of host h is row C + h*Kc + j with
// k1 = h << 44 | DT_MAX and k2 = 0. Output: s_k1 and perm over the
// N = C + H*Kc rows in (k1, k2, row) order, as the JAX package's stable
// two-key sort leaves them: the sorted k1 and the row each place came
// from (what extract_slots takes).
//
// Over S shards (the islands engine, shadow_tpu/parallel/islands.py;
// S = 1 is the global engine) the pool is S blocks of C/S rows and the
// hosts S blocks of Hl = H/S: shard s's rows sort apart, after shard
// s - 1's, each keyed on its shard-local row lrow = dst - s*Hl (the JAX
// package's _dense_extract with lrow: run_key = lrow where the row is in
// the window and lrow in [0, Hl), else Hl, so a row deferred to another
// shard never extracts), its Kc fillers a local host. The sort runs on
// G = s*(Hl + 1) + run_key in k1's place, so one sort orders every
// shard; the output is S blocks of C/S + Hl*Kc places, each as the
// shard's own sort leaves it, s_k1 with the local run key and perm the
// global row (fillers C + (s*Hl + h)*Kc + j).
//
// The fillers are not sorted. With g(row) = run_key + c for run_key < H
// and H otherwise, where c = 1 only for a row with dt = DT_MAX and
// k2 > 0 (which sorts after its host's fillers; an in-window row has
// dt < win_end - win_start, so c = 1 takes a window over 2^44 ns), host
// h's fillers come after every pool row with g <= h and before every
// other. So only the C pool rows are sorted, and then
//   pool row at sorted place p   -> p + Kc * g
//   filler j of host h           -> P(h) + h*Kc + j,
// P(h) the number of pool rows with g <= h, a binary search of the
// sorted rows (g does not decrease along them).
//
// Bound: bytes. The least is the four columns read once (20 bytes a
// row) and s_k1 and perm written (16 bytes a row of N). Design: an LSD
// radix sort of the C rows on the 128-bit key (k1, k2 ^ 2^63) with
// 8-bit digits, 16 passes (radix_common.cuh), each one launch: a tile of
// 2,048 rows ranked in shared memory, the tiles' bucket counts chained
// by a decoupled look-back, each row scattered once. One launch before
// them builds every row's keys and counts all sixteen digits, and its
// last block scans the counts and plans the passes: a digit that has
// the same value on every row leaves the order as it is, so its pass
// returns at once (no host read; P's pools vary in about 12 of 16
// digits). The first pass that runs builds the keys from the pool's
// columns again instead of reading a copy. A last launch places every
// pool row and makes every filler. One memset clears the counters and
// the look-back words first. So a call is 19 device launches, whatever
// the data.

#include <cuda_runtime.h>

#include "radix_common.cuh"

namespace {

using radix::kRadix;
using radix::kThreads;
using radix::kTile;
using u64 = unsigned long long;

constexpr int kDtBits = 44;
constexpr long long kDtMax = (1LL << kDtBits) - 1;
constexpr int kDigits = 16;  // 8-bit digits of the 128-bit key
constexpr u64 kSign = 1ULL << 63;
constexpr int kMaxHosts = 1 << 19;  // G << 44 stays below 2^63

struct Args {
  const long long* time;
  const int* dst;
  const int* src;
  const int* seq;
  long long* s_k1;
  long long* perm;
  unsigned* hist;    // [kDigits][kRadix], zeroed
  unsigned* done;    // the histogram launch's block tickets, zeroed
  unsigned* ctr;     // [kDigits] tile counters, zeroed
  unsigned* status;  // [kDigits][tiles][kRadix] look-back words, zeroed
  unsigned* goff;    // [kDigits][kRadix] each digit's bucket offsets
  int* plan;         // [kDigits + 1]: each pass's order among those run
                     // (-1: skipped), then the number of passes run
  u64* hi[2];        // k1 of the rows in a pass's order, two buffers
  u64* lo[2];        // k2 ^ 2^63
  unsigned* val[2];  // the pool row
  long long win_start, win_end, C, tiles;
  long long Cl;  // pool rows a shard
  int H, Kc, S, Hl;
};

// the shard of pool row i (a uniform branch: no division on the global
// engine)
__device__ __forceinline__ int shard_of(const Args& a, long long i) {
  return a.S == 1 ? 0 : (int)(i / a.Cl);
}

// row i's keys, hi with the shard's G in place of the run key
__device__ __forceinline__ void build(const Args& a, long long i, u64& hi,
                                      u64& lo) {
  const long long t = a.time[i];
  const int sh = shard_of(a, i);
  const long long d = (long long)a.dst[i] - (long long)sh * a.Hl;
  const bool inwin = t < a.win_end && d >= 0 && d < a.Hl;
  const long long run_key =
      (long long)sh * (a.Hl + 1) + (inwin ? d : a.Hl);
  // time - win_start wraps as int64 arithmetic does, then clips
  long long dt = (long long)((u64)t - (u64)a.win_start);
  dt = dt < 0 ? 0 : (dt > kDtMax ? kDtMax : dt);
  hi = ((u64)run_key << kDtBits) | (u64)dt;
  lo = (((u64)(long long)a.src[i] << 32) | (unsigned)a.seq[i]) ^ kSign;
}

// the keys and row of place p after the passes that run before the one
// whose order among them is e (e = the number run: after all of them)
__device__ __forceinline__ void key_at(const Args& a, int e, long long p,
                                       u64& hi, u64& lo, unsigned& v) {
  if (e == 0) {
    build(a, p, hi, lo);
    v = (unsigned)p;
  } else {
    const int b = (e - 1) & 1;
    hi = a.hi[b][p];
    lo = a.lo[b][p];
    v = a.val[b][p];
  }
}

__device__ __forceinline__ int digit(u64 hi, u64 lo, int d) {
  const u64 w = d < 8 ? lo : hi;
  return (int)((w >> (8 * (d & 7))) & 0xFF);
}

// the number of filler blocks of its shard sh before a pool row (see
// above)
__device__ __forceinline__ long long groups_before(const Args& a, int sh,
                                                   u64 hi, u64 lo) {
  const long long key =
      (long long)(hi >> kDtBits) - (long long)sh * (a.Hl + 1);
  if (key >= a.Hl) return a.Hl;
  const bool after = (hi & (u64)kDtMax) == (u64)kDtMax && lo > kSign;
  return key + (after ? 1 : 0);
}

__global__ void __launch_bounds__(kThreads)
    window_count_kernel(Args a) {
  __shared__ unsigned h[kDigits][kRadix];
  __shared__ unsigned red[radix::kWarps];
  __shared__ int last;
  for (int i = threadIdx.x; i < kDigits * kRadix; i += kThreads)
    (&h[0][0])[i] = 0;
  __syncthreads();
  for (int r = 0; r < radix::kItems; ++r) {
    const long long i = radix::tile_row(blockIdx.x, r);
    const bool ok = i < a.C;
    u64 hi = 0, lo = 0;
    if (ok) build(a, i, hi, lo);
#pragma unroll
    for (int d = 0; d < kDigits; ++d)
      radix::warp_count(h[d], ok ? digit(hi, lo, d) : -1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kDigits * kRadix; i += kThreads) {
    const unsigned c = (&h[0][0])[i];
    if (c) atomicAdd(&a.hist[i], c);
  }
  if (!radix::last_block(a.done, &last)) return;
  // every block has counted: scan each digit, plan the passes
  __shared__ int varies[kDigits];
  for (int d = 0; d < kDigits; ++d) {
    const unsigned c = __ldcg(&a.hist[d * kRadix + threadIdx.x]);
    a.goff[d * kRadix + threadIdx.x] = radix::block_excl_scan(c, red);
    const int same = __syncthreads_or(c == (unsigned)a.C);
    if (threadIdx.x == 0) varies[d] = !same;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int e = 0;
    for (int d = 0; d < kDigits; ++d) a.plan[d] = varies[d] ? e++ : -1;
    a.plan[kDigits] = e;
  }
}

__global__ void __launch_bounds__(kThreads)
    window_pass_kernel(Args a, int d) {
  const int e = a.plan[d];
  if (e < 0) return;  // the digit is the same on every row
  __shared__ radix::TileShared<kRadix> sh;
  __shared__ unsigned off[kRadix];
  off[threadIdx.x] = a.goff[d * kRadix + threadIdx.x];
  const int tile = radix::begin_tile(sh, a.ctr + d);
  u64 hi[radix::kItems], lo[radix::kItems];
  unsigned v[radix::kItems], rank[radix::kItems];
  int bucket[radix::kItems];
#pragma unroll
  for (int r = 0; r < radix::kItems; ++r) {
    const long long i = radix::tile_row(tile, r);
    bucket[r] = -1;
    if (i < a.C) {
      key_at(a, e, i, hi[r], lo[r], v[r]);
      bucket[r] = digit(hi[r], lo[r], d);
    }
  }
  radix::warp_rank(sh, bucket, rank);
  radix::place_buckets(sh, a.status + (long long)d * a.tiles * kRadix,
                       tile, off);
  const int w = threadIdx.x >> 5, o = e & 1;
#pragma unroll
  for (int r = 0; r < radix::kItems; ++r) {
    const int b = bucket[r];
    if (b < 0) continue;
    const long long q = (long long)sh.base[b] + sh.wc[w][b] + rank[r];
    a.hi[o][q] = hi[r];
    a.lo[o][q] = lo[r];
    a.val[o][q] = v[r];
  }
}

// one thread a place of the output: pool rows first, then fillers; shard
// sh's C/S sorted rows are places sh*C/S on (G orders the shards), and
// its output block starts at sh*(C/S + Hl*Kc)
__global__ void __launch_bounds__(kThreads)
    window_place_kernel(Args a) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long n = a.C + (long long)a.H * a.Kc;
  if (i >= n) return;
  const int e = a.plan[kDigits];
  const long long ns = a.Cl + (long long)a.Hl * a.Kc;
  if (i < a.C) {
    u64 hi, lo;
    unsigned v;
    key_at(a, e, i, hi, lo, v);
    const int sh = shard_of(a, i);
    const long long o = (long long)sh * ns + (i - sh * a.Cl) +
                        (long long)a.Kc * groups_before(a, sh, hi, lo);
    a.s_k1[o] = (long long)(hi - ((u64)sh * (a.Hl + 1) << kDtBits));
    a.perm[o] = v;
    return;
  }
  const long long f = i - a.C;
  const long long gh = f / a.Kc, j = f - gh * a.Kc;
  const int sh = a.S == 1 ? 0 : (int)(gh / a.Hl);
  const long long h = gh - (long long)sh * a.Hl;
  // P(h): the first of the shard's sorted places whose row has g > h
  long long lo_p = sh * a.Cl, hi_p = (sh + 1) * a.Cl;
  while (lo_p < hi_p) {
    const long long mid = (lo_p + hi_p) >> 1;
    u64 khi, klo;
    unsigned v;
    key_at(a, e, mid, khi, klo, v);
    if (groups_before(a, sh, khi, klo) > h)
      hi_p = mid;
    else
      lo_p = mid + 1;
  }
  const long long o = (long long)sh * ns + (lo_p - sh * a.Cl) + h * a.Kc + j;
  a.s_k1[o] = (long long)(((u64)h << kDtBits) | (u64)kDtMax);
  a.perm[o] = i;
}

// scratch layout; every part 8-byte aligned
struct Layout {
  long long hist, done, ctr, status, zero_end, goff, plan, hi, lo, val, end;
};

Layout layout(long long C) {
  Layout L;
  const long long tiles = radix::tiles(C);
  auto up = [](long long x) { return (x + 7) & ~7LL; };
  L.hist = 0;
  L.done = L.hist + 4LL * kDigits * kRadix;
  L.ctr = L.done + 4;
  L.status = up(L.ctr + 4LL * kDigits);
  L.zero_end = up(L.status + 4LL * kDigits * tiles * kRadix);
  L.goff = L.zero_end;
  L.plan = L.goff + 4LL * kDigits * kRadix;
  L.hi = up(L.plan + 4LL * (kDigits + 1));
  L.lo = L.hi + 16 * C;
  L.val = L.lo + 16 * C;
  L.end = up(L.val + 8 * C);
  return L;
}

}  // namespace

// the scratch bytes of a call on C pool rows (kernels.window_sort
// allocates them)
extern "C" long long window_sort_scratch(long long C) {
  return layout(C).end;
}

// a: time, dst, src, seq, s_k1, perm, scratch, scratch_bytes, C, H, Kc,
// win_start, win_end, S (kernels.window_sort packs them in this order)
extern "C" int window_sort(const long long* a, void* stream) {
  const long long C = a[8];
  const int H = (int)a[9], Kc = (int)a[10], S = (int)a[13];
  if (C < 1 || C > radix::kMaxRows || H < 1 || Kc < 1 || S < 1 ||
      H % S || C % S || (long long)H + S - 1 >= kMaxHosts ||
      a[7] < layout(C).end)
    return (int)cudaErrorInvalidValue;
  const Layout L = layout(C);
  char* s = (char*)a[6];
  Args k{};
  k.time = (const long long*)a[0];
  k.dst = (const int*)a[1];
  k.src = (const int*)a[2];
  k.seq = (const int*)a[3];
  k.s_k1 = (long long*)a[4];
  k.perm = (long long*)a[5];
  k.hist = (unsigned*)(s + L.hist);
  k.done = (unsigned*)(s + L.done);
  k.ctr = (unsigned*)(s + L.ctr);
  k.status = (unsigned*)(s + L.status);
  k.goff = (unsigned*)(s + L.goff);
  k.plan = (int*)(s + L.plan);
  for (int b = 0; b < 2; ++b) {
    k.hi[b] = (u64*)(s + L.hi) + b * C;
    k.lo[b] = (u64*)(s + L.lo) + b * C;
    k.val[b] = (unsigned*)(s + L.val) + b * C;
  }
  k.win_start = a[11];
  k.win_end = a[12];
  k.C = C;
  k.tiles = radix::tiles(C);
  k.H = H;
  k.Kc = Kc;
  k.S = S;
  k.Hl = H / S;
  k.Cl = C / S;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaMemsetAsync(s, 0, L.zero_end, st);
  window_count_kernel<<<(unsigned)k.tiles, kThreads, 0, st>>>(k);
  for (int d = 0; d < kDigits; ++d)
    window_pass_kernel<<<(unsigned)k.tiles, kThreads, 0, st>>>(k, d);
  const long long n = C + (long long)H * Kc;
  const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
  window_place_kernel<<<grid, kThreads, 0, st>>>(k);
  return (int)cudaGetLastError();
}
