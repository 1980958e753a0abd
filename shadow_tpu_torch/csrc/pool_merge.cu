// K20 pool_merge: the next pool, a stable sort by time of the window's
// candidate rows, truncated to the pool's capacity.
//
// Replaces the merge of shadow_tpu/core/engine.py: make_window_step's
// assemble (694-728) on the matrix path and the loop path's finish
// (1102): lax.sort(num_keys=1, is_stable=True) of the candidates by time,
// the first C rows kept, and pool_overflow_dropped, the rows past C whose
// time is not NEVER.
//
// Inputs: up to four blocks of rows in order (the matrix path's tail and
// emissions; the loop path's leftover dense cells, tail, outbox and
// inbox), each read where it lies by its pointers: time, dst, src, seq,
// kind and its payload rows. A block's dst may be one value a host for
// runs of equal length (the dense cells' and the inbox's gid), and a
// block may carry a cursor a host: row j of host h's run is empty (time
// NEVER) for j < cut[h] (the dense cells a micro-step consumed). Output:
// the C rows of the next pool, each column where the pool keeps it, and
// the dropped count.
//
// All NEVER rows compare equal, so they sort last, in row order, and only
// the F rows with a finite time need sorting; the rows past C are F - C
// finite rows when F > C, else none. Bound: bytes: each candidate's
// time read once (a row behind its cursor not even that), the other
// columns of the C rows kept read once, and the C rows of the next pool
// written once (chip_smoke's kernel_bound).
// Design: an LSD radix sort on time ^ 2^63 with 8-bit digits, eight
// passes (radix_common.cuh). One launch counts the finite rows' digits
// and F, and its last block scans them and plans the passes. The first
// pass reads the times from the blocks and sends the NEVER rows, as a
// 257th bucket, to [F, M) in row order, where they stay; passes 2-7 move
// only the F finite rows, and one whose digit has the same value on
// every finite row returns at once (P's times stay below 2^40, so the
// top two of those skip). The eighth pass does not write keys: it sends
// each finite row that lands below C, and each NEVER row at a place in
// [F, C), straight to its place in the next pool, all six columns read
// from the row's block. With the memset of the counters, a call is ten
// device launches.

#include <cuda_runtime.h>

#include "radix_common.cuh"

namespace {

using radix::kRadix;
using radix::kThreads;
using radix::kTile;
using u64 = unsigned long long;

constexpr int kDigits = 8;
constexpr int kMaxBlocks = 4;
constexpr long long kNever = 0x7FFFFFFFFFFFFFFFLL;
constexpr u64 kSign = 1ULL << 63;

struct Block {
  long long start, n;
  const long long* t;
  const int* d;
  long long d_div;  // rows a dst value: 1, or a host's run
  const int* s;
  const int* q;
  const int* k;
  const long long* p;
  const int* cut;  // null, or [hosts]: the empty head of each run
  long long cut_w;  // rows a run of cut
};

struct Args {
  Block blk[kMaxBlocks];
  int nb, PP;
  long long C, M, tiles;
  long long* o_t;
  int* o_d;
  int* o_s;
  int* o_q;
  int* o_k;
  long long* o_p;
  long long* dropped;
  unsigned* hist;    // [kDigits][kRadix], zeroed
  unsigned* fin;     // F, zeroed
  unsigned* done;    // the count launch's block tickets, zeroed
  unsigned* ctr;     // [kDigits] tile counters, zeroed
  unsigned* status;  // pass 0: [tiles][kRadix + 1]; then [tiles][kRadix]
  unsigned* goff;    // pass 0: kRadix + 1 offsets; then kRadix a digit
  int* plan;         // [kDigits]: each pass's order among those run, -1
  u64* key[2];
  unsigned* val[2];
};

__device__ __forceinline__ const Block& block_of(const Args& a,
                                                 long long i) {
  int b = 0;
#pragma unroll
  for (int j = 1; j < kMaxBlocks; ++j)
    if (j < a.nb && i >= a.blk[j].start) b = j;
  return a.blk[b];
}

__device__ __forceinline__ long long row_time(const Args& a, long long i) {
  const Block& B = block_of(a, i);
  const long long l = i - B.start;
  if (B.cut) {
    const long long h = l / B.cut_w;
    if (l - h * B.cut_w < B.cut[h]) return kNever;
  }
  return B.t[l];
}

// row i of the candidates to place q of the next pool
__device__ __forceinline__ void write_row(const Args& a, long long q,
                                          long long i, long long t) {
  const Block& B = block_of(a, i);
  const long long l = i - B.start;
  a.o_t[q] = t;
  a.o_d[q] = B.d[l / B.d_div];
  a.o_s[q] = B.s[l];
  a.o_q[q] = B.q[l];
  a.o_k[q] = B.k[l];
  const long long* src = B.p + l * a.PP;
  long long* dst = a.o_p + q * a.PP;
  for (int w = 0; w < a.PP; ++w) dst[w] = src[w];
}

__device__ __forceinline__ int digit(u64 key, int d) {
  return (int)((key >> (8 * d)) & 0xFF);
}

__device__ __forceinline__ unsigned* status_of(const Args& a, int d) {
  // pass 0 has kRadix + 1 words a tile
  return d == 0 ? a.status
                : a.status + a.tiles * (kRadix + 1) +
                      (long long)(d - 1) * a.tiles * kRadix;
}

__global__ void __launch_bounds__(kThreads)
    merge_count_kernel(Args a) {
  __shared__ unsigned h[kDigits][kRadix];
  __shared__ unsigned red[radix::kWarps];
  __shared__ unsigned nfin;
  __shared__ int last;
  for (int i = threadIdx.x; i < kDigits * kRadix; i += kThreads)
    (&h[0][0])[i] = 0;
  if (threadIdx.x == 0) nfin = 0;
  __syncthreads();
  unsigned mine = 0;
  for (int r = 0; r < radix::kItems; ++r) {
    const long long i = radix::tile_row(blockIdx.x, r);
    long long t = kNever;
    if (i < a.M) t = row_time(a, i);
    const bool ok = t != kNever;
    mine += ok;
    const u64 key = (u64)t ^ kSign;
#pragma unroll
    for (int d = 0; d < kDigits; ++d)
      radix::warp_count(h[d], ok ? digit(key, d) : -1);
  }
  atomicAdd(&nfin, mine);
  __syncthreads();
  for (int i = threadIdx.x; i < kDigits * kRadix; i += kThreads) {
    const unsigned c = (&h[0][0])[i];
    if (c) atomicAdd(&a.hist[i], c);
  }
  if (threadIdx.x == 0 && nfin) atomicAdd(a.fin, nfin);
  if (!radix::last_block(a.done, &last)) return;
  // every block has counted: scan each digit, plan the passes
  const unsigned F = __ldcg(a.fin);
  __shared__ int varies[kDigits];
  for (int d = 0; d < kDigits; ++d) {
    const unsigned c = __ldcg(&a.hist[d * kRadix + threadIdx.x]);
    // pass 0's offsets are kRadix + 1 words (the NEVER bucket at F)
    const long long base = d == 0 ? 0 : (kRadix + 1) + (d - 1) * kRadix;
    a.goff[base + threadIdx.x] = radix::block_excl_scan(c, red);
    const int same = __syncthreads_or(c == F);
    if (threadIdx.x == 0) varies[d] = !same;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    a.goff[kRadix] = F;
    // the first pass splits off the NEVER rows and the last writes the
    // pool, so both always run
    int e = 0;
    for (int d = 0; d < kDigits; ++d)
      a.plan[d] = (d == 0 || d == kDigits - 1 || varies[d]) ? e++ : -1;
    *a.dropped = F > a.C ? (long long)F - a.C : 0;
  }
}

// digit d's pass over n rows with NB buckets; pass 0 reads the blocks
// and buckets the NEVER rows last; the last pass writes the pool
template <int NB>
__device__ __forceinline__ void pass(const Args& a, int d) {
  const int e = a.plan[d];
  if (e < 0) return;  // the digit is the same on every finite row
  const bool first = d == 0, last = d == kDigits - 1;
  const long long F = *a.fin;
  if (last) {
    // the NEVER rows that stay below C, at their places since pass 0
    const long long q = (long long)blockIdx.x * kThreads + threadIdx.x;
    const long long stride = (long long)gridDim.x * kThreads;
    for (long long p = F + q; p < a.C && p < a.M; p += stride)
      write_row(a, p, a.val[0][p], kNever);
  }
  __shared__ radix::TileShared<NB> sh;
  __shared__ unsigned off[NB];
  const long long goff = first ? 0 : (kRadix + 1) + (d - 1) * kRadix;
  for (int b = threadIdx.x; b < NB; b += kThreads) off[b] = a.goff[goff + b];
  const int tile = radix::begin_tile(sh, a.ctr + d);
  const long long n = first ? a.M : F;
  if ((long long)tile * kTile >= n) return;
  u64 key[radix::kItems];
  unsigned v[radix::kItems], rank[radix::kItems];
  int bucket[radix::kItems];
  const int src = (e - 1) & 1;
#pragma unroll
  for (int r = 0; r < radix::kItems; ++r) {
    const long long i = radix::tile_row(tile, r);
    bucket[r] = -1;
    if (i < n) {
      if (first) {
        const long long t = row_time(a, i);
        key[r] = (u64)t ^ kSign;
        v[r] = (unsigned)i;
        bucket[r] = t == kNever ? kRadix : digit(key[r], d);
      } else {
        key[r] = a.key[src][i];
        v[r] = a.val[src][i];
        bucket[r] = digit(key[r], d);
      }
    }
  }
  radix::warp_rank(sh, bucket, rank);
  radix::place_buckets(sh, status_of(a, d), tile, off);
  const int w = threadIdx.x >> 5, o = e & 1;
#pragma unroll
  for (int r = 0; r < radix::kItems; ++r) {
    const int b = bucket[r];
    if (b < 0) continue;
    const long long q = (long long)sh.base[b] + sh.wc[w][b] + rank[r];
    if (last) {
      if (q < a.C) write_row(a, q, v[r], (long long)(key[r] ^ kSign));
    } else {
      a.key[o][q] = key[r];
      a.val[o][q] = v[r];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    merge_first_pass_kernel(Args a) {
  pass<kRadix + 1>(a, 0);
}

__global__ void __launch_bounds__(kThreads)
    merge_pass_kernel(Args a, int d) {
  pass<kRadix>(a, d);
}

struct Layout {
  long long hist, fin, done, ctr, status, zero_end, goff, plan, key, val,
      end;
};

Layout layout(long long M) {
  Layout L;
  const long long tiles = radix::tiles(M);
  auto up = [](long long x) { return (x + 7) & ~7LL; };
  L.hist = 0;
  L.fin = L.hist + 4LL * kDigits * kRadix;
  L.done = L.fin + 4;
  L.ctr = L.done + 4;
  L.status = up(L.ctr + 4LL * kDigits);
  L.zero_end = up(L.status + 4LL * tiles *
                                 ((kRadix + 1) + (kDigits - 1) * kRadix));
  L.goff = L.zero_end;
  L.plan = L.goff + 4LL * ((kRadix + 1) + (kDigits - 1) * kRadix);
  L.key = up(L.plan + 4LL * kDigits);
  L.val = L.key + 16 * M;
  L.end = up(L.val + 8 * M);
  return L;
}

}  // namespace

// the scratch bytes of a call on M candidate rows (kernels.pool_merge
// allocates them)
extern "C" long long pool_merge_scratch(long long M) {
  return layout(M).end;
}

// a: nb, C, PP, the outputs time, dst, src, seq, kind, payload and
// dropped, scratch, scratch_bytes, then for each of kMaxBlocks blocks
// n, time, dst, d_div, src, seq, kind, payload, cut, cut_w (kernels.
// pool_merge packs them in this order; unused blocks are zeros)
extern "C" int pool_merge(const long long* a, void* stream) {
  Args k{};
  k.nb = (int)a[0];
  k.C = a[1];
  k.PP = (int)a[2];
  long long M = 0;
  if (k.nb < 1 || k.nb > kMaxBlocks || k.PP < 0)
    return (int)cudaErrorInvalidValue;
  for (int b = 0; b < k.nb; ++b) {
    const long long* x = a + 12 + 10 * b;
    Block& B = k.blk[b];
    B.start = M;
    B.n = x[0];
    B.t = (const long long*)x[1];
    B.d = (const int*)x[2];
    B.d_div = x[3];
    B.s = (const int*)x[4];
    B.q = (const int*)x[5];
    B.k = (const int*)x[6];
    B.p = (const long long*)x[7];
    B.cut = (const int*)x[8];
    B.cut_w = x[9];
    if (B.n < 0 || B.d_div < 1 || (B.cut && B.cut_w < 1))
      return (int)cudaErrorInvalidValue;
    M += B.n;
  }
  k.M = M;
  const Layout L = layout(M);
  if (k.C < 1 || M < k.C || M > radix::kMaxRows || a[11] < L.end)
    return (int)cudaErrorInvalidValue;
  k.tiles = radix::tiles(M);
  k.o_t = (long long*)a[3];
  k.o_d = (int*)a[4];
  k.o_s = (int*)a[5];
  k.o_q = (int*)a[6];
  k.o_k = (int*)a[7];
  k.o_p = (long long*)a[8];
  k.dropped = (long long*)a[9];
  char* s = (char*)a[10];
  k.hist = (unsigned*)(s + L.hist);
  k.fin = (unsigned*)(s + L.fin);
  k.done = (unsigned*)(s + L.done);
  k.ctr = (unsigned*)(s + L.ctr);
  k.status = (unsigned*)(s + L.status);
  k.goff = (unsigned*)(s + L.goff);
  k.plan = (int*)(s + L.plan);
  for (int b = 0; b < 2; ++b) {
    k.key[b] = (u64*)(s + L.key) + b * M;
    k.val[b] = (unsigned*)(s + L.val) + b * M;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  const unsigned grid = (unsigned)k.tiles;
  cudaMemsetAsync(s, 0, L.zero_end, st);
  merge_count_kernel<<<grid, kThreads, 0, st>>>(k);
  merge_first_pass_kernel<<<grid, kThreads, 0, st>>>(k);
  for (int d = 1; d < kDigits; ++d)
    merge_pass_kernel<<<grid, kThreads, 0, st>>>(k, d);
  return (int)cudaGetLastError();
}
