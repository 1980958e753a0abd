// Shared parts of the two LSD radix sorts (window_sort, pool_merge): the
// tile, a stable rank of a tile's rows by bucket, and the decoupled
// look-back that gives a tile the count of each bucket in the tiles
// before it.
//
// A pass of either sort moves every row once: a tile of kTile rows is
// ranked by its 8-bit digit in shared memory, each warp over its own
// contiguous run of rows (32 a round, a __match_any_sync a round), then
// each bucket's place is the digit's offset over the whole input (the
// exclusive scan of its histogram, made before the first pass) plus the
// count of the bucket in the tiles before (the look-back) plus the row's
// rank in its tile. Tiles take their index from a counter in arrival
// order, so a tile only waits on tiles whose blocks already run. The
// rank keeps the input order within a bucket, so each pass is stable
// and the passes from the least significant digit up sort by the whole
// key, ties in input order.
#pragma once

#include <cuda_runtime.h>

namespace radix {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                   // rows a thread, one a round
constexpr int kTile = kThreads * kItems;    // rows a tile
constexpr int kRadix = 256;                 // buckets of an 8-bit digit
constexpr unsigned kFlagA = 1u << 30;       // the tile's own count
constexpr unsigned kFlagP = 1u << 31;       // the count of tiles 0..this
constexpr unsigned kCountMask = kFlagA - 1;  // counts below 2^30
constexpr long long kMaxRows = kCountMask;   // the C entries refuse more
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ void publish(unsigned* w, unsigned v) {
  *(volatile unsigned*)w = v;
}

__device__ __forceinline__ unsigned peek(const unsigned* w) {
  return *(const volatile unsigned*)w;
}

// The count of bucket b in the tiles before `tile`, given this tile's
// count; status holds NB words a tile, zero before the pass. The words
// of kWindow tiles before are read at once (independent loads, so one
// round trip to L2 a window rather than a tile), and the walk ends at
// the nearest tile that holds its inclusive count.
constexpr int kWindow = 16;

__device__ __forceinline__ unsigned look_back(unsigned* status, int nb,
                                              int tile, int b,
                                              unsigned count) {
  unsigned* mine = status + (long long)tile * nb + b;
  if (tile == 0) {
    publish(mine, kFlagP | count);
    return 0;
  }
  publish(mine, kFlagA | count);
  unsigned excl = 0;
  for (int j = tile - 1; j >= 0;) {
    unsigned s[kWindow];
#pragma unroll
    for (int k = 0; k < kWindow; ++k)  // before tile 0: an empty P
      s[k] = j - k >= 0 ? peek(status + (long long)(j - k) * nb + b)
                        : kFlagP;
    // the window's words up to its nearest P, all published, or none
    unsigned sum = 0;
    bool ready = true, done = false;
#pragma unroll
    for (int k = 0; k < kWindow; ++k) {
      if (done || !ready) continue;
      if ((s[k] & (kFlagA | kFlagP)) == 0) {
        ready = false;
      } else {
        sum += s[k] & kCountMask;
        done = (s[k] & kFlagP) != 0;
      }
    }
    if (!ready) continue;  // read the window again
    excl += sum;
    if (done) break;
    j -= kWindow;
  }
  publish(mine, kFlagP | (excl + count));
  return excl;
}

// The tile's shared memory for NB buckets.
template <int NB>
struct TileShared {
  unsigned wc[kWarps][NB];  // a warp's count of each bucket, then its offset
  unsigned base[NB];        // where the tile's rows of each bucket start
  int tile;
};

// The row of round r for this lane: each warp takes a contiguous run of
// 32 * kItems rows of the tile, 32 consecutive rows a round.
__device__ __forceinline__ long long tile_row(int tile, int r) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return (long long)tile * kTile + (long long)w * 32 * kItems + r * 32 +
         lane;
}

// Zero the warp counters and take the next tile index from *ctr; every
// thread returns it.
template <int NB>
__device__ __forceinline__ int begin_tile(TileShared<NB>& sh,
                                          unsigned* ctr) {
  for (int i = threadIdx.x; i < kWarps * NB; i += kThreads)
    (&sh.wc[0][0])[i] = 0;
  if (threadIdx.x == 0) sh.tile = (int)atomicAdd(ctr, 1u);
  __syncthreads();
  return sh.tile;
}

// Rank the warp's rows by bucket (-1: no row), stably: rank[r] is the
// row's index among the warp's rows of its bucket; sh.wc[w][b] ends as
// the warp's count of bucket b.
template <int NB>
__device__ __forceinline__ void warp_rank(TileShared<NB>& sh,
                                          const int (&bucket)[kItems],
                                          unsigned (&rank)[kItems]) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int b = bucket[r];
    const unsigned peers = __match_any_sync(kFull, b);
    unsigned seen = 0;
    if (b >= 0) seen = sh.wc[w][b];
    __syncwarp();
    if (b >= 0) {
      rank[r] = seen + __popc(peers & below);
      if (lane == 31 - __clz(peers)) sh.wc[w][b] = seen + __popc(peers);
    }
    __syncwarp();
  }
}

// After warp_rank: turn each bucket's warp counts into the warps' offsets
// in the tile, look back for the tiles before, and set sh.base[b] to
// offset[b] plus that; a row's place is then
// sh.base[b] + sh.wc[w][b] + rank.
template <int NB>
__device__ __forceinline__ void place_buckets(TileShared<NB>& sh,
                                              unsigned* status, int tile,
                                              const unsigned* offset) {
  __syncthreads();
  for (int b = threadIdx.x; b < NB; b += kThreads) {
    unsigned run = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const unsigned c = sh.wc[w][b];
      sh.wc[w][b] = run;
      run += c;
    }
    sh.base[b] = offset[b] + look_back(status, NB, tile, b, run);
  }
  __syncthreads();
}

// The exclusive scan of 256 counts, one a thread of a kThreads block, in
// every thread: its own entry's offset; `red` holds kWarps words.
__device__ __forceinline__ unsigned block_excl_scan(unsigned v,
                                                    unsigned* red) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  unsigned inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned x = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += x;
  }
  if (lane == 31) red[w] = inc;
  __syncthreads();
  unsigned before = 0;
  for (int j = 0; j < w; ++j) before += red[j];
  __syncthreads();
  return before + inc - v;
}

// Add a warp's rows' digits into a shared histogram: one atomic a run of
// equal digits (d < 0: no row).
__device__ __forceinline__ void warp_count(unsigned* hist, int d) {
  const unsigned peers = __match_any_sync(kFull, d);
  const int lane = threadIdx.x & 31;
  if (d >= 0 && lane == 31 - __clz(peers))
    atomicAdd(&hist[d], (unsigned)__popc(peers));
}

// True in the last block to call it (after its own global writes): a
// fence, then one ticket a block on *done.
__device__ __forceinline__ bool last_block(unsigned* done, int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    *flag = atomicAdd(done, 1u) == gridDim.x - 1;
  __syncthreads();
  return *flag != 0;
}

inline long long tiles(long long n) { return (n + kTile - 1) / kTile; }

}  // namespace radix
