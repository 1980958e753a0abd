// K3 extract_slots: every row of the window's first sort moved to its place.
//
// Replaces shadow_tpu/core/engine.py:_dense_extract after its first sort:
// the rank scan (the boundary mask and lax.cummax over the k1 column), the
// slot formula, and the second stable sort by slot that carries every
// column and payload word.
//
// Inputs: the k1 column after the window's first stable sort, N = C + H*Kc
// rows, each run_key << 44 | dt with run_key in [0, H] (H marks rows
// outside the window); perm, the row each sorted position came from (pool
// rows 0..C-1, then the H*Kc filler rows host-major); the pool's columns.
// Every host run holds at least Kc rows (its Kc fillers), so where the
// stable sort by slot puts sorted row i, with key its run_key and rank its
// index minus its run's first index, follows in closed form:
//   key * Kc + rank                (key < H, rank < Kc: the dense window)
//   H*Kc + i - min(key + 1, H)*Kc  (every other row: the tail, in order).
// rank >= Kc exactly when i >= Kc and row i - Kc has the same key; below
// that the rank is i minus the first index in (i - Kc, i] with its key.
// Output: the N placed rows column by column (time, src, seq, kind,
// payload; dst for the C tail rows only). A filler's columns are made in
// registers: time NEVER, dst its host, src = seq = kind = 0, zero payload.
//
// Over S shards (window_sort's: S blocks of N/S sorted rows, each with its
// local run keys in [0, Hl], Hl = H/S) each block places alone: the keys
// compare as G = s*(Hl + 1) + key, which never ties across a shard's edge,
// shard s's dense cells are the rows of hosts s*Hl.. (the [H, Kc] window
// in global host order), its tail rows follow shard s - 1's, and a
// filler's dst is its local host. S = 1 is the global engine, and runs
// an instance without the shard arithmetic (kShards false).
//
// Bound: bytes. It reads 16 bytes a sorted row (key and perm) and each
// pool row once, and writes each placed row once. Design: one thread per
// sorted row. A block stages the keys of its rows and the Kc keys before
// them (the halo, for Kc up to kMaxKc) in shared memory, so the rank is a
// binary search of log2(Kc) steps there instead of a search over [0, i]
// in device memory; a larger Kc, whose halo would not fit, runs the same
// search over the keys in device memory (a second instance of the
// kernel). The rows of one host run land on consecutive slots
// and the tail is consecutive, so the stores coalesce; the pool rows are
// gathered. A warp copies its 32 rows' payload words together, lane j on
// word j % PP of row j / PP (the row's place and source by shuffle), so
// neighbouring lanes store neighbouring words at any PP.

#include <cuda_runtime.h>

namespace {

constexpr int kDtBits = 44;
constexpr int kBlock = 256;
constexpr int kMaxKc = 1024;  // a larger Kc searches device memory
constexpr long long kNever = 0x7FFFFFFFFFFFFFFFLL;
constexpr unsigned kFull = 0xFFFFFFFFu;

// the key G of sorted row g (its shard's run key, shifted by the
// shard), -1 before row 0 (keys are >= 0); ns rows a shard
template <bool kShards>
__device__ __forceinline__ int key_of(const long long* __restrict__ k1,
                                      long long g, long long n, long long ns,
                                      int Hl) {
  if (g < 0 || g >= n) return -1;
  const int key = (int)(k1[g] >> kDtBits);
  if constexpr (kShards)
    return (int)(g / ns) * (Hl + 1) + key;
  else
    return key;
}

template <bool kHalo, bool kShards>
__global__ void __launch_bounds__(kBlock) extract_slots_kernel(
    const long long* __restrict__ k1, const long long* __restrict__ perm,
    const long long* __restrict__ p_t, const int* __restrict__ p_d,
    const int* __restrict__ p_s, const int* __restrict__ p_q,
    const int* __restrict__ p_k, const long long* __restrict__ p_p,
    long long* __restrict__ o_t, int* __restrict__ o_s,
    int* __restrict__ o_q, int* __restrict__ o_k,
    long long* __restrict__ o_p, int* __restrict__ o_d, long long n, int C,
    int H, int Kc, int PP, int S) {
  const int Hl = kShards ? H / S : H;
  const long long ns = kShards ? n / S : n, Cl = kShards ? C / S : C;
  // with the halo, skey[j] is the key of row b0 - Kc + j
  __shared__ int skey[kHalo ? kBlock + kMaxKc : 1];
  const long long b0 = (long long)blockIdx.x * kBlock;
  if constexpr (kHalo) {
    for (int j = threadIdx.x; j < kBlock + Kc; j += kBlock)
      skey[j] = key_of<kShards>(k1, b0 - Kc + j, n, ns, Hl);
    __syncthreads();
  }
  // the key of row i - Kc + j (j in [0, Kc]) from the halo or the keys
  auto near = [&](int j) {
    if constexpr (kHalo)
      return skey[j + threadIdx.x];
    else
      return key_of<kShards>(k1, b0 + threadIdx.x - Kc + j, n, ns, Hl);
  };
  const long long i = b0 + threadIdx.x;
  long long o = -1, r = 0;  // the placed row (-1 past the last) and source
  const long long HK = (long long)H * Kc;
  if (i < n) {
    const int g = near(Kc);
    const int sh = kShards ? (int)(i / ns) : 0;
    const int key = g - sh * (Hl + 1);  // the shard's run key
    const bool dense = key < Hl && near(0) != g;
    if (dense) {  // a dense slot
      int lo = 1, hi = Kc;  // the first of (i - Kc, i] with key, from i - Kc
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (near(mid) < g)
          lo = mid + 1;
        else
          hi = mid;
      }
      o = ((long long)sh * Hl + key) * Kc + (Kc - lo);
    } else {  // HK + the shard's tail block + the tail index in it
      o = HK + sh * Cl + (i - sh * ns) -
          (long long)(key < Hl ? key + 1 : Hl) * Kc;
    }
    r = perm[i];
    if (r < C) {
      o_t[o] = p_t[r];
      o_s[o] = p_s[r];
      o_q[o] = p_q[r];
      o_k[o] = p_k[r];
      if (!dense) o_d[o - HK] = p_d[r];
    } else {
      o_t[o] = kNever;
      o_s[o] = 0;
      o_q[o] = 0;
      o_k[o] = 0;
      if (!dense) o_d[o - HK] = (int)((r - C) / Kc - (long long)sh * Hl);
    }
  }
  // every lane runs PP rounds, so the whole warp reaches each shuffle
  for (int j = threadIdx.x & 31; j < 32 * PP; j += 32) {
    const int row = j / PP, w = j - row * PP;
    const long long ro = __shfl_sync(kFull, o, row);
    const long long rr = __shfl_sync(kFull, r, row);
    if (ro >= 0) o_p[ro * PP + w] = rr < C ? p_p[rr * PP + w] : 0;
  }
}

}  // namespace

// a: k1, perm, the pool's time, dst, src, seq, kind and payload; the
// outputs time, src, seq, kind, payload and the tail's dst; n, C, H, Kc,
// PP, S
extern "C" int extract_slots(const long long* a, void* stream) {
  const long long n = a[14];
  const int C = (int)a[15], H = (int)a[16], Kc = (int)a[17], PP = (int)a[18];
  const int S = (int)a[19];
  if (Kc < 1 || S < 1 || H % S || C % S || n != C + (long long)H * Kc)
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const long long blocks = (n + kBlock - 1) / kBlock;
    auto kernel = Kc <= kMaxKc
                      ? (S > 1 ? extract_slots_kernel<true, true>
                               : extract_slots_kernel<true, false>)
                      : (S > 1 ? extract_slots_kernel<false, true>
                               : extract_slots_kernel<false, false>);
    kernel<<<(unsigned)blocks, kBlock, 0, (cudaStream_t)stream>>>(
        (const long long*)a[0], (const long long*)a[1],
        (const long long*)a[2], (const int*)a[3], (const int*)a[4],
        (const int*)a[5], (const int*)a[6], (const long long*)a[7],
        (long long*)a[8], (int*)a[9], (int*)a[10], (int*)a[11],
        (long long*)a[12], (int*)a[13], n, C, H, Kc, PP, S);
  }
  return (int)cudaGetLastError();
}
