// K3 extract_slots: the dense slot of each row of the sorted window keys.
//
// Replaces the rank scan of shadow_tpu/core/engine.py:_dense_extract (the
// boundary mask and lax.cummax over the first sort's k1 column) and the
// slot formula that follows it.
//
// Input: the k1 column after the window's first stable sort, N rows, each
// run_key << 44 | dt with run_key in [0, H] (H marks rows outside the
// window). Output: slot = run_key * Kc + rank for the first Kc rows of
// each host run (run_key < H), N for every other row; rank is the row's
// index minus the index of its run's first row.
//
// Bound: bytes. The function reads N int64 keys and writes N int32 slots,
// 12 bytes a row. Design: one thread per row. The run's first index is the
// lower bound of (run_key << 44) over the sorted keys, found by a binary
// search over [0, i]; this equals the cummax over run boundaries and needs
// no scan across blocks. The search's ~log2(N) reads are shared by
// neighbouring threads and stay in L2.

#include <cuda_runtime.h>

namespace {

constexpr int kDtBits = 44;

__global__ void extract_slots_kernel(const long long* __restrict__ k1,
                                     int* __restrict__ slot, long long n,
                                     int H, int Kc) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  long long key = k1[i] >> kDtBits;
  long long first_k1 = key << kDtBits;
  long long lo = 0, hi = i;  // first index in [0, i] with k1 >= first_k1
  while (lo < hi) {
    long long mid = (lo + hi) >> 1;
    if (k1[mid] < first_k1)
      lo = mid + 1;
    else
      hi = mid;
  }
  long long rank = i - lo;
  slot[i] = (key < H && rank < Kc) ? (int)(key * Kc + rank) : (int)n;
}

}  // namespace

extern "C" int extract_slots(const void* k1, void* slot, long long n, int H,
                             int Kc, void* stream) {
  if (n > 0) {
    const int threads = 256;
    long long blocks = (n + threads - 1) / threads;
    extract_slots_kernel<<<(unsigned)blocks, threads, 0,
                           (cudaStream_t)stream>>>(
        (const long long*)k1, (int*)slot, n, H, Kc);
  }
  return (int)cudaGetLastError();
}
