// K10 tcp_reorder: the data-receive block of one incoming segment per host.
//
// Replaces the reorder scoreboard of shadow_tpu/net/tcp.py:Tcp.on_segment
// (lines 1001-1048) and _pack_sack (340-349) of the ACK reply. The board
// is a host's [S, W] bool array; chunk k of a socket's row is
// [rcv_nxt + k*MSS, +MSS). On a socket that can receive (ESTABLISHED,
// FIN_WAIT_1, FIN_WAIT_2): an in-order segment advances rcv_nxt by its
// length and, when it is a full MSS, by the run of chunks already held
// after it, shifting the row down by 1 + that run (a short segment clears
// the row); an out-of-order segment that is MSS long, MSS-aligned and
// within the board sets its chunk, any other is counted as dropped.
// bytes_received gains what was delivered in order. The SACK word is the
// first 32 chunks of the slot's row after the update, as the int32 bit
// pattern of a uint32.
//
// In place: rcv_nxt, ooo_map and bytes_received are updated in the
// tensors given, at each masked host's slot and nowhere else (the row
// where the board changed; rcv_nxt and bytes_received where in order).
// Per host the kernel writes fresh decision bits (RO_* in kernels.py),
// the bytes delivered up and the SACK word. A masked-off host's values
// are read from its clipped slot and nothing of it is written.
//
// Bound: bytes, each host's inputs and its slot's state, rcv_nxt,
// bytes_received and board row. One thread a host loads its slot's row
// once (W / 16 uint4 words where W is a multiple of 16 and the board is
// 16-byte aligned, bytes otherwise) into a 64-bit register, computes the
// absorb run, the shift, the aligned chunk and the SACK word there, and
// writes the row back only where it changed: the whole row is read
// before any of it is written. W <= 64 (the wrapper checks).

#include "tcp_common.cuh"

#include <cstdint>

namespace {

using namespace tcp;

// one bit a byte of a 32-bit word: bit k is byte k != 0
__device__ __forceinline__ unsigned nibble(unsigned x) {
  x |= x >> 4;
  x |= x >> 2;
  x |= x >> 1;
  x &= 0x01010101u;
  return (x | x >> 7 | x >> 14 | x >> 21) & 0xFu;
}

// the inverse: bytes 0/1 from the low four bits
__device__ __forceinline__ unsigned bytes_of(unsigned n) {
  return (n & 1u) | (n & 2u) << 7 | (n & 4u) << 14 | (n & 8u) << 21;
}

__device__ __forceinline__ unsigned long long load_row(const bool* row, int W,
                                                       bool vec) {
  unsigned long long bits = 0;
  if (vec) {
    const uint4* v = reinterpret_cast<const uint4*>(row);
    for (int u = 0; u < W / 16; ++u) {
      const uint4 q = v[u];
      const unsigned lo = nibble(q.x) | nibble(q.y) << 4;
      const unsigned hi = nibble(q.z) | nibble(q.w) << 4;
      bits |= (unsigned long long)(lo | hi << 8) << (16 * u);
    }
  } else {
    for (int j = 0; j < W; ++j)
      bits |= (unsigned long long)(row[j] != 0) << j;
  }
  return bits;
}

__device__ __forceinline__ void store_row(bool* row, int W, bool vec,
                                          unsigned long long bits) {
  if (vec) {
    uint4* v = reinterpret_cast<uint4*>(row);
    for (int u = 0; u < W / 16; ++u) {
      const unsigned b = (unsigned)(bits >> (16 * u)) & 0xFFFFu;
      v[u] = make_uint4(bytes_of(b), bytes_of(b >> 4), bytes_of(b >> 8),
                        bytes_of(b >> 12));
    }
  } else {
    for (int j = 0; j < W; ++j) row[j] = (bits >> j) & 1ull;
  }
}

__global__ void __launch_bounds__(kThreads)
    tcp_reorder_kernel(const bool* mask, const int* slot, const int* seg_seq,
                       const int* seg_len, const int* state, int* rcv_nxt,
                       long long* bytes_received, bool* ooo_map, int* o_flags,
                       int* o_adv, int* o_sack, int H, int S, int W, int mss,
                       bool vec) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= H) return;
  const long long r = (long long)h * S;
  const int sl = slot[h];
  const long long i = r + clip_slot(sl, S);
  const int st = state[i];
  const int len = seg_len[h];
  const bool m_data = mask[h] && len > 0 &&
                      (st == kEstablished || st == kFinWait1 ||
                       st == kFinWait2);
  const int rn = rcv_nxt[i];
  const int d = wsub(seg_seq[h], rn);
  bool* row = ooo_map + i * W;
  const unsigned long long bits = load_row(row, W, vec);

  const bool in_order = m_data && d == 0;
  const bool full = len == mss;
  // the run of held chunks after chunk 0; bit 63 of ~(bits >> 1) is
  // always set, and no bit at or past W is, so the run stays below W
  const int n_absorb = full ? __ffsll((long long)~(bits >> 1)) - 1 : 0;
  const int adv = in_order ? wadd(len, n_absorb * mss) : 0;
  const int shift = full ? 1 + n_absorb : W;
  const bool m_ooo = m_data && d > 0;
  const int kchunk = floordiv(d, mss);
  const bool aligned = m_ooo && d - kchunk * mss == 0 && full &&
                       kchunk >= 1 && kchunk < W;

  unsigned long long now = bits;
  if (in_order) now = shift >= W ? 0ull : bits >> shift;
  if (aligned) now |= 1ull << kchunk;
  if ((in_order || aligned) && sl >= 0 && sl < S) store_row(row, W, vec, now);
  if (in_order && sl >= 0 && sl < S) {
    rcv_nxt[i] = wadd(rn, adv);
    bytes_received[i] += (long long)adv;
  }
  o_flags[h] = (int)in_order | (int)aligned << 1 |
               (int)(m_ooo && !aligned) << 2 |
               (int)(in_order && n_absorb > 0) << 3;
  o_adv[h] = adv;
  o_sack[h] = (int)(unsigned)(now & 0xFFFFFFFFull);
}

}  // namespace

extern "C" int tcp_reorder(const void* mask, const void* slot,
                           const void* seg_seq, const void* seg_len,
                           const void* state, void* rcv_nxt,
                           void* bytes_received, void* ooo_map,
                           void* o_flags, void* o_adv, void* o_sack, int H,
                           int S, int W, int mss, void* stream) {
  const bool vec =
      W % 16 == 0 && reinterpret_cast<std::uintptr_t>(ooo_map) % 16 == 0;
  if (H > 0)
    tcp_reorder_kernel<<<blocks(H), kThreads, 0, (cudaStream_t)stream>>>(
        (const bool*)mask, (const int*)slot, (const int*)seg_seq,
        (const int*)seg_len, (const int*)state, (int*)rcv_nxt,
        (long long*)bytes_received, (bool*)ooo_map, (int*)o_flags,
        (int*)o_adv, (int*)o_sack, H, S, W, mss, vec);
  return (int)cudaGetLastError();
}
