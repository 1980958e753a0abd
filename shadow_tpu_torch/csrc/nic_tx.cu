// K16 nic_tx: the direct send of every transmitting host, in one launch.
//
// Replaces the device work of shadow_tpu/net/stack.py:NetStack._tx (142)
// up to its emissions: the send bucket's lazy refill
// (shadow_tpu/net/nic.py:lazy_refill, K13's), the admission test, the
// token charge, the tx counters, and link.send (shadow_tpu/net/link.py:
// send, K15's) on the remote packets with its four counter sums. The
// caller keeps what depends on the order of emissions: the qdisc's note,
// the deliveries and the loopback emissions, the enqueue of the packets
// not admitted and the send pump.
//
// Per host h:
//   rem, tick  = the tx bucket refilled to now, where mask  (nic_common.cuh)
//   boot       = now < bootstrap_end
//   size       = the payload's wire size (W_LEN plus its header)
//   direct     = mask && !queued && (boot || rem >= MTU)
//   rem       -= size where direct && !boot                 (debt allowed)
//   tx_packets += direct;  tx_bytes += size where direct
//   remote     = direct && dst != gid;  loopback = direct && dst == gid
//   deliver, drop, arrival, counter = link.send's roll of the remote
//                packets, control packets (W_LEN == 0) never lost
//                                                        (link_common.cuh)
// and link.send's four counters (packets_sent, packets_dropped_loss,
// packets_dropped_unreachable, bytes_sent), each plus its sum over the
// hosts of remote, drop, remote && unreachable, size where remote.
// Everything is written out of place, into one int64 allocation that the
// wrapper slices into views: six rows [H] (rem, tick, tx_packets,
// tx_bytes, arrival, counter), the four counters, then four bool rows [H]
// (direct, deliver, drop, loopback). The arguments come packed in one
// host array of int64 (pointers, strides and sizes), which costs the
// caller less than one ctypes argument each.
//
// Bound: bytes (each host's mask, now, dst, queued flag, gid, bucket,
// tx counters, counter and two payload words in, and with several
// vertices its vertex, its destination's vertex and its path; the key
// pair of each host that draws; the rows out; the kernel reads every
// host's key pair, in the first round). The call is a few
// microseconds of device time: what it saves is the two launches (K13,
// K15) and the thirty-odd PyTorch operations around them on the host.
// Design: one thread a host issues every load it needs in one round, its
// key pair too (the path table, with several vertices, follows where it
// is needed), and stores only at the end. The sums go by warp shuffles
// and shared memory to four threads a block, each of which adds its sum
// into an accumulator word in device memory with one atomicAdd; after a
// fence, one thread a block takes a ticket from a fifth word. The block
// that takes the last ticket (gridDim.x - 1 before it) finds every sum
// complete: its four threads take the words' sums, setting them back to
// zero, write each counter plus its sum out, and zero the ticket for the
// next launch. So the call stays one launch (a memset of the output
// before it would be a device operation of its own, about as long as the
// kernel), with one round trip to the accumulators at its end, and its
// launches must not overlap (the port runs one stream). The ticket is a
// word of its own, so any number of blocks is exact, and each sum keeps
// all 64 bits (wrapping, as the counters' int64 additions do). Folding
// the counters in spares the caller four additions, each a launch.

#include "link_common.cuh"
#include "nic_common.cuh"

namespace {

// the launch's four sums and the count of blocks that have added theirs:
// zero between launches (the last block leaves them so)
__device__ unsigned long long g_sums[4];
__device__ unsigned int g_ticket;

constexpr int kWarps = nic::kBlock / 32;

struct Args {
  const bool* mask;
  const long long* now;
  const int* dst;
  const bool* queued;
  const int* gid;
  const long long *rem, *tick, *refill, *cap, *tx_packets, *tx_bytes;
  const int* payload;
  transit::Paths paths;
  const long long* keys;
  const long long* ctr;
  const long long* counters[4];
  long long bootstrap_end;
  long long payload_stride;
  long long* out;
  int now_stride, dst_stride, H;
};

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, o);
  return v;
}

__global__ void __launch_bounds__(nic::kBlock) nic_tx_kernel(Args a) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  const int H = a.H;
  unsigned long long sums[4] = {0, 0, 0, 0};  // sent, lost, unreachable, bytes
  // thread i < 4 carries counter i
  const long long before = threadIdx.x < 4 ? *a.counters[threadIdx.x] : 0;
  if (h < H) {
    // every load first
    const bool mask = a.mask[h];
    const long long now = a.now[(long long)h * a.now_stride];
    const int dst = a.dst[(long long)h * a.dst_stride];
    const bool queued = a.queued[h];
    const int gid = a.gid[h];
    const long long rem0 = a.rem[h], tick0 = a.tick[h];
    const long long refill = a.refill[h], cap = a.cap[h];
    const long long txp = a.tx_packets[h], txb = a.tx_bytes[h];
    const long long ctr = a.ctr[h];
    const long long k0 = a.keys[2 * h], k1 = a.keys[2 * h + 1];
    const int* w = a.payload + (long long)h * a.payload_stride;
    const int proto = w[nic::kWProto], len = w[nic::kWLen];
    long long lat;
    float rel;
    transit::lookup(a.paths, h, dst, lat, rel);

    long long rem = rem0, tick = tick0;
    if (mask) nic::refill(rem0, tick0, refill, cap, now, rem, tick);
    const bool boot = now < a.bootstrap_end;
    const long long size = nic::wire_bytes(proto, len);
    const bool direct = mask && !queued && (boot || rem >= nic::kMtu);
    if (direct && !boot) rem = nic::wsub(rem, size);
    const bool remote = direct && dst != gid;
    const transit::Roll r = transit::roll(remote, lat, rel, now,
                                          boot || len == 0, k0, k1, ctr);

    long long* o = a.out;
    o[h] = rem;
    o[H + h] = tick;
    o[2LL * H + h] = nic::wadd(txp, direct ? 1 : 0);
    o[3LL * H + h] = direct ? nic::wadd(txb, size) : txb;
    o[4LL * H + h] = r.arrival;
    o[5LL * H + h] = r.ctr;
    bool* b = (bool*)(o + 6LL * H + 4);
    b[h] = direct;
    b[H + h] = r.deliver;
    b[2LL * H + h] = r.drop;
    b[3LL * H + h] = direct && dst == gid;

    sums[0] = remote;
    sums[1] = r.drop;
    sums[2] = remote && !(r.deliver || r.drop);
    sums[3] = remote ? (unsigned long long)size : 0ULL;
  }
  __shared__ unsigned long long part[4][kWarps];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned long long v = warp_sum(sums[i]);
    if (lane == 0) part[i][warp] = v;
  }
  __syncthreads();
  if (threadIdx.x < 4) {
    const int i = threadIdx.x;
    unsigned long long v = 0;
    for (int j = 0; j < kWarps; ++j) v += part[i][j];
    if (v) atomicAdd(&g_sums[i], v);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&g_ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (last && threadIdx.x < 4) {
    // every other block has added: the words hold the launch's sums
    const int i = threadIdx.x;
    const unsigned long long total = atomicExch(&g_sums[i], 0ULL);
    a.out[6LL * H + i] = nic::wadd(before, (long long)total);
    if (i == 0) g_ticket = 0u;
  }
}

}  // namespace

// a: mask, now, now_stride, dst, dst_stride, queued, gid, rem, tick,
// refill, cap, tx_packets, tx_bytes, payload, payload_stride, vertex,
// vtab, T, lat_vv, rel_vv, U, keys, ctr, the four counters,
// bootstrap_end, out, H (kernels.nic_tx packs them in this order)
extern "C" int nic_tx(const long long* a, void* stream) {
  const int H = (int)a[29];
  Args k{(const bool*)a[0],
         (const long long*)a[1],
         (const int*)a[3],
         (const bool*)a[5],
         (const int*)a[6],
         (const long long*)a[7],
         (const long long*)a[8],
         (const long long*)a[9],
         (const long long*)a[10],
         (const long long*)a[11],
         (const long long*)a[12],
         (const int*)a[13],
         {(const int*)a[15], (const int*)a[16], (const long long*)a[18],
          (const float*)a[19], (int)a[20], (int)a[17]},
         (const long long*)a[21],
         (const long long*)a[22],
         {(const long long*)a[23], (const long long*)a[24],
          (const long long*)a[25], (const long long*)a[26]},
         a[27],
         a[14],
         (long long*)a[28],
         (int)a[2],
         (int)a[4],
         H};
  // one block at least: with no host it still writes the counters out
  const int blocks = H > 0 ? nic::blocks(H) : 1;
  nic_tx_kernel<<<blocks, nic::kBlock, 0, (cudaStream_t)stream>>>(k);
  return (int)cudaGetLastError();
}
