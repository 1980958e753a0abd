// K22 qdisc_enqueue: one packet a masked host into its device-queue
// discipline (pifo or eiffel), in place.
//
// Replaces shadow_tpu/net/qdisc/pifo.py:DeviceQueueDiscipline.enqueue
// (178) with its parts: the depth and room of the representation
// (pifo.py:_depth/_room, eiffel.py:_depth/_room), RED
// (drops.py:red_enqueue, 62), the rank (ranks.py:Ranker.rank, 79: fifo,
// prio or wfq, then the shaping term), the insert (pifo.py:_insert, 132:
// the stable compare-and-place and the right shift of every slot from the
// position to the end of the row; eiffel.py:_insert, 63: the first free
// slot and its bucket) and the counters.
//
// Per host h:
//   depth, room  = pifo: q_len, q_len < Q; eiffel: valid slots, any free
//   attempt      = mask && room
//   RED          avg += ((depth << 8) - avg) >> 3 where attempt;
//                p = (avg - min_fp) * scale, interval = ceil(1 / max(p,
//                1e-9)) in float64 (scale = max_p * (1 / (max_fp -
//                min_fp)): XLA folds the division by the constant span
//                into that multiply); drop at or above max_fp, or between
//                the thresholds every interval-th attempt
//   ok           = attempt && !drop
//   class        = cls[h] >= 0 ? cls[h] : socket mod C (floor)
//   rank         = 0 | priority word | max(vtime, finish[c]) + size *
//                inv_w[c] (wfq, finish[c] set where ok); shaped classes:
//                elig = max(now, shape_next[c]), shape_next[c] = elig +
//                size * ns_per_byte[c] where ok, rank = max(rank, elig)
//   insert       where ok, at seq[h] and now
//   q_bytes += size, seq, enqueues += ok; drops_overflow += mask && !room;
//   depth_peak = max(depth_peak, depth + ok)
// The rank and the insert run only where ok, as their results are used
// only there (now is NEVER on lanes without an event). The plane's cells
// that the JAX package leaves as they were stay untouched; PIFO's shift
// writes every slot past the position, as pifo.py:_shift_insert does.
//
// Bound: bytes. The function reads each host's per-host state and row
// (pifo: the ranks of its queued packets; eiffel: its valid flags) and
// writes each admitted packet's slot, and for PIFO every slot after the
// insert position. Design: one thread a host, the discipline, ranker,
// drop policy and shaping as runtime flags the whole block agrees on;
// the row is walked by its thread (rows hold at most Q = 64 slots of
// 76 bytes); coalescing the walk across a warp is later work.

#include "qdisc_common.cuh"

#include <cstring>

namespace {

using namespace qdisc;

enum { kRankFifo = 0, kRankPrio = 1, kRankWfq = 2 };
enum { kDropNone = 0, kDropRed = 1, kDropCodel = 2 };

struct Args {
  Plane s;
  const bool* mask;
  const int* dst;
  const int* payload;
  const long long* now;
  const long long* inv_w;
  const long long* ns_per_byte;
  bool* ok;
  long long dst_stride, payload_stride, now_stride;
  int H, Q, P, C, eiffel, rank, shaped, drop;
  long long buckets, bucket_width, min_fp, max_fp;
  double scale;
};

__global__ void __launch_bounds__(kBlock) qdisc_enqueue_kernel(Args a) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= a.H) return;
  const Plane& s = a.s;
  const int Q = a.Q, P = a.P, C = a.C;
  const long long row = (long long)h * Q;
  const bool m = a.mask[h];

  // depth and room (eiffel: the first free slot, 0 where none)
  long long depth = 0;
  bool room;
  int free_slot = -1;
  if (a.eiffel) {
    for (int j = 0; j < Q; ++j) {
      if (s.q_valid[row + j])
        ++depth;
      else if (free_slot < 0)
        free_slot = j;
    }
    room = free_slot >= 0;
  } else {
    depth = s.q_len[h];
    room = s.q_len[h] < Q;
  }
  const bool attempt = m && room;

  bool red_drop = false;
  if (a.drop == kDropRed) {
    long long avg = s.red_avg[h];
    if (attempt) avg = avg + (((depth << 8) - avg) >> 3);
    const bool over = avg >= a.max_fp;
    const bool between = avg >= a.min_fp && !over;
    const double p = __dmul_rn((double)(avg - a.min_fp), a.scale);
    const long long interval =
        (long long)ceil(__ddiv_rn(1.0, fmax(p, 1e-9)));
    const long long cnt = s.red_count[h] + (attempt ? 1 : 0);
    red_drop = attempt && (over || (between && cnt >= interval));
    s.red_avg[h] = avg;
    s.red_count[h] = (red_drop || !between) ? 0 : cnt;
    s.drops_red[h] += red_drop ? 1 : 0;
  }
  const bool ok = attempt && !red_drop;

  if (ok) {
    const int* pl = a.payload + (long long)h * a.payload_stride;
    const long long now = a.now[(long long)h * a.now_stride];
    const int dst = a.dst[(long long)h * a.dst_stride];
    const long long size = codel::wire_bytes(pl);
    int c = s.cls[h];
    if (c < 0) c = (int)floor_mod(pl[kWSocket], C);
    // jnp's gather of the class tables clamps the index; get_at / set_at
    // of the [H, C] planes read 0 and write nothing outside [0, C)
    const int ci = c < 0 ? 0 : (c >= C ? C - 1 : c);
    const bool in_c = c >= 0 && c < C;
    const long long cell = (long long)h * C + c;

    long long rank = 0;
    if (a.rank == kRankWfq) {
      const long long start = lmax(s.vtime[h], in_c ? s.finish[cell] : 0);
      rank = wadd(start, wmul(size, a.inv_w[ci]));
      if (in_c) s.finish[cell] = rank;
    } else if (a.rank == kRankPrio) {
      rank = pl[kWPriority];
    }
    if (a.shaped) {
      const long long npb = a.ns_per_byte[ci];
      if (npb > 0) {
        const long long elig = lmax(now, in_c ? s.shape_next[cell] : 0);
        if (in_c) s.shape_next[cell] = wadd(elig, wmul(size, npb));
        rank = lmax(rank, elig);
      }
    }

    int slot;
    if (a.eiffel) {
      slot = free_slot;
      s.q_valid[row + slot] = true;
      s.q_bucket[row + slot] =
          floor_mod(floor_div(rank, a.bucket_width), a.buckets);
    } else {
      // stable compare-and-place: the count of queued ranks <= rank
      const int len = s.q_len[h];
      slot = 0;
      for (int j = 0; j < len; ++j) slot += s.q_rank[row + j] <= rank;
      for (int j = Q - 1; j > slot; --j) {
        int* to = s.q_payload + (row + j) * P;
        copy_words(to, to - P, P);
        s.q_dst[row + j] = s.q_dst[row + j - 1];
        s.q_rank[row + j] = s.q_rank[row + j - 1];
        s.q_seq[row + j] = s.q_seq[row + j - 1];
        s.q_enq_ts[row + j] = s.q_enq_ts[row + j - 1];
      }
      s.q_len[h] = len + 1;
    }
    copy_words(s.q_payload + (row + slot) * P, pl, P);
    s.q_dst[row + slot] = dst;
    s.q_rank[row + slot] = rank;
    s.q_seq[row + slot] = s.seq[h];
    s.q_enq_ts[row + slot] = now;
    s.q_bytes[h] = wadd(s.q_bytes[h], size);
    s.seq[h] += 1;
    s.enqueues[h] += 1;
  }
  if (m && !room) s.drops_overflow[h] += 1;
  s.depth_peak[h] = lmax(s.depth_peak[h], depth + (ok ? 1 : 0));
  a.ok[h] = ok;
}

}  // namespace

// a: the kFields field pointers (kernels.QDISC_FIELDS), then mask, dst,
// dst_stride, payload, payload_stride, now, now_stride, inv_w,
// ns_per_byte, ok, H, Q, P, C, eiffel, rank, shaped, drop, buckets,
// bucket_width, min_fp, max_fp and the bits of scale (kernels.qdisc_enqueue
// packs them in this order)
extern "C" int qdisc_enqueue(const long long* a, void* stream) {
  Args k;
  k.s = unpack(a);
  const long long* b = a + kFields;
  k.mask = (const bool*)b[0];
  k.dst = (const int*)b[1];
  k.dst_stride = b[2];
  k.payload = (const int*)b[3];
  k.payload_stride = b[4];
  k.now = (const long long*)b[5];
  k.now_stride = b[6];
  k.inv_w = (const long long*)b[7];
  k.ns_per_byte = (const long long*)b[8];
  k.ok = (bool*)b[9];
  k.H = (int)b[10];
  k.Q = (int)b[11];
  k.P = (int)b[12];
  k.C = (int)b[13];
  k.eiffel = (int)b[14];
  k.rank = (int)b[15];
  k.shaped = (int)b[16];
  k.drop = (int)b[17];
  k.buckets = b[18];
  k.bucket_width = b[19];
  k.min_fp = b[20];
  k.max_fp = b[21];
  std::memcpy(&k.scale, &b[22], sizeof(double));
  if (k.P > kMaxP || k.Q < 1 || k.C < 1) return (int)cudaErrorInvalidValue;
  if (k.H > 0) {
    qdisc_enqueue_kernel<<<blocks(k.H), kBlock, 0, (cudaStream_t)stream>>>(k);
  }
  return (int)cudaGetLastError();
}
