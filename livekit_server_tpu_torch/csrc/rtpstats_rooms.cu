// Phase-1 RTP statistics of the media-plane tick: the per-(track, layer)
// routing and the receiver-stats fold over the K packet slots of every
// (room, track), as one CUDA kernel for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package runs this block as XLA code
// (the one-hot routing in models/plane.py's room tick and a `lax.scan` in
// ops/rtpstats.py `update_tick`), which XLA fuses. The port's eager form
// of the same code is a Python loop over K of ~45 elementwise ops on
// [R, T*L] rows behind a one-hot routing stack [R, 5, T*L, K]: some 800
// launches a tick, more than half of the dense tick's host work. The
// plain PyTorch version is `route_stats` + `update_tick` in
// ops/rtpstats.py.
//
// What bounds it on the H100: bytes. The fold is a few dozen integer
// operations per packet; the floor is reading the seven packet fields, the
// track flag and the stats state once and writing the new state and the
// tracker sums once, over 3.35 TB/s (~50 MB, ~15 us at the north-star
// shape). The routing stack of the plain code is never formed.
//
// Design:
//  * One thread per (room, track). It holds that track's L = 3 stream rows
//    (ten fields each) and its 3 x 3 tracker sums in registers, and walks
//    the K packets in arrival order, so each packet is read once. Rows are
//    selected by an unrolled compare against the packet's lane, never by
//    a run-time index into a register array (which would spill to local
//    memory).
//  * Routing in registers: an invalid packet changes nothing (the plain
//    code's zeroed slot); a valid one folds into stats row is_svc ? 0 :
//    clamp(layer, 0, L-1) and adds to tracker row clamp(layer, 0, L-1).
//  * Packet fields are read with 16-byte loads, four packets at a time,
//    when K is a multiple of 4 and every field pointer is aligned for it
//    (the launcher checks); otherwise one packet at a time.
//  * Integer results are bit-equal to the plain code: every sum and
//    difference that may wrap is formed in uint32 (C's signed overflow is
//    undefined, torch's int32 wraps), |INT_MIN| stays INT_MIN as with
//    torch.abs, and the jitter step's floor division by 16 is an
//    arithmetic shift (C's `/` would truncate toward zero).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLayers = 3;         // stats rows a track (plane.MAX_LAYERS)
constexpr int kThreads = 128;

__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t wsub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}

// One stream row's receiver state (ops/rtpstats.py StreamStats, less the
// snapshot fields, which the tick does not touch).
struct Row {
  bool started;
  int32_t first_sn, highest_sn, sn_cycles, highest_ts, received, bytes, dups,
      jitter_q4, last_transit;
};

// Stats operands, in StreamStats field order: `started` (bool), then the
// nine int32 fields, each [R, T*L].
struct StatsIn {
  const uint8_t* started;
  const int32_t* f[9];
};
struct StatsOut {
  uint8_t* started;
  int32_t* f[9];
};

// The packet operands, [R, T, K].
struct Packets {
  const int32_t *sn, *ts, *size, *arrival, *layer;
  const uint8_t *valid, *begin_pic;
};

// update_tick's step for one valid packet of this row.
__device__ __forceinline__ void fold(Row& s, int32_t sn, int32_t ts, int32_t size,
                                     int32_t arrival) {
  const bool fresh = !s.started;
  const int32_t hi0 = fresh ? sn : s.highest_sn;
  // seqnum.diff16: ((sn - hi0 + 0x8000) & 0xFFFF) - 0x8000
  const int32_t d =
      static_cast<int32_t>((static_cast<uint32_t>(wsub(sn, hi0)) + 0x8000u) & 0xFFFFu) - 0x8000;
  const bool newer = d > 0;
  if (fresh) s.first_sn = sn;
  if (!fresh && d <= 0) s.dups = wadd(s.dups, 1);
  if (newer && sn < hi0) s.sn_cycles = wadd(s.sn_cycles, 1);
  if (fresh || wsub(ts, s.highest_ts) > 0) s.highest_ts = ts;
  const int32_t transit = wsub(arrival, ts);
  if (!fresh) {
    const int32_t dt = wsub(transit, s.last_transit);
    const int32_t dtr = dt < 0 ? wsub(0, dt) : dt;                 // |INT_MIN| = INT_MIN
    const int32_t x = wsub(static_cast<int32_t>(static_cast<uint32_t>(dtr) << 4), s.jitter_q4);
    s.jitter_q4 = wadd(s.jitter_q4, x >> 4);                       // floor(x / 16)
  }
  s.highest_sn = (newer || fresh) ? sn : hi0;
  s.started = true;
  s.received = wadd(s.received, 1);
  s.bytes = wadd(s.bytes, size);
  s.last_transit = transit;
}

struct Track {
  Row row[kLayers];
  uint32_t pkts[kLayers], bytes[kLayers], frames[kLayers];   // tracker sums
  bool svc;

  __device__ __forceinline__ void packet(int32_t sn, int32_t ts, int32_t size,
                                         int32_t arrival, int32_t layer, bool valid,
                                         bool begin_pic) {
    if (!valid) return;
    const int tl = layer < 0 ? 0 : (layer > kLayers - 1 ? kLayers - 1 : layer);
    const int sl = svc ? 0 : tl;
#pragma unroll
    for (int l = 0; l < kLayers; ++l) {
      if (l == sl) fold(row[l], sn, ts, size, arrival);
      if (l == tl) {
        pkts[l] += 1u;
        bytes[l] += static_cast<uint32_t>(size);
        frames[l] += begin_pic ? 1u : 0u;
      }
    }
  }
};

// `vec`: K is a multiple of 4 and the packet fields are aligned for 16-byte
// (int32) and 4-byte (bool) loads at every fourth packet.
__global__ void __launch_bounds__(kThreads) rtpstats_rooms_kernel(
    Packets p, const uint8_t* __restrict__ is_svc, StatsIn in, StatsOut out,
    int32_t* __restrict__ tr, long long RT, int T, int K, bool vec) {
  const long long rt = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (rt >= RT) return;
  Track tk;
  tk.svc = is_svc[rt] != 0;
#pragma unroll
  for (int l = 0; l < kLayers; ++l) {
    const long long i = rt * kLayers + l;
    Row& s = tk.row[l];
    s.started = in.started[i] != 0;
    s.first_sn = in.f[0][i];
    s.highest_sn = in.f[1][i];
    s.sn_cycles = in.f[2][i];
    s.highest_ts = in.f[3][i];
    s.received = in.f[4][i];
    s.bytes = in.f[5][i];
    s.dups = in.f[6][i];
    s.jitter_q4 = in.f[7][i];
    s.last_transit = in.f[8][i];
    tk.pkts[l] = tk.bytes[l] = tk.frames[l] = 0u;
  }

  const long long base = rt * K;
  if (vec) {
    for (int k = 0; k < K; k += 4) {
      const long long o = base + k;
      const int4 sn = *reinterpret_cast<const int4*>(p.sn + o);
      const int4 ts = *reinterpret_cast<const int4*>(p.ts + o);
      const int4 sz = *reinterpret_cast<const int4*>(p.size + o);
      const int4 ar = *reinterpret_cast<const int4*>(p.arrival + o);
      const int4 ly = *reinterpret_cast<const int4*>(p.layer + o);
      const uchar4 v = *reinterpret_cast<const uchar4*>(p.valid + o);
      const uchar4 bp = *reinterpret_cast<const uchar4*>(p.begin_pic + o);
      tk.packet(sn.x, ts.x, sz.x, ar.x, ly.x, v.x != 0, bp.x != 0);
      tk.packet(sn.y, ts.y, sz.y, ar.y, ly.y, v.y != 0, bp.y != 0);
      tk.packet(sn.z, ts.z, sz.z, ar.z, ly.z, v.z != 0, bp.z != 0);
      tk.packet(sn.w, ts.w, sz.w, ar.w, ly.w, v.w != 0, bp.w != 0);
    }
  } else {
    for (int k = 0; k < K; ++k) {
      const long long o = base + k;
      tk.packet(p.sn[o], p.ts[o], p.size[o], p.arrival[o], p.layer[o], p.valid[o] != 0,
                p.begin_pic[o] != 0);
    }
  }

  // tr [R, 3, T*L]: row (track t, layer l) of room r at r*3*T*L + q*T*L + t*L + l.
  const long long r = rt / T, t = rt % T;
  const long long N = static_cast<long long>(T) * kLayers;
#pragma unroll
  for (int l = 0; l < kLayers; ++l) {
    const long long i = rt * kLayers + l;
    const Row& s = tk.row[l];
    out.started[i] = s.started ? 1 : 0;
    out.f[0][i] = s.first_sn;
    out.f[1][i] = s.highest_sn;
    out.f[2][i] = s.sn_cycles;
    out.f[3][i] = s.highest_ts;
    out.f[4][i] = s.received;
    out.f[5][i] = s.bytes;
    out.f[6][i] = s.dups;
    out.f[7][i] = s.jitter_q4;
    out.f[8][i] = s.last_transit;
    const long long j = r * 3 * N + t * kLayers + l;
    tr[j] = static_cast<int32_t>(tk.pkts[l]);
    tr[j + N] = static_cast<int32_t>(tk.bytes[l]);
    tr[j + 2 * N] = static_cast<int32_t>(tk.frames[l]);
  }
}

bool aligned(const void* ptr, uintptr_t to) {
  return (reinterpret_cast<uintptr_t>(ptr) % to) == 0;
}

}  // namespace

// Operands: packets sn, ts, size, arrival_rtp, layer (int32) and valid,
// begin_pic (bool), [R, T, K]; is_svc (bool) [R, T]; the stats state in
// StreamStats field order (`started` bool, nine int32), each [R, T*L];
// outputs the new state in the same order and tr [R, 3, T*L] int32.
extern "C" int rtpstats_rooms_launch(
    const void* sn, const void* ts, const void* size, const void* arrival,
    const void* layer, const void* valid, const void* begin_pic, const void* is_svc,
    const void* const* state_in, void* const* state_out, void* tr, int R, int T, int K,
    void* stream) {
  const long long RT = static_cast<long long>(R) * T;
  if (RT <= 0 || K <= 0) return static_cast<int>(cudaGetLastError());
  Packets p{static_cast<const int32_t*>(sn), static_cast<const int32_t*>(ts),
            static_cast<const int32_t*>(size), static_cast<const int32_t*>(arrival),
            static_cast<const int32_t*>(layer), static_cast<const uint8_t*>(valid),
            static_cast<const uint8_t*>(begin_pic)};
  StatsIn in{static_cast<const uint8_t*>(state_in[0]), {}};
  StatsOut out{static_cast<uint8_t*>(state_out[0]), {}};
  for (int i = 0; i < 9; ++i) {
    in.f[i] = static_cast<const int32_t*>(state_in[i + 1]);
    out.f[i] = static_cast<int32_t*>(state_out[i + 1]);
  }
  const bool vec = K % 4 == 0 && aligned(sn, 16) && aligned(ts, 16) && aligned(size, 16) &&
                   aligned(arrival, 16) && aligned(layer, 16) && aligned(valid, 4) &&
                   aligned(begin_pic, 4);
  const unsigned blocks = static_cast<unsigned>((RT + kThreads - 1) / kThreads);
  rtpstats_rooms_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<const uint8_t*>(is_svc), in, out, static_cast<int32_t*>(tr), RT, T, K,
      vec);
  return static_cast<int>(cudaGetLastError());
}
