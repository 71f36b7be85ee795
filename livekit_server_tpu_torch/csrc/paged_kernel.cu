// Phase 0 of the live-extent paged tick for every LIVE page, as one CUDA
// kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel livekit_server_tpu/ops/paged_kernel.py
// `_page_kernel` (driven by `_pallas_live_call`, entries `decide_pages`,
// `mix_pages`, `decide_mix_pages`). The page pool holds P pages, each a
// [TP, K, SP] block of one room's (track, packet, subscriber) plane. Entry
// i of `live_rows` names the pool page whose slice of every pooled operand
// gives compact entry i of every output, so dead pages are never read.
// Padded duplicate entries repeat a live page and write distinct compact
// entries: no two threads write the same address.
//
// For each entry it computes:
//  * decide (with_decide): ops/selector.py `decide_rooms` at page shape —
//    the simulcast and SVC state machines (select_step.cuh) over the K
//    packets, base merge, audio path, send/drop/switch mask words (SP <= 32:
//    one word per (track, packet)), per-subscriber packets/bytes (+ wire
//    overhead) and per-page totals (bytes without the overhead);
//  * the stats/tracker routing of models/plane.py `route_stats`:
//    st[f, tp*L + l, k] = field f of packet (tp, k) where its effective
//    layer (0 for SVC tracks, else clip(layer)) is l, else 0;
//    tr[f, tp*L + l] = sum over k of (1, size, 1) where clip(layer) == l
//    and (valid, valid, valid && begin_pic);
//  * mix (with_mix): ops/mix.py `mix_tick` before its tanh — the top-K
//    speaker gate thr = min{lv : #{lv' > lv} < K} over lv = active ? level
//    : -1 (ties at the threshold all speak), self-exclusion, gain, and the
//    weighted sum over tracks in track order with __fmul_rn/__fadd_rn, so
//    nvcc cannot contract it into FMAs and it equals the plain version bit
//    for bit.
// The plain PyTorch versions are `decide_pages_plain` / `mix_pages_plain`
// in ops/paged_kernel.py.
//
// What bounds it on the H100: bytes — about 1.5 KB read and 2.8 KB
// written per page at (TP, K, SP) = (4, 8, 8), most of the writes the
// routed stats, over 3.35 TB/s. Each page is many small spans gathered
// from 18 pooled arrays, so the reads run well below that rate, and each
// page's decide is a short chain of dependent steps; the design keeps a
// tile's loads in flight at once and spends few instructions per page
// (PERF.md has its time against the bound).
//
// Design:
//  * Persistent blocks of 256 threads, four on an SM, each walking tiles of
//    pb consecutive entries of live_rows: pb as large as a 54 KB tile allows,
//    then lowered so the tiles spread evenly over the blocks. A tile's row
//    ids are loaded while the tile before it computes.
//  * Staging: each page's slice of every decide operand is one span (128 B
//    for an int32 packet or state field at (4, 8, 8), 32 B for a bool
//    field, 4 B for is_svc/is_video), copied to the start of its slot in
//    shared memory by cp.async of 16 bytes when every span of its class
//    is 16-byte aligned (on the main path all but is_svc/is_video), of 4
//    bytes when 4-byte aligned, else by plain byte loads. Every copy of a
//    tile is in flight at once.
//  * Per packet, once per tile (one thread per (page, track, packet)): the
//    packet is packed into an int4 {layer, temporal, size, flags}, its
//    track's kind (SVC, video) among the flags; its five routed stats
//    fields go straight to global memory (the one-hot row of each field: L
//    stores each, full 32-byte sectors across a warp at K = 8); its tracker
//    counts go to shared per-(page, track, layer) sums by atomics.
//    Quotients by the geometry are one multiply (FastDiv), so nothing is
//    divided per element; offsets in a tile are 32-bit.
//  * Decide: a track's subscribers sit on consecutive lanes (SP rounded up
//    to a power of two, spw), the tracks of consecutive pages fill a warp,
//    and a lane carries its (track, subscriber) selector state in
//    registers across the K packets. Lane s of each track owns slots s,
//    s + spw, ...: one ballot of the owners' validity gives the slots of a
//    chunk that some track of the warp uses, and the warp steps only over
//    those (most slots of a tick are empty: an audio track sends one packet
//    a tick). It runs only the state machines and votes that some track of
//    it needs (a warp holds tracks of different kinds). One __ballot_sync
//    per slot and mask gives every track's word of the warp (unsigned, so
//    bit 31 at SP = 32 is well defined); the slot's owner keeps its words
//    and stores them after the chunk, so a warp's mask stores are
//    contiguous when spw = K.
//  * The new layers and need_kf go straight from the lanes (a warp's stores
//    are contiguous); per-subscriber and tracker sums, uint32 in shared
//    memory (they wrap like the reference's int32 sums and are exact in
//    any order), leave a tile as contiguous spans.
//  * The mix (off the main path) runs per tile after the decide: the gate's
//    per-page values in shared memory, then one thread per (page, column of
//    4 samples) summing the tracks for every subscriber.
//  * A row id outside [0, P) traps: the error surfaces at the next
//    synchronisation instead of reading another buffer.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "select_step.cuh"
#include "staging.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 4;             // caps registers at 64 a thread
constexpr size_t kBlockSmem = 54 * 1024;   // four blocks on an SM
constexpr int kMaxTilePages = 64;
constexpr int kLayers = 3;                 // stats rows a track (plane.MAX_LAYERS)
constexpr unsigned kFull = 0xffffffffu;

using select_step::kEndFrame;
using select_step::kKeyframe;
using select_step::kSync;
using select_step::kValid;
// Track kind, carried in every packed packet's flags.
constexpr int kSvcTrack = 16, kVideoTrack = 32;

// Decide operands in staging order, grouped in classes by the shape of a
// page's slice.
enum Op {
  kCurSp, kCurTp, kTgtSp, kTgtTp,                   // int32 [TP, SP]
  kLayer, kTemporal, kSize, kSn, kTs, kArrival,     // int32 [TP, K]
  kIsKeyframe, kIsSync, kIsEndFrame, kIsValid, kIsBeginPic,  // bool [TP, K]
  kBase,                                            // bool [TP, SP]
  kSvc, kVideo,                                     // bool [TP]
  kOps
};
enum Class { kSubI32, kPktI32, kPktU8, kSubU8, kTrackU8, kClasses };

__host__ __device__ constexpr int class_of(int op) {
  return op < kLayer ? kSubI32
         : op < kIsKeyframe ? kPktI32
         : op < kBase ? kPktU8
         : op == kBase ? kSubU8 : kTrackU8;
}

struct Ops {
  const unsigned char* p[kOps];
};

struct Outs {
  int32_t *send, *drop, *sw;      // [NL, TP, K]
  int32_t *out_sp, *out_tp;       // [NL, TP, SP]
  uint8_t* need_kf;               // [NL, TP, SP]
  int32_t *pkts, *bytes;          // [NL, SP]
  int32_t *fwd_pkts, *fwd_bytes;  // [NL]
  int32_t* st;                    // [NL, 5, TP*L, K]
  int32_t* tr;                    // [NL, 3, TP*L]
};

struct MixIn {
  const float* pcm;          // [P, TP, N]
  const float* level;        // [P, TP]
  const uint8_t* active;     // [P, TP]
  const float* gain;         // [P, TP]
  const int32_t* sub_track;  // [P, SP]
};

// q / d by one multiply, m = ceil(2^32 / d): exact while q * d < 2^32,
// which holds for every quotient taken here: q and d are both counts of
// one tile's 4-byte words or less, and a tile fits 227 KB.
struct FastDiv {
  unsigned long long m;
  __device__ __forceinline__ unsigned operator()(unsigned q) const {
    return static_cast<unsigned>((q * m) >> 32);
  }
};

FastDiv fast_div(unsigned d) {
  d = d > 0 ? d : 1;  // a mix-only launch has no packets
  return {((1ull << 32) + d - 1) / d};
}

// Byte offsets into a block's shared memory for tiles of pb pages, and the
// geometry's divisors. Operand op's span for tile page j starts at
// in[op] + j * stride[class_of(op)].
struct Layout {
  unsigned span[kClasses], stride[kClasses], chunks[kClasses], words[kClasses], in[kOps];
  FastDiv by_chunks[kClasses], by_words[kClasses], by_tpk, by_k, by_tp;
  unsigned rows, packed, sums[2], tr, lv, cnt, thr, w;
  unsigned aligned;   // bit c: class c is staged by 16-byte copies alone
  unsigned aligned4;  // bit c: else by 4-byte copies
};

// Fills *lay and returns the bytes of shared memory it needs.
size_t make_layout(Layout* lay, int TP, int K, int SP, int pb, unsigned aligned,
                   unsigned aligned4, bool decide, bool mix) {
  const size_t n = static_cast<size_t>(pb);
  const size_t spans[kClasses] = {static_cast<size_t>(TP) * SP * 4,
                                  static_cast<size_t>(TP) * K * 4,
                                  static_cast<size_t>(TP) * K, static_cast<size_t>(TP) * SP,
                                  static_cast<size_t>(TP)};
  size_t o = 0;
  auto take = [&o](size_t bytes) {
    const size_t at = o;
    o += (bytes + 15) & ~static_cast<size_t>(15);
    return static_cast<unsigned>(at);
  };
  lay->aligned = aligned;
  lay->aligned4 = aligned4;
  lay->rows = take(n * 4);
  for (int c = 0; c < kClasses; ++c) {
    lay->span[c] = static_cast<unsigned>(spans[c]);
    lay->stride[c] = static_cast<unsigned>((spans[c] + 15) & ~static_cast<size_t>(15));
    lay->chunks[c] = static_cast<unsigned>(spans[c] / 16);
    lay->by_chunks[c] = fast_div(lay->chunks[c]);
    lay->words[c] = static_cast<unsigned>(spans[c] / 4);
    lay->by_words[c] = fast_div(lay->words[c]);
  }
  lay->by_tpk = fast_div(static_cast<unsigned>(TP * K));
  lay->by_k = fast_div(static_cast<unsigned>(K));
  lay->by_tp = fast_div(static_cast<unsigned>(TP));
  for (int op = 0; op < kOps; ++op) lay->in[op] = take(decide ? n * lay->stride[class_of(op)] : 0);
  lay->packed = take(decide ? n * TP * K * 16 : 0);
  for (int m = 0; m < 2; ++m) lay->sums[m] = take(decide ? n * SP * 4 : 0);
  lay->tr = take(decide ? n * 3 * TP * kLayers * 4 : 0);
  lay->lv = take(mix ? n * TP * 4 : 0);
  lay->cnt = take(mix ? n * TP * 4 : 0);
  lay->thr = take(mix ? n * 4 : 0);
  lay->w = take(mix ? n * SP * TP * 4 : 0);
  return o;
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

// Copy the tile pages' spans of operands First..First+Count-1 (one class)
// to the starts of their slots, by cp.async of 16 bytes (the class is
// 16-byte aligned) or of 4 bytes (4-byte aligned), complete after the
// caller's commit/wait, else by plain byte loads.
template <int First, int Count>
__device__ __forceinline__ void stage_class(unsigned char* smem, const Layout& lay,
                                            const Ops& in, const int* rows, int pages,
                                            int tid) {
  constexpr int c = class_of(First);
  const unsigned n = lay.span[c], stride = lay.stride[c];
  if (lay.aligned >> c & 1u) {
    const unsigned chunks = lay.chunks[c];
    for (unsigned x = tid; x < pages * chunks; x += kThreads) {
      const unsigned j = lay.by_chunks[c](x), q = (x - j * chunks) * 16;
      const size_t g = static_cast<size_t>(rows[j]) * n + q;
      const unsigned d = j * stride + q;
#pragma unroll
      for (int u = 0; u < Count; ++u) {
        staging::cp_async16(smem + lay.in[First + u] + d, in.p[First + u] + g);
      }
    }
  } else if (lay.aligned4 >> c & 1u) {
    const unsigned words = lay.words[c];
    for (unsigned x = tid; x < pages * words; x += kThreads) {
      const unsigned j = lay.by_words[c](x), q = (x - j * words) * 4;
      const size_t g = static_cast<size_t>(rows[j]) * n + q;
      const unsigned d = j * stride + q;
#pragma unroll
      for (int u = 0; u < Count; ++u) cp_async4(smem + lay.in[First + u] + d, in.p[First + u] + g);
    }
  } else {
    for (unsigned x = tid; x < pages * n; x += kThreads) {
      const unsigned j = x / n, e = x - j * n;
      const size_t g = static_cast<size_t>(rows[j]) * n + e;
#pragma unroll
      for (int u = 0; u < Count; ++u) smem[lay.in[First + u] + j * stride + e] = in.p[First + u][g];
    }
  }
}

// The mix's weighted sums for the tile's pages, V samples a thread.
template <int V>
__device__ __forceinline__ void mix_columns(const MixIn& mx, float* mixed, const float* w,
                                            const int* rows, long long i0, int pages, int TP,
                                            int SP, int N, int tid) {
  const unsigned cols = N / V;
  for (unsigned x = tid; x < static_cast<unsigned>(pages) * cols; x += kThreads) {
    const unsigned j = x / cols, c = (x - j * cols) * V;
    const float* src = mx.pcm + static_cast<size_t>(rows[j]) * TP * N + c;
    float* dst = mixed + static_cast<size_t>(i0 + j) * SP * N + c;
    const float* wj = w + j * SP * TP;
    for (int s = 0; s < SP; ++s) {
      float acc[V];
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = 0.0f;
      for (int t = 0; t < TP; ++t) {
        const float ws = wj[s * TP + t];
        const float* xs = src + static_cast<size_t>(t) * N;
        float v[V];
        if constexpr (V == 4) {
          const float4 q = __ldg(reinterpret_cast<const float4*>(xs));
          v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
        } else {
          v[0] = __ldg(xs);
        }
#pragma unroll
        for (int e = 0; e < V; ++e) acc[e] = __fadd_rn(acc[e], __fmul_rn(ws, v[e]));
      }
      float* o = dst + static_cast<size_t>(s) * N;
      if constexpr (V == 4) {
        *reinterpret_cast<float4*>(o) = make_float4(acc[0], acc[1], acc[2], acc[3]);
      } else {
        o[0] = acc[0];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks) paged_kernel(
    const int32_t* __restrict__ live_rows, const Ops in, const Outs out, const MixIn mx,
    float* __restrict__ mixed, const Layout lay, int NL, int P, int TP, int K, int SP,
    int lg_spw, int N, int pb, unsigned overhead, int top_k, int with_decide, int with_mix,
    int vec4) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* rows = reinterpret_cast<int*>(smem + lay.rows);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned TPK = TP * K, TL = TP * kLayers;
  const long long tiles = (static_cast<long long>(NL) + pb - 1) / pb;
  const long long step = gridDim.x;

  long long tile = blockIdx.x;
  int next = (tid < pb && tile * pb + tid < NL) ? live_rows[tile * pb + tid] : 0;
  for (; tile < tiles; tile += step) {
    const long long i0 = tile * pb;
    const int pages = static_cast<int>(NL - i0 < pb ? NL - i0 : pb);
    if (tid < pages) {
      if (next < 0 || next >= P) __trap();
      rows[tid] = next;
    }
    // The tile's per-subscriber and tracker sums start at 0.
    uint32_t* sh_pkts = reinterpret_cast<uint32_t*>(smem + lay.sums[0]);
    uint32_t* sh_bytes = reinterpret_cast<uint32_t*>(smem + lay.sums[1]);
    uint32_t* sh_tr = reinterpret_cast<uint32_t*>(smem + lay.tr);
    if (with_decide) {
      for (int x = tid; x < pages * SP; x += kThreads) sh_pkts[x] = sh_bytes[x] = 0u;
      for (unsigned x = tid; x < pages * 3 * TL; x += kThreads) sh_tr[x] = 0u;
    }
    __syncthreads();
    {
      const long long n0 = i0 + step * pb;
      next = (tid < pb && n0 + tid < NL) ? live_rows[n0 + tid] : 0;
    }

    if (with_decide) {
      stage_class<kCurSp, 4>(smem, lay, in, rows, pages, tid);
      stage_class<kLayer, 6>(smem, lay, in, rows, pages, tid);
      stage_class<kIsKeyframe, 5>(smem, lay, in, rows, pages, tid);
      stage_class<kBase, 1>(smem, lay, in, rows, pages, tid);
      stage_class<kSvc, 2>(smem, lay, in, rows, pages, tid);
      staging::commit();
      staging::wait<0>();
      __syncthreads();

      // -- per packet: pack, route the stats, sum the tracker rows --------
      int4* packed = reinterpret_cast<int4*>(smem + lay.packed);
      int32_t* st = out.st + i0 * 5 * TL * K;
      const unsigned TLK = TL * K;
      for (unsigned q = tid; q < pages * TPK; q += kThreads) {
        const unsigned j = lay.by_tpk(q), r = q - j * TPK, t = lay.by_k(r), k = r - t * K;
        const unsigned char* p32 = smem + j * lay.stride[kPktI32] + r * 4;
        const unsigned char* p8 = smem + j * lay.stride[kPktU8] + r;
        const unsigned char* pt = smem + j * lay.stride[kTrackU8] + t;
        auto i32 = [&](int op) { return *reinterpret_cast<const int32_t*>(p32 + lay.in[op]); };
        auto u8 = [&](int op) { return p8[lay.in[op]] != 0; };
        const bool svc = pt[lay.in[kSvc]] != 0;
        const int layer = i32(kLayer), size = i32(kSize);
        const bool valid = u8(kIsValid);
        const int flags = (u8(kIsKeyframe) ? kKeyframe : 0) | (u8(kIsSync) ? kSync : 0) |
                          (u8(kIsEndFrame) ? kEndFrame : 0) | (valid ? kValid : 0) |
                          (svc ? kSvcTrack : 0) | (pt[lay.in[kVideo]] ? kVideoTrack : 0);
        packed[q] = make_int4(layer, i32(kTemporal), size, flags);
        const int lane_l = layer < 0 ? 0 : (layer > kLayers - 1 ? kLayers - 1 : layer);
        const int eff = svc ? 0 : lane_l;
        const int v[5] = {i32(kSn), i32(kTs), size, i32(kArrival), valid ? 1 : 0};
        int32_t* o = st + j * 5 * TLK + t * kLayers * K + k;
#pragma unroll
        for (int f = 0; f < 5; ++f) {
#pragma unroll
          for (int l = 0; l < kLayers; ++l) o[f * TLK + l * K] = l == eff ? v[f] : 0;
        }
        if (valid) {
          uint32_t* tr = sh_tr + j * 3 * TL + t * kLayers + lane_l;
          atomicAdd(tr, 1u);
          atomicAdd(tr + TL, static_cast<unsigned>(size));
          if (u8(kIsBeginPic)) atomicAdd(tr + 2 * TL, 1u);
        }
      }
      __syncthreads();

      // -- decide: warps over groups of tracks ------------------------------
      const int spw = 1 << lg_spw;
      const int G = 32 >> lg_spw;        // tracks a warp
      const int g = lane >> lg_spw;
      const int s = lane & (spw - 1);
      const unsigned group = spw == 32 ? kFull : ((1u << spw) - 1u);
      const unsigned low = SP == 32 ? kFull : ((1u << SP) - 1u);
      const unsigned ntr = pages * TP;
      int32_t* out_sp = out.out_sp + i0 * TP * SP;
      int32_t* out_tp = out.out_tp + i0 * TP * SP;
      uint8_t* need_kf = out.need_kf + i0 * TP * SP;
      int32_t* send = out.send + i0 * TPK;
      int32_t* drop = out.drop + i0 * TPK;
      int32_t* sw = out.sw + i0 * TPK;
      for (unsigned item = warp; item * G < ntr; item += kWarps) {
        const unsigned gt = item * G + g;  // track of the tile
        const bool trk = gt < ntr;
        const bool live = trk && s < SP;
        const unsigned j = trk ? lay.by_tp(gt) : 0u;
        const unsigned t = gt - j * TP;
        const int4* pk = packed + gt * K;
        const int kind = trk ? pk[0].w : 0;
        const bool svc = kind & kSvcTrack, vid = kind & kVideoTrack;
        int tgt_sp = 0, tgt_tp = 0, cur_sp = 0, cur_tp = 0;
        bool base = false;
        if (live) {
          const unsigned ix = t * SP + s;
          const unsigned char* p32 = smem + j * lay.stride[kSubI32] + ix * 4;
          tgt_sp = *reinterpret_cast<const int32_t*>(p32 + lay.in[kTgtSp]);
          tgt_tp = *reinterpret_cast<const int32_t*>(p32 + lay.in[kTgtTp]);
          cur_sp = *reinterpret_cast<const int32_t*>(p32 + lay.in[kCurSp]);
          cur_tp = *reinterpret_cast<const int32_t*>(p32 + lay.in[kCurTp]);
          base = smem[lay.in[kBase] + j * lay.stride[kSubU8] + ix] != 0;
        }
        // The machines and votes some track of the warp needs.
        const bool any_svc = __any_sync(kFull, trk && svc);
        const bool any_sim = __any_sync(kFull, trk && !svc);
        const bool any_vid = __any_sync(kFull, trk && vid);
        int sim_sp = cur_sp, sim_tp = cur_tp, svc_sp = cur_sp, svc_tp = cur_tp;
        const bool paused = tgt_sp < 0;
        const bool on = live && base;
        unsigned my_pkts = 0u, my_bytes = 0u;
        // Slots in chunks of spw: lane s of each track owns slot kb + s, keeps
        // its three mask words and stores them after the chunk (a warp's
        // stores are contiguous when spw = K).
        for (int kb = 0; kb < K; kb += spw) {
          const int own = kb + s;
          // The chunk's slots that some track of the warp uses: the owners'
          // validity, OR-folded over the warp's tracks.
          unsigned slots = __ballot_sync(kFull, trk && own < K && (pk[own].w & kValid));
          for (int sh = spw; sh < 32; sh <<= 1) slots |= slots >> sh;
          slots &= group;
          unsigned my_fw = 0u, my_dw = 0u, my_ww = 0u;
          while (slots) {
            const int k = kb + __ffs(slots) - 1;
            slots &= slots - 1u;
            // The slots stepped over set a paused subscriber's spatial layer
            // to -1, as every slot's step does.
            if (paused && k > 0) {
              sim_sp = -1;
              svc_sp = -1;
            }
            const int4 p = trk ? pk[k] : make_int4(0, 0, 0, 0);
            const bool val = p.w & kValid;
            const bool kf = p.w & kKeyframe, sync = p.w & kSync, eof = p.w & kEndFrame;
            select_step::Decision a{false, false, false}, b{false, false, false};
            if (any_sim) {
              a = select_step::simulcast(val, p.x, p.y, kf, sync, tgt_sp, tgt_tp, paused, sim_sp,
                                         sim_tp);
            }
            if (any_svc) {
              b = select_step::svc(val, p.x, p.y, kf, sync, eof, tgt_sp, tgt_tp, paused, svc_sp,
                                   svc_tp);
            }
            // Video selection x base; audio = valid x base.
            const bool fwd = on && (vid ? (svc ? b.fwd : a.fwd) : val);
            const unsigned fw = __ballot_sync(kFull, fwd);
            unsigned dw = 0u, ww = 0u;
            if (any_vid) {
              dw = __ballot_sync(kFull, on && vid && (svc ? b.drop : a.drop));
              ww = __ballot_sync(kFull, on && vid && !svc && a.sw);
            }
            if (fwd) {
              my_pkts += 1u;
              my_bytes += static_cast<unsigned>(p.z) + overhead;
            }
            if (k == own) {
              const unsigned sh = g * spw;
              my_fw = (fw >> sh) & low;
              my_dw = (dw >> sh) & low;
              my_ww = (ww >> sh) & low;
            }
          }
          if (trk && own < K) {
            const unsigned o = gt * K + own;
            send[o] = static_cast<int32_t>(my_fw);
            drop[o] = static_cast<int32_t>(my_dw);
            sw[o] = static_cast<int32_t>(my_ww);
          }
        }
        if (paused && K > 0) {  // the same for the slots after the last used one
          sim_sp = -1;
          svc_sp = -1;
        }
        if (live) {
          const unsigned o = gt * SP + s;
          const int o_sp = svc ? svc_sp : sim_sp;
          const int o_tp = svc ? svc_tp : sim_tp;
          out_sp[o] = o_sp;
          out_tp[o] = o_tp;
          const bool nkf = (tgt_sp >= 0) && (svc ? (tgt_sp > o_sp) : (tgt_sp != o_sp));
          need_kf[o] = (nkf && base && vid) ? 1 : 0;
          atomicAdd(&sh_pkts[j * SP + s], my_pkts);
          atomicAdd(&sh_bytes[j * SP + s], my_bytes);
        }
      }
      __syncthreads();

      // -- the tile's sums ---------------------------------------------------
      for (int x = tid; x < pages * SP; x += kThreads) {
        out.pkts[i0 * SP + x] = static_cast<int32_t>(sh_pkts[x]);
        out.bytes[i0 * SP + x] = static_cast<int32_t>(sh_bytes[x]);
      }
      for (unsigned x = tid; x < pages * 3 * TL; x += kThreads) {
        out.tr[i0 * 3 * TL + x] = static_cast<int32_t>(sh_tr[x]);
      }
      for (int j = tid; j < pages; j += kThreads) {
        unsigned pk_sum = 0u, by_sum = 0u;
        for (int x = 0; x < SP; ++x) {
          pk_sum += sh_pkts[j * SP + x];
          by_sum += sh_bytes[j * SP + x];
        }
        out.fwd_pkts[i0 + j] = static_cast<int32_t>(pk_sum);
        out.fwd_bytes[i0 + j] = static_cast<int32_t>(by_sum - pk_sum * overhead);
      }
    }

    if (with_mix) {
      float* lv = reinterpret_cast<float*>(smem + lay.lv);   // [pages, TP]
      int* cnt = reinterpret_cast<int*>(smem + lay.cnt);     // [pages, TP]
      float* thr = reinterpret_cast<float*>(smem + lay.thr); // [pages]
      float* w = reinterpret_cast<float*>(smem + lay.w);     // [pages, SP, TP]
      const int npt = pages * TP;
      for (int q = tid; q < npt; q += kThreads) {
        const int j = q / TP;
        const size_t gq = static_cast<size_t>(rows[j]) * TP + (q - j * TP);
        lv[q] = mx.active[gq] ? mx.level[gq] : -1.0f;
      }
      __syncthreads();
      for (int q = tid; q < npt; q += kThreads) {
        const float* lj = lv + (q / TP) * TP;
        int c = 0;
        for (int u = 0; u < TP; ++u) c += lj[u] > lv[q];
        cnt[q] = c;
      }
      __syncthreads();
      const int k_eff = top_k < TP ? top_k : TP;
      for (int j = tid; j < pages; j += kThreads) {
        float m = CUDART_INF_F;
        for (int t = 0; t < TP; ++t) {
          if (cnt[j * TP + t] < k_eff && lv[j * TP + t] < m) m = lv[j * TP + t];
        }
        thr[j] = fmaxf(m, 0.0f);
      }
      __syncthreads();
      const int spt = SP * TP;
      for (int q = tid; q < pages * spt; q += kThreads) {
        const int j = q / spt, r = q - j * spt, s = r / TP, t = r - s * TP;
        const size_t row = static_cast<size_t>(rows[j]);
        const bool speak = mx.active[row * TP + t] && lv[j * TP + t] >= thr[j];
        const bool inc = speak && t != mx.sub_track[row * SP + s];
        w[q] = __fmul_rn(inc ? 1.0f : 0.0f, mx.gain[row * TP + t]);
      }
      __syncthreads();
      if (vec4) {
        mix_columns<4>(mx, mixed, w, rows, i0, pages, TP, SP, N, tid);
      } else {
        mix_columns<1>(mx, mixed, w, rows, i0, pages, TP, SP, N, tid);
      }
    }
    __syncthreads();  // the tile's shared memory is read before the next tile writes it
  }
}

}  // namespace

// 1 if the kernel can take pages of TP tracks, K packets and SP subscribers
// with L stats rows a track (one page's tile, decide and/or mix, fits the
// card's shared memory), else 0. The wrapper's one guard: the launch does
// not check again.
extern "C" int paged_kernel_fits(int TP, int K, int SP, int L, int with_decide, int with_mix) {
  Layout lay;
  return L == kLayers && make_layout(&lay, TP, K, SP, 1, 0u, 0u, with_decide != 0,
                                     with_mix != 0) <= staging::max_smem()
             ? 1
             : 0;
}

extern "C" int paged_kernel_launch(
    const void* live_rows,
    const void* cur_sp, const void* cur_tp, const void* tgt_sp, const void* tgt_tp,
    const void* is_svc, const void* is_video, const void* base,
    const void* layer, const void* temporal, const void* keyframe,
    const void* layer_sync, const void* end_frame, const void* valid,
    const void* size, const void* sn, const void* ts, const void* arrival,
    const void* begin_pic,
    const void* pcm, const void* level, const void* active, const void* gain,
    const void* sub_track,
    void* send, void* drop, void* sw, void* out_sp, void* out_tp, void* need_kf,
    void* pkts, void* bytes, void* fwd_pkts, void* fwd_bytes, void* st, void* tr,
    void* mixed,
    int NL, int P, int TP, int K, int SP, int N, int L, int wire_overhead, int top_k,
    int with_decide, int with_mix, void* stream) {
  (void)L;  // kLayers; the wrapper's fits check holds it to that
  if (NL <= 0) return static_cast<int>(cudaGetLastError());
  auto bytes_of = [](const void* p) { return static_cast<const unsigned char*>(p); };
  Ops in{{bytes_of(cur_sp), bytes_of(cur_tp), bytes_of(tgt_sp), bytes_of(tgt_tp),
          bytes_of(layer), bytes_of(temporal), bytes_of(size), bytes_of(sn), bytes_of(ts),
          bytes_of(arrival), bytes_of(keyframe), bytes_of(layer_sync), bytes_of(end_frame),
          bytes_of(valid), bytes_of(begin_pic), bytes_of(base), bytes_of(is_svc),
          bytes_of(is_video)}};
  Outs out{
      static_cast<int32_t*>(send), static_cast<int32_t*>(drop), static_cast<int32_t*>(sw),
      static_cast<int32_t*>(out_sp), static_cast<int32_t*>(out_tp),
      static_cast<uint8_t*>(need_kf),
      static_cast<int32_t*>(pkts), static_cast<int32_t*>(bytes),
      static_cast<int32_t*>(fwd_pkts), static_cast<int32_t*>(fwd_bytes),
      static_cast<int32_t*>(st), static_cast<int32_t*>(tr)};
  MixIn mx{static_cast<const float*>(pcm), static_cast<const float*>(level),
           static_cast<const uint8_t*>(active), static_cast<const float*>(gain),
           static_cast<const int32_t*>(sub_track)};

  // A class is staged by 16-byte (4-byte) copies when every span of it is
  // 16-byte (4-byte) aligned: its length and each operand's base.
  unsigned aligned = 0u, aligned4 = 0u;
  if (with_decide) {
    Layout probe;
    make_layout(&probe, TP, K, SP, 1, 0u, 0u, true, false);
    for (int c = 0; c < kClasses; ++c) {
      uintptr_t bits = probe.span[c];
      for (int op = 0; op < kOps; ++op) {
        if (class_of(op) == c) bits |= reinterpret_cast<uintptr_t>(in.p[op]);
      }
      if ((bits & 15u) == 0) aligned |= 1u << c;
      else if ((bits & 3u) == 0) aligned4 |= 1u << c;
    }
  }
  int lg_spw = 0;
  while ((1 << lg_spw) < SP) ++lg_spw;
  const int vec4 = with_mix && N % 4 == 0 && (reinterpret_cast<uintptr_t>(pcm) & 15u) == 0 &&
                   (reinterpret_cast<uintptr_t>(mixed) & 15u) == 0;

  // The most pages a tile that fit one of four blocks' shared memory, the
  // blocks that fit on the card at that size, then the fewest pages a tile
  // that still needs no more rounds of tiles over those blocks.
  Layout lay;
  int pb = 1;
  auto tile_smem = [&](int pages) {
    return make_layout(&lay, TP, K, SP, pages, aligned, aligned4, with_decide, with_mix);
  };
  while (pb < kMaxTilePages && pb < NL && tile_smem(pb + 1) <= kBlockSmem) ++pb;
  cudaError_t err = cudaSuccess;
  const int blocks = staging::persistent_blocks(paged_kernel, kThreads, tile_smem(pb), NL, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long per_round = static_cast<long long>(blocks) * pb;
  const long long rounds = (NL + per_round - 1) / per_round;
  pb = static_cast<int>((NL + blocks * rounds - 1) / (blocks * rounds));
  const size_t smem = tile_smem(pb);
  const long long tiles = (static_cast<long long>(NL) + pb - 1) / pb;
  const int grid = static_cast<int>(tiles < blocks ? tiles : blocks);
  paged_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(live_rows), in, out, mx, static_cast<float*>(mixed), lay, NL,
      P, TP, K, SP, lg_spw, N, pb, static_cast<unsigned>(wire_overhead), top_k, with_decide,
      with_mix, vec4);
  return static_cast<int>(cudaGetLastError());
}
