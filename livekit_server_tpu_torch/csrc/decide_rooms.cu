// Phase 0 of the media-plane tick: the whole per-packet forward decision
// for every room, as one CUDA kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel livekit_server_tpu/ops/selector.py
// `_decide_rooms_kernel` (driven by `decide_rooms`). Per packet k and
// subscriber s of every (room, track) it runs the simulcast state machine
// (keyframe-gated spatial switch, sync-gated temporal up, immediate
// down), the SVC onion path (up at a keyframe, down at end of frame), the
// base merge (subscribed & !sub_muted & published & !pub_muted) and the
// audio path (valid & base); it bit-packs send/drop/switch and sums the
// per-subscriber packets/bytes (+ wire overhead) and the per-room totals.
// The plain PyTorch version is `decide_rooms_plain` in ops/selector.py.
//
// What bounds it on the H100: bytes. It is integer logic with a few
// operations per input byte, so the floor is the bytes it must move
// (packet fields, selector state, base, the mask words and sums out)
// over 3.35 TB/s. The dense [R,T,K,S] masks that the decision implies are
// 65 M elements at the north-star shape; they never reach global memory.
//
// Design:
//  * Persistent blocks, four on an SM, each walking tiles of RB
//    consecutive rooms. Every operand of a tile is one contiguous span,
//    staged into shared memory by 16-byte cp.async (staging.cuh), all of
//    it in flight at once; while one block computes, the other blocks'
//    copies are in flight. (A two-stage ring per block measured slower:
//    it halves the rooms a tile and needs more registers.)
//  * Each packet's seven fields are packed once per tile into one int4
//    {spatial, temporal, size, flags} in shared memory; a warp reads it as
//    one broadcast load per packet.
//  * A warp owns one (room, track, 32-subscriber word): lane l handles
//    subscriber s = 32*w + l and carries the selector state in registers
//    across the K packets, like the TPU kernel carries sim_sp/sim_tp/
//    svc_sp/svc_tp. Whether a track is SVC and whether it is video, and
//    whether a packet is valid, are the same for the whole warp, so the
//    warp runs only the state machine the track uses (the other one's
//    result is never selected), steps over invalid packets (most of a
//    tick's K slots: audio sends one packet a tick), and skips the votes
//    and stores of words that are 0 (zeroed once a tile): all three for an
//    invalid packet, drop and switch for audio, switch for SVC. The
//    per-packet steps are select_step.cuh's, shared with paged_kernel.cu.
//  * A mask word is one __ballot_sync; lane 0 writes it to a shared
//    [3][RB,T,K,W] tile, which leaves as 16-byte coalesced stores. The bit
//    pattern is formed as uint32, so bit 31 is well defined. Lanes past S
//    vote 0.
//  * Per-subscriber sums go through shared-memory atomics in uint32, so
//    they wrap like the reference's int32 sums and are exact in any order.
//    A room's totals are sums of those: packets = sum of pkts_sent, bytes
//    = sum of sent_bytes - overhead * packets (mod 2^32, exact).
//  * __launch_bounds__ caps registers at 64 a thread and tiles stay under
//    54 KB, so four 256-thread blocks (32 warps) fit on an SM.

#include <cstdint>
#include <cuda_runtime.h>

#include "select_step.cuh"
#include "staging.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 4;             // caps registers at 64 a thread
constexpr size_t kBlockSmem = 54 * 1024;   // four blocks on an SM
constexpr int kMaxTileRooms = 64;

using select_step::kEndFrame;
using select_step::kKeyframe;
using select_step::kSync;
using select_step::kValid;
using staging::slot_bytes;

// Shared-memory layout of a block that walks tiles of `rb` rooms: the 14
// operand slots, then the packed packets, the three mask-word tiles and
// the per-subscriber sums.
struct Layout {
  size_t pkt32[3], pkt8[4], state[4], base, svc, video, stage;
  size_t packed, masks[3], sums, total;
  __host__ __device__ Layout(int T, int K, int S, int rb) {
    const size_t np = static_cast<size_t>(rb) * T * K;
    const size_t ns = static_cast<size_t>(rb) * T * S;
    const size_t words = np * ((S + 31) / 32);
    size_t o = 0;
    for (int i = 0; i < 3; ++i) { pkt32[i] = o; o += slot_bytes(np * 4); }
    for (int i = 0; i < 4; ++i) { pkt8[i] = o; o += slot_bytes(np); }
    for (int i = 0; i < 4; ++i) { state[i] = o; o += slot_bytes(ns * 4); }
    base = o; o += slot_bytes(ns);
    svc = o; o += slot_bytes(static_cast<size_t>(rb) * T);
    video = o; o += slot_bytes(static_cast<size_t>(rb) * T);
    stage = o;
    packed = o; o += np * 16;
    for (int i = 0; i < 3; ++i) { masks[i] = o; o += slot_bytes(words * 4); }
    sums = o; o += static_cast<size_t>(rb) * S * 2 * 4;
    total = o;
  }
};

__device__ __forceinline__ unsigned warp_sum(unsigned v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// One warp's walk over the K packets of its track for its 32 subscribers.
// `st_sp`/`st_tp` carry the simulcast state (SVC = false) or the SVC
// state (SVC = true); `on` = live & base. Mask words go to send/drop/
// switch[k*W + w].
template <bool SVC, bool VIDEO>
__device__ __forceinline__ void walk(const int4* __restrict__ pk, int K, int W, int w,
                                     int lane, bool on, int tgt_sp, int tgt_tp,
                                     int& st_sp, int& st_tp, uint32_t* send,
                                     uint32_t* drop, uint32_t* sw_out, unsigned overhead,
                                     unsigned& my_pkts, unsigned& my_bytes) {
  const bool paused = tgt_sp < 0;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const int4 p = pk[k];
    // An invalid packet sends, drops and switches nothing (its mask words
    // were zeroed) and leaves the state as is, except that a paused
    // subscriber's spatial layer becomes -1. Validity is the track's, so
    // the whole warp takes this branch together.
    if (!(p.w & kValid)) {
      if (paused) st_sp = -1;
      continue;
    }
    const int sp = p.x, tp = p.y;
    const bool kf = p.w & kKeyframe, sync = p.w & kSync, eof = p.w & kEndFrame;
    const select_step::Decision d =
        SVC ? select_step::svc(true, sp, tp, kf, sync, eof, tgt_sp, tgt_tp, paused, st_sp, st_tp)
            : select_step::simulcast(true, sp, tp, kf, sync, tgt_sp, tgt_tp, paused, st_sp,
                                     st_tp);
    const bool fwd = on && (!VIDEO || d.fwd);   // audio: every valid packet
    const unsigned fw = __ballot_sync(0xffffffffu, fwd);
    unsigned dw = 0u, ww = 0u;
    if (VIDEO) {
      dw = __ballot_sync(0xffffffffu, on && d.drop);
      if (!SVC) ww = __ballot_sync(0xffffffffu, on && d.sw);
    }
    if (lane == 0) {                  // words that stay 0 were zeroed
      const int o = k * W + w;
      send[o] = fw;
      if (VIDEO) drop[o] = dw;
      if (VIDEO && !SVC) sw_out[o] = ww;
    }
    if (fwd) {
      my_pkts += 1u;
      my_bytes += static_cast<unsigned>(p.z) + overhead;
    }
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks) decide_rooms_kernel(
    const int32_t* __restrict__ pkt_sp, const int32_t* __restrict__ pkt_tp,
    const uint8_t* __restrict__ pkt_kf, const uint8_t* __restrict__ pkt_sync,
    const uint8_t* __restrict__ pkt_eof, const uint8_t* __restrict__ pkt_valid,
    const int32_t* __restrict__ pkt_size,
    const int32_t* __restrict__ cur_sp, const int32_t* __restrict__ cur_tp,
    const int32_t* __restrict__ tgt_sp_in, const int32_t* __restrict__ tgt_tp_in,
    const uint8_t* __restrict__ is_svc, const uint8_t* __restrict__ is_video,
    const uint8_t* __restrict__ base_in,
    int32_t* __restrict__ send_bits, int32_t* __restrict__ drop_bits,
    int32_t* __restrict__ switch_bits,
    int32_t* __restrict__ out_sp, int32_t* __restrict__ out_tp,
    uint8_t* __restrict__ need_kf,
    int32_t* __restrict__ pkts_sent, int32_t* __restrict__ sent_bytes,
    int32_t* __restrict__ fwd_packets, int32_t* __restrict__ fwd_bytes,
    int R, int T, int K, int S, int W, int rb, long long tiles, int wire_overhead) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay(T, K, S, rb);
  int4* packed = reinterpret_cast<int4*>(smem + lay.packed);
  uint32_t* sh_pkts = reinterpret_cast<uint32_t*>(smem + lay.sums);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long TK = static_cast<long long>(T) * K;
  const long long TS = static_cast<long long>(T) * S;
  const unsigned overhead = static_cast<unsigned>(wire_overhead);

  const int32_t* const p32[3] = {pkt_sp, pkt_tp, pkt_size};
  const uint8_t* const p8[4] = {pkt_kf, pkt_sync, pkt_eof, pkt_valid};
  const int32_t* const st[4] = {cur_sp, cur_tp, tgt_sp_in, tgt_tp_in};
  int32_t* const masks_out[3] = {send_bits, drop_bits, switch_bits};

  // Every thread of the block takes part in every span. (Giving each span
  // one warp, as budget_rooms does, measured slower here: 14 spans on 8
  // warps put two spans' copies behind each other in six of them.)
  auto stage_tile = [&](long long tile) {
    const long long r0 = tile * rb;
    const long long rooms = R - r0 < rb ? R - r0 : rb;
    for (int i = 0; i < 3; ++i)
      staging::stage(smem + lay.pkt32[i], p32[i] + r0 * TK, rooms * TK * 4, tid, nt);
    for (int i = 0; i < 4; ++i)
      staging::stage(smem + lay.pkt8[i], p8[i] + r0 * TK, rooms * TK, tid, nt);
    for (int i = 0; i < 4; ++i)
      staging::stage(smem + lay.state[i], st[i] + r0 * TS, rooms * TS * 4, tid, nt);
    staging::stage(smem + lay.base, base_in + r0 * TS, rooms * TS, tid, nt);
    staging::stage(smem + lay.svc, is_svc + r0 * T, rooms * T, tid, nt);
    staging::stage(smem + lay.video, is_video + r0 * T, rooms * T, tid, nt);
  };

  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    stage_tile(tile);
    staging::commit();
    staging::wait<0>();
    __syncthreads();

    const long long r0 = tile * rb;
    const int rooms = static_cast<int>(R - r0 < rb ? R - r0 : rb);
    const int np = rooms * T * K;
    const int ns = rooms * S;
    const long long mask0 = r0 * TK * W;
    uint32_t* mk[3];
    for (int i = 0; i < 3; ++i)
      mk[i] = staging::placed<uint32_t>(smem + lay.masks[i], masks_out[i] + mask0);
    {
      const int32_t* sp = staging::placed<const int32_t>(smem + lay.pkt32[0], pkt_sp + r0 * TK);
      const int32_t* tp = staging::placed<const int32_t>(smem + lay.pkt32[1], pkt_tp + r0 * TK);
      const int32_t* sz = staging::placed<const int32_t>(smem + lay.pkt32[2], pkt_size + r0 * TK);
      const uint8_t* kf = staging::placed<const uint8_t>(smem + lay.pkt8[0], pkt_kf + r0 * TK);
      const uint8_t* sy = staging::placed<const uint8_t>(smem + lay.pkt8[1], pkt_sync + r0 * TK);
      const uint8_t* ef = staging::placed<const uint8_t>(smem + lay.pkt8[2], pkt_eof + r0 * TK);
      const uint8_t* va = staging::placed<const uint8_t>(smem + lay.pkt8[3], pkt_valid + r0 * TK);
      for (int i = tid; i < np; i += nt) {
        const int flags = (kf[i] ? kKeyframe : 0) | (sy[i] ? kSync : 0) |
                          (ef[i] ? kEndFrame : 0) | (va[i] ? kValid : 0);
        packed[i] = make_int4(sp[i], tp[i], sz[i], flags);
      }
      for (int i = tid; i < 2 * ns; i += nt) sh_pkts[i] = 0u;
      for (int i = tid; i < np * W; i += nt) mk[0][i] = mk[1][i] = mk[2][i] = 0u;
    }
    __syncthreads();

    const int32_t* c_sp = staging::placed<const int32_t>(smem + lay.state[0], cur_sp + r0 * TS);
    const int32_t* c_tp = staging::placed<const int32_t>(smem + lay.state[1], cur_tp + r0 * TS);
    const int32_t* t_sp = staging::placed<const int32_t>(smem + lay.state[2], tgt_sp_in + r0 * TS);
    const int32_t* t_tp = staging::placed<const int32_t>(smem + lay.state[3], tgt_tp_in + r0 * TS);
    const uint8_t* bas = staging::placed<const uint8_t>(smem + lay.base, base_in + r0 * TS);
    const uint8_t* svc_s = staging::placed<const uint8_t>(smem + lay.svc, is_svc + r0 * T);
    const uint8_t* vid_s = staging::placed<const uint8_t>(smem + lay.video, is_video + r0 * T);
    uint32_t* sh_bytes = sh_pkts + ns;

    for (int item = warp; item < rooms * T * W; item += kWarps) {
      const int rt = item / W;                    // room-track within the tile
      const int w = item - rt * W;
      const int s = 32 * w + lane;
      const bool live = s < S;
      const int ix = rt * S + s;
      int tgt_sp = 0, tgt_tp = 0, sp = 0, tp = 0;
      bool base = false;
      if (live) {
        tgt_sp = t_sp[ix];
        tgt_tp = t_tp[ix];
        sp = c_sp[ix];
        tp = c_tp[ix];
        base = bas[ix] != 0;
      }
      const bool svc = svc_s[rt] != 0;
      const bool vid = vid_s[rt] != 0;
      const bool on = live && base;
      unsigned my_pkts = 0u, my_bytes = 0u;
      const int4* pk = packed + rt * K;
      const int mo = rt * K * W;
#define WALK(A, B)                                                                    \
  walk<A, B>(pk, K, W, w, lane, on, tgt_sp, tgt_tp, sp, tp, mk[0] + mo, mk[1] + mo, \
             mk[2] + mo, overhead, my_pkts, my_bytes)
      if (svc) {
        if (vid) WALK(true, true); else WALK(true, false);
      } else {
        if (vid) WALK(false, true); else WALK(false, false);
      }
#undef WALK
      if (live) {
        const long long g = r0 * TS + ix;
        out_sp[g] = sp;
        out_tp[g] = tp;
        const bool nkf = (tgt_sp >= 0) && (svc ? (tgt_sp > sp) : (tgt_sp != sp));
        need_kf[g] = (nkf && base && vid) ? 1 : 0;
        const int q = (rt / T) * S + s;
        atomicAdd(&sh_pkts[q], my_pkts);
        atomicAdd(&sh_bytes[q], my_bytes);
      }
    }
    __syncthreads();

    const size_t mask_bytes = static_cast<size_t>(np) * W * 4;
    for (int i = 0; i < 3; ++i) staging::store(masks_out[i] + mask0, mk[i], mask_bytes, tid, nt);
    for (int rr = warp; rr < rooms; rr += kWarps) {
      unsigned pk_sum = 0u, by_sum = 0u;
      for (int s = lane; s < S; s += 32) {
        const unsigned p = sh_pkts[rr * S + s], b = sh_bytes[rr * S + s];
        pkts_sent[(r0 + rr) * S + s] = static_cast<int32_t>(p);
        sent_bytes[(r0 + rr) * S + s] = static_cast<int32_t>(b);
        pk_sum += p;
        by_sum += b;
      }
      pk_sum = warp_sum(pk_sum);
      by_sum = warp_sum(by_sum);
      if (lane == 0) {
        fwd_packets[r0 + rr] = static_cast<int32_t>(pk_sum);
        fwd_bytes[r0 + rr] = static_cast<int32_t>(by_sum - pk_sum * overhead);
      }
    }
    __syncthreads();
  }
}

size_t tile_smem(int T, int K, int S, int rb) { return Layout(T, K, S, rb).total; }

}  // namespace

// 1 if the kernel can take T tracks, K packets and S subscribers (one
// room's tile fits the card's shared memory), else 0. The wrapper's one guard: the launch
// does not check again.
extern "C" int decide_rooms_fits(int T, int K, int S) {
  return tile_smem(T, K, S, 1) <= staging::max_smem() ? 1 : 0;
}

extern "C" int decide_rooms_launch(
    const void* pkt_sp, const void* pkt_tp, const void* pkt_kf,
    const void* pkt_sync, const void* pkt_eof, const void* pkt_valid,
    const void* pkt_size, const void* cur_sp, const void* cur_tp,
    const void* tgt_sp, const void* tgt_tp, const void* is_svc,
    const void* is_video, const void* base, void* send_bits, void* drop_bits,
    void* switch_bits, void* out_sp, void* out_tp, void* need_kf,
    void* pkts_sent, void* sent_bytes, void* fwd_packets, void* fwd_bytes,
    int R, int T, int K, int S, int wire_overhead, void* stream) {
  if (R <= 0) return static_cast<int>(cudaGetLastError());
  const int W = (S + 31) / 32;
  // As many rooms a tile as fit the shared-memory share of one of four
  // blocks on an SM: fewer, larger tiles spread the per-tile staging work.
  int rb = 1;
  while (rb < R && rb < kMaxTileRooms && tile_smem(T, K, S, rb + 1) <= kBlockSmem) ++rb;
  const size_t smem = tile_smem(T, K, S, rb);
  const long long tiles = (static_cast<long long>(R) + rb - 1) / rb;
  cudaError_t err = cudaSuccess;
  const int blocks = staging::persistent_blocks(decide_rooms_kernel, kThreads, smem, tiles, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  decide_rooms_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(pkt_sp), static_cast<const int32_t*>(pkt_tp),
      static_cast<const uint8_t*>(pkt_kf), static_cast<const uint8_t*>(pkt_sync),
      static_cast<const uint8_t*>(pkt_eof), static_cast<const uint8_t*>(pkt_valid),
      static_cast<const int32_t*>(pkt_size),
      static_cast<const int32_t*>(cur_sp), static_cast<const int32_t*>(cur_tp),
      static_cast<const int32_t*>(tgt_sp), static_cast<const int32_t*>(tgt_tp),
      static_cast<const uint8_t*>(is_svc), static_cast<const uint8_t*>(is_video),
      static_cast<const uint8_t*>(base),
      static_cast<int32_t*>(send_bits), static_cast<int32_t*>(drop_bits),
      static_cast<int32_t*>(switch_bits),
      static_cast<int32_t*>(out_sp), static_cast<int32_t*>(out_tp),
      static_cast<uint8_t*>(need_kf),
      static_cast<int32_t*>(pkts_sent), static_cast<int32_t*>(sent_bytes),
      static_cast<int32_t*>(fwd_packets), static_cast<int32_t*>(fwd_bytes),
      R, T, K, S, W, rb, tiles, wire_overhead);
  return static_cast<int>(cudaGetLastError());
}
