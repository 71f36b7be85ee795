// Phase 0 of the dense media-plane tick: the whole per-packet forward
// decision for every room, as one CUDA kernel for Hopper (sm_90a).
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
//  * One block per room. A warp owns one (track, 32-subscriber word): lane
//    l handles subscriber s = 32*w + l and carries the simulcast and SVC
//    state in registers across the K packets, exactly like the TPU kernel
//    carries sim_sp/sim_tp/svc_sp/svc_tp. Warps loop over the T*W words,
//    so any T and S fit a block of at most 1024 threads.
//  * A mask word is one __ballot_sync over the warp; lane 0 stores it. The
//    bit pattern is formed as uint32 and stored through int32, so bit 31
//    is well defined. Lanes past S vote 0.
//  * Packet fields are the same for all lanes of a warp (one broadcast
//    load); state, base and outputs are contiguous in s (coalesced).
//  * Per-subscriber sums over tracks and the per-room totals are formed
//    with integer atomics in shared memory and uint32 arithmetic, so they
//    wrap like the reference's int32 sums and are exact in any order.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ unsigned warp_sum(unsigned v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void decide_rooms_kernel(
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
    int T, int K, int S, int W, int wire_overhead) {
  extern __shared__ unsigned smem[];
  unsigned* sh_pkts = smem;           // [S]
  unsigned* sh_bytes = smem + S;      // [S]
  unsigned* sh_tot = smem + 2 * S;    // [2] room packets, room bytes

  const long long r = blockIdx.x;
  for (int i = threadIdx.x; i < 2 * S + 2; i += blockDim.x) smem[i] = 0u;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  unsigned room_pkts = 0u, room_bytes = 0u;

  for (int item = warp; item < T * W; item += nwarps) {
    const int t = item / W;
    const int w = item - t * W;
    const int s = 32 * w + lane;
    const bool live = s < S;
    const long long rt = r * T + t;
    const long long ix = rt * S + s;

    int tgt_sp = 0, tgt_tp = 0, sim_sp = 0, sim_tp = 0;
    bool base = false;
    if (live) {
      tgt_sp = tgt_sp_in[ix];
      tgt_tp = tgt_tp_in[ix];
      sim_sp = cur_sp[ix];
      sim_tp = cur_tp[ix];
      base = base_in[ix] != 0;
    }
    int svc_sp = sim_sp, svc_tp = sim_tp;
    const bool svc = is_svc[rt] != 0;
    const bool vid = is_video[rt] != 0;
    const bool paused = tgt_sp < 0;
    unsigned my_pkts = 0u, my_bytes = 0u;

    for (int k = 0; k < K; ++k) {
      const long long p = rt * K + k;
      const int sp = pkt_sp[p];
      const int tp = pkt_tp[p];
      const bool kf = pkt_kf[p] != 0;
      const bool sync = pkt_sync[p] != 0;
      const bool eof = pkt_eof[p] != 0;
      const bool val = pkt_valid[p] != 0;
      const int size = pkt_size[p];

      // -- simulcast path --------------------------------------------------
      const bool want = (tgt_sp != sim_sp) && (tgt_sp >= 0);
      const bool sw = val && kf && want && (sp == tgt_sp);
      const int c_sp = sw ? tgt_sp : sim_sp;
      int c_tp = sw ? tgt_tp : sim_tp;
      const bool on_cur = val && (sp == c_sp) && (c_sp >= 0);
      if (on_cur && sync && tp <= tgt_tp && tp > c_tp) c_tp = tp;
      if (on_cur && tgt_tp < c_tp) c_tp = tgt_tp;
      const bool fwd_sim = on_cur && (tp <= c_tp) && !paused;
      const bool drp_sim = on_cur && (!(tp <= c_tp) || paused);
      sim_sp = paused ? -1 : c_sp;
      sim_tp = c_tp;

      // -- SVC onion path --------------------------------------------------
      const bool up = val && kf && (tgt_sp > svc_sp) && (sp <= tgt_sp);
      const int s_sp = up ? tgt_sp : svc_sp;
      const bool down = val && eof && (tgt_sp >= 0) && (tgt_sp < s_sp);
      const int s_sp_next = down ? tgt_sp : s_sp;
      const bool on_stream = val && (s_sp >= 0);
      int s_tp = up ? tgt_tp : svc_tp;
      if (on_stream && sync && tp <= tgt_tp && tp > s_tp) s_tp = tp;
      if (on_stream && tgt_tp < s_tp) s_tp = tgt_tp;
      const bool fwd_svc = on_stream && (sp <= s_sp) && (tp <= s_tp) && !paused;
      const bool drp_svc = on_stream && !fwd_svc;
      svc_sp = paused ? -1 : s_sp_next;
      svc_tp = s_tp;

      // -- merge: video selection x base; audio = valid x base --------------
      const bool fwd = live && base && (vid ? (svc ? fwd_svc : fwd_sim) : val);
      const bool drp = live && base && vid && (svc ? drp_svc : drp_sim);
      const bool swo = live && base && vid && !svc && sw;

      const unsigned fw = __ballot_sync(0xffffffffu, fwd);
      const unsigned dw = __ballot_sync(0xffffffffu, drp);
      const unsigned ww = __ballot_sync(0xffffffffu, swo);
      if (lane == 0) {
        const long long o = p * W + w;
        send_bits[o] = static_cast<int32_t>(fw);
        drop_bits[o] = static_cast<int32_t>(dw);
        switch_bits[o] = static_cast<int32_t>(ww);
      }
      if (fwd) {
        my_pkts += 1u;
        my_bytes += static_cast<unsigned>(size) + static_cast<unsigned>(wire_overhead);
        room_pkts += 1u;
        room_bytes += static_cast<unsigned>(size);
      }
    }

    if (live) {
      const int o_sp = svc ? svc_sp : sim_sp;
      const int o_tp = svc ? svc_tp : sim_tp;
      out_sp[ix] = o_sp;
      out_tp[ix] = o_tp;
      const bool nkf = (tgt_sp >= 0) && (svc ? (tgt_sp > o_sp) : (tgt_sp != o_sp));
      need_kf[ix] = (nkf && base && vid) ? 1 : 0;
      atomicAdd(&sh_pkts[s], my_pkts);
      atomicAdd(&sh_bytes[s], my_bytes);
    }
  }

  room_pkts = warp_sum(room_pkts);
  room_bytes = warp_sum(room_bytes);
  if (lane == 0) {
    atomicAdd(&sh_tot[0], room_pkts);
    atomicAdd(&sh_tot[1], room_bytes);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    pkts_sent[r * S + i] = static_cast<int32_t>(sh_pkts[i]);
    sent_bytes[r * S + i] = static_cast<int32_t>(sh_bytes[i]);
  }
  if (threadIdx.x == 0) {
    fwd_packets[r] = static_cast<int32_t>(sh_tot[0]);
    fwd_bytes[r] = static_cast<int32_t>(sh_tot[1]);
  }
}

}  // namespace

extern "C" int decide_rooms_launch(
    const void* pkt_sp, const void* pkt_tp, const void* pkt_kf,
    const void* pkt_sync, const void* pkt_eof, const void* pkt_valid,
    const void* pkt_size, const void* cur_sp, const void* cur_tp,
    const void* tgt_sp, const void* tgt_tp, const void* is_svc,
    const void* is_video, const void* base, void* send_bits, void* drop_bits,
    void* switch_bits, void* out_sp, void* out_tp, void* need_kf,
    void* pkts_sent, void* sent_bytes, void* fwd_packets, void* fwd_bytes,
    int R, int T, int K, int S, int wire_overhead, void* stream) {
  const int W = (S + 31) / 32;
  int warps = T * W;
  if (warps > 32) warps = 32;
  const size_t shared = static_cast<size_t>(2 * S + 2) * sizeof(unsigned);
  if (R > 0) {
    decide_rooms_kernel<<<R, 32 * warps, shared, static_cast<cudaStream_t>(stream)>>>(
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
        T, K, S, W, wire_overhead);
  }
  return static_cast<int>(cudaGetLastError());
}
