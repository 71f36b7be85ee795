// Phase 0 of the live-extent paged tick, one thread block per LIVE page, as
// one CUDA kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel livekit_server_tpu/ops/paged_kernel.py
// `_page_kernel` (driven by `_pallas_live_call`, entries `decide_pages`,
// `mix_pages`, `decide_mix_pages`). The page pool holds P pages, each a
// [TP, K, SP] block of one room's (track, packet, subscriber) plane. Block i
// reads pool page live_rows[i] of every pooled operand and writes compact
// block i of every output, so dead pages are never scheduled. Padded
// duplicate entries repeat a live page and write distinct compact blocks:
// no two blocks write the same address.
//
// Each block does, for its page:
//  * decide (with_decide): ops/selector.py `decide_rooms` at page shape —
//    the simulcast and SVC state machines over the K packets, base merge,
//    audio path, send/drop/switch mask words (SP <= 32: one word per
//    (track, packet)), per-subscriber packets/bytes (+ wire overhead) and
//    per-page totals (bytes without the overhead);
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
// What bounds it on the H100: bytes. Decide is integer logic with a few
// operations per input byte (about 2 KB read and 2.8 KB written per page
// at TP=4, K=8, SP=8, most of the writes being the routed stats); the mix
// is TP multiply-adds per output sample. The floor is those bytes over
// 3.35 TB/s.
//
// Design:
//  * A track's subscribers sit on consecutive lanes: SP rounded up to a
//    power of two (spw) lanes per track, 32/spw tracks per warp, so at
//    TP=4, SP=8 one warp covers a whole page. A lane carries its
//    (track, subscriber) selector state in registers across the K packets;
//    one __ballot_sync per packet gives every track's mask word of that
//    warp (shift out the track's spw-lane group). The ballot is unsigned
//    and stored through int32, so bit 31 (SP = 32) is well defined.
//  * Sums are uint32 with shared-memory atomics: they wrap like the
//    reference's int32 sums and are exact in any order.
//  * A row id outside [0, P) traps: the error surfaces at the next
//    synchronisation instead of reading another buffer.

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

struct DecideIn {
  const int32_t *cur_sp, *cur_tp, *tgt_sp, *tgt_tp;   // [P, TP, SP]
  const uint8_t *is_svc, *is_video;                   // [P, TP]
  const uint8_t *base;                                // [P, TP, SP]
  const int32_t *layer, *temporal;                    // [P, TP, K]
  const uint8_t *keyframe, *layer_sync, *end_frame, *valid;
  const int32_t *size, *sn, *ts, *arrival;
  const uint8_t *begin_pic;
};

struct DecideOut {
  int32_t *send, *drop, *sw;      // [NL, TP, K]
  int32_t *out_sp, *out_tp;       // [NL, TP, SP]
  uint8_t *need_kf;               // [NL, TP, SP]
  int32_t *pkts, *bytes;          // [NL, SP]
  int32_t *fwd_pkts, *fwd_bytes;  // [NL]
  int32_t *st;                    // [NL, 5, TP*L, K]
  int32_t *tr;                    // [NL, 3, TP*L]
};

struct MixIn {
  const float* pcm;          // [P, TP, N]
  const float* level;        // [P, TP]
  const uint8_t* active;     // [P, TP]
  const float* gain;         // [P, TP]
  const int32_t* sub_track;  // [P, SP]
};

__device__ __forceinline__ unsigned warp_sum(unsigned v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ int clip_layer(int v, int L) {
  return v < 0 ? 0 : (v > L - 1 ? L - 1 : v);
}

__device__ void decide_page(unsigned* smem, long long i, long long p, const DecideIn& in,
                            const DecideOut& out, int TP, int K, int SP, int spw, int L,
                            int wire_overhead) {
  unsigned* sh_pkts = smem;         // [SP]
  unsigned* sh_bytes = smem + SP;   // [SP]
  unsigned* sh_tot = smem + 2 * SP; // [2] page packets, page bytes
  for (int j = threadIdx.x; j < 2 * SP + 2; j += blockDim.x) smem[j] = 0u;
  __syncthreads();

  const int G = 32 / spw;  // tracks per warp
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane / spw;
  const int s = lane - g * spw;
  const int tp = warp * G + g;
  const bool track = tp < TP;
  const bool live = track && s < SP;
  const unsigned low = SP == 32 ? 0xffffffffu : ((1u << SP) - 1u);
  unsigned page_pkts = 0u, page_bytes = 0u;

  if (warp * G < TP) {  // warp-uniform: every lane reaches the ballots
    const long long pt = p * TP + tp;
    const long long ix = pt * SP + s;
    int tgt_sp = 0, tgt_tp = 0, sim_sp = 0, sim_tp = 0;
    bool base = false, svc = false, vid = false;
    if (live) {
      tgt_sp = in.tgt_sp[ix];
      tgt_tp = in.tgt_tp[ix];
      sim_sp = in.cur_sp[ix];
      sim_tp = in.cur_tp[ix];
      base = in.base[ix] != 0;
    }
    if (track) {
      svc = in.is_svc[pt] != 0;
      vid = in.is_video[pt] != 0;
    }
    int svc_sp = sim_sp, svc_tp = sim_tp;
    const bool paused = tgt_sp < 0;
    unsigned my_pkts = 0u, my_bytes = 0u;

    for (int k = 0; k < K; ++k) {
      int sp = 0, tpk = 0, size = 0;
      bool kf = false, sync = false, eof = false, val = false;
      if (track) {
        const long long q = pt * K + k;
        sp = in.layer[q];
        tpk = in.temporal[q];
        kf = in.keyframe[q] != 0;
        sync = in.layer_sync[q] != 0;
        eof = in.end_frame[q] != 0;
        val = in.valid[q] != 0;
        size = in.size[q];
      }

      // -- simulcast path ----------------------------------------------------
      const bool want = (tgt_sp != sim_sp) && (tgt_sp >= 0);
      const bool swi = val && kf && want && (sp == tgt_sp);
      const int c_sp = swi ? tgt_sp : sim_sp;
      int c_tp = swi ? tgt_tp : sim_tp;
      const bool on_cur = val && (sp == c_sp) && (c_sp >= 0);
      if (on_cur && sync && tpk <= tgt_tp && tpk > c_tp) c_tp = tpk;
      if (on_cur && tgt_tp < c_tp) c_tp = tgt_tp;
      const bool fwd_sim = on_cur && (tpk <= c_tp) && !paused;
      const bool drp_sim = on_cur && (!(tpk <= c_tp) || paused);
      sim_sp = paused ? -1 : c_sp;
      sim_tp = c_tp;

      // -- SVC onion path ----------------------------------------------------
      const bool up = val && kf && (tgt_sp > svc_sp) && (sp <= tgt_sp);
      const int s_sp = up ? tgt_sp : svc_sp;
      const bool down = val && eof && (tgt_sp >= 0) && (tgt_sp < s_sp);
      const int s_sp_next = down ? tgt_sp : s_sp;
      const bool on_stream = val && (s_sp >= 0);
      int s_tp = up ? tgt_tp : svc_tp;
      if (on_stream && sync && tpk <= tgt_tp && tpk > s_tp) s_tp = tpk;
      if (on_stream && tgt_tp < s_tp) s_tp = tgt_tp;
      const bool fwd_svc = on_stream && (sp <= s_sp) && (tpk <= s_tp) && !paused;
      const bool drp_svc = on_stream && !fwd_svc;
      svc_sp = paused ? -1 : s_sp_next;
      svc_tp = s_tp;

      // -- merge: video selection x base; audio = valid x base ----------------
      const bool fwd = live && base && (vid ? (svc ? fwd_svc : fwd_sim) : val);
      const bool drp = live && base && vid && (svc ? drp_svc : drp_sim);
      const bool swo = live && base && vid && !svc && swi;

      const unsigned fw = __ballot_sync(0xffffffffu, fwd);
      const unsigned dw = __ballot_sync(0xffffffffu, drp);
      const unsigned ww = __ballot_sync(0xffffffffu, swo);
      if (track && s == 0) {
        const int sh = g * spw;
        const long long o = (i * TP + tp) * K + k;
        out.send[o] = static_cast<int32_t>((fw >> sh) & low);
        out.drop[o] = static_cast<int32_t>((dw >> sh) & low);
        out.sw[o] = static_cast<int32_t>((ww >> sh) & low);
      }
      if (fwd) {
        my_pkts += 1u;
        my_bytes += static_cast<unsigned>(size) + static_cast<unsigned>(wire_overhead);
        page_pkts += 1u;
        page_bytes += static_cast<unsigned>(size);
      }
    }

    if (live) {
      const long long o = (i * TP + tp) * SP + s;
      const int o_sp = svc ? svc_sp : sim_sp;
      const int o_tp = svc ? svc_tp : sim_tp;
      out.out_sp[o] = o_sp;
      out.out_tp[o] = o_tp;
      const bool nkf = (tgt_sp >= 0) && (svc ? (tgt_sp > o_sp) : (tgt_sp != o_sp));
      out.need_kf[o] = (nkf && base && vid) ? 1 : 0;
      atomicAdd(&sh_pkts[s], my_pkts);
      atomicAdd(&sh_bytes[s], my_bytes);
    }
  }

  page_pkts = warp_sum(page_pkts);
  page_bytes = warp_sum(page_bytes);
  if (lane == 0) {
    atomicAdd(&sh_tot[0], page_pkts);
    atomicAdd(&sh_tot[1], page_bytes);
  }

  // -- stats / tracker routing (no dependence on the selection) -------------
  const int TL = TP * L;
  for (int j = threadIdx.x; j < 5 * TL * K; j += blockDim.x) {
    const int f = j / (TL * K);
    const int rem = j - f * TL * K;
    const int tl = rem / K;
    const int k = rem - tl * K;
    const int t = tl / L;
    const int l = tl - t * L;
    const long long q = (p * TP + t) * K + k;
    const int eff = in.is_svc[p * TP + t] ? 0 : clip_layer(in.layer[q], L);
    int v = 0;
    if (eff == l) {
      switch (f) {
        case 0: v = in.sn[q]; break;
        case 1: v = in.ts[q]; break;
        case 2: v = in.size[q]; break;
        case 3: v = in.arrival[q]; break;
        default: v = in.valid[q] != 0; break;
      }
    }
    out.st[i * 5 * TL * K + j] = v;
  }
  for (int j = threadIdx.x; j < 3 * TL; j += blockDim.x) {
    const int f = j / TL;
    const int tl = j - f * TL;
    const int t = tl / L;
    const int l = tl - t * L;
    unsigned acc = 0u;
    for (int k = 0; k < K; ++k) {
      const long long q = (p * TP + t) * K + k;
      if (clip_layer(in.layer[q], L) != l || !in.valid[q]) continue;
      if (f == 2 && !in.begin_pic[q]) continue;
      acc += f == 1 ? static_cast<unsigned>(in.size[q]) : 1u;
    }
    out.tr[i * 3 * TL + j] = static_cast<int32_t>(acc);
  }

  __syncthreads();
  for (int j = threadIdx.x; j < SP; j += blockDim.x) {
    out.pkts[i * SP + j] = static_cast<int32_t>(sh_pkts[j]);
    out.bytes[i * SP + j] = static_cast<int32_t>(sh_bytes[j]);
  }
  if (threadIdx.x == 0) {
    out.fwd_pkts[i] = static_cast<int32_t>(sh_tot[0]);
    out.fwd_bytes[i] = static_cast<int32_t>(sh_tot[1]);
  }
}

__device__ void mix_page(unsigned* smem, long long i, long long p, const MixIn& in,
                         float* mixed, int TP, int SP, int N, int top_k) {
  float* lv = reinterpret_cast<float*>(smem);      // [TP]
  int* cnt = reinterpret_cast<int*>(lv + TP);      // [TP]
  float* thr = reinterpret_cast<float*>(cnt + TP); // [1]
  float* w = thr + 1;                              // [SP, TP]
  for (int t = threadIdx.x; t < TP; t += blockDim.x) {
    lv[t] = in.active[p * TP + t] ? in.level[p * TP + t] : -1.0f;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < TP; t += blockDim.x) {
    int c = 0;
    for (int u = 0; u < TP; ++u) c += lv[u] > lv[t];
    cnt[t] = c;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int k_eff = top_k < TP ? top_k : TP;
    float m = CUDART_INF_F;
    for (int t = 0; t < TP; ++t) {
      if (cnt[t] < k_eff && lv[t] < m) m = lv[t];
    }
    *thr = fmaxf(m, 0.0f);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < SP * TP; j += blockDim.x) {
    const int s = j / TP;
    const int t = j - s * TP;
    const bool speak = in.active[p * TP + t] && lv[t] >= *thr;
    const bool inc = speak && t != in.sub_track[p * SP + s];
    w[j] = __fmul_rn(inc ? 1.0f : 0.0f, in.gain[p * TP + t]);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < SP * N; j += blockDim.x) {
    const int s = j / N;
    const int n = j - s * N;
    float acc = 0.0f;
    for (int t = 0; t < TP; ++t) {
      acc = __fadd_rn(acc, __fmul_rn(w[s * TP + t], in.pcm[(p * TP + t) * N + n]));
    }
    mixed[i * SP * N + j] = acc;
  }
}

__global__ void paged_kernel(const int32_t* __restrict__ live_rows, DecideIn din,
                             DecideOut dout, MixIn min, float* __restrict__ mixed,
                             int P, int TP, int K, int SP, int spw, int N, int L,
                             int wire_overhead, int top_k, int with_decide, int with_mix) {
  extern __shared__ unsigned smem[];
  const long long i = blockIdx.x;
  const long long p = live_rows[i];
  if (p < 0 || p >= P) __trap();
  if (with_decide) decide_page(smem, i, p, din, dout, TP, K, SP, spw, L, wire_overhead);
  if (with_mix) {
    __syncthreads();  // the decide half's shared sums are read before reuse
    mix_page(smem, i, p, min, mixed, TP, SP, N, top_k);
  }
}

}  // namespace

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
  DecideIn din{
      static_cast<const int32_t*>(cur_sp), static_cast<const int32_t*>(cur_tp),
      static_cast<const int32_t*>(tgt_sp), static_cast<const int32_t*>(tgt_tp),
      static_cast<const uint8_t*>(is_svc), static_cast<const uint8_t*>(is_video),
      static_cast<const uint8_t*>(base),
      static_cast<const int32_t*>(layer), static_cast<const int32_t*>(temporal),
      static_cast<const uint8_t*>(keyframe), static_cast<const uint8_t*>(layer_sync),
      static_cast<const uint8_t*>(end_frame), static_cast<const uint8_t*>(valid),
      static_cast<const int32_t*>(size), static_cast<const int32_t*>(sn),
      static_cast<const int32_t*>(ts), static_cast<const int32_t*>(arrival),
      static_cast<const uint8_t*>(begin_pic)};
  DecideOut dout{
      static_cast<int32_t*>(send), static_cast<int32_t*>(drop), static_cast<int32_t*>(sw),
      static_cast<int32_t*>(out_sp), static_cast<int32_t*>(out_tp),
      static_cast<uint8_t*>(need_kf),
      static_cast<int32_t*>(pkts), static_cast<int32_t*>(bytes),
      static_cast<int32_t*>(fwd_pkts), static_cast<int32_t*>(fwd_bytes),
      static_cast<int32_t*>(st), static_cast<int32_t*>(tr)};
  MixIn min{static_cast<const float*>(pcm), static_cast<const float*>(level),
            static_cast<const uint8_t*>(active), static_cast<const float*>(gain),
            static_cast<const int32_t*>(sub_track)};
  int spw = 1;
  while (spw < SP) spw <<= 1;
  const int tracks_per_warp = 32 / spw;
  int warps = with_decide ? (TP + tracks_per_warp - 1) / tracks_per_warp : 1;
  if (with_mix && warps < 8) warps = 8;
  if (warps > 32) return static_cast<int>(cudaErrorInvalidConfiguration);
  // The mix half reuses the decide half's shared words.
  const int decide_words = with_decide ? 2 * SP + 2 : 0;
  const int mix_words = with_mix ? 2 * TP + 1 + SP * TP : 0;
  const size_t shared =
      static_cast<size_t>(decide_words > mix_words ? decide_words : mix_words) * sizeof(unsigned);
  if (NL > 0) {
    paged_kernel<<<NL, 32 * warps, shared, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(live_rows), din, dout, min,
        static_cast<float*>(mixed), P, TP, K, SP, spw, N, L, wire_overhead, top_k,
        with_decide, with_mix);
  }
  return static_cast<int>(cudaGetLastError());
}
