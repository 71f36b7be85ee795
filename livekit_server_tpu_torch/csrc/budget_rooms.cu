// Phase 2 of the dense media-plane tick: cooperative layer allocation
// under each subscriber's budget, for every room, as one CUDA kernel for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel livekit_server_tpu/ops/allocation.py
// `_budget_rooms_kernel` (driven by `allocate_budget_rooms`). Per
// (room, subscriber), over the tracks in order: pass 1 grants each track
// its lowest allowed layer if it fits the remaining float32 budget; pass 2
// upgrades each granted track to its highest allowed layer that fits the
// remaining budget plus its own grant. A layer is allowed when its bitrate
// is > 0, it is within the subscriber's max spatial/temporal layer, and
// the track is not muted for the subscriber. The plain PyTorch version is
// `allocate_budget_rooms_plain` in ops/allocation.py.
//
// What bounds it on the H100: bytes. Each (room, subscriber) does a few
// dozen compares per track over a 16-entry bitrate row, far below the
// card's compute rate; the floor is moving the bitrate rows, the caps,
// mute flags and budgets in and the targets, used budget and deficiency
// flags out, over 3.35 TB/s.
//
// Design:
//  * One thread per (room, subscriber), threads of a warp on consecutive
//    subscribers of a room, so they share (broadcast) each bitrate row.
//  * The remaining budget lives in a register and is updated with the
//    same float32 operations in the same track order as the reference
//    (bl -= lo_cost in pass 1; avail = bl + lo_cost, bl = avail - cost in
//    pass 2; used = budget - bl). There is no multiply in this chain, so
//    floating-point contraction into FMA cannot alter it: `used` and
//    `target` are bit-identical to the reference's.
//  * Pass 1's grants are kept as a 64-bit mask (the wrapper requires
//    T <= 64); pass 2 recomputes each track's allowed set from the inputs
//    instead of holding per-track arrays in local memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLayers = 16;    // 4 spatial x 4 temporal, flat l = 4*s + t
constexpr int kMaxTemporal = 4;

struct TrackLayers {
  unsigned allowed;  // bit l set: layer l allowed
  int lo;            // lowest allowed layer, -1 if none
  int hi;            // highest allowed layer, -1 if none
};

__device__ __forceinline__ TrackLayers track_layers(const float* b, int max_sp,
                                                    int max_tp, bool muted) {
  TrackLayers out{0u, -1, -1};
  if (muted) return out;
  for (int l = 0; l < kLayers; ++l) {
    const bool a = (b[l] > 0.0f) && (l / kMaxTemporal <= max_sp) &&
                   (l % kMaxTemporal <= max_tp);
    if (a) {
      out.allowed |= 1u << l;
      if (out.lo < 0) out.lo = l;
      out.hi = l;
    }
  }
  return out;
}

__global__ void budget_rooms_kernel(
    const float* __restrict__ bitrates,     // [R, T, 16]
    const int32_t* __restrict__ max_sp,     // [R, S, T]
    const int32_t* __restrict__ max_tp,     // [R, S, T]
    const uint8_t* __restrict__ muted,      // [R, S, T]
    const float* __restrict__ budget,       // [R, S]
    int32_t* __restrict__ target,           // [R, S, T]
    float* __restrict__ used,               // [R, S]
    uint8_t* __restrict__ deficient,        // [R, S, T]
    long long RS, int T, int S) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= RS) return;
  const long long r = i / S;
  const float* b_room = bitrates + r * T * kLayers;
  const long long row = i * T;

  float bl = budget[i];
  unsigned long long got = 0ull;
  for (int t = 0; t < T; ++t) {                                // pass 1
    const float* b = b_room + t * kLayers;
    const TrackLayers tl = track_layers(b, max_sp[row + t], max_tp[row + t],
                                        muted[row + t] != 0);
    const float lo_cost = tl.lo >= 0 ? b[tl.lo] : 0.0f;
    if (tl.lo >= 0 && lo_cost <= bl) {
      bl = bl - lo_cost;
      got |= 1ull << t;
    }
  }
  for (int t = 0; t < T; ++t) {                                // pass 2
    const float* b = b_room + t * kLayers;
    const TrackLayers tl = track_layers(b, max_sp[row + t], max_tp[row + t],
                                        muted[row + t] != 0);
    int best = -1;
    if ((got >> t) & 1ull) {
      const float avail = bl + b[tl.lo];
      for (int l = 0; l < kLayers; ++l) {
        if (((tl.allowed >> l) & 1u) && b[l] <= avail) best = l;
      }
      if (best < tl.lo) best = tl.lo;
      bl = avail - b[best];
    }
    target[row + t] = best;
    deficient[row + t] = (tl.hi >= 0 && best < tl.hi) ? 1 : 0;
  }
  used[i] = budget[i] - bl;
}

}  // namespace

extern "C" int budget_rooms_launch(const void* bitrates, const void* max_sp,
                                   const void* max_tp, const void* muted,
                                   const void* budget, void* target, void* used,
                                   void* deficient, int R, int T, int S,
                                   void* stream) {
  const long long RS = static_cast<long long>(R) * S;
  const int threads = 128;
  const long long blocks = (RS + threads - 1) / threads;
  if (blocks > 0) {
    budget_rooms_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(bitrates), static_cast<const int32_t*>(max_sp),
        static_cast<const int32_t*>(max_tp), static_cast<const uint8_t*>(muted),
        static_cast<const float*>(budget), static_cast<int32_t*>(target),
        static_cast<float*>(used), static_cast<uint8_t*>(deficient), RS, T, S);
  }
  return static_cast<int>(cudaGetLastError());
}
