// Phase 2 of the media-plane tick: cooperative layer allocation under each
// subscriber's budget, for every room, as one CUDA kernel for Hopper
// (sm_90a).
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
// What bounds it on the H100: bytes. Per (room, subscriber, track) it does
// a few integer and float compares against ~9 bytes in and 5 bytes out,
// far below the card's compute rate; the floor is moving the bitrate rows,
// caps, mute flags and budgets in and the targets, used budgets and
// deficiency flags out once each, over 3.35 TB/s. The walk over tracks is
// serial per subscriber, so the design takes every dependent load out of
// it and keeps the device-memory traffic wide and in flight beside it.
//
// Design:
//  * Persistent blocks, four on an SM, each walking tiles of RB
//    consecutive rooms. A room's operands are contiguous, so a tile is one
//    contiguous span per operand, staged into shared memory by 16-byte
//    cp.async (staging.cuh), all of it in flight at once; while one block
//    computes, the other blocks' copies are in flight. (A two-stage ring
//    per block measured slower at the same shared memory: half the rooms
//    a tile, and the per-tile phases cost more than the overlap gained.)
//    Each of the tile's five operand spans is staged, and each of its two
//    output spans written, by one warp, so the other warps skip that
//    span's set-up.
//  * Track pass: one bit per (room, track, layer) "bitrate > 0", formed
//    by one __ballot_sync over 32 consecutive bitrates (two tracks).
//  * Pass 0, over every (room, subscriber, track) in parallel, once: the
//    allowed-layer mask = exists & spatial cap & temporal cap (0 when
//    muted), and the bitrates of its lowest and highest allowed layers,
//    into one 16-byte record (rows padded to an odd record count, so the
//    threads of a warp read distinct banks).
//  * Passes 1 and 2, one thread per (room, subscriber), read one record a
//    track; no load depends on the budget, so they run ahead of it. Pass
//    2 takes the highest allowed layer when it fits, else searches the
//    allowed layers below it from the top (the only bitrate-row reads).
//  * The remaining budget is updated with the same float32 operations in
//    the same track order as the reference (bl = bl - lo_cost in pass 1;
//    avail = bl + lo_cost, bl = avail - cost in pass 2; used = budget -
//    bl). No multiply enters the chain, so contraction into FMA cannot
//    alter it: `used` and `target` are bit-identical to the reference's.
//  * Targets and deficiency flags are staged in the tile's spent cap and
//    mute slots and leave as 16-byte coalesced stores; `used` leaves one
//    coalesced float per (room, subscriber).

#include <cstdint>
#include <cuda_runtime.h>

#include "staging.cuh"

namespace {

constexpr int kLayers = 16;        // 4 spatial x 4 temporal, flat l = 4*s + t
constexpr int kThreads = 256;
constexpr size_t kBlockSmem = 56 * 1024;   // four blocks on an SM
constexpr int kMaxTileRooms = 256;

using staging::slot_bytes;

// Shared-memory layout of a block that walks tiles of `rb` rooms: the five
// operand slots, then the per-track bitrate-exists masks and one 16-byte
// record per (room, subscriber, track), rows padded to an odd number of
// records.
struct Layout {
  size_t bit, msp, mtp, mut, bud, stage, exists, recs, total;
  __host__ __device__ Layout(int T, int S, int rb) {
    const size_t n = static_cast<size_t>(rb) * S * T;
    bit = 0;
    msp = bit + slot_bytes(static_cast<size_t>(rb) * T * kLayers * 4);
    mtp = msp + slot_bytes(n * 4);
    mut = mtp + slot_bytes(n * 4);
    bud = mut + slot_bytes(n);
    stage = bud + slot_bytes(static_cast<size_t>(rb) * S * 4);
    exists = stage;
    recs = exists + slot_bytes(static_cast<size_t>(rb) * T * 4);
    total = recs + static_cast<size_t>(rb) * S * (T | 1) * 16;
  }
};

// Layers within the caps: spatial l/4 <= max_sp and temporal l%4 <= max_tp.
__device__ __forceinline__ uint32_t cap_mask(int max_sp, int max_tp) {
  const uint32_t sp = max_sp < 0 ? 0u : (max_sp >= 3 ? 0xFFFFu : (1u << (4 * (max_sp + 1))) - 1u);
  const uint32_t tp = max_tp < 0 ? 0u : (max_tp >= 3 ? 0xFu : (1u << (max_tp + 1)) - 1u);
  return sp & (tp * 0x1111u);
}

// Record of one (room, subscriber, track): x = allowed-layer mask, y/z =
// bitrate of its lowest/highest allowed layer (NaN when none, so no
// compare admits it), w = the result, (target & 0xFF) | deficient << 8.
__global__ void __launch_bounds__(kThreads) budget_rooms_kernel(
    const float* __restrict__ bitrates,     // [R, T, 16]
    const int32_t* __restrict__ max_sp,     // [R, S, T]
    const int32_t* __restrict__ max_tp,     // [R, S, T]
    const uint8_t* __restrict__ muted,      // [R, S, T]
    const float* __restrict__ budget,       // [R, S]
    int32_t* __restrict__ target,           // [R, S, T]
    float* __restrict__ used,               // [R, S]
    uint8_t* __restrict__ deficient,        // [R, S, T]
    int R, int T, int S, int rb, long long tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay(T, S, rb);
  uint32_t* exists = reinterpret_cast<uint32_t*>(smem + lay.exists);
  uint4* recs = reinterpret_cast<uint4*>(smem + lay.recs);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int Tp = T | 1;
  const long long ST = static_cast<long long>(S) * T;
  // Thread stride over (room-subscriber, track) pairs, as (rows, tracks).
  const int step_rs = nt / T, step_t = nt - (nt / T) * T;
  const float inv_s = 1.0f / static_cast<float>(S);

  // Span i of a tile (an operand in, or an output out) moves with the 32
  // lanes of warp i % warps, so its setup runs in one warp, not in all.
  const int warp = tid >> 5, nwarps = nt >> 5;
  auto mine = [&](int span) { return span % nwarps == warp; };
  auto stage_tile = [&](long long tile) {
    const long long r0 = tile * rb;
    const long long rows = R - r0 < rb ? R - r0 : rb;
    if (mine(0))
      staging::stage(smem + lay.bit, bitrates + r0 * T * kLayers, rows * T * kLayers * 4, lane, 32);
    if (mine(1)) staging::stage(smem + lay.msp, max_sp + r0 * ST, rows * ST * 4, lane, 32);
    if (mine(2)) staging::stage(smem + lay.mtp, max_tp + r0 * ST, rows * ST * 4, lane, 32);
    if (mine(3)) staging::stage(smem + lay.mut, muted + r0 * ST, rows * ST, lane, 32);
    if (mine(4)) staging::stage(smem + lay.bud, budget + r0 * S, rows * S * 4, lane, 32);
  };

  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    stage_tile(tile);
    staging::commit();
    staging::wait<0>();
    __syncthreads();

    const long long r0 = tile * rb;
    const int rows = static_cast<int>(R - r0 < rb ? R - r0 : rb);
    const float* b = staging::placed<const float>(smem + lay.bit, bitrates + r0 * T * kLayers);
    const int32_t* msp = staging::placed<const int32_t>(smem + lay.msp, max_sp + r0 * ST);
    const int32_t* mtp = staging::placed<const int32_t>(smem + lay.mtp, max_tp + r0 * ST);
    const uint8_t* mut = staging::placed<const uint8_t>(smem + lay.mut, muted + r0 * ST);
    const float* bud = staging::placed<const float>(smem + lay.bud, budget + r0 * S);

    // Track pass: bit l of exists[room*T + t] = bitrate l > 0. Lanes 0-15
    // of a warp hold one track's 16 bitrates, lanes 16-31 the next's.
    const int nb = rows * T * kLayers;
    for (int i = tid; i < ((nb + 31) & ~31); i += nt) {
      const unsigned v = __ballot_sync(0xffffffffu, i < nb && b[i] > 0.0f);
      if (i < nb && (lane & 15) == 0) exists[i >> 4] = (v >> (lane & 16)) & 0xFFFFu;
    }
    __syncthreads();

    // Pass 0: every (room, subscriber, track)'s allowed-layer mask and the
    // bitrates of its lowest and highest allowed layer.
    const int ne = rows * S * T;
    {
      int rs = tid / T, t = tid - (tid / T) * T;
      for (int e = tid; e < ne; e += nt) {
        // rs / S without an integer division: exact while the product's
        // error, below (rs / S) * 2^-23, stays under 0.5 / S, i.e. rs < 2^22
        // (a tile's rs fits in shared memory at 16 bytes each: < 2^14).
        const int q = __float2int_rz((rs + 0.5f) * inv_s) * T + t;   // (room, track)
        const uint32_t a = mut[e] ? 0u : exists[q] & cap_mask(msp[e], mtp[e]);
        const float* bt = b + q * kLayers;
        const float nan = __uint_as_float(0x7fc00000u);
        const float c_lo = a != 0u ? bt[__ffs(a) - 1] : nan;
        const float c_hi = a != 0u ? bt[31 - __clz(a)] : nan;
        recs[rs * Tp + t] = make_uint4(a, __float_as_uint(c_lo), __float_as_uint(c_hi), 0u);
        rs += step_rs;
        t += step_t;
        if (t >= T) {
          t -= T;
          ++rs;
        }
      }
    }
    __syncthreads();

    // Passes 1 and 2: one thread per (room, subscriber), tracks in order,
    // reading the records (and the bitrate row only when an upgrade below
    // the highest allowed layer is searched).
    for (int rs = tid; rs < rows * S; rs += nt) {
      uint4* rec = recs + rs * Tp;
      const float* brow = b + (rs / S) * T * kLayers;
      const float budget_rs = bud[rs];
      float bl = budget_rs;
      unsigned long long got = 0ull;
#pragma unroll 4
      for (int t = 0; t < T; ++t) {                            // pass 1
        const float lo_cost = __uint_as_float(rec[t].y);
        if (lo_cost <= bl) {
          bl = bl - lo_cost;
          got |= 1ull << t;
        }
      }
#pragma unroll 4
      for (int t = 0; t < T; ++t) {                            // pass 2
        const uint4 r = rec[t];
        const uint32_t a = r.x;
        const int hi = a != 0u ? 31 - __clz(a) : -1;
        int best = -1;
        if ((got >> t) & 1ull) {
          const int lo = __ffs(a) - 1;
          const float lo_cost = __uint_as_float(r.y), hi_cost = __uint_as_float(r.z);
          const float avail = bl + lo_cost;
          float cost;
          if (hi_cost <= avail) {
            best = hi;
            cost = hi_cost;
          } else {
            best = lo;
            cost = lo_cost;
            const float* bt = brow + t * kLayers;
            for (uint32_t m = a & ~((2u << lo) - 1u) & ~(1u << hi); m != 0u;) {
              const int l = 31 - __clz(m);
              if (bt[l] <= avail) {
                best = l;
                cost = bt[l];
                break;
              }
              m &= ~(1u << l);
            }
          }
          bl = avail - cost;
        }
        rec[t].w = (static_cast<uint32_t>(best) & 0xFFu) | (hi >= 0 && best < hi ? 0x100u : 0u);
      }
      used[r0 * S + rs] = budget_rs - bl;
    }
    __syncthreads();

    // Stage targets and flags in the spent cap/mute slots, placed for
    // 16-byte stores, and write them out.
    int32_t* tgt_s = staging::placed<int32_t>(smem + lay.msp, target + r0 * ST);
    uint8_t* def_s = staging::placed<uint8_t>(smem + lay.mut, deficient + r0 * ST);
    {
      int rs = tid / T, t = tid - (tid / T) * T;
      for (int e = tid; e < ne; e += nt) {
        const uint32_t v = recs[rs * Tp + t].w;
        tgt_s[e] = static_cast<int32_t>(static_cast<int8_t>(v & 0xFFu));
        def_s[e] = static_cast<uint8_t>((v >> 8) & 1u);
        rs += step_rs;
        t += step_t;
        if (t >= T) {
          t -= T;
          ++rs;
        }
      }
    }
    __syncthreads();
    if (mine(0)) staging::store(target + r0 * ST, tgt_s, static_cast<size_t>(ne) * 4, lane, 32);
    if (mine(1)) staging::store(deficient + r0 * ST, def_s, static_cast<size_t>(ne), lane, 32);
    __syncthreads();
  }
}

}  // namespace

// 1 if the kernel can take T tracks and S subscribers (one room's tile
// fits the card's shared memory), else 0. The wrapper's one guard: the launch
// does not check again.
extern "C" int budget_rooms_fits(int T, int S) {
  return Layout(T, S, 1).total <= staging::max_smem() ? 1 : 0;
}

extern "C" int budget_rooms_launch(const void* bitrates, const void* max_sp,
                                   const void* max_tp, const void* muted,
                                   const void* budget, void* target, void* used,
                                   void* deficient, int R, int T, int S,
                                   void* stream) {
  if (R <= 0) return static_cast<int>(cudaGetLastError());
  int rb = 1;
  while (rb < R && rb < kMaxTileRooms && Layout(T, S, rb + 1).total <= kBlockSmem) ++rb;
  const size_t smem = Layout(T, S, rb).total;
  const long long tiles = (static_cast<long long>(R) + rb - 1) / rb;
  cudaError_t err = cudaSuccess;
  const int blocks = staging::persistent_blocks(budget_rooms_kernel, kThreads, smem, tiles, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  budget_rooms_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(bitrates), static_cast<const int32_t*>(max_sp),
      static_cast<const int32_t*>(max_tp), static_cast<const uint8_t*>(muted),
      static_cast<const float*>(budget), static_cast<int32_t*>(target),
      static_cast<float*>(used), static_cast<uint8_t*>(deficient), R, T, S, rb, tiles);
  return static_cast<int>(cudaGetLastError());
}
