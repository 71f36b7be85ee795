// Host-side munge walker: expand bit-packed send/drop/switch masks and
// apply the SN/TS/VP8 offset rewrites in one pass.
//
// Reference parity: pkg/sfu/rtpmunger.go UpdateAndGetSnTs/PacketDropped and
// pkg/sfu/codecmunger/vp8.go UpdateAndGet — the per-packet CPU work the
// reference does in DownTrack.WriteRTP. Semantics are pinned bit-identical
// to ops/rtpmunger.py + ops/vp8.py (the jax scan spec) by
// tests/test_host_munge.py; the numpy implementation in runtime/munge.py
// is the readable fallback.
//
// Layout contract (see runtime/munge.py HostMunger):
//   packet fields  int32  [R*T*K]          (row-major r, t, k)
//   mask words     uint32 [R*T*K*W]        (bit s%32 of word s/32)
//   state arrays   int64  [R*T*S], bools uint8 [R*T*S] (updated in place)
//   outputs        int32 column arrays, capacity >= popcount(send&valid)
// Walk order matches np.nonzero: ascending (r, t, k, s).
//
// Sharding (munge_walk_multi): the egress plane partitions the room axis
// into contiguous ranges, one per worker shard. State rows are indexed
// [R, T, S], so whole-room ownership makes every state write disjoint
// across shards; per-shard outputs are written at exact prefix-sum bases
// so the concatenated result is bit-identical to a single walk — shard
// count never changes the output (pinned by tests/test_egress_plane.py).

#include <atomic>
#include <cstdint>
#include <thread>
#include <vector>

#include <time.h>

namespace {

constexpr int64_t M16 = 0xFFFF;
constexpr int64_t M32 = 0xFFFFFFFFll;
constexpr int64_t M15 = 0x7FFF;
constexpr int64_t M8 = 0xFF;
constexpr int64_t M5 = 0x1F;
constexpr int64_t REANCHOR_TS_THRESH = 900000;  // ops/rtpmunger.py
constexpr int64_t FALLBACK_TS_JUMP = 3000;

// Bump when the exported symbol set or any signature changes; the ctypes
// loader and tools/check.py compare it against the Python-side constant.
constexpr int32_t MUNGE_ABI = 2;

inline int64_t sdiff32(int64_t a, int64_t b) {
  int64_t d = (a - b + (1ll << 31)) & M32;
  return d - (1ll << 31);
}

inline int64_t now_ns() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (int64_t)ts.tv_sec * 1000000000ll + ts.tv_nsec;
}

struct WalkArgs {
  int32_t R, T, K, S, W;
  const uint32_t* send_bits;
  const uint32_t* drop_bits;
  const uint32_t* switch_bits;
  const int32_t* sn;
  const int32_t* ts;
  const int32_t* ts_jump;
  const int32_t* pid;
  const int32_t* tl0;
  const int32_t* ki;
  const uint8_t* begin_pic;
  const uint8_t* valid;
  int64_t* st_sn_off;
  int64_t* st_ts_off;
  int64_t* st_last_sn;
  int64_t* st_last_ts;
  uint8_t* st_started;
  uint8_t* st_aligned;
  int64_t* st_pid_off;
  int64_t* st_tl0_off;
  int64_t* st_ki_off;
  int64_t* st_last_pid;
  int64_t* st_last_tl0;
  int64_t* st_last_ki;
  uint8_t* st_v_started;
  int32_t* out_rooms;
  int32_t* out_tracks;
  int32_t* out_ks;
  int32_t* out_subs;
  int32_t* out_sn;
  int32_t* out_ts;
  int32_t* out_pid;
  int32_t* out_tl0;
  int32_t* out_ki;
};

// Exact count of egress entries rooms [r_lo, r_hi) will emit: send bits on
// valid lanes, ghost bits (s >= S) masked out of the last word so shard
// output bases computed from these counts leave no holes.
int64_t count_range(const WalkArgs& a, int32_t r_lo, int32_t r_hi) {
  const int32_t tail = a.S % 32;
  const uint32_t last_mask = tail ? ((1u << tail) - 1) : 0xFFFFFFFFu;
  int64_t need = 0;
  const int64_t lo = (int64_t)r_lo * a.T * a.K;
  const int64_t hi = (int64_t)r_hi * a.T * a.K;
  for (int64_t rtk = lo; rtk < hi; ++rtk) {
    if (!a.valid[rtk]) continue;
    for (int32_t w = 0; w < a.W; ++w) {
      uint32_t bits = a.send_bits[rtk * a.W + w];
      if (w == a.W - 1) bits &= last_mask;
      need += __builtin_popcount(bits);
    }
  }
  return need;
}

// Walk rooms [r_lo, r_hi), writing entries at out index `base`. Returns
// entries written, or -2 when the post-mutation guard fires (state already
// half-advanced — see the -2 contract on munge_walk below).
int64_t walk_range(const WalkArgs& a, int32_t r_lo, int32_t r_hi,
                   int64_t base, int64_t cap) {
  const int32_t T = a.T, K = a.K, S = a.S, W = a.W;
  int64_t n = base;
  const int64_t lim = base + cap;
  for (int32_t r = r_lo; r < r_hi; ++r) {
    for (int32_t t = 0; t < T; ++t) {
      const int64_t rt = (int64_t)r * T + t;
      const int64_t pk_base = rt * K;
      const int64_t st_base = rt * S;
      for (int32_t k = 0; k < K; ++k) {
        if (!a.valid[pk_base + k]) continue;
        const int64_t wb = (pk_base + k) * W;
        // Visit only lanes with a send or drop bit (switch ⊆ send).
        bool any = false;
        for (int32_t w = 0; w < W; ++w) {
          if (a.send_bits[wb + w] | a.drop_bits[wb + w]) { any = true; break; }
        }
        if (!any) continue;
        const int64_t p_sn = (int64_t)(uint32_t)a.sn[pk_base + k] & M16;
        const int64_t p_ts = (int64_t)(uint32_t)a.ts[pk_base + k] & M32;
        const int64_t p_jump = a.ts_jump[pk_base + k];
        const bool pkt_aligned = p_jump < 0;
        const int64_t jump_eff = pkt_aligned ? FALLBACK_TS_JUMP : p_jump;
        const int64_t p_pid = (int64_t)(uint32_t)a.pid[pk_base + k] & M15;
        const int64_t p_tl0 = (int64_t)(uint32_t)a.tl0[pk_base + k] & M8;
        const int64_t p_ki = (int64_t)(uint32_t)a.ki[pk_base + k] & M5;
        const bool bp = a.begin_pic[pk_base + k] != 0;
        for (int32_t w = 0; w < W; ++w) {
          uint32_t bits = a.send_bits[wb + w] | a.drop_bits[wb + w];
          while (bits) {
            const int32_t b = __builtin_ctz(bits);
            bits &= bits - 1;
            const int32_t s = w * 32 + b;
            if (s >= S) break;
            const uint32_t m = 1u << b;
            const bool fwd = (a.send_bits[wb + w] & m) != 0;
            const bool drp = !fwd && (a.drop_bits[wb + w] & m) != 0;
            const bool sw = fwd && (a.switch_bits[wb + w] & m) != 0;
            const int64_t i = st_base + s;

            // ---- rtpmunger step (runtime/munge.py apply_dense) --------
            const bool fresh = fwd && !a.st_started[i];
            const bool resync = sw && a.st_started[i];
            if (resync) {
              a.st_sn_off[i] = (p_sn - ((a.st_last_sn[i] + 1) & M16)) & M16;
              int64_t sw_ts_off =
                  (p_ts - ((a.st_last_ts[i] + jump_eff) & M32)) & M32;
              if (pkt_aligned && a.st_aligned[i]) sw_ts_off = a.st_ts_off[i];
              a.st_ts_off[i] = sw_ts_off;
              a.st_aligned[i] = pkt_aligned;
            } else if (fresh) {
              a.st_sn_off[i] = 0;
              a.st_ts_off[i] = 0;
              a.st_aligned[i] = pkt_aligned;
            } else if (fwd && a.st_started[i]) {
              // Timeline shear guard (continuing forward only).
              const int64_t cur_out_ts = (p_ts - a.st_ts_off[i]) & M32;
              const int64_t shear = sdiff32(cur_out_ts, a.st_last_ts[i]);
              if (shear > REANCHOR_TS_THRESH || shear < -REANCHOR_TS_THRESH) {
                a.st_ts_off[i] =
                    (p_ts - ((a.st_last_ts[i] + FALLBACK_TS_JUMP) & M32)) & M32;
                a.st_aligned[i] = pkt_aligned;
              }
            }
            const int64_t o_sn = (p_sn - a.st_sn_off[i]) & M16;
            const int64_t o_ts = (p_ts - a.st_ts_off[i]) & M32;
            if (fwd) {
              a.st_last_sn[i] = o_sn;
              a.st_last_ts[i] = o_ts;
            }
            if (drp && a.st_started[i]) {
              a.st_sn_off[i] = (a.st_sn_off[i] + 1) & M16;
            }
            if (fwd) a.st_started[i] = 1;

            // ---- vp8 step ---------------------------------------------
            const bool v_fresh = fwd && !a.st_v_started[i];
            const bool v_resync = sw && a.st_v_started[i];
            if (v_resync) {
              a.st_pid_off[i] = (p_pid - ((a.st_last_pid[i] + 1) & M15)) & M15;
              a.st_tl0_off[i] = (p_tl0 - a.st_last_tl0[i] - 1) & M8;
              a.st_ki_off[i] = (p_ki - a.st_last_ki[i] - 1) & M5;
            } else if (v_fresh) {
              a.st_pid_off[i] = 0;
              a.st_tl0_off[i] = 0;
              a.st_ki_off[i] = 0;
            }
            const int64_t o_pid = (p_pid - a.st_pid_off[i]) & M15;
            const int64_t o_tl0 = (p_tl0 - a.st_tl0_off[i]) & M8;
            const int64_t o_ki = (p_ki - a.st_ki_off[i]) & M5;
            if (fwd && bp) {
              a.st_last_pid[i] = o_pid;
              a.st_last_tl0[i] = o_tl0;
              a.st_last_ki[i] = o_ki;
            }
            if (drp && bp && a.st_v_started[i]) {
              a.st_pid_off[i] = (a.st_pid_off[i] + 1) & M15;
            }
            if (fwd) a.st_v_started[i] = 1;

            if (fwd) {
              // Post-mutation guard: see -2 contract on munge_walk.
              if (n >= lim) return -2;
              a.out_rooms[n] = r;
              a.out_tracks[n] = t;
              a.out_ks[n] = k;
              a.out_subs[n] = s;
              a.out_sn[n] = (int32_t)o_sn;
              a.out_ts[n] = (int32_t)(uint32_t)o_ts;
              a.out_pid[n] = (int32_t)o_pid;
              a.out_tl0[n] = (int32_t)o_tl0;
              a.out_ki[n] = (int32_t)o_ki;
              ++n;
            }
          }
        }
      }
    }
  }
  return n - base;
}

}  // namespace

extern "C" {

int32_t munge_abi_version(void) { return MUNGE_ABI; }

// Returns the number of egress entries written, or -1 if cap would
// overflow. The capacity check happens in a COUNTING pre-pass before any
// state mutation: a mid-walk bailout would leave the munger offsets
// half-advanced, and the caller's fallback would then double-apply the
// tick (state corruption on every walked lane).
//
// -2 is the invariant-violation code: the mid-walk overflow guard fired
// AFTER mutation began (the pre-pass counts exactly — ghost bits at
// s >= S are masked — so this should be unreachable). It is distinct from
// -1 on purpose: -1 means "nothing touched, fall back to the dense path",
// while -2 means "state already half-advanced, a fallback would
// double-apply" — the Python wrapper raises on it instead of falling back.
int64_t munge_walk(
    int32_t R, int32_t T, int32_t K, int32_t S, int32_t W,
    const uint32_t* send_bits, const uint32_t* drop_bits,
    const uint32_t* switch_bits,
    const int32_t* sn, const int32_t* ts, const int32_t* ts_jump,
    const int32_t* pid, const int32_t* tl0, const int32_t* ki,
    const uint8_t* begin_pic, const uint8_t* valid,
    int64_t* st_sn_off, int64_t* st_ts_off, int64_t* st_last_sn,
    int64_t* st_last_ts, uint8_t* st_started, uint8_t* st_aligned,
    int64_t* st_pid_off, int64_t* st_tl0_off, int64_t* st_ki_off,
    int64_t* st_last_pid, int64_t* st_last_tl0, int64_t* st_last_ki,
    uint8_t* st_v_started,
    int32_t* out_rooms, int32_t* out_tracks, int32_t* out_ks,
    int32_t* out_subs, int32_t* out_sn, int32_t* out_ts, int32_t* out_pid,
    int32_t* out_tl0, int32_t* out_ki, int64_t cap) {
  WalkArgs a{R, T, K, S, W, send_bits, drop_bits, switch_bits,
             sn, ts, ts_jump, pid, tl0, ki, begin_pic, valid,
             st_sn_off, st_ts_off, st_last_sn, st_last_ts, st_started,
             st_aligned, st_pid_off, st_tl0_off, st_ki_off, st_last_pid,
             st_last_tl0, st_last_ki, st_v_started,
             out_rooms, out_tracks, out_ks, out_subs, out_sn, out_ts,
             out_pid, out_tl0, out_ki};
  if (count_range(a, 0, R) > cap) return -1;  // nothing mutated yet
  return walk_range(a, 0, R, 0, cap);
}

// Sharded walk: n_shards contiguous room ranges [r_lo[i], r_hi[i]),
// walked concurrently. The calling thread counts each shard exactly
// (a popcount pass, far cheaper than the walk), so outputs land at
// prefix-sum bases and the concatenation is bit-identical to one
// munge_walk over [0, R). Same return contract as munge_walk (-1 = cap
// overflow before any mutation; -2 = post-mutation guard, should be
// unreachable). shard_counts[i] receives each shard's entry count and
// shard_ns[i] its walk wall time.
int64_t munge_walk_multi(
    int32_t n_shards, const int32_t* r_lo, const int32_t* r_hi,
    int64_t* shard_counts, int64_t* shard_ns,
    int32_t R, int32_t T, int32_t K, int32_t S, int32_t W,
    const uint32_t* send_bits, const uint32_t* drop_bits,
    const uint32_t* switch_bits,
    const int32_t* sn, const int32_t* ts, const int32_t* ts_jump,
    const int32_t* pid, const int32_t* tl0, const int32_t* ki,
    const uint8_t* begin_pic, const uint8_t* valid,
    int64_t* st_sn_off, int64_t* st_ts_off, int64_t* st_last_sn,
    int64_t* st_last_ts, uint8_t* st_started, uint8_t* st_aligned,
    int64_t* st_pid_off, int64_t* st_tl0_off, int64_t* st_ki_off,
    int64_t* st_last_pid, int64_t* st_last_tl0, int64_t* st_last_ki,
    uint8_t* st_v_started,
    int32_t* out_rooms, int32_t* out_tracks, int32_t* out_ks,
    int32_t* out_subs, int32_t* out_sn, int32_t* out_ts, int32_t* out_pid,
    int32_t* out_tl0, int32_t* out_ki, int64_t cap) {
  WalkArgs a{R, T, K, S, W, send_bits, drop_bits, switch_bits,
             sn, ts, ts_jump, pid, tl0, ki, begin_pic, valid,
             st_sn_off, st_ts_off, st_last_sn, st_last_ts, st_started,
             st_aligned, st_pid_off, st_tl0_off, st_ki_off, st_last_pid,
             st_last_tl0, st_last_ki, st_v_started,
             out_rooms, out_tracks, out_ks, out_subs, out_sn, out_ts,
             out_pid, out_tl0, out_ki};
  if (n_shards <= 0) return 0;
  if (n_shards == 1) {
    shard_counts[0] = count_range(a, r_lo[0], r_hi[0]);
    if (shard_counts[0] > cap) return -1;
    const int64_t t0 = now_ns();
    const int64_t n = walk_range(a, r_lo[0], r_hi[0], 0, cap);
    shard_ns[0] = now_ns() - t0;
    return n;
  }
  int64_t total = 0;
  std::vector<int64_t> bases(n_shards, 0);
  for (int w = 0; w < n_shards; ++w) {
    shard_counts[w] = count_range(a, r_lo[w], r_hi[w]);
    bases[w] = total;
    total += shard_counts[w];
  }
  if (total > cap) return -1;  // nothing mutated yet
  // The caller and n_shards - 1 spawned threads claim shards from one
  // counter, and nobody waits on another before its walk: a thread the
  // host schedules late finds its share already taken, where a barrier
  // would hold every other thread spinning until it ran.
  std::atomic<int> next{0};
  std::vector<int64_t> results(n_shards, 0);
  auto work = [&] {
    for (int w; (w = next.fetch_add(1)) < n_shards;) {
      const int64_t t0 = now_ns();
      results[w] = walk_range(a, r_lo[w], r_hi[w], bases[w], shard_counts[w]);
      shard_ns[w] = now_ns() - t0;
    }
  };
  std::vector<std::thread> ths;
  for (int w = 1; w < n_shards; ++w) ths.emplace_back(work);
  work();
  for (auto& t : ths) t.join();
  int64_t written = 0;
  for (int w = 0; w < n_shards; ++w) {
    if (results[w] < 0) return -2;
    written += results[w];
  }
  return written;
}

}  // extern "C"
