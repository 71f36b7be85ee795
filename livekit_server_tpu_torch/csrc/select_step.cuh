// One packet's step of the simulcast and SVC selector state machines, for
// one subscriber of one track (decide_rooms.cu, paged_kernel.cu).
//
// The steps are those of the JAX package's ops/selector.py
// `_decide_rooms_kernel`, written per subscriber lane: `cur_sp`/`cur_tp`
// are the subscriber's current spatial/temporal layers, updated in place;
// `tgt_sp`/`tgt_tp` its targets (`paused` = tgt_sp < 0); `val` whether
// the packet exists. A caller that steps only over valid packets passes
// `val = true`, which the compiler folds away. An invalid packet
// forwards, drops and switches nothing and leaves the layers as they are,
// except that a paused subscriber's spatial layer becomes -1.
//
// Internal linkage, like staging.cuh: each kernel's library keeps its own
// copy.

#pragma once

namespace select_step {
namespace {

// Bits of a packed packet's flag word ({layer, temporal, size, flags}).
enum Flag : int { kKeyframe = 1, kSync = 2, kEndFrame = 4, kValid = 8 };

struct Decision {
  bool fwd, drop, sw;
};

// Simulcast: a keyframe of the target spatial layer switches to it; on the
// current layer a layer-sync packet raises the temporal layer toward the
// target, and a lower target takes effect at once.
__device__ __forceinline__ Decision simulcast(bool val, int sp, int tp, bool kf, bool sync,
                                              int tgt_sp, int tgt_tp, bool paused,
                                              int& cur_sp, int& cur_tp) {
  const bool want = (tgt_sp != cur_sp) && (tgt_sp >= 0);
  const bool sw = val && kf && want && (sp == tgt_sp);
  const int c_sp = sw ? tgt_sp : cur_sp;
  int c_tp = sw ? tgt_tp : cur_tp;
  const bool on_cur = val && (sp == c_sp) && (c_sp >= 0);
  if (on_cur && sync && tp <= tgt_tp && tp > c_tp) c_tp = tp;
  if (on_cur && tgt_tp < c_tp) c_tp = tgt_tp;
  cur_sp = paused ? -1 : c_sp;
  cur_tp = c_tp;
  return {on_cur && (tp <= c_tp) && !paused, on_cur && (!(tp <= c_tp) || paused), sw};
}

// SVC onion: the spatial layer goes up at a keyframe and down at the end
// of a frame; every packet at or below the current layers is forwarded.
__device__ __forceinline__ Decision svc(bool val, int sp, int tp, bool kf, bool sync, bool eof,
                                        int tgt_sp, int tgt_tp, bool paused, int& cur_sp,
                                        int& cur_tp) {
  const bool up = val && kf && (tgt_sp > cur_sp) && (sp <= tgt_sp);
  const int s_sp = up ? tgt_sp : cur_sp;
  const bool down = val && eof && (tgt_sp >= 0) && (tgt_sp < s_sp);
  const bool on_stream = val && (s_sp >= 0);
  int s_tp = up ? tgt_tp : cur_tp;
  if (on_stream && sync && tp <= tgt_tp && tp > s_tp) s_tp = tp;
  if (on_stream && tgt_tp < s_tp) s_tp = tgt_tp;
  const bool fwd = on_stream && (sp <= s_sp) && (tp <= s_tp) && !paused;
  cur_sp = paused ? -1 : (down ? tgt_sp : s_sp);
  cur_tp = s_tp;
  return {fwd, on_stream && !fwd, false};
}

}  // namespace
}  // namespace select_step
