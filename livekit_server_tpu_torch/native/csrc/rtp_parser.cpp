// Batch RTP parser — the native half of the ingest path.
//
// Reference parity: the parsing the reference does per packet in Go inside
// buffer.Buffer.calc (pkg/sfu/buffer/buffer.go:417-491: header fields,
// RFC 8285 one-byte header extensions incl. RFC 6464 audio level, VP8
// payload descriptor via buffer/vp8.go). Here it is a C++ batch routine:
// the UDP receiver hands a packed buffer of N datagrams and gets back
// column arrays ready to memcpy into the IngestBuffer's numpy tensors —
// one native call per receive batch instead of per-packet Go allocations.
//
// Build: g++ -O2 -shared -fPIC -o librtp_parser.so rtp_parser.cpp
// ABI: plain C, loaded via ctypes (livekit_server_tpu_torch/native).

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// One parsed packet's fixed-width fields (keep in sync with PARSED_DTYPE in
// livekit_server_tpu_torch/native/__init__.py).
struct ParsedPacket {
  uint32_t ssrc;
  uint16_t sn;
  uint8_t pt;
  uint8_t marker;
  uint32_t ts;
  int32_t payload_off;   // offset of payload within the datagram
  int32_t payload_len;   // -1 on parse error
  uint8_t audio_level;   // RFC 6464 dBov (127 if absent)
  uint8_t voice;         // RFC 6464 V bit
  // VP8 payload descriptor (valid when is_vp8 != 0):
  uint8_t is_vp8;
  uint8_t keyframe;      // P bit == 0 on first payload byte & begin_pic
  uint8_t begin_pic;     // S bit & PID==0
  uint8_t tid;           // temporal id
  uint8_t layer_sync;    // Y bit
  int32_t picture_id;    // -1 if absent
  int32_t tl0picidx;     // -1 if absent
  int32_t keyidx;        // -1 if absent
  // AV1 dependency-descriptor header extension (RFC 8285), when
  // dd_ext_id > 0: offset/length of the DD payload within the batch
  // buffer (-1/0 when absent). Descriptor decode is host-side
  // (runtime/dd.py) — structures arrive only on keyframes.
  int32_t dd_off;
  int32_t dd_len;
  // Frame-end marker: RTP M bit by default; the VP9 descriptor's E bit
  // (per-spatial-layer frame end — vp9.go's downswitch boundary) where
  // parsed.
  uint8_t end_frame;
  // Plain-VP9 spatial layer id from the payload descriptor (SVC without
  // the DD extension — buffer.go:599-671 VP9 parse path); -1 if absent.
  int8_t sid;
};

// Parse `n` datagrams packed back-to-back in `buf`; `offsets`/`lengths`
// give each datagram's position. `audio_level_ext` is the negotiated
// RFC 8285 id for the audio-level extension (0 = disabled); packets whose
// PT is in `vp8_pts` (bitmask over 0..127) get VP8 descriptor parsing.
// Returns the number of successfully parsed packets.
int parse_rtp_batch(const uint8_t* buf, const int32_t* offsets,
                    const int32_t* lengths, int n, int audio_level_ext,
                    const uint8_t* vp8_pt_mask, ParsedPacket* out,
                    int dd_ext_id, const uint8_t* vp9_pt_mask,
                    const uint8_t* h264_pt_mask) {
  int ok = 0;
  for (int i = 0; i < n; i++) {
    const uint8_t* p = buf + offsets[i];
    int len = lengths[i];
    ParsedPacket& o = out[i];
    std::memset(&o, 0, sizeof(o));
    o.audio_level = 127;
    o.picture_id = -1;
    o.tl0picidx = -1;
    o.keyidx = -1;
    o.payload_len = -1;
    o.dd_off = -1;
    o.sid = -1;
    if (len < 12) continue;
    uint8_t v = p[0] >> 6;
    if (v != 2) continue;
    int cc = p[0] & 0x0F;
    bool has_ext = (p[0] >> 4) & 1;
    bool has_pad = (p[0] >> 5) & 1;
    o.marker = p[1] >> 7;
    o.pt = p[1] & 0x7F;
    o.sn = (uint16_t)((p[2] << 8) | p[3]);
    o.ts = ((uint32_t)p[4] << 24) | ((uint32_t)p[5] << 16) |
           ((uint32_t)p[6] << 8) | p[7];
    o.ssrc = ((uint32_t)p[8] << 24) | ((uint32_t)p[9] << 16) |
             ((uint32_t)p[10] << 8) | p[11];
    int off = 12 + cc * 4;
    if (off > len) continue;

    if (has_ext) {
      if (off + 4 > len) continue;
      uint16_t profile = (uint16_t)((p[off] << 8) | p[off + 1]);
      int ext_words = (p[off + 2] << 8) | p[off + 3];
      int ext_len = ext_words * 4;
      int ext_off = off + 4;
      if (ext_off + ext_len > len) continue;
      if (profile == 0xBEDE) {
        // RFC 8285 one-byte header extensions.
        int q = ext_off;
        int end = ext_off + ext_len;
        while (q < end) {
          uint8_t b = p[q];
          if (b == 0) { q++; continue; }  // padding
          int id = b >> 4;
          int elen = (b & 0x0F) + 1;
          if (id == 15) break;
          if (q + 1 + elen > end) break;
          if (audio_level_ext > 0 && id == audio_level_ext && elen >= 1) {
            o.voice = p[q + 1] >> 7;
            o.audio_level = p[q + 1] & 0x7F;
          }
          if (dd_ext_id > 0 && id == dd_ext_id) {
            o.dd_off = offsets[i] + q + 1;
            o.dd_len = elen;
          }
          q += 1 + elen;
        }
      } else if ((profile & 0xFFF0) == 0x1000) {
        // RFC 8285 two-byte header extensions (DD structures can exceed
        // the one-byte form's 16-byte data cap).
        int q = ext_off;
        int end = ext_off + ext_len;
        while (q + 1 < end) {
          uint8_t id = p[q];
          if (id == 0) { q++; continue; }  // padding
          int elen = p[q + 1];
          if (q + 2 + elen > end) break;
          if (audio_level_ext > 0 && id == audio_level_ext && elen >= 1) {
            o.voice = p[q + 2] >> 7;
            o.audio_level = p[q + 2] & 0x7F;
          }
          if (dd_ext_id > 0 && id == dd_ext_id) {
            o.dd_off = offsets[i] + q + 2;
            o.dd_len = elen;
          }
          q += 2 + elen;
        }
      }
      off = ext_off + ext_len;
    }

    int pad = 0;
    if (has_pad && len > off) pad = p[len - 1];
    int payload_len = len - off - pad;
    if (payload_len < 0) continue;
    o.payload_off = off;
    o.payload_len = payload_len;
    o.end_frame = o.marker;

    // VP8 payload descriptor (RFC 7741; buffer/vp8.go Unmarshal).
    if (vp8_pt_mask[o.pt >> 3] & (1 << (o.pt & 7))) {
      const uint8_t* d = p + off;
      int dl = payload_len;
      if (dl < 1) continue;
      o.is_vp8 = 1;
      int q = 0;
      uint8_t b0 = d[q++];
      bool X = b0 & 0x80;
      bool S = (b0 >> 4) & 1;
      uint8_t pid3 = b0 & 0x07;
      o.begin_pic = (S && pid3 == 0) ? 1 : 0;
      if (X) {
        if (q >= dl) continue;
        uint8_t xb = d[q++];
        bool I = xb & 0x80, L = xb & 0x40, T = xb & 0x20, K = xb & 0x10;
        if (I) {
          if (q >= dl) continue;
          uint8_t pb = d[q++];
          if (pb & 0x80) {  // 15-bit picture id
            if (q >= dl) continue;
            o.picture_id = ((pb & 0x7F) << 8) | d[q++];
          } else {
            o.picture_id = pb & 0x7F;
          }
        }
        if (L) {
          if (q >= dl) continue;
          o.tl0picidx = d[q++];
        }
        if (T || K) {
          if (q >= dl) continue;
          uint8_t tk = d[q++];
          o.tid = tk >> 6;
          o.layer_sync = (tk >> 5) & 1;
          o.keyidx = tk & 0x1F;
        }
      }
      // Keyframe: P bit of the first VP8 payload byte (after descriptor),
      // only meaningful on the first packet of the picture.
      if (o.begin_pic && q < dl) o.keyframe = (d[q] & 0x01) == 0 ? 1 : 0;
    } else if (vp9_pt_mask[o.pt >> 3] & (1 << (o.pt & 7))) {
      // VP9 payload descriptor (draft-ietf-payload-vp9; the selection
      // fields of pkg/sfu/buffer/buffer.go:599-671's VP9 parse feeding
      // videolayerselector/vp9.go:43).
      const uint8_t* d = p + off;
      int dl = payload_len;
      if (dl < 1) continue;
      int q = 0;
      uint8_t b0 = d[q++];
      bool I = b0 & 0x80, P = b0 & 0x40, L = b0 & 0x20, F = b0 & 0x10;
      bool B = b0 & 0x08, E = b0 & 0x04;
      o.begin_pic = B ? 1 : 0;
      o.end_frame = E ? 1 : 0;
      if (I) {
        if (q >= dl) continue;
        uint8_t pb = d[q++];
        if (pb & 0x80) {
          if (q >= dl) continue;
          o.picture_id = ((pb & 0x7F) << 8) | d[q++];
        } else {
          o.picture_id = pb & 0x7F;
        }
      }
      bool have_layer = false;
      if (L) {
        if (q >= dl) continue;
        uint8_t lb = d[q++];
        o.tid = lb >> 5;
        o.layer_sync = (lb >> 4) & 1;  // U: switching-up point
        o.sid = (int8_t)((lb >> 1) & 0x07);
        have_layer = true;
        if (!F) {
          if (q >= dl) continue;
          o.tl0picidx = d[q++];
        }
      }
      // vp9.go keyframe: !P && B && (SID == 0 || no layer indices).
      if (!P && B && (!have_layer || o.sid == 0)) o.keyframe = 1;
      if (o.keyframe) o.layer_sync = 1;
    } else if (h264_pt_mask[o.pt >> 3] & (1 << (o.pt & 7))) {
      // H264 (RFC 6184): NALU type drives keyframe detection — IDR (5)
      // or SPS (7), also inside STAP-A aggregates and at FU-A starts
      // (the reference's buffer.go:599-671 H264 keyframe scan).
      const uint8_t* d = p + off;
      int dl = payload_len;
      if (dl < 1) continue;
      uint8_t ntype = d[0] & 0x1F;
      if (ntype >= 1 && ntype <= 23) {           // single NALU
        o.begin_pic = 1;
        if (ntype == 5 || ntype == 7) o.keyframe = 1;
      } else if (ntype == 24) {                  // STAP-A
        o.begin_pic = 1;
        int q = 1;
        while (q + 2 <= dl) {
          int nsz = (d[q] << 8) | d[q + 1];
          if (q + 2 + nsz > dl || nsz < 1) break;
          uint8_t t = d[q + 2] & 0x1F;
          if (t == 5 || t == 7) o.keyframe = 1;
          q += 2 + nsz;
        }
      } else if ((ntype == 28 || ntype == 29) && dl >= 2) {  // FU-A/B
        uint8_t fu = d[1];
        bool start = fu & 0x80;
        uint8_t t = fu & 0x1F;
        o.begin_pic = start ? 1 : 0;
        if (start && (t == 5 || t == 7)) o.keyframe = 1;
      }
      if (o.keyframe) o.layer_sync = 1;
    }
    ok++;
  }
  return ok;
}

// Batch header rewrite for egress: patch SN/TS/SSRC in-place in the
// outgoing datagram buffer (the write half of the reference's
// DownTrack.WriteRTP header rewrite before pacing).
void rewrite_rtp_batch(uint8_t* buf, const int32_t* offsets, int n,
                       const uint16_t* sns, const uint32_t* tss,
                       const uint32_t* ssrcs) {
  for (int i = 0; i < n; i++) {
    uint8_t* p = buf + offsets[i];
    p[2] = sns[i] >> 8;
    p[3] = sns[i] & 0xFF;
    p[4] = tss[i] >> 24; p[5] = (tss[i] >> 16) & 0xFF;
    p[6] = (tss[i] >> 8) & 0xFF; p[7] = tss[i] & 0xFF;
    p[8] = ssrcs[i] >> 24; p[9] = (ssrcs[i] >> 16) & 0xFF;
    p[10] = (ssrcs[i] >> 8) & 0xFF; p[11] = ssrcs[i] & 0xFF;
  }
}

// Full egress rewrite: SN/TS/SSRC header patch plus, for packets flagged
// vp8, an in-place rewrite of the VP8 payload descriptor's picture-id /
// TL0PICIDX / KEYIDX from the device munger's outputs — the byte-level
// half of codecmunger/vp8.go:161 UpdateAndGet. Field widths are preserved
// (a 7-bit picture-id slot takes the low 7 bits, a 15-bit slot the low
// 15; both remain contiguous because the munged sequence is contiguous),
// since an in-place rewrite cannot grow the descriptor. pid/tl0/keyidx
// values < 0 skip that field; fields absent from the descriptor are left
// untouched.
void rewrite_rtp_vp8_batch(uint8_t* buf, const int32_t* offsets,
                           const int32_t* lengths, int n,
                           const uint16_t* sns, const uint32_t* tss,
                           const uint32_t* ssrcs, const int32_t* pids,
                           const int32_t* tl0s, const int32_t* keyidxs,
                           const uint8_t* vp8_flags) {
  for (int i = 0; i < n; i++) {
    uint8_t* p = buf + offsets[i];
    int len = lengths[i];
    if (len < 12) continue;
    p[2] = sns[i] >> 8;
    p[3] = sns[i] & 0xFF;
    p[4] = tss[i] >> 24; p[5] = (tss[i] >> 16) & 0xFF;
    p[6] = (tss[i] >> 8) & 0xFF; p[7] = tss[i] & 0xFF;
    p[8] = ssrcs[i] >> 24; p[9] = (ssrcs[i] >> 16) & 0xFF;
    p[10] = (ssrcs[i] >> 8) & 0xFF; p[11] = ssrcs[i] & 0xFF;
    if (!vp8_flags[i]) continue;

    // Locate the payload (same walk as the parser: CSRCs + extension).
    int cc = p[0] & 0x0F;
    bool has_ext = (p[0] >> 4) & 1;
    int off = 12 + cc * 4;
    if (off > len) continue;
    if (has_ext) {
      if (off + 4 > len) continue;
      int ext_words = (p[off + 2] << 8) | p[off + 3];
      off += 4 + ext_words * 4;
      if (off > len) continue;
    }
    uint8_t* d = p + off;
    int dl = len - off;
    if (dl < 1) continue;

    // Walk + patch the VP8 payload descriptor (RFC 7741).
    int q = 0;
    uint8_t b0 = d[q++];
    if (!(b0 & 0x80)) continue;  // no X ⇒ no pid/tl0/keyidx fields
    if (q >= dl) continue;
    uint8_t xb = d[q++];
    bool I = xb & 0x80, L = xb & 0x40, T = xb & 0x20, K = xb & 0x10;
    if (I) {
      if (q >= dl) continue;
      if (d[q] & 0x80) {  // 15-bit picture id
        if (q + 1 >= dl) continue;
        if (pids[i] >= 0) {
          d[q] = 0x80 | ((pids[i] >> 8) & 0x7F);
          d[q + 1] = pids[i] & 0xFF;
        }
        q += 2;
      } else {  // 7-bit picture id
        if (pids[i] >= 0) d[q] = pids[i] & 0x7F;
        q += 1;
      }
    }
    if (L) {
      if (q >= dl) continue;
      if (tl0s[i] >= 0) d[q] = tl0s[i] & 0xFF;
      q += 1;
    }
    if (T || K) {
      if (q >= dl) continue;
      // Preserve TID/Y (packet-intrinsic), replace KEYIDX (munged).
      if (keyidxs[i] >= 0) d[q] = (d[q] & 0xE0) | (keyidxs[i] & 0x1F);
      q += 1;
    }
  }
}

// Concatenate blob[starts[i] .. starts[i]+lens[i]) into out. The payload-
// slab staging gather (ingest.push_batch): a plain memcpy loop beats both
// per-range Python slicing and numpy's repeat/arange index trick by ~50×
// at tick sizes. Returns total bytes written.
int64_t gather_ranges(const uint8_t* blob, const int64_t* starts,
                      const int64_t* lens, int n, uint8_t* out) {
  int64_t o = 0;
  for (int i = 0; i < n; i++) {
    int64_t l = lens[i];
    if (l <= 0) continue;
    std::memcpy(out + o, blob + starts[i], (size_t)l);
    o += l;
  }
  return o;
}

}  // extern "C"

// row[j] = old row[idx[j]] for j < K, through `tmp` (room for K items).
template <typename T>
static inline void permute_row(T* row, const int* idx, int K, void* tmp) {
  T* t = static_cast<T*>(tmp);
  for (int j = 0; j < K; j++) t[j] = row[j];
  for (int j = 0; j < K; j++) row[j] = t[idx[j]];
}

extern "C" {

// The drain's within-tick reorder and dedup (ingest._reorder_dedup),
// in place over the [n_rows, K] staging set, visiting only the rows
// whose count holds two or more packets. A row's slots are sorted
// stably by (layer, SN relative to the first valid slot of the same
// layer in slot order, in the 16-bit ring; 0 below layer 0); invalid
// slots sort last. Every per-slot array in `fields` (widths 1, 4 or 8
// bytes, [n_rows, K] each) is permuted alike, sn, layer and valid
// among them. Then a valid slot whose layer and SN equal those of the
// valid slot before it is marked invalid, judged on the sorted, not yet
// deduplicated row. out[0]: rows visited, out[1]: rows permuted,
// out[2]: slots marked duplicate. Returns 0, or -1 on a width it does
// not know (nothing is touched then).
int reorder_slots(int64_t n_rows, int K, const int32_t* count,
                  const int32_t* sn, const int32_t* layer, uint8_t* valid,
                  int n_fields, uint8_t* const* fields, const int32_t* widths,
                  int64_t* out) {
  for (int f = 0; f < n_fields; f++)
    if (widths[f] != 1 && widths[f] != 4 && widths[f] != 8) return -1;
  std::vector<int64_t> key(K);
  std::vector<int> idx(K);
  std::vector<int64_t> tmp(K);
  int64_t rows = 0, moved = 0, dupes = 0;
  for (int64_t r = 0; r < n_rows; r++) {
    if (count[r] < 2) continue;
    rows++;
    const int64_t o = r * K;
    const int32_t* s = sn + o;
    const int32_t* l = layer + o;
    uint8_t* v = valid + o;
    for (int j = 0; j < K; j++) {
      idx[j] = j;
      if (!v[j]) {
        key[j] = (int64_t)1 << 40;
        continue;
      }
      int64_t rel = 0;
      if (l[j] >= 0) {
        int first = 0;
        while (!(v[first] && l[first] == l[j])) first++;
        uint32_t d = ((uint32_t)s[j] - (uint32_t)s[first]) & 0xFFFF;
        rel = d >= 0x8000 ? (int64_t)d - 0x10000 : (int64_t)d;
      }
      key[j] = (int64_t)l[j] * (1 << 20) + rel;
    }
    // Stable insertion sort of the slot indices by key.
    bool perm = false;
    for (int i = 1; i < K; i++) {
      int x = idx[i];
      int j = i - 1;
      while (j >= 0 && key[idx[j]] > key[x]) {
        idx[j + 1] = idx[j];
        j--;
        perm = true;
      }
      idx[j + 1] = x;
    }
    if (perm) {
      moved++;
      for (int f = 0; f < n_fields; f++) {
        if (widths[f] == 1)
          permute_row(fields[f] + o, idx.data(), K, tmp.data());
        else if (widths[f] == 4)
          permute_row(reinterpret_cast<int32_t*>(fields[f]) + o, idx.data(), K, tmp.data());
        else
          permute_row(reinterpret_cast<int64_t*>(fields[f]) + o, idx.data(), K, tmp.data());
      }
    }
    // sn, layer and valid are among the fields, so s, l and v now read
    // the sorted row; `prev` keeps the slot before's validity undeduped.
    bool prev = v[0] != 0;
    for (int j = 1; j < K; j++) {
      bool cur = v[j] != 0;
      if (cur && prev && s[j] == s[j - 1] && l[j] == l[j - 1]) {
        v[j] = 0;
        dupes++;
      }
      prev = cur;
    }
  }
  out[0] = rows;
  out[1] = moved;
  out[2] = dupes;
  return 0;
}

}  // extern "C"
