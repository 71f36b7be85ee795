// Native batch egress — datagram assembly, AEAD sealing, and kernel send.
//
// Reference parity: the per-packet egress work the reference does per
// DownTrack in Go — header construction + payload write
// (pkg/sfu/downtrack.go:680 WriteRTP), VP8 descriptor munge application
// (pkg/sfu/codecmunger/vp8.go:161), SRTP protection (pion/srtp under
// pkg/rtc/transport.go), and the socket write behind the pacer
// (pkg/sfu/pacer) — executed as ONE native call per tick over the device
// plane's compacted egress arrays:
//
//   for each entry: 12-byte RTP header (SN/TS/SSRC/PT/M) + payload gather
//   from the ingest slab + in-place VP8 descriptor patch; optionally an
//   AES-128-GCM seal (frame layout must match runtime/crypto.py:
//   0x01 | key_id(4 BE) | dir(1)=S2C | counter(8 BE) | ct || tag,
//   nonce = dir | counter | 0^3, AAD = the 14-byte header); then
//   sendmmsg() in chunks, fanned over a few threads (seal + syscall both
//   parallelize; entries are pre-partitioned so threads never share
//   output ranges).
//
// AES-GCM uses OpenSSL's stable EVP C ABI. A machine may ship
// libcrypto.so.3 without its headers, so the handful of prototypes used
// are declared here directly.
//
// Build: g++ -O2 -shared -fPIC -pthread -o libegress.so egress.cpp -l:libcrypto.so.3
// ABI: plain C, loaded via ctypes (livekit_server_tpu_torch/native).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#include <errno.h>
#include <netinet/in.h>
#include <sys/socket.h>
#include <time.h>
#include <unistd.h>

// UDP generic segmentation offload (Linux ≥ 4.18): one sendmsg carries a
// run of equal-size datagrams to one destination; the kernel splits them
// at xmit. This is the difference between ~3 µs/datagram (per-datagram
// sendmmsg, socket-lock bound) and amortizing that cost over a whole
// (subscriber, track) tick burst. Headers for it aren't guaranteed to be
// installed, so define the ABI constants directly.
#ifndef SOL_UDP
#define SOL_UDP 17
#endif
#ifndef UDP_SEGMENT
#define UDP_SEGMENT 103
#endif

// ---- OpenSSL EVP prototypes (libcrypto.so.3; EVP ABI is stable) -----------
extern "C" {
typedef struct evp_cipher_ctx_st EVP_CIPHER_CTX;
typedef struct evp_cipher_st EVP_CIPHER;
typedef struct engine_st ENGINE;
EVP_CIPHER_CTX* EVP_CIPHER_CTX_new(void);
void EVP_CIPHER_CTX_free(EVP_CIPHER_CTX*);
const EVP_CIPHER* EVP_aes_128_gcm(void);
int EVP_EncryptInit_ex(EVP_CIPHER_CTX*, const EVP_CIPHER*, ENGINE*,
                       const unsigned char*, const unsigned char*);
int EVP_EncryptUpdate(EVP_CIPHER_CTX*, unsigned char*, int*,
                      const unsigned char*, int);
int EVP_EncryptFinal_ex(EVP_CIPHER_CTX*, unsigned char*, int*);
int EVP_DecryptInit_ex(EVP_CIPHER_CTX*, const EVP_CIPHER*, ENGINE*,
                       const unsigned char*, const unsigned char*);
int EVP_DecryptUpdate(EVP_CIPHER_CTX*, unsigned char*, int*,
                      const unsigned char*, int);
int EVP_DecryptFinal_ex(EVP_CIPHER_CTX*, unsigned char*, int*);
int EVP_CIPHER_CTX_ctrl(EVP_CIPHER_CTX*, int, int, void*);
}
#define EVP_CTRL_GCM_GET_TAG 0x10
#define EVP_CTRL_GCM_SET_TAG 0x11

namespace {

constexpr int SEAL_HEADER = 14;  // magic + key_id(4) + dir(1) + counter(8)
constexpr int SEAL_TAG = 16;
constexpr uint8_t SEAL_MAGIC = 0x01;
constexpr uint8_t DIR_S2C = 1;
constexpr int MAX_DGRAM = 2048;
constexpr int MMSG_CHUNK = 512;
// Bump when the exported symbol set or any signature changes; the ctypes
// loader and tools/check.py compare it against the Python-side constant.
constexpr int32_t EGRESS_ABI = 4;
// Kernel cap is UDP_MAX_SEGMENTS (64); stay under it and under 64 KB.
constexpr int GSO_MAX_SEGS = 60;
constexpr int64_t GSO_MAX_BYTES = 64000;

// First EINVAL/EOPNOTSUPP on a segmented send disables GSO process-wide
// (e.g. exotic kernels); every batch then rides the plain sendmmsg path.
std::atomic<bool> g_gso_ok{true};

struct Args {
  uint8_t* skip;  // [n] — entries the assembler refused (oversized sealed)
  const uint8_t* slab;
  const int64_t* pay_off;
  const int32_t* pay_len;
  const uint8_t* marker;
  const uint8_t* pt;
  const uint8_t* vp8;
  // Pre-serialized RTP header-extension section per entry (profile +
  // length + elements + padding, built host-side: playout delay,
  // dependency descriptor, or both). ext_len 0 = no extension.
  const uint8_t* ext_blob;
  const int64_t* ext_off;
  const int32_t* ext_len;
  const uint16_t* sn;
  const uint32_t* ts;
  const uint32_t* ssrc;
  const int32_t* pid;
  const int32_t* tl0;
  const int32_t* kidx;
  const uint32_t* ip;    // host byte order
  const uint16_t* port;  // host byte order
  const uint8_t* seal;
  const int32_t* key_idx;
  const uint8_t* keys;      // [nkeys][16]
  const uint32_t* key_ids;  // [nkeys]
  const uint64_t* counters;
  uint8_t* out;
  const int64_t* out_off;
  const int32_t* out_len;
  int fd;
  // Pacer (pkg/sfu/pacer "no-queue" seat): spread each worker's sendmmsg
  // chunks across this window so a tick's burst doesn't hit receiver
  // buffers as one spike. 0 = no shaping. Chunking shrinks to PACE_CHUNK
  // when active so typical loads actually have gaps to spread.
  int pace_window_us;
};

constexpr int PACE_CHUNK = 64;

void be16(uint8_t* p, uint16_t v) { p[0] = v >> 8; p[1] = v & 0xFF; }
void be32(uint8_t* p, uint32_t v) {
  p[0] = v >> 24; p[1] = (v >> 16) & 0xFF; p[2] = (v >> 8) & 0xFF; p[3] = v & 0xFF;
}
void be64(uint8_t* p, uint64_t v) {
  for (int i = 0; i < 8; i++) p[i] = (v >> (56 - 8 * i)) & 0xFF;
}

// VP8 payload-descriptor patch on an assembled payload (same semantics as
// rewrite_rtp_vp8_batch in rtp_parser.cpp, but the payload location is
// already known). Field widths preserved; negative values skip a field.
void patch_vp8(uint8_t* d, int dl, int32_t pid, int32_t tl0, int32_t kidx) {
  if (dl < 1) return;
  int q = 0;
  uint8_t b0 = d[q++];
  if (!(b0 & 0x80)) return;  // no X ⇒ no pid/tl0/keyidx fields
  if (q >= dl) return;
  uint8_t xb = d[q++];
  bool I = xb & 0x80, L = xb & 0x40, T = xb & 0x20, K = xb & 0x10;
  if (I) {
    if (q >= dl) return;
    if (d[q] & 0x80) {  // 15-bit picture id
      if (q + 1 >= dl) return;
      if (pid >= 0) {
        d[q] = 0x80 | ((pid >> 8) & 0x7F);
        d[q + 1] = pid & 0xFF;
      }
      q += 2;
    } else {
      if (pid >= 0) d[q] = pid & 0x7F;
      q += 1;
    }
  }
  if (L) {
    if (q >= dl) return;
    if (tl0 >= 0) d[q] = tl0 & 0xFF;
    q += 1;
  }
  if (T || K) {
    if (q >= dl) return;
    if (kidx >= 0) d[q] = (d[q] & 0xE0) | (kidx & 0x1F);
    q += 1;
  }
}

// Per-datagram sendmmsg over built entries [lo, hi) — the portable path,
// also used for paced sends (pacing spreads individual datagrams; GSO
// would re-burst them).
int64_t send_plain(const Args& a, int lo, int hi) {
  int64_t sent = 0;
  mmsghdr msgs[MMSG_CHUNK];
  iovec iovs[MMSG_CHUNK];
  sockaddr_in sas[MMSG_CHUNK];
  int chunk = a.pace_window_us > 0 ? PACE_CHUNK : MMSG_CHUNK;
  // Sleep per inter-chunk gap, from THIS worker's real chunk count (the
  // caller only names the window; constants stay one-sided).
  int n_chunks = (hi - lo + chunk - 1) / chunk;
  int gap_us = n_chunks > 1 ? a.pace_window_us / (n_chunks - 1) : 0;
  int i = lo;
  while (i < hi) {
    int cnt = 0;
    while (i < hi && a.skip[i]) i++;
    for (; cnt < chunk && i + cnt < hi && !a.skip[i + cnt]; cnt++) {
      int j = i + cnt;
      std::memset(&sas[cnt], 0, sizeof(sockaddr_in));
      sas[cnt].sin_family = AF_INET;
      sas[cnt].sin_addr.s_addr = htonl(a.ip[j]);
      sas[cnt].sin_port = htons(a.port[j]);
      iovs[cnt].iov_base = a.out + a.out_off[j];
      iovs[cnt].iov_len = (size_t)a.out_len[j];
      std::memset(&msgs[cnt].msg_hdr, 0, sizeof(msghdr));
      msgs[cnt].msg_hdr.msg_name = &sas[cnt];
      msgs[cnt].msg_hdr.msg_namelen = sizeof(sockaddr_in);
      msgs[cnt].msg_hdr.msg_iov = &iovs[cnt];
      msgs[cnt].msg_hdr.msg_iovlen = 1;
    }
    int done = 0;
    int spins = 0;
    while (done < cnt) {
      int r = sendmmsg(a.fd, msgs + done, cnt - done, 0);
      if (r > 0) {
        done += r;
        sent += r;
        continue;
      }
      if ((errno == EAGAIN || errno == EWOULDBLOCK || errno == ENOBUFS) &&
          spins < 64) {
        spins++;
        usleep(50);  // socket buffer full: brief backoff, then drop rest
        continue;
      }
      break;  // hard error (or spun out): drop the remainder of the chunk
    }
    i += cnt;
    if (gap_us > 0 && i < hi) usleep(gap_us);
  }
  return sent;
}

// GSO send over built entries [lo, hi): consecutive entries to the same
// destination whose datagrams are equal-size (plus at most one shorter
// trailer — the UDP_SEGMENT contract) collapse into ONE message whose
// payload is their already-contiguous bytes in `out`. The caller sorts
// entries by (room, sub, track), so a (subscriber, track) tick burst is
// typically one message. On kernel refusal, *resume holds the first
// unsent entry and the caller falls back to send_plain.
int64_t send_gso(const Args& a, int lo, int hi, int* resume) {
  int64_t sent = 0;
  mmsghdr msgs[MMSG_CHUNK];
  iovec iovs[MMSG_CHUNK];
  sockaddr_in sas[MMSG_CHUNK];
  alignas(cmsghdr) static thread_local char
      ctrls[MMSG_CHUNK][CMSG_SPACE(sizeof(uint16_t))];
  int run_first[MMSG_CHUNK];
  int run_cnt[MMSG_CHUNK];
  *resume = -1;
  int i = lo;
  while (i < hi) {
    int m = 0;
    while (m < MMSG_CHUNK && i < hi) {
      while (i < hi && a.skip[i]) i++;
      if (i >= hi) break;
      int first = i;
      int32_t seg = a.out_len[i];
      int cnt = 1;
      int64_t bytes = seg;
      i++;
      // Runs break at skips too: a skipped entry leaves a hole in `out`,
      // so bytes on its far side are not contiguous with this run.
      while (i < hi && !a.skip[i] && cnt < GSO_MAX_SEGS &&
             a.ip[i] == a.ip[first] && a.port[i] == a.port[first] &&
             bytes + a.out_len[i] <= GSO_MAX_BYTES &&
             a.out_len[i] <= seg) {
        bytes += a.out_len[i];
        cnt++;
        bool last_short = a.out_len[i] < seg;
        i++;
        if (last_short) break;  // only the final segment may be shorter
      }
      std::memset(&sas[m], 0, sizeof(sockaddr_in));
      sas[m].sin_family = AF_INET;
      sas[m].sin_addr.s_addr = htonl(a.ip[first]);
      sas[m].sin_port = htons(a.port[first]);
      iovs[m].iov_base = a.out + a.out_off[first];
      iovs[m].iov_len = (size_t)bytes;
      std::memset(&msgs[m].msg_hdr, 0, sizeof(msghdr));
      msgs[m].msg_hdr.msg_name = &sas[m];
      msgs[m].msg_hdr.msg_namelen = sizeof(sockaddr_in);
      msgs[m].msg_hdr.msg_iov = &iovs[m];
      msgs[m].msg_hdr.msg_iovlen = 1;
      if (cnt > 1) {
        msgs[m].msg_hdr.msg_control = ctrls[m];
        msgs[m].msg_hdr.msg_controllen = CMSG_SPACE(sizeof(uint16_t));
        cmsghdr* cm = CMSG_FIRSTHDR(&msgs[m].msg_hdr);
        cm->cmsg_level = SOL_UDP;
        cm->cmsg_type = UDP_SEGMENT;
        cm->cmsg_len = CMSG_LEN(sizeof(uint16_t));
        uint16_t gs = (uint16_t)seg;
        std::memcpy(CMSG_DATA(cm), &gs, sizeof(uint16_t));
      }
      run_first[m] = first;
      run_cnt[m] = cnt;
      m++;
    }
    int done = 0;
    int spins = 0;
    while (done < m) {
      int r = sendmmsg(a.fd, msgs + done, m - done, 0);
      if (r > 0) {
        for (int q = done; q < done + r; q++) sent += run_cnt[q];
        done += r;
        continue;
      }
      if ((errno == EAGAIN || errno == EWOULDBLOCK || errno == ENOBUFS) &&
          spins < 64) {
        spins++;
        usleep(50);
        continue;
      }
      if (errno == EINVAL || errno == EOPNOTSUPP || errno == ENOTSUP ||
          errno == EMSGSIZE || errno == EIO) {
        if (run_cnt[done] > 1) {
          *resume = run_first[done];  // caller re-sends plain from here
          return sent;
        }
        // Single-datagram message carries no UDP_SEGMENT cmsg, so this
        // is a per-destination error (e.g. PMTU), not GSO refusal —
        // skip the entry and keep the GSO fast path alive.
        done++;
        continue;
      }
      return sent;  // hard error: drop the remainder
    }
  }
  return sent;
}

inline int64_t now_ns() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (int64_t)ts.tv_sec * 1000000000ll + ts.tv_nsec;
}

// Multicast-shaped grouping (P3FA): entries that fan one source packet out
// to many subscribers share a canonical staging of its bytes. The group
// key is the packet's (track, k) slot; rooms are walked in order, so a
// slot is valid only for the room it was staged in. Matching on
// (room, pay_off, ext section) keeps the reuse sound when subscribers get
// different extension sections (per-sub layer caps).
struct CanonSlot {
  int32_t room = -1;     // staging scope; -1 = never staged
  int64_t pay_off = -1;
  int64_t ext_off = -1;
  int32_t ext_len = -1;
  int32_t clear_len = 0;
};

// Per-worker scratch that persists across jobs on pool threads — the
// canonical slab stays cache-hot between ticks.
struct WorkerScratch {
  std::vector<uint8_t> canon;
  std::vector<CanonSlot> slots;
  void ensure(int32_t n_slots) {
    if ((int32_t)slots.size() < n_slots) {
      slots.assign(n_slots, CanonSlot{});
      canon.assign((size_t)n_slots * MAX_DGRAM, 0);
    } else {
      for (auto& s : slots) s.room = -1;
    }
  }
};

// Build entries [lo, hi) into the shared out buffer (disjoint ranges) and
// send them. Returns datagrams handed to the kernel. When `grp` is given
// (multicast-shaped mode), entry i with grp[i] >= 0 stages its packet's
// bytes once per group in `scr` and later fan-out members copy from that
// hot canonical instead of re-gathering slab + extension bytes; the
// 12-byte RTP header (SN/TS/SSRC) and VP8 descriptor fields are patched
// per subscriber. The AEAD seal itself necessarily runs per datagram —
// every sealed frame carries its own counter, and a GCM nonce must never
// repeat under one key — so what the group shares is the staged
// cleartext, not the tag.
int64_t worker(const Args& a, int lo, int hi, const int32_t* grp,
               const int32_t* rooms, int32_t grp_slots,
               WorkerScratch* scr, int64_t* built_out) {
  EVP_CIPHER_CTX* ctx = EVP_CIPHER_CTX_new();
  const EVP_CIPHER* cipher = EVP_aes_128_gcm();
  bool ctx_inited = false;
  int32_t ctx_key = -1;
  uint8_t scratch[MAX_DGRAM];
  if (grp && scr) scr->ensure(grp_slots);
  int64_t built = 0;

  for (int i = lo; i < hi; i++) {
    uint8_t* dst = a.out + a.out_off[i];
    int plen = a.pay_len[i];
    int ext_len = a.ext_len[i];
    int hdr_len = 12 + ext_len;
    int clear_len = hdr_len + plen;
    bool sealed = a.seal[i] && a.key_idx[i] >= 0;
    if (plen < 0 || ext_len < 0 || (sealed && clear_len > MAX_DGRAM)) {
      // The sealed path stages cleartext in a fixed stack scratch; an
      // attacker-sized jumbo datagram must be refused, never overflowed.
      a.skip[i] = 1;
      continue;
    }
    uint8_t* build = sealed ? scratch : dst;
    const int32_t slot = (grp && scr) ? grp[i] : -1;
    if (slot >= 0 && slot < grp_slots && clear_len <= MAX_DGRAM) {
      CanonSlot& cs = scr->slots[slot];
      uint8_t* cb = scr->canon.data() + (size_t)slot * MAX_DGRAM;
      const int64_t eo = ext_len ? a.ext_off[i] : -1;
      if (cs.room != rooms[i] || cs.pay_off != a.pay_off[i] ||
          cs.ext_off != eo || cs.ext_len != ext_len) {
        // Stage the canonical once per (room, track, k[, ext]) group.
        cb[0] = 0x80 | (ext_len ? 0x10 : 0);
        cb[1] = (a.marker[i] ? 0x80 : 0) | (a.pt[i] & 0x7F);
        std::memset(cb + 2, 0, 10);  // SN/TS/SSRC are per-subscriber
        if (ext_len) std::memcpy(cb + 12, a.ext_blob + a.ext_off[i], ext_len);
        std::memcpy(cb + hdr_len, a.slab + a.pay_off[i], plen);
        cs.room = rooms[i];
        cs.pay_off = a.pay_off[i];
        cs.ext_off = eo;
        cs.ext_len = ext_len;
        cs.clear_len = clear_len;
      }
      std::memcpy(build, cb, clear_len);
      be16(build + 2, a.sn[i]);
      be32(build + 4, a.ts[i]);
      be32(build + 8, a.ssrc[i]);
    } else {
      build[0] = 0x80 | (ext_len ? 0x10 : 0);
      build[1] = (a.marker[i] ? 0x80 : 0) | (a.pt[i] & 0x7F);
      be16(build + 2, a.sn[i]);
      be32(build + 4, a.ts[i]);
      be32(build + 8, a.ssrc[i]);
      if (ext_len) std::memcpy(build + 12, a.ext_blob + a.ext_off[i], ext_len);
      std::memcpy(build + hdr_len, a.slab + a.pay_off[i], plen);
    }
    if (a.vp8[i]) patch_vp8(build + hdr_len, plen, a.pid[i], a.tl0[i], a.kidx[i]);
    built++;

    if (sealed) {
      const uint8_t* key = a.keys + 16 * a.key_idx[i];
      uint8_t* h = dst;
      h[0] = SEAL_MAGIC;
      be32(h + 1, a.key_ids[a.key_idx[i]]);
      h[5] = DIR_S2C;
      be64(h + 6, a.counters[i]);
      uint8_t nonce[12];
      nonce[0] = DIR_S2C;
      std::memcpy(nonce + 1, h + 6, 8);
      std::memset(nonce + 9, 0, 3);
      int outl = 0, fl = 0;
      // First init binds the cipher. Entries are destination-major, so
      // consecutive datagrams usually share a session key: re-initing
      // with IV only skips the AES key-schedule expansion per datagram.
      if (a.key_idx[i] != ctx_key) {
        EVP_EncryptInit_ex(ctx, ctx_inited ? nullptr : cipher, nullptr, key,
                           nonce);
        ctx_key = a.key_idx[i];
      } else {
        EVP_EncryptInit_ex(ctx, nullptr, nullptr, nullptr, nonce);
      }
      ctx_inited = true;
      EVP_EncryptUpdate(ctx, nullptr, &outl, h, SEAL_HEADER);  // AAD
      EVP_EncryptUpdate(ctx, dst + SEAL_HEADER, &outl, build, clear_len);
      EVP_EncryptFinal_ex(ctx, dst + SEAL_HEADER + outl, &fl);
      EVP_CIPHER_CTX_ctrl(ctx, EVP_CTRL_GCM_GET_TAG, SEAL_TAG,
                          dst + SEAL_HEADER + clear_len);
    }
  }
  EVP_CIPHER_CTX_free(ctx);
  if (built_out) *built_out = built;

  int64_t sent = 0;
  if (a.fd >= 0) {
    if (a.pace_window_us > 0 || !g_gso_ok.load(std::memory_order_relaxed)) {
      sent = send_plain(a, lo, hi);
    } else {
      int resume = -1;
      sent = send_gso(a, lo, hi, &resume);
      if (resume >= 0) {
        // Kernel refused segmentation: fall back for this and every
        // later batch, resuming from the first unsent entry.
        g_gso_ok.store(false, std::memory_order_relaxed);
        sent += send_plain(a, resume, hi);
      }
    }
  }
  return sent;
}

int64_t worker(const Args& a, int lo, int hi) {
  return worker(a, lo, hi, nullptr, nullptr, 0, nullptr, nullptr);
}

// ---- persistent shard pool -------------------------------------------------
//
// The one-shot egress_batch_send spawns threads per call; at a 5 ms tick
// that spawn/join overhead is a few percent of the window. The plane path
// instead parks a fixed crew of workers on a condvar and hands each tick's
// shard list to them: shard i owns entries [shard_lo[i], shard_hi[i]) —
// room-aligned, so group canonicals never straddle workers — and writes
// only its own disjoint out ranges. Workers keep their canonical slabs
// across ticks (cache-warm).

struct PlaneJob {
  const Args* a = nullptr;
  const int64_t* shard_lo = nullptr;
  const int64_t* shard_hi = nullptr;
  const int32_t* grp = nullptr;
  const int32_t* rooms = nullptr;
  int32_t grp_slots = 0;
  int n_shards = 0;
  int64_t* shard_sent = nullptr;
  int64_t* shard_built = nullptr;
  int64_t* shard_ns = nullptr;
};

class Pool {
 public:
  ~Pool() {
    {
      std::unique_lock<std::mutex> lk(mu_);
      stop_ = true;
      cv_.notify_all();
    }
    for (auto& t : ths_) t.join();
  }

  void ensure(int n) {
    if (n > 16) n = 16;
    std::unique_lock<std::mutex> lk(mu_);
    while ((int)ths_.size() < n) {
      int id = (int)ths_.size();
      ths_.emplace_back([this, id] { loop(id); });
    }
  }

  int size() {
    std::unique_lock<std::mutex> lk(mu_);
    return (int)ths_.size();
  }

  // Runs the job on the pool and blocks until every shard completed and
  // every worker that took this job has left its claim loop. Without the
  // second condition a straggler of this call, still holding its job copy,
  // could claim a shard of the next call once that call reset next_, build
  // it from this call's dead pointers and count it done there (the next
  // call then returns short, or waits forever when the shard counts
  // differ). run_mu_ serializes callers: the pool is one per process.
  void run(PlaneJob& job) {
    std::lock_guard<std::mutex> serial(run_mu_);
    std::unique_lock<std::mutex> lk(mu_);
    job_ = &job;
    next_.store(0, std::memory_order_relaxed);
    done_ = 0;
    gen_++;
    cv_.notify_all();
    cv_done_.wait(lk, [&] { return done_ >= job.n_shards && active_ == 0; });
    job_ = nullptr;
  }

 private:
  void loop(int id) {
    (void)id;
    uint64_t seen = 0;
    WorkerScratch scr;
    for (;;) {
      // Copy the job descriptor under the lock: a straggler that loses the
      // last-shard race must never dereference the caller's stack frame
      // after run() returned. Claimed shards (s < n_shards) are always
      // processed before done_ releases the caller, so the pointed-to
      // arrays are alive wherever they are actually read.
      PlaneJob job;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [&] { return stop_ || gen_ != seen; });
        if (stop_) return;
        seen = gen_;
        if (!job_) continue;
        job = *job_;
        active_++;
      }
      for (;;) {
        int s = next_.fetch_add(1, std::memory_order_relaxed);
        if (s >= job.n_shards) {
          std::unique_lock<std::mutex> lk(mu_);
          if (--active_ == 0 && done_ >= job.n_shards) cv_done_.notify_all();
          break;
        }
        const int64_t t0 = now_ns();
        int64_t built = 0;
        int64_t sent = worker(*job.a, (int)job.shard_lo[s],
                              (int)job.shard_hi[s], job.grp, job.rooms,
                              job.grp_slots, &scr, &built);
        job.shard_sent[s] = sent;
        job.shard_built[s] = built;
        job.shard_ns[s] = now_ns() - t0;
        {
          std::unique_lock<std::mutex> lk(mu_);
          if (++done_ >= job.n_shards) cv_done_.notify_all();
        }
      }
    }
  }

  std::vector<std::thread> ths_;
  std::mutex mu_, run_mu_;
  std::condition_variable cv_, cv_done_;
  uint64_t gen_ = 0;
  bool stop_ = false;
  PlaneJob* job_ = nullptr;
  int done_ = 0;
  int active_ = 0;  // workers inside the current job's claim loop
  std::atomic<int> next_{0};
};

Pool g_pool;

}  // namespace

extern "C" {

// Assemble (and seal, and send when fd >= 0) one tick's egress datagrams.
// All arrays have n entries; out/out_off/out_len are caller-allocated with
// per-entry destination ranges (disjoint). Returns datagrams sent, or n
// when fd < 0 (build-only mode, used by tests).
int64_t egress_batch_send(
    int fd, int n_threads, const uint8_t* slab, int32_t n,
    const int64_t* pay_off, const int32_t* pay_len, const uint8_t* marker,
    const uint8_t* pt, const uint8_t* vp8,
    const uint8_t* ext_blob, const int64_t* ext_off, const int32_t* ext_len,
    const uint16_t* sn,
    const uint32_t* ts, const uint32_t* ssrc, const int32_t* pid,
    const int32_t* tl0, const int32_t* kidx, const uint32_t* ip,
    const uint16_t* port, const uint8_t* seal, const int32_t* key_idx,
    const uint8_t* keys, const uint32_t* key_ids, const uint64_t* counters,
    uint8_t* out, const int64_t* out_off, const int32_t* out_len,
    int pace_window_us) {
  if (n <= 0) return 0;
  std::vector<uint8_t> skip(n, 0);
  Args a{skip.data(), slab, pay_off, pay_len, marker, pt, vp8,
         ext_blob, ext_off, ext_len,
         sn,  ts,
         ssrc,  pid,     tl0,     kidx,   ip,       port,    seal, key_idx,
         keys,  key_ids, counters, out,   out_off,  out_len, fd,
         pace_window_us};
  if (n_threads < 1) n_threads = 1;
  if (n_threads > 8) n_threads = 8;
  if (n < 2 * n_threads) n_threads = 1;

  int64_t total = 0;
  if (n_threads == 1) {
    total = worker(a, 0, n);
  } else {
    std::vector<int64_t> sent(n_threads, 0);
    std::vector<std::thread> th;
    int per = (n + n_threads - 1) / n_threads;
    for (int w = 0; w < n_threads; w++) {
      int lo = w * per, hi = lo + per < n ? lo + per : n;
      if (lo >= hi) break;
      th.emplace_back([&a, &sent, w, lo, hi] { sent[w] = worker(a, lo, hi); });
    }
    for (auto& t : th) t.join();
    for (int64_t s : sent) total += s;
  }
  if (fd >= 0) return total;
  int64_t built = 0;
  for (int i = 0; i < n; i++) built += skip[i] ? 0 : 1;
  return built;
}

int32_t egress_abi_version(void) { return EGRESS_ABI; }

// Pre-warm the persistent worker pool (idempotent; capped at 16). The
// plane path also calls this lazily, so warming is an optimization only.
void egress_pool_ensure(int n) { g_pool.ensure(n); }

int32_t egress_pool_size(void) { return g_pool.size(); }

// Sharded, multicast-shaped egress: the plane path. Entries arrive sorted
// by (room, sub, track, k); shards are contiguous, room-aligned entry
// ranges [shard_lo[i], shard_hi[i]) with disjoint out ranges, each run by
// one persistent pool worker (build + group-canonical reuse + seal +
// per-shard GSO/sendmmsg). `grp[i]` >= 0 names the entry's canonical
// cache slot (its packet's t*K+k), -1 forces the direct build; `rooms`
// scopes slot validity. Per-shard datagrams-sent / built / wall-ns land
// in shard_sent/shard_built/shard_ns. Returns total datagrams handed to
// the kernel, or total built when fd < 0 (build-only mode, used by the
// parity and determinism tests).
int64_t egress_plane_send(
    int fd, int n_shards, const int64_t* shard_lo, const int64_t* shard_hi,
    const uint8_t* slab, int32_t n,
    const int64_t* pay_off, const int32_t* pay_len, const uint8_t* marker,
    const uint8_t* pt, const uint8_t* vp8,
    const uint8_t* ext_blob, const int64_t* ext_off, const int32_t* ext_len,
    const uint16_t* sn,
    const uint32_t* ts, const uint32_t* ssrc, const int32_t* pid,
    const int32_t* tl0, const int32_t* kidx, const uint32_t* ip,
    const uint16_t* port, const uint8_t* seal, const int32_t* key_idx,
    const uint8_t* keys, const uint32_t* key_ids, const uint64_t* counters,
    uint8_t* out, const int64_t* out_off, const int32_t* out_len,
    const int32_t* rooms, const int32_t* grp, int32_t grp_slots,
    int pace_window_us,
    int64_t* shard_sent, int64_t* shard_built, int64_t* shard_ns) {
  if (n <= 0 || n_shards <= 0) return 0;
  std::vector<uint8_t> skip(n, 0);
  Args a{skip.data(), slab, pay_off, pay_len, marker, pt, vp8,
         ext_blob, ext_off, ext_len,
         sn,  ts,
         ssrc,  pid,     tl0,     kidx,   ip,       port,    seal, key_idx,
         keys,  key_ids, counters, out,   out_off,  out_len, fd,
         pace_window_us};
  for (int s = 0; s < n_shards; s++) {
    shard_sent[s] = 0;
    shard_built[s] = 0;
    shard_ns[s] = 0;
  }
  if (n_shards == 1) {
    // Single shard runs inline on the caller's thread: on small hosts the
    // cross-thread handoff would cost more than it buys.
    static thread_local WorkerScratch scr;
    const int64_t t0 = now_ns();
    int64_t built = 0;
    shard_sent[0] = worker(a, (int)shard_lo[0], (int)shard_hi[0], grp, rooms,
                           grp_slots, &scr, &built);
    shard_built[0] = built;
    shard_ns[0] = now_ns() - t0;
  } else {
    g_pool.ensure(n_shards);
    PlaneJob job;
    job.a = &a;
    job.shard_lo = shard_lo;
    job.shard_hi = shard_hi;
    job.grp = grp;
    job.rooms = rooms;
    job.grp_slots = grp_slots;
    job.n_shards = n_shards;
    job.shard_sent = shard_sent;
    job.shard_built = shard_built;
    job.shard_ns = shard_ns;
    g_pool.run(job);
  }
  int64_t total = 0;
  for (int s = 0; s < n_shards; s++) {
    total += fd >= 0 ? shard_sent[s] : shard_built[s];
  }
  return total;
}

// Express-lane egress: assemble+seal(+send) a SMALL batch (one receive
// window's worth of packets for interactive rooms) inline on the caller's
// thread, with none of the plane machinery — no shard planning, no pool
// handoff, no pacing. Reuses the same worker() walk as the sharded path,
// so the canonical-group staging (grp/rooms/grp_slots, may be null/0) and
// the per-thread key-schedule cache apply unchanged; output frames are
// byte-identical to what the batched path would build for the same
// entries. Returns datagrams handed to the kernel, or datagrams built
// when fd < 0; *built_out (optional) always receives the built count.
int64_t egress_express_send(
    int fd, const uint8_t* slab, int32_t n,
    const int64_t* pay_off, const int32_t* pay_len, const uint8_t* marker,
    const uint8_t* pt, const uint8_t* vp8,
    const uint8_t* ext_blob, const int64_t* ext_off, const int32_t* ext_len,
    const uint16_t* sn,
    const uint32_t* ts, const uint32_t* ssrc, const int32_t* pid,
    const int32_t* tl0, const int32_t* kidx, const uint32_t* ip,
    const uint16_t* port, const uint8_t* seal, const int32_t* key_idx,
    const uint8_t* keys, const uint32_t* key_ids, const uint64_t* counters,
    uint8_t* out, const int64_t* out_off, const int32_t* out_len,
    const int32_t* rooms, const int32_t* grp, int32_t grp_slots,
    int64_t* built_out) {
  if (n <= 0) {
    if (built_out) *built_out = 0;
    return 0;
  }
  std::vector<uint8_t> skip(n, 0);
  Args a{skip.data(), slab, pay_off, pay_len, marker, pt, vp8,
         ext_blob, ext_off, ext_len,
         sn,  ts,
         ssrc,  pid,     tl0,     kidx,   ip,       port,    seal, key_idx,
         keys,  key_ids, counters, out,   out_off,  out_len, fd,
         /*pace_window_us=*/0};
  static thread_local WorkerScratch scr;
  int64_t built = 0;
  int64_t sent = worker(a, 0, n, grp, rooms, grp_slots, &scr, &built);
  if (built_out) *built_out = built;
  return fd >= 0 ? sent : built;
}

// Send pre-built datagrams (contiguous blob + per-entry offset/length/
// destination) with the same GSO/sendmmsg machinery as the egress path.
// Used by load generators and relays that already hold wire-ready bytes —
// no RTP assembly, no sealing. Returns datagrams handed to the kernel.
int64_t send_raw(int fd, const uint8_t* blob, int32_t n,
                 const int64_t* offs, const int32_t* lens,
                 const uint32_t* ip, const uint16_t* port) {
  if (n <= 0 || fd < 0) return 0;
  std::vector<uint8_t> skip(n, 0);
  Args a{skip.data(), nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
         nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
         nullptr, nullptr, ip,      port,    nullptr, nullptr, nullptr,
         nullptr, nullptr, const_cast<uint8_t*>(blob), offs, lens, fd, 0};
  if (!g_gso_ok.load(std::memory_order_relaxed)) return send_plain(a, 0, n);
  int resume = -1;
  int64_t sent = send_gso(a, 0, n, &resume);
  if (resume >= 0) {
    g_gso_ok.store(false, std::memory_order_relaxed);
    sent += send_plain(a, resume, n);
  }
  return sent;
}

}  // extern "C"

extern "C" {

// Batch receive: drain up to max_n datagrams from a non-blocking UDP
// socket with recvmmsg (the ingress twin of the batch sender — replaces
// one Python callback per datagram with one native call per wake).
// Returns the number received; fills per-datagram offsets/lengths into
// `buf` (caller-sized) and source ip/port (host byte order).
int32_t rx_batch(int fd, uint8_t* buf, int64_t cap, int32_t* offsets,
                 int32_t* lengths, uint32_t* ips, uint16_t* ports,
                 int32_t max_n, int32_t max_dgram) {
  constexpr int CHUNK = 64;
  mmsghdr msgs[CHUNK];
  iovec iovs[CHUNK];
  sockaddr_in sas[CHUNK];
  int32_t n = 0;
  int64_t off = 0;
  while (n < max_n && off + (int64_t)CHUNK * max_dgram <= cap) {
    int want = max_n - n < CHUNK ? max_n - n : CHUNK;
    for (int j = 0; j < want; j++) {
      iovs[j].iov_base = buf + off + (int64_t)j * max_dgram;
      iovs[j].iov_len = max_dgram;
      std::memset(&msgs[j].msg_hdr, 0, sizeof(msghdr));
      msgs[j].msg_hdr.msg_iov = &iovs[j];
      msgs[j].msg_hdr.msg_iovlen = 1;
      msgs[j].msg_hdr.msg_name = &sas[j];
      msgs[j].msg_hdr.msg_namelen = sizeof(sockaddr_in);
    }
    int r = recvmmsg(fd, msgs, want, MSG_DONTWAIT, nullptr);
    if (r <= 0) break;
    for (int j = 0; j < r; j++) {
      if (msgs[j].msg_hdr.msg_flags & MSG_TRUNC) {
        // Oversized datagram: delivering the truncated prefix as if
        // complete would feed corrupt payloads downstream — drop it
        // (length 0; the caller's valid-mask skips it).
        offsets[n] = (int32_t)(off + (int64_t)j * max_dgram);
        lengths[n] = 0;
        ips[n] = 0;
        ports[n] = 0;
        n++;
        continue;
      }
      offsets[n] = (int32_t)(off + (int64_t)j * max_dgram);
      lengths[n] = (int32_t)msgs[j].msg_len;
      ips[n] = ntohl(sas[j].sin_addr.s_addr);
      ports[n] = ntohs(sas[j].sin_port);
      n++;
    }
    off += (int64_t)r * max_dgram;
    if (r < want) break;  // socket drained
  }
  return n;
}

}  // extern "C"

extern "C" {

// Batch AEAD open for sealed ingress frames (the decrypt twin of the
// sealed egress path; layout per runtime/crypto.py:
// 0x01 | key_id(4 BE) | dir(1) | counter(8 BE) | ct || tag(16),
// nonce = dir | counter | 0^3, AAD = the 14-byte header). `key_idx` maps
// each frame to a row of `keys` (16-byte AES-128 keys); <0 = unknown key.
// Plaintext for frame i lands at out + out_off[i]; out_len[i] = plaintext
// length, or -1 on auth failure / wrong direction / runt. Caller handles
// replay windows (cheap per-frame bitmap in Python).
void open_batch(const uint8_t* buf, const int32_t* offsets,
                const int32_t* lengths, int32_t n, const int32_t* key_idx,
                const uint8_t* keys, uint8_t expect_dir,
                uint8_t* out, const int64_t* out_off, int32_t* out_len) {
  EVP_CIPHER_CTX* ctx = EVP_CIPHER_CTX_new();
  const EVP_CIPHER* cipher = EVP_aes_128_gcm();
  bool inited = false;
  for (int i = 0; i < n; i++) {
    out_len[i] = -1;
    int len = lengths[i];
    if (key_idx[i] < 0 || len < 14 + 16) continue;
    const uint8_t* f = buf + offsets[i];
    if (f[0] != 0x01 || f[5] != expect_dir) continue;
    uint8_t nonce[12];
    nonce[0] = f[5];
    std::memcpy(nonce + 1, f + 6, 8);
    std::memset(nonce + 9, 0, 3);
    int ctlen = len - 14 - 16;
    int outl = 0, fl = 0;
    EVP_DecryptInit_ex(ctx, inited ? nullptr : cipher, nullptr,
                       keys + 16 * key_idx[i], nonce);
    inited = true;
    EVP_DecryptUpdate(ctx, nullptr, &outl, f, 14);  // AAD
    EVP_DecryptUpdate(ctx, out + out_off[i], &outl, f + 14, ctlen);
    EVP_CIPHER_CTX_ctrl(ctx, EVP_CTRL_GCM_SET_TAG, 16,
                        const_cast<uint8_t*>(f + len - 16));
    if (EVP_DecryptFinal_ex(ctx, out + out_off[i] + outl, &fl) == 1) {
      out_len[i] = outl + fl;
    }
  }
  EVP_CIPHER_CTX_free(ctx);
}

}  // extern "C"
