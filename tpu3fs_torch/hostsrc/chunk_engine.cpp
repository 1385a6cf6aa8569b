// tpu3fs native chunk engine.
//
// The port's own copy of native/chunk_engine.cpp: the same code, so the C structs,
// the ABI tag and the wire are the JAX package's. tpu3fs_torch/hostbuild.py
// builds it with g++ into tpu3fs_torch/_build/, under a name that carries a
// digest of this file.
//
// C++ re-design of the reference's Rust chunk engine semantics
// (src/storage/chunk_engine/src/core/engine.rs:31-685 and its README):
//   - physical blocks drawn from power-of-two size classes (the reference
//     uses 64KiB..64MiB x11, constants.rs:3-8; here 4KiB..64MiB to let tests
//     run with tiny chunks), one data file per class, group-bitmap allocator
//     (256 chunks per group, first-zero-bit scan like the Rust allocator);
//   - copy-on-write updates: a pending version (u = v+1) lands in a freshly
//     allocated block; commit atomically flips the metadata to point at it
//     and frees the old block; full-chunk-replace installs committed state
//     directly (recovery path);
//   - crash consistency via a metadata write-ahead log replayed on open
//     (the reference uses a RocksDB WriteBatch per commit; a WAL + snapshot
//     is the equivalent atomicity contract without the dependency);
//   - CRC32C maintained per committed chunk (slice-by-8; bit-exact with the
//     framework's TPU/MXU batched CRC kernels).
//
// Exposed as a C ABI consumed through ctypes (no pybind11 in this image).

#include <algorithm>
#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <set>
#include <string>
#include <vector>

#include <fcntl.h>
#include <linux/io_uring.h>
#include <linux/magic.h>
#include <sys/mman.h>
#include <sys/statfs.h>
#include <sys/stat.h>
#include <sys/syscall.h>
#include <sys/types.h>
#include <unistd.h>

#include <condition_variable>
#include <functional>
#include <thread>
#if defined(__x86_64__)
#include <immintrin.h>
#endif

namespace {

// ---- error codes (mirrors tpu3fs.utils.result codes the wrapper maps) ----
enum ErrCode : int {
  OK = 0,
  E_NOT_FOUND = -1,
  E_NOT_COMMIT = -2,
  E_STALE_UPDATE = -3,
  E_MISSING_UPDATE = -4,
  E_ADVANCE_UPDATE = -5,
  E_IO = -6,
  E_INVALID = -7,
  E_NO_SPACE = -8,
  E_CHECKSUM = -9,
  E_RANGE = -10,  // batch-read op does not fit its output slot
};

constexpr int kMinClassShift = 12;           // 4 KiB
constexpr int kMaxClassShift = 26;           // 64 MiB
constexpr int kNumClasses = kMaxClassShift - kMinClassShift + 1;
constexpr uint32_t kGroupChunks = 256;       // bitmap group size (ref allocator)
constexpr size_t kKeyLen = 12;               // file_id(8) + chunk_index(4)

struct Key {
  uint8_t b[kKeyLen];
  bool operator<(const Key& o) const { return memcmp(b, o.b, kKeyLen) < 0; }
  bool operator==(const Key& o) const { return memcmp(b, o.b, kKeyLen) == 0; }
};

// ---- CRC32C (Castagnoli, reflected), slice-by-8 ---------------------------
struct Crc32cTables {
  uint32_t t[8][256];
  Crc32cTables() {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++) c = (c & 1) ? (c >> 1) ^ 0x82F63B78u : c >> 1;
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; i++)
      for (int s = 1; s < 8; s++)
        t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
  }
};
const Crc32cTables kCrc;

uint32_t crc32c_sw(const uint8_t* data, size_t n, uint32_t crc) {
  uint32_t c = ~crc;
  while (n >= 8) {
    uint64_t w;
    memcpy(&w, data, 8);
    w ^= c;
    c = kCrc.t[7][w & 0xFF] ^ kCrc.t[6][(w >> 8) & 0xFF] ^
        kCrc.t[5][(w >> 16) & 0xFF] ^ kCrc.t[4][(w >> 24) & 0xFF] ^
        kCrc.t[3][(w >> 32) & 0xFF] ^ kCrc.t[2][(w >> 40) & 0xFF] ^
        kCrc.t[1][(w >> 48) & 0xFF] ^ kCrc.t[0][(w >> 56) & 0xFF];
    data += 8;
    n -= 8;
  }
  while (n--) c = (c >> 8) ^ kCrc.t[0][(c ^ *data++) & 0xFF];
  return ~c;
}

#if defined(__x86_64__)
// Hardware CRC32C (SSE4.2 crc32 instruction computes exactly the
// Castagnoli polynomial). The crc32q chain has 3-cycle latency, so four
// independent accumulators over interleaved lanes keep the unit saturated;
// lanes are then stitched with the slice-by-8 combine (zero-shift trick:
// feeding the next lane's bytes through the running crc is equivalent to
// a serial pass because each lane is processed in order here — we simply
// unroll 32 bytes per iteration on ONE stream, which already hides most
// of the latency for cache-resident data).
__attribute__((target("sse4.2")))
uint32_t crc32c_hw(const uint8_t* data, size_t n, uint32_t crc) {
  uint64_t c = static_cast<uint32_t>(~crc);
  while (n >= 32) {
    uint64_t w0, w1, w2, w3;
    memcpy(&w0, data, 8);
    memcpy(&w1, data + 8, 8);
    memcpy(&w2, data + 16, 8);
    memcpy(&w3, data + 24, 8);
    c = __builtin_ia32_crc32di(c, w0);
    c = __builtin_ia32_crc32di(c, w1);
    c = __builtin_ia32_crc32di(c, w2);
    c = __builtin_ia32_crc32di(c, w3);
    data += 32;
    n -= 32;
  }
  while (n >= 8) {
    uint64_t w;
    memcpy(&w, data, 8);
    c = __builtin_ia32_crc32di(c, w);
    data += 8;
    n -= 8;
  }
  uint32_t c32 = static_cast<uint32_t>(c);
  while (n--) c32 = __builtin_ia32_crc32qi(c32, *data++);
  return ~c32;
}

const bool kHasSse42 = __builtin_cpu_supports("sse4.2");

uint32_t crc32c(const uint8_t* data, size_t n, uint32_t crc = 0) {
  return kHasSse42 ? crc32c_hw(data, n, crc) : crc32c_sw(data, n, crc);
}
#else
uint32_t crc32c(const uint8_t* data, size_t n, uint32_t crc = 0) {
  return crc32c_sw(data, n, crc);
}
#endif

// ---- block reference ------------------------------------------------------
struct BlockRef {
  int8_t cls = -1;        // size class, -1 = none
  uint32_t idx = 0;       // block index within the class file
  uint32_t length = 0;    // content bytes
  uint32_t crc = 0;
  bool valid() const { return cls >= 0; }
};

struct ChunkMeta {
  uint64_t committed_ver = 0;
  uint64_t pending_ver = 0;
  uint64_t chain_ver = 0;
  BlockRef committed;
  BlockRef pending;
  // opaque per-chunk tag, promoted with the content at commit; the EC
  // stripe path stores the stripe's logical (pre-padding) byte length so
  // rebuilds and queryLastChunk never have to infer it from zero-trimming
  uint32_t aux = 0;
  uint32_t aux_pending = 0;
};

// ---- WAL record -----------------------------------------------------------
// Fixed-size state record: last-wins per key on replay; remove = tombstone.

// v1 layout (pre-aux builds): readable forever so upgrades never lose
// acknowledged writes; replay migrates v1 logs to v2 via compact()
struct WalRecordV1 {
  static constexpr uint32_t kMagic = 0x33465354;  // "3FST"
  uint32_t magic = kMagic;
  uint8_t op = 0;
  uint8_t key[kKeyLen] = {0};
  uint64_t committed_ver = 0, pending_ver = 0, chain_ver = 0;
  int8_t c_cls = -1, p_cls = -1;
  uint32_t c_idx = 0, c_len = 0, c_crc = 0;
  uint32_t p_idx = 0, p_len = 0, p_crc = 0;
  uint32_t rec_crc = 0;

  bool check() const;
  uint32_t aux_of() const { return 0; }
  uint32_t aux_pending_of() const { return 0; }
};

struct WalRecord {
  uint32_t magic = 0x33465355;  // "3FSU" (v2: aux fields)
  uint8_t op = 0;               // 1 = state, 2 = remove
  uint8_t key[kKeyLen] = {0};
  uint64_t committed_ver = 0, pending_ver = 0, chain_ver = 0;
  int8_t c_cls = -1, p_cls = -1;
  uint32_t c_idx = 0, c_len = 0, c_crc = 0;
  uint32_t p_idx = 0, p_len = 0, p_crc = 0;
  uint32_t aux = 0, aux_pending = 0;
  uint32_t rec_crc = 0;         // crc of the record up to this field

  void seal() {
    rec_crc = crc32c(reinterpret_cast<const uint8_t*>(this),
                     offsetof(WalRecord, rec_crc));
  }
  bool check() const {
    return magic == 0x33465355 &&
           rec_crc == crc32c(reinterpret_cast<const uint8_t*>(this),
                             offsetof(WalRecord, rec_crc));
  }
  uint32_t aux_of() const { return aux; }
  uint32_t aux_pending_of() const { return aux_pending; }
};

inline bool WalRecordV1::check() const {
  return magic == kMagic &&
         rec_crc == crc32c(reinterpret_cast<const uint8_t*>(this),
                           offsetof(WalRecordV1, rec_crc));
}

// ---- per-class allocator + data file --------------------------------------
struct SizeClass {
  int fd = -1;
  uint32_t block_size = 0;
  std::vector<uint64_t> bitmap;  // 1 bit per block, grouped 256/group
  uint32_t allocated = 0;
  // mmap IO mode (tmpfs-backed engines): the class file stays mapped and
  // block IO is a memcpy — no per-op syscall, no kernel/user copy pair
  uint8_t* map = nullptr;
  size_t map_len = 0;
  size_t file_len = 0;

  int32_t allocate() {
    for (size_t w = 0; w < bitmap.size(); w++) {
      uint64_t inv = ~bitmap[w];
      if (inv) {
        int bit = __builtin_ctzll(inv);
        bitmap[w] |= (1ull << bit);
        allocated++;
        return static_cast<int32_t>(w * 64 + bit);
      }
    }
    // grow by one group (256 chunks -> 4 words)
    size_t base = bitmap.size() * 64;
    bitmap.resize(bitmap.size() + kGroupChunks / 64, 0);
    bitmap[base / 64] |= 1ull;
    allocated++;
    return static_cast<int32_t>(base);
  }

  void mark(uint32_t idx) {
    size_t w = idx / 64;
    if (w >= bitmap.size()) bitmap.resize((w / 4 + 1) * 4, 0);
    if (!(bitmap[w] & (1ull << (idx % 64)))) {
      bitmap[w] |= (1ull << (idx % 64));
      allocated++;
    }
  }

  void release(uint32_t idx) {
    size_t w = idx / 64;
    if (w < bitmap.size() && (bitmap[w] & (1ull << (idx % 64)))) {
      bitmap[w] &= ~(1ull << (idx % 64));
      allocated--;
    }
  }
};

// ---- io_uring batch reader -------------------------------------------------
// Raw-syscall io_uring (no liburing in this image): the AioReadWorker role
// (ref src/storage/aio/AioReadWorker.h:19-50 — libaio/io_uring, registered
// FDs). Batched reads submit one SQE per op and reap completions in one
// io_uring_enter; the engine's size-class FDs are registered once
// (IORING_REGISTER_FILES) so the kernel skips the per-op fd lookup.
// Unavailable (seccomp, old kernel) => callers fall back to sync pread.
struct Uring {
  int fd = -1;
  unsigned sq_entries = 0;
  unsigned *sq_head = nullptr, *sq_tail = nullptr, *sq_mask = nullptr;
  unsigned *sq_array = nullptr;
  unsigned *cq_head = nullptr, *cq_tail = nullptr, *cq_mask = nullptr;
  io_uring_sqe* sqes = nullptr;
  io_uring_cqe* cqes = nullptr;
  void* sq_ptr = nullptr;
  void* cq_ptr = nullptr;
  size_t sq_len = 0, cq_len = 0, sqes_len = 0;
  bool fixed_files = false;

  bool init(unsigned entries, const int* files, unsigned nfiles) {
    io_uring_params p{};
    fd = static_cast<int>(syscall(__NR_io_uring_setup, entries, &p));
    if (fd < 0) return false;
    sq_len = p.sq_off.array + p.sq_entries * sizeof(unsigned);
    cq_len = p.cq_off.cqes + p.cq_entries * sizeof(io_uring_cqe);
    bool single = p.features & IORING_FEAT_SINGLE_MMAP;
    if (single) sq_len = cq_len = std::max(sq_len, cq_len);
    sq_ptr = mmap(nullptr, sq_len, PROT_READ | PROT_WRITE,
                  MAP_SHARED | MAP_POPULATE, fd, IORING_OFF_SQ_RING);
    if (sq_ptr == MAP_FAILED) return fail();
    cq_ptr = single ? sq_ptr
                    : mmap(nullptr, cq_len, PROT_READ | PROT_WRITE,
                           MAP_SHARED | MAP_POPULATE, fd, IORING_OFF_CQ_RING);
    if (cq_ptr == MAP_FAILED) return fail();
    sqes_len = p.sq_entries * sizeof(io_uring_sqe);
    sqes = static_cast<io_uring_sqe*>(
        mmap(nullptr, sqes_len, PROT_READ | PROT_WRITE,
             MAP_SHARED | MAP_POPULATE, fd, IORING_OFF_SQES));
    if (sqes == MAP_FAILED) return fail();
    auto at = [](void* base, unsigned off) {
      return reinterpret_cast<unsigned*>(static_cast<char*>(base) + off);
    };
    sq_head = at(sq_ptr, p.sq_off.head);
    sq_tail = at(sq_ptr, p.sq_off.tail);
    sq_mask = at(sq_ptr, p.sq_off.ring_mask);
    sq_array = at(sq_ptr, p.sq_off.array);
    cq_head = at(cq_ptr, p.cq_off.head);
    cq_tail = at(cq_ptr, p.cq_off.tail);
    cq_mask = at(cq_ptr, p.cq_off.ring_mask);
    cqes = reinterpret_cast<io_uring_cqe*>(
        static_cast<char*>(cq_ptr) + p.cq_off.cqes);
    sq_entries = p.sq_entries;
    if (files && nfiles &&
        syscall(__NR_io_uring_register, fd, IORING_REGISTER_FILES, files,
                nfiles) == 0) {
      fixed_files = true;
    }
    return true;
  }

  bool fail() {
    shutdown();
    return false;
  }

  void shutdown() {
    if (sqes && sqes != MAP_FAILED) munmap(sqes, sqes_len);
    if (cq_ptr && cq_ptr != sq_ptr && cq_ptr != MAP_FAILED)
      munmap(cq_ptr, cq_len);
    if (sq_ptr && sq_ptr != MAP_FAILED) munmap(sq_ptr, sq_len);
    sqes = nullptr;
    sq_ptr = cq_ptr = nullptr;
    if (fd >= 0) close(fd);
    fd = -1;
  }

  struct ReadOp {
    int file;          // raw fd, or registered index when fixed_files
    uint8_t* buf;
    uint32_t len;
    uint64_t off;
    int64_t result;    // bytes read or -errno
  };

  unsigned reap(ReadOp* ops, unsigned n) {
    unsigned reaped = 0;
    unsigned chead = __atomic_load_n(cq_head, __ATOMIC_ACQUIRE);
    unsigned ctail = __atomic_load_n(cq_tail, __ATOMIC_ACQUIRE);
    while (chead != ctail) {
      const io_uring_cqe& c = cqes[chead & *cq_mask];
      if (c.user_data < n) ops[c.user_data].result = c.res;
      chead++;
      reaped++;
    }
    __atomic_store_n(cq_head, chead, __ATOMIC_RELEASE);
    return reaped;
  }

  // submit + reap all ops (waves of sq_entries); returns false on a ring
  // failure (caller falls back to sync reads). INVARIANT on return: zero
  // ops in flight — the kernel must never keep async-writing into the
  // caller's buffers after this returns, so any failure path drains the
  // submitted ops before reporting it.
  bool read_batch(ReadOp* ops, unsigned n) {
    unsigned done = 0;
    while (done < n) {
      unsigned wave = std::min(n - done, sq_entries);
      unsigned tail = __atomic_load_n(sq_tail, __ATOMIC_ACQUIRE);
      for (unsigned i = 0; i < wave; i++) {
        unsigned idx = (tail + i) & *sq_mask;
        io_uring_sqe& e = sqes[idx];
        memset(&e, 0, sizeof(e));
        e.opcode = IORING_OP_READ;
        e.fd = ops[done + i].file;
        e.addr = reinterpret_cast<uint64_t>(ops[done + i].buf);
        e.len = ops[done + i].len;
        e.off = ops[done + i].off;
        e.user_data = done + i;
        if (fixed_files) e.flags |= IOSQE_FIXED_FILE;
        sq_array[idx] = idx;
      }
      __atomic_store_n(sq_tail, tail + wave, __ATOMIC_RELEASE);
      // submit phase: io_uring_enter consumes SQEs; rc >= 0 is the count
      // consumed (may be partial), rc < 0 consumes nothing
      unsigned submitted = 0;
      bool submit_failed = false;
      while (submitted < wave) {
        int rc = static_cast<int>(
            syscall(__NR_io_uring_enter, fd, wave - submitted, 0, 0,
                    nullptr, 0));
        if (rc < 0) {
          if (errno == EINTR) continue;
          submit_failed = true;
          break;
        }
        submitted += static_cast<unsigned>(rc);
        if (rc == 0) {
          submit_failed = true;  // no progress: treat as a ring failure
          break;
        }
      }
      // reap phase: everything submitted MUST complete before we return,
      // success or not; GETEVENTS with min_complete blocks until then
      // (EINTR retried; other errors retried too — abandoning in-flight
      // reads would let the kernel scribble on freed buffers)
      unsigned reaped = 0;
      while (reaped < submitted) {
        reaped += reap(ops, n);
        if (reaped >= submitted) break;
        syscall(__NR_io_uring_enter, fd, 0, submitted - reaped,
                IORING_ENTER_GETEVENTS, nullptr, 0);
      }
      if (submit_failed) return false;  // drained; caller re-reads sync
      done += wave;
    }
    return true;
  }
};

int class_for(uint32_t chunk_bytes) {
  if (chunk_bytes == 0) return 0;
  uint32_t need = chunk_bytes;
  int shift = kMinClassShift;
  while ((1u << shift) < need && shift < kMaxClassShift) shift++;
  if ((1u << shift) < need) return -1;
  return shift - kMinClassShift;
}

// ---- paged metadata base run ----------------------------------------------
// One mmap'd SORTED array of sealed WalRecords: the at-rest form of the
// chunk index (the MetaStore role RocksDB plays in the reference,
// src/storage/chunk_engine/src/meta/rocksdb.rs). RAM holds only the DELTA
// since the last rewrite, so resident metadata stays flat as chunk count
// grows; lookups binary-search the mapping (page cache, evictable).
struct MetaBase {
  int fd = -1;
  const WalRecord* recs = nullptr;
  size_t n = 0;
  size_t map_len = 0;

  const WalRecord* find(const Key& k) const {
    size_t lo = 0, hi = n;
    while (lo < hi) {
      size_t mid = (lo + hi) / 2;
      int c = memcmp(recs[mid].key, k.b, kKeyLen);
      if (c < 0)
        lo = mid + 1;
      else if (c > 0)
        hi = mid;
      else
        return &recs[mid];
    }
    return nullptr;
  }

  void reset() {
    if (recs != nullptr) munmap(const_cast<WalRecord*>(recs), map_len);
    if (fd >= 0) close(fd);
    fd = -1;
    recs = nullptr;
    n = 0;
    map_len = 0;
  }
};

ChunkMeta meta_from_rec(const WalRecord& rec) {
  ChunkMeta m;
  m.committed_ver = rec.committed_ver;
  m.pending_ver = rec.pending_ver;
  m.chain_ver = rec.chain_ver;
  m.committed = {rec.c_cls, rec.c_idx, rec.c_len, rec.c_crc};
  m.pending = {rec.p_cls, rec.p_idx, rec.p_len, rec.p_crc};
  m.aux = rec.aux;
  m.aux_pending = rec.aux_pending;
  return m;
}

void rec_from_meta(const Key& k, const ChunkMeta& m, WalRecord* rec) {
  *rec = WalRecord{};
  rec->op = 1;
  memcpy(rec->key, k.b, kKeyLen);
  rec->committed_ver = m.committed_ver;
  rec->pending_ver = m.pending_ver;
  rec->chain_ver = m.chain_ver;
  rec->c_cls = m.committed.cls;
  rec->c_idx = m.committed.idx;
  rec->c_len = m.committed.length;
  rec->c_crc = m.committed.crc;
  rec->p_cls = m.pending.cls;
  rec->p_idx = m.pending.idx;
  rec->p_len = m.pending.length;
  rec->p_crc = m.pending.crc;
  rec->aux = m.aux;
  rec->aux_pending = m.aux_pending;
  rec->seal();
}

// ---- engine ---------------------------------------------------------------
struct Engine {
  std::string dir;
  // `metas` is the in-RAM DELTA over base_ (plus a read-materialization
  // cache); dead_ masks base-resident keys erased since the last rewrite;
  // base_overlap_ tracks delta keys that shadow a base record (for O(1)
  // chunk counting); logged_len_ carries each delta key's last accounted
  // committed length (for O(1) used_size)
  MetaBase base_;
  std::map<Key, ChunkMeta> metas;
  std::set<Key> dead_;
  std::set<Key> base_overlap_;
  std::map<Key, uint32_t> logged_len_;
  uint64_t used_ = 0;
  std::set<Key> pending_keys;  // keys with pending_ver != 0 (see note_pending)
  SizeClass classes[kNumClasses];
  int wal_fd = -1;
  uint64_t wal_records = 0;
  bool fsync_wal = false;
  // blocks freed by a state change stay quarantined (unallocatable) until
  // the WAL record superseding them is appended (and fsynced in durable
  // mode) — otherwise replay could resurrect a meta pointing at a reused,
  // overwritten block
  std::vector<std::pair<int8_t, uint32_t>> quarantine;
  std::mutex mu;
  Uring uring;
  int uring_state = 0;  // 0 = not probed, 1 = ready, -1 = unavailable
  // mmap IO: chosen at open when the engine dir sits on tmpfs/ramfs — AIO
  // buys nothing there (no device queue) while every pread/pwrite costs a
  // syscall + copy; real filesystems keep the io_uring/pread path (mapped
  // page faults would serialize on actual disk IO). Env override:
  // TPU3FS_MMAP=0|1.
  bool use_mmap = false;
  bool on_tmpfs = false;  // detected (never forced): gates fsync skipping
  // set when a post-rename remap_base failure leaves the paged index
  // half-visible (compact()): every subsequent op refuses with E_IO
  // rather than serving an index that silently hides base-resident
  // chunks. Recovery is a process restart (replay rebuilds from disk).
  bool poisoned = false;

  // ensure class `cls`'s file and mapping cover [0, end); -> map or null
  uint8_t* map_for(int cls, size_t end) {
    SizeClass& sc = classes[cls];
    if (end <= sc.map_len) return sc.map;
    constexpr size_t kAlign = 2u << 20;
    size_t new_len =
        std::max<size_t>(sc.map_len ? sc.map_len * 2 : (16u << 20), end);
    new_len = (new_len + kAlign - 1) & ~(kAlign - 1);
    if (sc.file_len < new_len) {
      // belt and braces: re-check the on-disk size so a stale file_len can
      // never shrink the file (ftruncate down would zero written blocks)
      struct stat st;
      if (fstat(sc.fd, &st) == 0)
        sc.file_len = std::max(sc.file_len, static_cast<size_t>(st.st_size));
      if (sc.file_len < new_len) {
        if (ftruncate(sc.fd, static_cast<off_t>(new_len)) != 0)
          return nullptr;
        sc.file_len = new_len;
      }
      new_len = std::max(new_len, sc.file_len);
      new_len = (new_len + kAlign - 1) & ~(kAlign - 1);
    }
    void* m = sc.map ? mremap(sc.map, sc.map_len, new_len, MREMAP_MAYMOVE)
                     : mmap(nullptr, new_len, PROT_READ | PROT_WRITE,
                            MAP_SHARED, sc.fd, 0);
    if (m == MAP_FAILED) return nullptr;
    sc.map = static_cast<uint8_t*>(m);
    sc.map_len = new_len;
    return sc.map;
  }

  Uring* get_uring() {
    if (uring_state == 0) {
      if (getenv("TPU3FS_NO_URING") != nullptr) {
        uring_state = -1;
      } else {
        int files[kNumClasses];
        for (int c = 0; c < kNumClasses; c++) files[c] = classes[c].fd;
        uring_state = uring.init(256, files, kNumClasses) ? 1 : -1;
      }
    }
    return uring_state == 1 ? &uring : nullptr;
  }

  std::string class_path(int c) const {
    return dir + "/data_" + std::to_string(c) + ".bin";
  }
  std::string wal_path() const { return dir + "/wal.log"; }

  int open_files() {
    for (int c = 0; c < kNumClasses; c++) {
      classes[c].block_size = 1u << (c + kMinClassShift);
      classes[c].fd = ::open(class_path(c).c_str(), O_RDWR | O_CREAT, 0644);
      if (classes[c].fd < 0) return E_IO;
      // mmap mode grows files by ftruncate: seed file_len with the REAL
      // size so a reopen can never truncate prior blocks away
      struct stat st;
      if (fstat(classes[c].fd, &st) == 0)
        classes[c].file_len = static_cast<size_t>(st.st_size);
    }
    wal_fd = ::open(wal_path().c_str(), O_RDWR | O_CREAT | O_APPEND, 0644);
    return wal_fd < 0 ? E_IO : OK;
  }

  template <typename Rec>
  size_t replay_records(FILE* f) {
    // -> byte offset of the end of the last VALID record. Applies each
    // record as a DELTA over the (already-scanned) base: allocator marks
    // follow the visible state exactly — a record superseding an earlier
    // visible version releases that version's blocks and marks its own.
    Rec rec;
    size_t valid = 0;
    while (fread(&rec, sizeof(rec), 1, f) == 1) {
      if (!rec.check()) break;  // torn tail: stop replay
      valid += sizeof(rec);
      wal_records++;
      Key k;
      memcpy(k.b, rec.key, kKeyLen);
      ChunkMeta* prior = lookup(k);
      if (prior != nullptr) {
        if (prior->committed.valid())
          classes[prior->committed.cls].release(prior->committed.idx);
        if (prior->pending.valid())
          classes[prior->pending.cls].release(prior->pending.idx);
      }
      if (rec.op == 2) {
        if (prior != nullptr) erase_meta_nolog(k);
        continue;
      }
      ChunkMeta m;
      m.committed_ver = rec.committed_ver;
      m.pending_ver = rec.pending_ver;
      m.chain_ver = rec.chain_ver;
      m.committed = {rec.c_cls, rec.c_idx, rec.c_len, rec.c_crc};
      m.pending = {rec.p_cls, rec.p_idx, rec.p_len, rec.p_crc};
      m.aux = rec.aux_of();
      m.aux_pending = rec.aux_pending_of();
      if (m.committed.valid()) classes[m.committed.cls].mark(m.committed.idx);
      if (m.pending.valid()) classes[m.pending.cls].mark(m.pending.idx);
      ChunkMeta& slot = pin(k);
      slot = m;
      uint32_t& ll = logged_len_[k];
      used_ += m.committed.length;
      used_ -= ll;
      ll = m.committed.length;
      note_pending(k, m);
    }
    return valid;
  }

  int load_base() {
    // mmap the base run and take ONE sequential pass: allocator marks,
    // live-byte total, pending-key index, and per-record CRC validation.
    // This pass is the whole "open replay" for base-resident state —
    // O(chunk count) of sequential page-cache reads, instead of replaying
    // an unbounded mutation history.
    int rc = remap_base();
    if (rc != OK) return rc;
    for (size_t i = 0; i < base_.n; i++) {
      const WalRecord& rec = base_.recs[i];
      if (!rec.check() || rec.op != 1) return E_IO;  // base never tears
      if (i > 0 &&
          memcmp(base_.recs[i - 1].key, rec.key, kKeyLen) >= 0)
        return E_IO;  // must be strictly sorted
      if (rec.c_cls >= 0) classes[rec.c_cls].mark(rec.c_idx);
      if (rec.p_cls >= 0) classes[rec.p_cls].mark(rec.p_idx);
      used_ += rec.c_len;
      if (rec.pending_ver != 0) {
        Key k;
        memcpy(k.b, rec.key, kKeyLen);
        pending_keys.insert(k);
      }
    }
    return OK;
  }

  int replay() {
    int rc = load_base();
    if (rc != OK) return rc;
    FILE* f = fopen(wal_path().c_str(), "rb");
    if (!f) return OK;
    // peek the first record's magic: a v1-format log (pre-aux build) is
    // replayed with the v1 layout, then compacted to v2 below — acked
    // writes from an older build must never be silently dropped
    uint32_t first_magic = 0;
    bool legacy = false;
    if (fread(&first_magic, sizeof(first_magic), 1, f) == 1)
      legacy = (first_magic == WalRecordV1::kMagic);
    rewind(f);
    size_t valid = legacy ? replay_records<WalRecordV1>(f)
                          : replay_records<WalRecord>(f);
    fclose(f);
    if (legacy) return compact();  // rewrite as v2 base before any append
    // drop any torn/garbage suffix NOW: O_APPEND writes after an unreadable
    // record would otherwise be invisible to every future replay
    struct stat st;
    if (stat(wal_path().c_str(), &st) == 0 &&
        static_cast<size_t>(st.st_size) != valid) {
      if (::truncate(wal_path().c_str(), valid) != 0) return E_IO;
    }
    return OK;
  }

  // WAL group-append: batch entry points buffer their records and write
  // them with ONE syscall (+ at most one fsync) per engine crossing —
  // quarantined blocks drain only after the buffered records actually
  // land, preserving the no-resurrection rule above.
  std::vector<WalRecord> log_buf;
  bool log_buffering = false;

  int flush_log() {
    if (log_buf.empty()) return OK;
    ssize_t want =
        static_cast<ssize_t>(log_buf.size() * sizeof(WalRecord));
    if (write(wal_fd, log_buf.data(), want) != want) return E_IO;
    if (fsync_wal) fsync(wal_fd);
    log_buf.clear();
    drain_quarantine();
    return OK;
  }

  // -- paged index primitives ----------------------------------------------
  std::string base_path() const { return dir + "/meta_base.bin"; }

  // visible meta for k, or null. Base hits MATERIALIZE into the delta so
  // callers get a stable mutable slot (the mutators all work through
  // in-place references); materialized entries simply ride into the next
  // rewrite unchanged.
  ChunkMeta* lookup(const Key& k) {
    auto it = metas.find(k);
    if (it != metas.end()) return &it->second;
    if (dead_.count(k)) return nullptr;
    const WalRecord* r = base_.find(k);
    if (r == nullptr) return nullptr;
    ChunkMeta m = meta_from_rec(*r);
    base_overlap_.insert(k);
    logged_len_[k] = m.committed.length;
    return &(metas[k] = m);
  }

  // the `metas[k]` (create-if-absent) form
  ChunkMeta& pin(const Key& k) {
    ChunkMeta* p = lookup(k);
    if (p != nullptr) return *p;
    dead_.erase(k);
    if (base_.find(k) != nullptr) base_overlap_.insert(k);
    logged_len_[k] = 0;
    return metas[k];
  }

  // a failed validated install drops the slot it just created (no
  // phantom). pin() erased the key from dead_, so a base-resident key —
  // i.e. one REMOVED since the last rewrite — must be re-masked here
  // (mirroring erase_meta_nolog), or the next lookup would resurrect the
  // removed chunk from the base with block refs remove() already freed
  // (and the allocator may have reassigned): reads could return another
  // chunk's data and a later remove would double-free a live block.
  void drop_phantom(const Key& k) {
    metas.erase(k);
    logged_len_.erase(k);
    base_overlap_.erase(k);
    if (base_.find(k) != nullptr) dead_.insert(k);
  }

  // true when `m` is a slot pin() just created (nothing committed or
  // staged): every post-pin error return must drop such slots via
  // drop_phantom, both for the no-phantom rule and the dead_ re-mask
  static bool is_phantom(const ChunkMeta& m) {
    return !m.committed.valid() && !m.pending.valid() &&
           m.committed_ver == 0 && m.pending_ver == 0;
  }

  // erase bookkeeping shared by remove() and WAL replay
  void erase_meta_nolog(const Key& k) {
    metas.erase(k);
    base_overlap_.erase(k);
    if (base_.find(k) != nullptr) dead_.insert(k);
    auto ll = logged_len_.find(k);
    if (ll != logged_len_.end()) {
      used_ -= ll->second;
      logged_len_.erase(ll);
    }
    pending_keys.erase(k);
  }

  uint64_t meta_count() const {
    return base_.n - dead_.size() - base_overlap_.size() + metas.size();
  }

  // pending-key index: every meta state change funnels through log_state /
  // log_remove / replay, so the set stays exact. Keeps ce_query_pending
  // O(pendings), not O(chunks) — it is the steady-state probe of the
  // healthy-chain EC repair sweep (once per resync interval per target).
  void note_pending(const Key& k, const ChunkMeta& m) {
    if (m.pending_ver)
      pending_keys.insert(k);
    else
      pending_keys.erase(k);
  }

  int log_state(const Key& k, const ChunkMeta& m) {
    note_pending(k, m);
    uint32_t& ll = logged_len_[k];
    used_ += m.committed.length;
    used_ -= ll;
    ll = m.committed.length;
    WalRecord rec;
    rec_from_meta(k, m, &rec);
    wal_records++;
    if (log_buffering) {
      log_buf.push_back(rec);
      return OK;  // quarantine drains at flush_log
    }
    if (write(wal_fd, &rec, sizeof(rec)) != sizeof(rec)) return E_IO;
    if (fsync_wal) fsync(wal_fd);
    drain_quarantine();
    return OK;
  }

  int log_remove(const Key& k) {
    WalRecord rec;
    rec.op = 2;
    memcpy(rec.key, k.b, kKeyLen);
    rec.seal();
    wal_records++;
    if (log_buffering) {
      log_buf.push_back(rec);
      return OK;  // quarantine drains at flush_log
    }
    if (write(wal_fd, &rec, sizeof(rec)) != sizeof(rec)) return E_IO;
    if (fsync_wal) fsync(wal_fd);
    drain_quarantine();
    return OK;
  }

  int compact() {
    if (poisoned) return E_IO;
    // rewrite the BASE RUN: stream-merge (base - dead) with the delta into
    // a fresh sorted record array, swap it in atomically, then truncate
    // the WAL — RAM drops back to an empty delta. The rewrite trigger is
    // the delta footprint (adaptive: ~1/8 of the live count), so total
    // rewrite traffic amortizes to O(N log N) over N creates.
    std::string tmp = base_path() + ".tmp";
    int fd = ::open(tmp.c_str(), O_RDWR | O_CREAT | O_TRUNC, 0644);
    if (fd < 0) return E_IO;
    std::vector<WalRecord> buf;
    buf.reserve(4096);
    auto emit = [&](const Key& k, const ChunkMeta& m) -> int {
      buf.emplace_back();
      rec_from_meta(k, m, &buf.back());
      if (buf.size() == 4096) {
        ssize_t want = static_cast<ssize_t>(buf.size() * sizeof(WalRecord));
        if (write(fd, buf.data(), want) != want) return E_IO;
        buf.clear();
      }
      return OK;
    };
    auto dit = metas.begin();
    size_t bi = 0;
    int rc = OK;
    while (rc == OK && (dit != metas.end() || bi < base_.n)) {
      if (bi < base_.n) {
        Key bk;
        memcpy(bk.b, base_.recs[bi].key, kKeyLen);
        if (dit == metas.end() || bk < dit->first) {
          if (!dead_.count(bk)) rc = emit(bk, meta_from_rec(base_.recs[bi]));
          bi++;
          continue;
        }
        if (bk == dit->first) bi++;  // shadowed by the delta
      }
      rc = emit(dit->first, dit->second);
      ++dit;
    }
    if (rc == OK && !buf.empty()) {
      ssize_t want = static_cast<ssize_t>(buf.size() * sizeof(WalRecord));
      if (write(fd, buf.data(), want) != want) rc = E_IO;
    }
    if (rc != OK) {
      close(fd);
      ::unlink(tmp.c_str());
      return rc;
    }
    fsync(fd);
    close(fd);
    if (rename(tmp.c_str(), base_path().c_str()) != 0) return E_IO;
    if (remap_base() != OK) {
      // the old base mapping is already gone (base_.reset inside
      // remap_base) but the delta/dead_ sets still describe overlays of
      // it: every base-resident chunk is now silently invisible while
      // counts/used_ disagree. That index cannot be served — POISON the
      // engine (all subsequent ops refuse with E_IO) instead of
      // returning a retryable error with a half-visible index.
      poisoned = true;
      return E_IO;
    }
    metas.clear();
    dead_.clear();
    base_overlap_.clear();
    logged_len_.clear();
    // WAL restarts empty: the base now carries full state
    close(wal_fd);
    wal_fd = ::open(wal_path().c_str(),
                    O_RDWR | O_CREAT | O_APPEND | O_TRUNC, 0644);
    wal_records = 0;
    // the base wrote (and fsynced) full current state: any buffered
    // records are redundant and every superseded block is now safe
    log_buf.clear();
    drain_quarantine();
    return wal_fd < 0 ? E_IO : OK;
  }

  int remap_base() {
    base_.reset();
    base_.fd = ::open(base_path().c_str(), O_RDONLY);
    if (base_.fd < 0) return OK;  // no base yet (fresh/legacy dir)
    struct stat st;
    if (fstat(base_.fd, &st) != 0) return E_IO;
    size_t sz = static_cast<size_t>(st.st_size);
    base_.n = sz / sizeof(WalRecord);
    if (base_.n == 0) return OK;
    base_.map_len = sz;
    void* m = mmap(nullptr, sz, PROT_READ, MAP_SHARED, base_.fd, 0);
    if (m == MAP_FAILED) {
      base_.n = 0;
      return E_IO;
    }
    base_.recs = static_cast<const WalRecord*>(m);
    return OK;
  }

  uint64_t hot_cap() const {
    // delta-size rewrite trigger. Default is adaptive (live/8): total
    // rewrite traffic stays O(N log N) over N creates while the resident
    // delta is bounded by live/8. TPU3FS_META_HOT_CAP pins it (a FLAT
    // RSS envelope at the cost of more rewrite traffic — the tradeoff
    // knob RocksDB's memtable size plays in the reference's engine).
    static const uint64_t fixed = [] {
      const char* v = getenv("TPU3FS_META_HOT_CAP");
      return v != nullptr ? strtoull(v, nullptr, 10) : 0ull;
    }();
    if (fixed) return fixed;
    uint64_t cap = meta_count() / 8;
    return cap < 65536 ? 65536 : cap;
  }

  void maybe_compact() {
    if (metas.size() + dead_.size() >= hot_cap() ||
        wal_records > 4 * (meta_count() + 1) + 4096)
      compact();
  }

  // -- block IO ------------------------------------------------------------
  int write_block(const BlockRef& ref, const uint8_t* data, uint32_t len) {
    SizeClass& sc = classes[ref.cls];
    off_t off = static_cast<off_t>(ref.idx) * sc.block_size;
    // writes stay on pwrite even in mmap mode: tmpfs pwrite allocates the
    // page and copies in one pass, while a store through a fresh mapping
    // pays a minor fault per 4 KiB first (measured ~25% slower on fresh
    // blocks). Reads hit long-lived pages, where the mapping wins.
    ssize_t n = pwrite(sc.fd, data, len, off);
    if (n != static_cast<ssize_t>(len)) return E_IO;
    // track the real extent: map_for grows files by ftruncate and must
    // never truncate BELOW pwrite-extended length (that would zero blocks)
    if (static_cast<size_t>(off) + len > sc.file_len)
      sc.file_len = static_cast<size_t>(off) + len;
    if (on_tmpfs) return OK;  // tmpfs: fsync is meaningless
    // NOTE: a forced TPU3FS_MMAP=1 on a real filesystem keeps full
    // durable-mode syncing — block content must hit disk before the WAL
    // record that references it
    // durable mode: block content must be on disk before the WAL record
    // that references it
    if (fsync_wal && fdatasync(sc.fd) != 0) return E_IO;
    return OK;
  }

  int read_block(const BlockRef& ref, uint8_t* out, uint32_t off_in,
                 uint32_t len) {
    const SizeClass& sc = classes[ref.cls];
    off_t off = static_cast<off_t>(ref.idx) * sc.block_size + off_in;
    if (use_mmap) {
      uint8_t* m = map_for(ref.cls, static_cast<size_t>(off) + len);
      if (m != nullptr) {
        memcpy(out, m + off, len);
        return OK;
      }
    }
    ssize_t n = pread(sc.fd, out, len, off);
    return n == static_cast<ssize_t>(len) ? OK : E_IO;
  }

  void free_block(BlockRef& ref) {
    if (ref.valid()) {
      quarantine.emplace_back(ref.cls, ref.idx);
      ref = BlockRef{};
    }
  }

  void drain_quarantine() {
    for (auto& [cls, idx] : quarantine) classes[cls].release(idx);
    quarantine.clear();
  }

  // -- engine ops ----------------------------------------------------------
  // io_ver: in/out — 0 on input means "assign committed+1" (the head-write
  // case); on return carries the staged version. out_len/out_crc (nullable)
  // report the staged pending block so callers never have to materialize
  // the chunk content to checksum it (the per-hop copy the Python path
  // used to pay; ref StorageOperator.cc:464-482 cross-check).
  // check_crc: refuse the install (no mutation) unless the engine-computed
  // content CRC equals expected_crc — the one-pass validated-install the EC
  // shard path uses (the CRC is computed during staging anyway).
  // `mode`: 0 = COW stage (chain version algebra), 1 = full replace
  // committed in one step (recovery writes), 2 = STAGE-replace: stage the
  // data as the whole pending content at update_ver, allowing version
  // gaps and replacing an older pending — phase one of the EC two-phase
  // stripe write (the committed version survives until commit()).
  int update(const Key& k, uint64_t* io_ver, uint64_t chain_ver,
             const uint8_t* data, uint32_t data_len, uint32_t offset,
             int mode, uint32_t chunk_size, uint32_t aux,
             uint32_t* out_len, uint32_t* out_crc, int check_crc = 0,
             uint32_t expected_crc = 0) {
    const int full_replace = (mode == 1);
    const int stage_replace = (mode == 2);
    // overflow-safe bound: offset + data_len can wrap uint32
    if (offset > chunk_size || data_len > chunk_size - offset)
      return E_INVALID;
    uint64_t update_ver = *io_ver;
    // validate against the existing meta (or an empty one) BEFORE inserting,
    // so rejected updates leave no phantom committed_ver=0 chunk behind
    {
      const ChunkMeta* it = lookup(k);
      uint64_t cv = it != nullptr ? it->committed_ver : 0;
      uint64_t pv = it != nullptr ? it->pending_ver : 0;
      if (update_ver == 0) {
        update_ver = cv + 1;
        *io_ver = update_ver;
      }
      if (stage_replace) {
        if (update_ver <= cv) {
          if (it != nullptr) {
            if (out_len) *out_len = it->committed.length;
            if (out_crc) *out_crc = it->committed.crc;
            *io_ver = it->committed_ver;
          }
          return E_STALE_UPDATE;
        }
        // version gaps + replacing an OLDER pending are legal; clobbering
        // a NEWER pending could strand its partial commit quorum
        if (pv && update_ver < pv) return E_ADVANCE_UPDATE;
      } else if (!full_replace) {
        if (update_ver <= cv) {
          // report committed state for the idempotent-duplicate reply
          if (it != nullptr) {
            if (out_len) *out_len = it->committed.length;
            if (out_crc) *out_crc = it->committed.crc;
            *io_ver = it->committed_ver;
          }
          return E_STALE_UPDATE;
        }
        if (pv && pv != update_ver) return E_ADVANCE_UPDATE;
        if (update_ver > cv + 1) return E_MISSING_UPDATE;
      }
    }
    if (full_replace) {
      int cls = class_for(std::max<uint32_t>(data_len, 1));
      if (cls < 0) return E_INVALID;
      uint32_t crc = crc32c(data, data_len);
      // refuse BEFORE metas[k] inserts: a failed validated install must
      // leave no phantom committed_ver=0 meta behind
      if (check_crc && crc != expected_crc) return E_CHECKSUM;
      ChunkMeta& m = pin(k);
      BlockRef nb{static_cast<int8_t>(cls),
                  static_cast<uint32_t>(classes[cls].allocate()), data_len,
                  crc};
      int rc = write_block(nb, data, data_len);
      if (rc != OK) {
        classes[cls].release(nb.idx);
        if (is_phantom(m)) drop_phantom(k);  // restore dead_ mask too
        return rc;
      }
      free_block(m.committed);
      free_block(m.pending);
      m.committed = nb;
      m.committed_ver = update_ver;
      m.pending_ver = 0;
      m.chain_ver = chain_ver;
      m.aux = aux;
      m.aux_pending = 0;
      if (out_len) *out_len = nb.length;
      if (out_crc) *out_crc = nb.crc;
      return log_state(k, m);
    }
    // COW: base = committed content extended to cover the write. A write
    // covering the whole resulting content (the common chunk-append /
    // full-overwrite form) skips the merge buffer entirely. stage_replace
    // NEVER merges: the data IS the whole pending content.
    ChunkMeta& m = pin(k);
    uint32_t new_len = stage_replace
                           ? data_len
                           : std::max(m.committed.length, offset + data_len);
    const uint8_t* src = data;
    std::vector<uint8_t> buf;
    if (!stage_replace && !(offset == 0 && data_len == new_len)) {
      buf.assign(new_len, 0);
      if (m.committed.valid() && m.committed.length) {
        int rc = read_block(m.committed, buf.data(), 0, m.committed.length);
        if (rc != OK) {
          if (is_phantom(m)) drop_phantom(k);
          return rc;
        }
      }
      memcpy(buf.data() + offset, data, data_len);
      src = buf.data();
    }
    int cls = class_for(std::max<uint32_t>(new_len, 1));
    if (cls < 0) {
      if (is_phantom(m)) drop_phantom(k);
      return E_INVALID;
    }
    uint32_t crc = crc32c(src, new_len);
    if (check_crc && crc != expected_crc) {
      // drop the meta if this lookup created it (no phantom on refusal;
      // drop_phantom also restores the dead_ mask of a removed
      // base-resident chunk — see drop_phantom)
      if (is_phantom(m)) drop_phantom(k);
      return E_CHECKSUM;
    }
    free_block(m.pending);  // re-staging the same pending ver is idempotent
    BlockRef nb{static_cast<int8_t>(cls),
                static_cast<uint32_t>(classes[cls].allocate()), new_len, crc};
    int rc = write_block(nb, src, new_len);
    if (rc != OK) {
      classes[cls].release(nb.idx);
      if (is_phantom(m)) drop_phantom(k);
      return rc;
    }
    m.pending = nb;
    m.pending_ver = update_ver;
    m.chain_ver = chain_ver;
    m.aux_pending = aux;
    if (out_len) *out_len = nb.length;
    if (out_crc) *out_crc = nb.crc;
    return log_state(k, m);
  }

  int commit(const Key& k, uint64_t ver, uint64_t chain_ver) {
    ChunkMeta* mp = lookup(k);
    if (mp == nullptr) return E_NOT_FOUND;
    ChunkMeta& m = *mp;
    if (m.committed_ver >= ver) return OK;  // duplicate commit
    if (m.pending_ver != ver || !m.pending.valid()) return E_MISSING_UPDATE;
    free_block(m.committed);
    m.committed = m.pending;
    m.pending = BlockRef{};
    m.committed_ver = ver;
    m.pending_ver = 0;
    m.chain_ver = chain_ver;
    m.aux = m.aux_pending;
    m.aux_pending = 0;
    int rc = log_state(k, m);
    maybe_compact();
    return rc;
  }

  int read(const Key& k, uint8_t* out, uint64_t cap, uint32_t offset,
           int64_t length, int64_t* out_len) {
    const ChunkMeta* mp = lookup(k);
    if (mp == nullptr) return E_NOT_FOUND;
    const ChunkMeta& m = *mp;
    if (m.committed_ver == 0) return E_NOT_COMMIT;
    if (offset >= m.committed.length) {
      *out_len = 0;
      return OK;
    }
    uint32_t avail = m.committed.length - offset;
    uint32_t n = length < 0 ? avail
                            : std::min<uint32_t>(static_cast<uint32_t>(length),
                                                 avail);
    // clamp to the caller's buffer: the meta the caller sized from may be
    // stale by the time we hold the mutex (concurrent commit can grow the
    // chunk); never write past the Python-owned buffer
    n = std::min<uint64_t>(n, cap);
    int rc = read_block(m.committed, out, offset, n);
    if (rc != OK) return rc;
    *out_len = n;
    return OK;
  }

  int read_pending(const Key& k, uint8_t* out, uint64_t cap,
                   int64_t* out_len) {
    // full content of the staged pending version (committed if none):
    // feeds the chain checksum cross-check
    const ChunkMeta* mp = lookup(k);
    if (mp == nullptr) return E_NOT_FOUND;
    const ChunkMeta& m = *mp;
    const BlockRef& ref = m.pending.valid() ? m.pending : m.committed;
    if (!ref.valid()) {
      *out_len = 0;
      return OK;
    }
    uint32_t n = std::min<uint64_t>(ref.length, cap);
    int rc = read_block(ref, out, 0, n);
    if (rc != OK) return rc;
    *out_len = n;
    return OK;
  }

  int remove(const Key& k) {
    ChunkMeta* mp = lookup(k);
    if (mp == nullptr) return E_NOT_FOUND;
    free_block(mp->committed);
    free_block(mp->pending);
    erase_meta_nolog(k);
    return log_remove(k);
  }

  int truncate(const Key& k, uint32_t new_len, uint64_t chain_ver) {
    ChunkMeta* mp = lookup(k);
    if (mp == nullptr) return E_NOT_FOUND;
    ChunkMeta& m = *mp;
    std::vector<uint8_t> buf(new_len, 0);
    if (m.committed.valid() && m.committed.length) {
      uint32_t copy = std::min(new_len, m.committed.length);
      if (copy) {
        int rc = read_block(m.committed, buf.data(), 0, copy);
        if (rc != OK) return rc;
      }
    }
    int cls = class_for(std::max<uint32_t>(new_len, 1));
    if (cls < 0) return E_INVALID;
    BlockRef nb{static_cast<int8_t>(cls),
                static_cast<uint32_t>(classes[cls].allocate()), new_len,
                crc32c(buf.data(), new_len)};
    int rc = write_block(nb, buf.data(), new_len);
    if (rc != OK) return rc;
    free_block(m.committed);
    free_block(m.pending);
    m.committed = nb;
    m.committed_ver += 1;
    m.pending_ver = 0;
    m.chain_ver = chain_ver;
    m.aux = 0;
    m.aux_pending = 0;
    return log_state(k, m);
  }

  uint64_t used_size() const { return used_; }
};

}  // namespace

// ---- C ABI ---------------------------------------------------------------

extern "C" {

// meta output layout for queries (field order mirrored by the ctypes
// _CMeta struct in tpu3fs/storage/native_engine.py — keep in sync)
struct CMeta {
  uint64_t committed_ver;
  uint64_t pending_ver;
  uint64_t chain_ver;
  uint32_t length;
  uint32_t crc;
  uint32_t pending_length;
  uint32_t pending_crc;
  uint32_t aux;
  uint8_t key[kKeyLen];
};

static void fill_cmeta(const Key& k, const ChunkMeta& m, CMeta* out) {
  out->committed_ver = m.committed_ver;
  out->pending_ver = m.pending_ver;
  out->chain_ver = m.chain_ver;
  out->length = m.committed.length;
  out->crc = m.committed.crc;
  out->pending_length = m.pending.valid() ? m.pending.length : 0;
  out->pending_crc = m.pending.valid() ? m.pending.crc : 0;
  out->aux = m.aux;
  memcpy(out->key, k.b, kKeyLen);
}

void* ce_open(const char* dir, int fsync_wal) {
  auto* e = new Engine();
  e->dir = dir;
  e->fsync_wal = fsync_wal != 0;
  ::mkdir(dir, 0755);
  {
    // memory-backed dir => mmap IO (no device to AIO against); real
    // filesystems keep io_uring/pread. TPU3FS_MMAP=0|1 overrides.
    struct statfs sfs;
    if (statfs(dir, &sfs) == 0) {
      e->on_tmpfs = sfs.f_type == TMPFS_MAGIC || sfs.f_type == RAMFS_MAGIC;
    }
    const char* ov = getenv("TPU3FS_MMAP");
    e->use_mmap = ov != nullptr ? ov[0] == '1' : e->on_tmpfs;
  }
  if (e->open_files() != OK || e->replay() != OK) {
    delete e;
    return nullptr;
  }
  return e;
}

void ce_close(void* h) {
  auto* e = static_cast<Engine*>(h);
  if (!e) return;
  e->uring.shutdown();
  e->compact();
  e->base_.reset();
  for (int c = 0; c < kNumClasses; c++) {
    if (e->classes[c].map != nullptr)
      munmap(e->classes[c].map, e->classes[c].map_len);
    if (e->classes[c].fd >= 0) close(e->classes[c].fd);
  }
  if (e->wal_fd >= 0) close(e->wal_fd);
  delete e;
}

int ce_update(void* h, const uint8_t* key, uint64_t update_ver,
              uint64_t chain_ver, const uint8_t* data, uint32_t data_len,
              uint32_t offset, int full_replace, uint32_t chunk_size,
              uint32_t aux, int check_crc, uint32_t expected_crc) {
  auto* e = static_cast<Engine*>(h);
  std::lock_guard<std::mutex> g(e->mu);
  if (e->poisoned) return E_IO;
  Key k;
  memcpy(k.b, key, kKeyLen);
  uint64_t ver = update_ver;
  return e->update(k, &ver, chain_ver, data, data_len, offset, full_replace,
                   chunk_size, aux, nullptr, nullptr, check_crc,
                   expected_crc);
}


int ce_commit(void* h, const uint8_t* key, uint64_t ver, uint64_t chain_ver) {
  auto* e = static_cast<Engine*>(h);
  std::lock_guard<std::mutex> g(e->mu);
  if (e->poisoned) return E_IO;
  Key k;
  memcpy(k.b, key, kKeyLen);
  return e->commit(k, ver, chain_ver);
}

int ce_read(void* h, const uint8_t* key, uint8_t* out, uint64_t cap,
            uint32_t offset, int64_t length, int64_t* out_len) {
  auto* e = static_cast<Engine*>(h);
  std::lock_guard<std::mutex> g(e->mu);
  if (e->poisoned) return E_IO;
  Key k;
  memcpy(k.b, key, kKeyLen);
  return e->read(k, out, cap, offset, length, out_len);
}

int ce_read_pending(void* h, const uint8_t* key, uint8_t* out, uint64_t cap,
                    int64_t* out_len) {
  auto* e = static_cast<Engine*>(h);
  std::lock_guard<std::mutex> g(e->mu);
  if (e->poisoned) return E_IO;
  Key k;
  memcpy(k.b, key, kKeyLen);
  return e->read_pending(k, out, cap, out_len);
}

int ce_get_meta(void* h, const uint8_t* key, CMeta* out) {
  auto* e = static_cast<Engine*>(h);
  std::lock_guard<std::mutex> g(e->mu);
  if (e->poisoned) return E_IO;
  Key k;
  memcpy(k.b, key, kKeyLen);
  const ChunkMeta* m = e->lookup(k);
  if (m == nullptr) return E_NOT_FOUND;
  fill_cmeta(k, *m, out);
  return OK;
}

int ce_remove(void* h, const uint8_t* key) {
  auto* e = static_cast<Engine*>(h);
  std::lock_guard<std::mutex> g(e->mu);
  if (e->poisoned) return E_IO;
  Key k;
  memcpy(k.b, key, kKeyLen);
  return e->remove(k);
}

int ce_truncate(void* h, const uint8_t* key, uint32_t new_len,
                uint64_t chain_ver) {
  auto* e = static_cast<Engine*>(h);
  std::lock_guard<std::mutex> g(e->mu);
  if (e->poisoned) return E_IO;
  Key k;
  memcpy(k.b, key, kKeyLen);
  return e->truncate(k, new_len, chain_ver);
}

// query: fill up to max_out metas whose key starts with prefix (ordered);
// returns count (>=0) or error (<0)
int ce_query(void* h, const uint8_t* prefix, uint32_t prefix_len, CMeta* out,
             int max_out) {
  auto* e = static_cast<Engine*>(h);
  std::lock_guard<std::mutex> g(e->mu);
  if (e->poisoned) return E_IO;
  if (prefix_len > kKeyLen) return E_INVALID;
  // ordered 2-way merge of the base run and the delta (delta wins on
  // ties; dead_ masks erased base keys) — same key order as before
  int n = 0;
  auto dit = e->metas.begin();
  size_t bi = 0;
  auto emit = [&](const Key& k, const ChunkMeta& m) {
    if (prefix_len == 0 || memcmp(k.b, prefix, prefix_len) == 0)
      fill_cmeta(k, m, &out[n++]);
  };
  while (n < max_out && (dit != e->metas.end() || bi < e->base_.n)) {
    if (bi < e->base_.n) {
      Key bk;
      memcpy(bk.b, e->base_.recs[bi].key, kKeyLen);
      if (dit == e->metas.end() || bk < dit->first) {
        if (!e->dead_.count(bk)) emit(bk, meta_from_rec(e->base_.recs[bi]));
        bi++;
        continue;
      }
      if (bk == dit->first) bi++;  // shadowed by the delta
    }
    emit(dit->first, dit->second);
    ++dit;
  }
  return n;
}

// query_pending: metas with a staged (uncommitted) pending version, via the
// engine's pending-key index — O(pendings), the healthy-chain EC repair
// probe's cost contract. Returns count (>=0) or error (<0).
int ce_query_pending(void* h, CMeta* out, int max_out) {
  auto* e = static_cast<Engine*>(h);
  std::lock_guard<std::mutex> g(e->mu);
  if (e->poisoned) return E_IO;
  int n = 0;
  for (const auto& k : e->pending_keys) {
    const ChunkMeta* m = e->lookup(k);
    if (m == nullptr) continue;
    if (n >= max_out) break;
    fill_cmeta(k, *m, &out[n++]);
  }
  return n;
}

int64_t ce_pending_count(void* h) {
  auto* e = static_cast<Engine*>(h);
  std::lock_guard<std::mutex> g(e->mu);
  return static_cast<int64_t>(e->pending_keys.size());
}

int64_t ce_used_size(void* h) {
  auto* e = static_cast<Engine*>(h);
  std::lock_guard<std::mutex> g(e->mu);
  return static_cast<int64_t>(e->used_size());
}

int64_t ce_chunk_count(void* h) {
  auto* e = static_cast<Engine*>(h);
  std::lock_guard<std::mutex> g(e->mu);
  return static_cast<int64_t>(e->meta_count());
}

int ce_compact(void* h) {
  auto* e = static_cast<Engine*>(h);
  std::lock_guard<std::mutex> g(e->mu);
  return e->compact();
}

// ABI fingerprint scanned as raw bytes by the Python loader BEFORE dlopen;
// bump in lockstep with native_engine._ABI_TAG on any layout change
__attribute__((used)) const char kAbiTag[] = "TPU3FS_ENGINE_ABI_6";

uint32_t ce_crc32c(const uint8_t* data, uint64_t n) { return crc32c(data, n); }
uint32_t ce_crc32c_seed(const uint8_t* data, uint64_t n, uint32_t crc) {
  return crc32c(data, n, crc);
}

// ---- GF(2^8) erasure-code data plane (CPU fallback for the TPU kernels) ---
//
// ISA-L-style table-driven SIMD multiply-accumulate: each coefficient c is
// handed in as two 16-entry PSHUFB tables (products of c with every low /
// high nibble), so one shuffle multiplies 16 (SSSE3) or 32 (AVX2) bytes.
// The nibble tables are built host-side from the SAME 0x11D field tables
// the JAX/Pallas kernels use (tpu3fs/ops/gf256.py), keeping this code
// field-agnostic; coefficients 0 and 1 take skip/XOR fast paths (parity
// row 0 is all-ones by the RSCode construction, so the dominant single-
// parity stripe never touches a shuffle). The reference has no RS path —
// its CPU-side per-chunk math is folly CRC32C (src/fbs/storage/
// Common.h:66-199); this is the added-capability analogue at the same
// "CPU does GB/s" competence level.
}  // extern "C" (the gfec helpers below need C++ linkage: templates)

namespace gfec {

void xor_acc_scalar(const uint8_t* src, uint8_t* dst, size_t n) {
  size_t i = 0;
  for (; i + 8 <= n; i += 8) {
    uint64_t a, b;
    memcpy(&a, src + i, 8);
    memcpy(&b, dst + i, 8);
    b ^= a;
    memcpy(dst + i, &b, 8);
  }
  for (; i < n; ++i) dst[i] ^= src[i];
}

void muladd_scalar(const uint8_t* lo, const uint8_t* hi, const uint8_t* src,
                   uint8_t* dst, size_t n) {
  for (size_t i = 0; i < n; ++i) {
    uint8_t x = src[i];
    dst[i] ^= lo[x & 15] ^ hi[x >> 4];
  }
}

#if defined(__x86_64__)
__attribute__((target("avx2"))) void xor_acc_avx2(const uint8_t* src,
                                                  uint8_t* dst, size_t n) {
  size_t i = 0;
  for (; i + 32 <= n; i += 32) {
    __m256i a = _mm256_loadu_si256(reinterpret_cast<const __m256i*>(src + i));
    __m256i b = _mm256_loadu_si256(reinterpret_cast<const __m256i*>(dst + i));
    _mm256_storeu_si256(reinterpret_cast<__m256i*>(dst + i),
                        _mm256_xor_si256(a, b));
  }
  if (i < n) xor_acc_scalar(src + i, dst + i, n - i);
}

__attribute__((target("avx2"))) void muladd_avx2(const uint8_t* lo,
                                                  const uint8_t* hi,
                                                  const uint8_t* src,
                                                  uint8_t* dst, size_t n) {
  const __m256i vlo = _mm256_broadcastsi128_si256(
      _mm_loadu_si128(reinterpret_cast<const __m128i*>(lo)));
  const __m256i vhi = _mm256_broadcastsi128_si256(
      _mm_loadu_si128(reinterpret_cast<const __m128i*>(hi)));
  const __m256i mask = _mm256_set1_epi8(0x0F);
  size_t i = 0;
  for (; i + 32 <= n; i += 32) {
    __m256i x = _mm256_loadu_si256(reinterpret_cast<const __m256i*>(src + i));
    __m256i l = _mm256_and_si256(x, mask);
    __m256i h = _mm256_and_si256(_mm256_srli_epi16(x, 4), mask);
    __m256i p = _mm256_xor_si256(_mm256_shuffle_epi8(vlo, l),
                                 _mm256_shuffle_epi8(vhi, h));
    __m256i d = _mm256_loadu_si256(reinterpret_cast<const __m256i*>(dst + i));
    _mm256_storeu_si256(reinterpret_cast<__m256i*>(dst + i),
                        _mm256_xor_si256(d, p));
  }
  if (i < n) muladd_scalar(lo, hi, src + i, dst + i, n - i);
}

__attribute__((target("ssse3"))) void muladd_ssse3(const uint8_t* lo,
                                                    const uint8_t* hi,
                                                    const uint8_t* src,
                                                    uint8_t* dst, size_t n) {
  const __m128i vlo = _mm_loadu_si128(reinterpret_cast<const __m128i*>(lo));
  const __m128i vhi = _mm_loadu_si128(reinterpret_cast<const __m128i*>(hi));
  const __m128i mask = _mm_set1_epi8(0x0F);
  size_t i = 0;
  for (; i + 16 <= n; i += 16) {
    __m128i x = _mm_loadu_si128(reinterpret_cast<const __m128i*>(src + i));
    __m128i l = _mm_and_si128(x, mask);
    __m128i h = _mm_and_si128(_mm_srli_epi16(x, 4), mask);
    __m128i p = _mm_xor_si128(_mm_shuffle_epi8(vlo, l),
                              _mm_shuffle_epi8(vhi, h));
    __m128i d = _mm_loadu_si128(reinterpret_cast<const __m128i*>(dst + i));
    _mm_storeu_si128(reinterpret_cast<__m128i*>(dst + i),
                     _mm_xor_si128(d, p));
  }
  if (i < n) muladd_scalar(lo, hi, src + i, dst + i, n - i);
}

const bool kHasAvx2 = __builtin_cpu_supports("avx2");
const bool kHasSsse3 = __builtin_cpu_supports("ssse3");

inline void xor_acc(const uint8_t* src, uint8_t* dst, size_t n) {
  if (kHasAvx2) return xor_acc_avx2(src, dst, n);
  xor_acc_scalar(src, dst, n);
}

inline void muladd(const uint8_t* lo, const uint8_t* hi, const uint8_t* src,
                   uint8_t* dst, size_t n) {
  if (kHasAvx2) return muladd_avx2(lo, hi, src, dst, n);
  if (kHasSsse3) return muladd_ssse3(lo, hi, src, dst, n);
  muladd_scalar(lo, hi, src, dst, n);
}
#else
inline void xor_acc(const uint8_t* src, uint8_t* dst, size_t n) {
  xor_acc_scalar(src, dst, n);
}
inline void muladd(const uint8_t* lo, const uint8_t* hi, const uint8_t* src,
                   uint8_t* dst, size_t n) {
  muladd_scalar(lo, hi, src, dst, n);
}
#endif

// Apply the (r, k) matrix to one S-byte slice of one batch element.
void apply_slice(const uint8_t* nib, const uint8_t* coeffs, int k, int r,
                 const uint8_t* data_b, uint8_t* out_b, uint64_t s_off,
                 uint64_t s_len, uint64_t S) {
  for (int i = 0; i < r; ++i) {
    memset(out_b + i * S + s_off, 0, s_len);
  }
  // src-row outer: each input shard slice is streamed once through all r
  // output accumulators (the shuffles are compute-bound; the src slice
  // stays hot in L1/L2 across the r passes)
  for (int j = 0; j < k; ++j) {
    const uint8_t* src = data_b + j * S + s_off;
    for (int i = 0; i < r; ++i) {
      uint8_t c = coeffs[i * k + j];
      if (c == 0) continue;
      uint8_t* dst = out_b + i * S + s_off;
      if (c == 1) {
        xor_acc(src, dst, s_len);
      } else {
        const uint8_t* t = nib + (static_cast<size_t>(i) * k + j) * 32;
        muladd(t, t + 16, src, dst, s_len);
      }
    }
  }
}

// Persistent worker pool: the serving hot path calls ce_gf_apply /
// ce_crc32c_batch per stripe batch, so per-call thread spawn/join would be
// pure overhead (the role of the reference's long-lived per-disk worker
// threads, src/storage/update/UpdateWorker.h:30-33). Workers park on a
// condition variable between jobs; the submitting thread participates.
// Intentionally leaked (never destroyed): workers block in wait() at
// process exit and tearing down the mutex under them would be UB.
class Pool {
 public:
  static Pool& get() {
    static Pool* p = new Pool();
    return *p;
  }

  void run(uint64_t n_tasks, const std::function<void(uint64_t)>& f) {
    std::lock_guard<std::mutex> job_guard(job_mu_);  // one job at a time
    {
      std::lock_guard<std::mutex> g(mu_);
      fn_ = &f;
      next_.store(0, std::memory_order_relaxed);
      total_ = n_tasks;
      pending_workers_ = static_cast<unsigned>(threads_.size());
      ++gen_;
    }
    cv_.notify_all();
    work();
    std::unique_lock<std::mutex> g(mu_);
    done_cv_.wait(g, [&] { return pending_workers_ == 0; });
    fn_ = nullptr;
  }

  unsigned width() const {
    return static_cast<unsigned>(threads_.size()) + 1;
  }

 private:
  Pool() {
    unsigned hw = std::thread::hardware_concurrency();
    unsigned nworkers = hw > 1 ? hw - 1 : 0;
    for (unsigned i = 0; i < nworkers; ++i)
      threads_.emplace_back([this] { worker_loop(); });
  }

  void work() {
    for (;;) {
      uint64_t t = next_.fetch_add(1, std::memory_order_relaxed);
      if (t >= total_) return;
      (*fn_)(t);
    }
  }

  void worker_loop() {
    uint64_t seen = 0;
    for (;;) {
      {
        std::unique_lock<std::mutex> g(mu_);
        cv_.wait(g, [&] { return gen_ != seen; });
        seen = gen_;
      }
      work();
      {
        std::lock_guard<std::mutex> g(mu_);
        if (--pending_workers_ == 0) done_cv_.notify_one();
      }
    }
  }

  std::mutex job_mu_;
  std::mutex mu_;
  std::condition_variable cv_, done_cv_;
  std::vector<std::thread> threads_;
  const std::function<void(uint64_t)>* fn_ = nullptr;
  std::atomic<uint64_t> next_{0};
  uint64_t total_ = 0;
  uint64_t gen_ = 0;
  unsigned pending_workers_ = 0;
};

// Run f(0..n_tasks) across the pool when the work justifies it; inline
// otherwise (small per-write calls must not pay dispatch latency).
template <typename F>
void parallel_for(uint64_t n_tasks, uint64_t approx_bytes, F&& f) {
  if (n_tasks <= 1 || approx_bytes < (1u << 20) || Pool::get().width() <= 1) {
    for (uint64_t t = 0; t < n_tasks; ++t) f(t);
    return;
  }
  std::function<void(uint64_t)> fw = std::forward<F>(f);
  Pool::get().run(n_tasks, fw);
}

}  // namespace gfec

extern "C" {

// Apply an (r, k) GF(2^8) matrix to (batch, k, S) data -> (batch, r, S).
// nib: (r*k, 32) nibble-product tables; coeffs: (r, k) raw coefficients.
// Encode passes the parity matrix; decode passes the inverted-submatrix
// reconstruction rows — one entry point, both directions.
int ce_gf_apply(const uint8_t* nib, const uint8_t* coeffs, int k, int r,
                const uint8_t* data, uint64_t batch, uint64_t S,
                uint8_t* out) {
  if (k <= 0 || r <= 0 || S == 0 || batch == 0) return E_INVALID;
  // tile the (batch, S) plane so one big stripe still spreads over cores
  const uint64_t kTile = 256 << 10;
  uint64_t tiles_per_s = (S + kTile - 1) / kTile;
  uint64_t n_tasks = batch * tiles_per_s;
  gfec::parallel_for(n_tasks, batch * S * (uint64_t)k, [&](uint64_t t) {
    uint64_t b = t / tiles_per_s;
    uint64_t s_off = (t % tiles_per_s) * kTile;
    uint64_t s_len = std::min(kTile, S - s_off);
    gfec::apply_slice(nib, coeffs, k, r, data + b * (uint64_t)k * S,
                      out + b * (uint64_t)r * S, s_off, s_len, S);
  });
  return OK;
}

// Batched CRC32C: n_rows rows of `len` bytes at `stride` apart -> out[n].
int ce_crc32c_batch(const uint8_t* data, uint64_t n_rows, uint64_t stride,
                    uint64_t len, uint32_t* out) {
  gfec::parallel_for(n_rows, n_rows * len, [&](uint64_t i) {
    out[i] = crc32c(data + i * stride, len);
  });
  return OK;
}

// Batched CRC32C over NON-CONTIGUOUS buffers (pointer + length per row):
// the mem-engine staging path checksums a batch of independently-owned
// payloads in one GIL-released crossing, spread over the pool — per-op
// scalar CRC was the dominant term of the CPU batched-write pipeline.
int ce_crc32c_multi(const uint8_t* const* bufs, const uint64_t* lens,
                    uint64_t n, uint32_t* out) {
  if (n == 0) return OK;
  uint64_t total = 0;
  for (uint64_t i = 0; i < n; ++i) total += lens[i];
  gfec::parallel_for(n, total, [&](uint64_t i) {
    out[i] = crc32c(bufs[i], lens[i]);
  });
  return OK;
}

// ---- batched ops -----------------------------------------------------------
// One ctypes crossing per BATCH: the op loop runs here with the GIL released
// (ctypes drops it for the duration of the call), which is what lets a
// multithreaded storage server scale past the Python interpreter — the role
// the per-disk UpdateWorker queues + 32-thread AIO pools play in the
// reference (src/storage/update/UpdateWorker.h:11-46, aio/AioReadWorker.h).
// Field order of these structs is mirrored by ctypes Structures in
// tpu3fs/storage/native_engine.py — keep in sync.

struct CUpOp {
  uint8_t key[kKeyLen];
  uint8_t flags;       // 1 = full_replace; 2 = validate expected_crc;
                       // 4 = stage_replace (EC two-phase stage);
                       // 8 = reject_create (near-full target: refuse ops
                       //     that would mint a NEW chunk with E_NO_SPACE,
                       //     mirroring the Python head's reject_create)
  uint8_t pad0[3];
  uint32_t offset;     // write offset within the chunk
  uint32_t data_len;
  uint32_t chunk_size;
  uint32_t aux;        // opaque tag stored with the staged content
  uint64_t data_off;   // offset of this op's payload in the shared blob;
                       // when the batch call's blob is NULL, this is the
                       // op payload's ABSOLUTE ADDRESS instead (iovec
                       // mode: callers pass per-op buffer pointers and
                       // skip the blob concatenation copy entirely)
  uint64_t update_ver; // 0 = assign committed+1 (head write)
  uint32_t expected_crc;  // content CRC to enforce when flags & 2
  uint32_t pad1;
};

struct COpResult {
  int32_t rc;
  uint32_t len;  // update: pending len; commit/read: committed len
  uint32_t crc;  // update: pending crc; commit/read: committed/read crc
  uint32_t aux;  // read: the chunk's aux tag (EC stripe logical length)
  uint64_t ver;  // update: staged (or committed-on-stale) ver; else committed
};

struct CReadOp {
  uint8_t key[kKeyLen];
  uint32_t slot_len;   // this op's slice of the shared output buffer
  uint64_t out_off;    // where this op's bytes land in the shared output
  uint32_t offset;     // read offset within the chunk
  int32_t length;      // -1 = to end of committed content
};

// op payload resolution: shared-blob offset, or absolute pointer when the
// caller passed blob == NULL (iovec mode — no concatenation copy)
static inline const uint8_t* op_payload(const uint8_t* blob,
                                        const CUpOp& op) {
  return blob ? blob + op.data_off
              : reinterpret_cast<const uint8_t*>(uintptr_t(op.data_off));
}

int ce_batch_update(void* h, uint64_t chain_ver, const uint8_t* blob,
                    const CUpOp* ops, COpResult* res, int n) {
  auto* e = static_cast<Engine*>(h);
  std::lock_guard<std::mutex> g(e->mu);
  if (e->poisoned) return E_IO;
  e->log_buffering = true;  // ONE WAL append for the whole batch
  for (int i = 0; i < n; i++) {
    const CUpOp& op = ops[i];
    Key k;
    memcpy(k.b, op.key, kKeyLen);
    COpResult& r = res[i];
    r = COpResult{};
    if ((op.flags & 8) && !(op.flags & 1) && e->lookup(k) == nullptr) {
      r.rc = E_NO_SPACE;  // reject_create: no new chunks on a full target
      continue;
    }
    uint64_t ver = op.update_ver;
    uint32_t len = 0, crc = 0;
    r.rc = e->update(k, &ver, chain_ver, op_payload(blob, op), op.data_len,
                     op.offset,
                     (op.flags & 4) ? 2 : (op.flags & 1),
                     op.chunk_size, op.aux, &len,
                     &crc, (op.flags >> 1) & 1, op.expected_crc);
    r.ver = ver;
    r.len = len;
    r.crc = crc;
  }
  e->log_buffering = false;
  return e->flush_log();
}

// Tail-of-chain batched write: stage + immediate commit per op under ONE
// mutex hold (the native transport's write fast path; the Python tail does
// the same two steps under its per-chunk locks, so a concurrent Python
// writer can never interleave between our stage and commit).
// E_STALE_UPDATE fills committed state (the idempotent-duplicate reply);
// any other failure leaves that op uncommitted.
int ce_batch_write(void* h, uint64_t chain_ver, const uint8_t* blob,
                   const CUpOp* ops, COpResult* res, int n) {
  auto* e = static_cast<Engine*>(h);
  std::lock_guard<std::mutex> g(e->mu);
  if (e->poisoned) return E_IO;
  e->log_buffering = true;  // ONE WAL append for the whole batch
  for (int i = 0; i < n; i++) {
    const CUpOp& op = ops[i];
    Key k;
    memcpy(k.b, op.key, kKeyLen);
    COpResult& r = res[i];
    r = COpResult{};
    if ((op.flags & 8) && !(op.flags & 1) && e->lookup(k) == nullptr) {
      r.rc = E_NO_SPACE;  // reject_create: no new chunks on a full target
      continue;
    }
    uint64_t ver = op.update_ver;
    uint32_t len = 0, crc = 0;
    r.rc = e->update(k, &ver, chain_ver, op_payload(blob, op), op.data_len,
                     op.offset, (op.flags & 4) ? 2 : (op.flags & 1),
                     op.chunk_size, op.aux, &len, &crc,
                     (op.flags >> 1) & 1, op.expected_crc);
    if (r.rc == OK && !(op.flags & 1))  // full_replace commits in update
      r.rc = e->commit(k, ver, chain_ver);
    r.ver = ver;
    r.len = len;
    r.crc = crc;
  }
  e->log_buffering = false;
  return e->flush_log();
}

int ce_batch_commit(void* h, uint64_t chain_ver, const uint8_t* keys,
                    const uint64_t* vers, COpResult* res, int n) {
  auto* e = static_cast<Engine*>(h);
  std::lock_guard<std::mutex> g(e->mu);
  if (e->poisoned) return E_IO;
  e->log_buffering = true;  // ONE WAL append for the whole batch
  for (int i = 0; i < n; i++) {
    Key k;
    memcpy(k.b, keys + static_cast<size_t>(i) * kKeyLen, kKeyLen);
    COpResult& r = res[i];
    r = COpResult{};
    r.rc = e->commit(k, vers[i], chain_ver);
    const ChunkMeta* m = e->lookup(k);
    if (m != nullptr) {
      r.ver = m->committed_ver;
      r.len = m->committed.length;
      r.crc = m->committed.crc;
    }
  }
  e->log_buffering = false;
  return e->flush_log();
}

int ce_batch_read(void* h, const CReadOp* ops, uint8_t* out, uint64_t cap,
                  COpResult* res, int n) {
  auto* e = static_cast<Engine*>(h);
  std::lock_guard<std::mutex> g(e->mu);
  if (e->poisoned) return E_IO;
  // resolve phase: validate each op and turn it into a raw (fd, offset,
  // len, dest) read under the mutex; the IO phase then runs every read
  // through ONE io_uring submit/reap (the AioReadWorker analogue) — or a
  // pread loop when the ring is unavailable
  struct Pending {
    int i;
    uint32_t want;
    bool full;           // full committed content: CRC reusable
    uint32_t crc;        // committed crc (for reuse)
  };
  std::vector<Uring::ReadOp> rops;
  std::vector<Pending> pend;
  rops.reserve(n);
  pend.reserve(n);
  Uring* ring = e->get_uring();
  for (int i = 0; i < n; i++) {
    const CReadOp& op = ops[i];
    Key k;
    memcpy(k.b, op.key, kKeyLen);
    COpResult& r = res[i];
    r = COpResult{};
    if (op.out_off > cap || op.slot_len > cap - op.out_off) {
      r.rc = E_INVALID;
      continue;
    }
    const ChunkMeta* mp = e->lookup(k);
    if (mp == nullptr) {
      r.rc = E_NOT_FOUND;
      continue;
    }
    const ChunkMeta& m = *mp;
    if (m.committed_ver == 0) {
      r.rc = E_NOT_COMMIT;
      continue;
    }
    uint32_t avail = m.committed.length;
    uint32_t want = op.offset >= avail
                        ? 0
                        : (op.length < 0
                               ? avail - op.offset
                               : std::min<uint32_t>(
                                     static_cast<uint32_t>(op.length),
                                     avail - op.offset));
    // a chunk whose committed content outgrew the caller's per-op cap must
    // neither spill into the next op's slot NOR return silently truncated
    // bytes with a recomputed CRC — report E_RANGE so the caller re-reads
    // that op with a big-enough buffer
    if (want > op.slot_len) {
      r.rc = E_RANGE;
      continue;
    }
    r.ver = m.committed_ver;
    r.aux = m.aux;
    if (want == 0) {
      r.len = 0;
      r.crc = (op.offset == 0 && avail == 0) ? m.committed.crc
                                             : crc32c(out, 0);
      continue;
    }
    if (e->use_mmap) {
      // tmpfs fast path: one memcpy from the mapping, no syscall
      if (e->read_block(m.committed, out + op.out_off, op.offset, want) !=
          OK) {
        r.rc = E_IO;
        continue;
      }
      bool full = op.offset == 0 && want == avail;
      r.len = want;
      r.crc = full ? m.committed.crc : crc32c(out + op.out_off, want);
      continue;
    }
    const SizeClass& sc = e->classes[m.committed.cls];
    Uring::ReadOp ro{};
    ro.file = (ring && ring->fixed_files) ? m.committed.cls : sc.fd;
    ro.buf = out + op.out_off;
    ro.len = want;
    ro.off = static_cast<uint64_t>(m.committed.idx) * sc.block_size +
             op.offset;
    rops.push_back(ro);
    pend.push_back({i, want, op.offset == 0 && want == avail,
                    m.committed.crc});
  }
  bool via_ring = ring != nullptr && rops.size() > 1;
  if (via_ring &&
      !ring->read_batch(rops.data(), static_cast<unsigned>(rops.size()))) {
    // ring failure (already drained — no ops in flight): release it and
    // fall back to sync preads for this and all future batches
    via_ring = false;
    e->uring.shutdown();
    e->uring_state = -1;
  }
  for (size_t j = 0; j < rops.size(); j++) {
    Uring::ReadOp& ro = rops[j];
    const Pending& pd = pend[j];
    COpResult& r = res[pd.i];
    if (!via_ring) {
      int fd = (ring && ring->fixed_files)
                   ? e->classes[ro.file].fd   // un-map registered index
                   : ro.file;
      ro.result = pread(fd, ro.buf, ro.len, static_cast<off_t>(ro.off));
    }
    if (ro.result != static_cast<int64_t>(pd.want)) {
      r.rc = E_IO;
      continue;
    }
    r.len = pd.want;
    // full-content reads reuse the committed CRC (the checksum-reuse
    // counters of ChunkReplica.cc:24-29); partial reads recompute here,
    // still outside the GIL
    r.crc = pd.full ? pd.crc : crc32c(ro.buf, pd.want);
  }
  return OK;
}

// single read returning data + meta + crc in one crossing
int ce_read2(void* h, const uint8_t* key, uint8_t* out, uint64_t cap,
             uint32_t offset, int64_t length, int64_t* out_len,
             uint64_t* out_commit_ver, uint32_t* out_crc,
             uint32_t* out_aux) {
  auto* e = static_cast<Engine*>(h);
  std::lock_guard<std::mutex> g(e->mu);
  if (e->poisoned) return E_IO;
  Key k;
  memcpy(k.b, key, kKeyLen);
  int rc = e->read(k, out, cap, offset, length, out_len);
  if (rc != OK) return rc;
  const ChunkMeta& m = *e->lookup(k);
  *out_commit_ver = m.committed_ver;
  *out_crc = (offset == 0 && *out_len == static_cast<int64_t>(m.committed.length))
                 ? m.committed.crc
                 : crc32c(out, static_cast<size_t>(*out_len));
  *out_aux = m.aux;
  return OK;
}

}  // extern "C"
