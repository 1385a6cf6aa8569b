// tpu3fs native RPC/net layer.
//
// The port's own copy of native/rpc_net.cpp: the same code, so the C structs,
// the ABI tag and the wire are the JAX package's. tpu3fs_torch/hostbuild.py
// builds it with g++ into tpu3fs_torch/_build/, under a name that carries a
// digest of this file.
//
// C++ re-design of the reference's net core + serde RPC transport
// (src/common/net/{EventLoop,Listener,IOWorker,Transport,Server}.cc and
// src/common/serde/MessagePacket.h): an epoll event loop owns all
// connections and does nonblocking length-prefixed framing; parsed request
// packets are handed to a worker-thread pool which dispatches through a
// registered handler and writes the reply back under a per-connection write
// lock. The MessagePacket envelope (service id, method id, flags, status,
// payload, message, 8-point latency timestamps — MessagePacket.h:11-52) is
// bit-compatible with the Python serde codec (tpu3fs/rpc/serde.py), so
// native servers interoperate with Python clients and vice versa.
//
// Exposed as a C ABI consumed through ctypes (no pybind11 in this image).

#include <algorithm>
#include <array>
#include <atomic>
#include <cerrno>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <list>
#include <map>
#include <memory>
#include <mutex>
#include <random>
#include <set>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include <arpa/inet.h>
#include <fcntl.h>
#include <limits.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <sys/epoll.h>
#include <sys/socket.h>
#include <sys/uio.h>
#include <unistd.h>

namespace {

// ---- status codes shared with tpu3fs.utils.result -------------------------
enum Code : int64_t {
  OK = 0,
  INTERNAL = 104,
  RPC_CONNECT_FAILED = 200,
  RPC_TIMEOUT = 202,
  RPC_BAD_REQUEST = 203,
  RPC_METHOD_NOT_FOUND = 204,
  RPC_SERVICE_NOT_FOUND = 205,
  RPC_PEER_CLOSED = 206,
};

constexpr uint32_t kMaxPacket = 64u << 20;
constexpr int64_t kFlagIsReq = 1;
// bulk framing (tpu3fs/rpc/net.py FLAG_BULK): the frame body is
// [MessagePacket serde][bulk section] — control fields in the envelope,
// chunk payloads appended raw. Senders gather caller buffers with writev
// (no concatenation of control + data); the analogue of the reference
// splitting serde packets from RDMA READ/WRITE batches into registered
// buffers (src/common/net/ib/IBSocket.h:155-229).
constexpr int64_t kFlagBulk = 8;

double mono_now() {
  return std::chrono::duration<double>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// ---- varint / zigzag (wire-compatible with tpu3fs/rpc/serde.py) -----------
void put_uvarint(std::string& buf, uint64_t v) {
  while (true) {
    uint8_t b = v & 0x7F;
    v >>= 7;
    if (v) {
      buf.push_back(char(b | 0x80));
    } else {
      buf.push_back(char(b));
      return;
    }
  }
}

bool get_uvarint(const uint8_t* data, size_t len, size_t& pos, uint64_t& out) {
  int shift = 0;
  out = 0;
  while (pos < len && shift < 64) {
    uint8_t b = data[pos++];
    out |= uint64_t(b & 0x7F) << shift;
    if (!(b & 0x80)) return true;
    shift += 7;
  }
  return false;
}

uint64_t zigzag(int64_t v) { return (uint64_t(v) << 1) ^ uint64_t(v >> 63); }
int64_t unzigzag(uint64_t v) { return int64_t(v >> 1) ^ -int64_t(v & 1); }

void put_int(std::string& buf, int64_t v) { put_uvarint(buf, zigzag(v)); }

void put_str(std::string& buf, const std::string& s) {
  put_uvarint(buf, s.size());
  buf += s;
}

void put_double(std::string& buf, double d) {  // little-endian IEEE double
  uint64_t bits;
  memcpy(&bits, &d, 8);
  for (int i = 0; i < 8; i++) buf.push_back(char((bits >> (8 * i)) & 0xFF));
}

bool get_int(const uint8_t* d, size_t len, size_t& pos, int64_t& out) {
  uint64_t u;
  if (!get_uvarint(d, len, pos, u)) return false;
  out = unzigzag(u);
  return true;
}

bool get_str(const uint8_t* d, size_t len, size_t& pos, std::string& out) {
  uint64_t n;
  // bounds as `n > len - pos`: the `pos + n > len` form overflows for a
  // crafted huge-length varint and would crash the event loop
  if (!get_uvarint(d, len, pos, n) || pos > len || n > len - pos)
    return false;
  out.assign(reinterpret_cast<const char*>(d + pos), n);
  pos += n;
  return true;
}

bool get_double(const uint8_t* d, size_t len, size_t& pos, double& out) {
  if (pos > len || len - pos < 8) return false;
  uint64_t bits = 0;
  for (int i = 0; i < 8; i++) bits |= uint64_t(d[pos + i]) << (8 * i);
  memcpy(&out, &bits, 8);
  pos += 8;
  return true;
}

// ---- MessagePacket envelope ----------------------------------------------
// Python: @dataclass MessagePacket{uuid:str, service_id:int, method_id:int,
// flags:int, status:int, payload:bytes, message:str, timestamps:Timestamps}
// Timestamps = 8 floats. Dataclasses encode as varint field count + fields.
struct Packet {
  std::string uuid;
  int64_t service_id = 0;
  int64_t method_id = 0;
  int64_t flags = 0;
  int64_t status = 0;
  std::string payload;
  std::string message;
  double ts[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  // bulk section (raw: varint count + varint lens + segments), present
  // when flags carries kFlagBulk; an EMPTY section is meaningful ("I speak
  // bulk; reply with data in bulk"), hence the separate presence bit
  std::string bulk;
  bool has_bulk = false;
};

std::string encode_packet(const Packet& p) {
  std::string buf;
  put_uvarint(buf, 8);  // MessagePacket field count
  put_str(buf, p.uuid);
  put_int(buf, p.service_id);
  put_int(buf, p.method_id);
  put_int(buf, p.flags);
  put_int(buf, p.status);
  put_str(buf, p.payload);
  put_str(buf, p.message);
  put_uvarint(buf, 8);  // Timestamps field count
  for (double t : p.ts) put_double(buf, t);
  return buf;
}

// decode one frame. With `bulk_off` given, a bulk section is NOT copied
// into p.bulk — *bulk_off names its offset inside `d` and the caller reads
// it in place (the client's zero-copy reply path: the recv buffer itself
// is handed to Python, which views the section without another copy).
bool decode_packet(const uint8_t* d, size_t len, Packet& p,
                   size_t* bulk_off = nullptr) {
  size_t pos = 0;
  uint64_t nfields;
  if (!get_uvarint(d, len, pos, nfields) || nfields < 8) return false;
  if (!get_str(d, len, pos, p.uuid)) return false;
  if (!get_int(d, len, pos, p.service_id)) return false;
  if (!get_int(d, len, pos, p.method_id)) return false;
  if (!get_int(d, len, pos, p.flags)) return false;
  if (!get_int(d, len, pos, p.status)) return false;
  if (!get_str(d, len, pos, p.payload)) return false;
  if (!get_str(d, len, pos, p.message)) return false;
  uint64_t nts;
  if (!get_uvarint(d, len, pos, nts)) return false;
  for (uint64_t i = 0; i < nts && i < 8; i++)
    if (!get_double(d, len, pos, p.ts[i])) return false;
  // the rest of the frame is the bulk section when the flag says so; a
  // frame with trailing bytes but NO flag is malformed (catches a legacy
  // peer mis-framing rather than silently dropping data)
  if (p.flags & kFlagBulk) {
    p.has_bulk = true;
    if (bulk_off != nullptr)
      *bulk_off = pos;
    else
      p.bulk.assign(reinterpret_cast<const char*>(d + pos), len - pos);
  } else if (pos != len) {
    return false;
  }
  return true;
}

// minimal bulk-section sanity: varint count + per-segment varint lens must
// cover the section exactly (the Python split_bulk enforces the same)
bool bulk_section_valid_raw(const uint8_t* d, size_t len) {
  size_t pos = 0;
  uint64_t count;
  if (!get_uvarint(d, len, pos, count)) return false;
  uint64_t total = 0;
  for (uint64_t i = 0; i < count; i++) {
    uint64_t n;
    if (!get_uvarint(d, len, pos, n)) return false;
    // per-segment bound before accumulating: crafted 2^63-ish lengths
    // could otherwise wrap `total` mod 2^64 and pass the final equality
    if (n > len) return false;
    total += n;
    if (total > len) return false;
  }
  return pos <= len && total == len - pos;
}

bool bulk_section_valid(const std::string& bulk) {
  return bulk_section_valid_raw(
      reinterpret_cast<const uint8_t*>(bulk.data()), bulk.size());
}

// ---- socket helpers -------------------------------------------------------
int set_nonblocking(int fd, bool nb) {
  int fl = fcntl(fd, F_GETFL, 0);
  if (fl < 0) return -1;
  return fcntl(fd, F_SETFL, nb ? (fl | O_NONBLOCK) : (fl & ~O_NONBLOCK));
}

// a server reply may stall this long per EAGAIN before the connection is
// declared dead and closed (workers return to the queue instead of blocking)
constexpr int kServerDrainTimeoutMs = 5000;

// gather-write with EAGAIN poll (socket may be nonblocking): payload
// buffers go to the kernel straight from their owners (no concatenation).
// drain_timeout_ms bounds the WHOLE send, not each EAGAIN: a slow-drip
// reader that accepts a few bytes every few seconds must not pin a server
// worker thread (and the connection's write_mu) indefinitely —
// head-of-line blocking across the whole pool.
bool send_iovs(int fd, struct iovec* iov, int n_iov, int drain_timeout_ms) {
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::milliseconds(drain_timeout_ms);
  int first = 0;
  while (first < n_iov) {
    ssize_t n = ::writev(fd, iov + first, std::min(n_iov - first, IOV_MAX));
    if (n > 0) {
      size_t done = size_t(n);
      while (first < n_iov && done >= iov[first].iov_len) {
        done -= iov[first].iov_len;
        first++;
      }
      if (first < n_iov && done > 0) {
        iov[first].iov_base = static_cast<char*>(iov[first].iov_base) + done;
        iov[first].iov_len -= done;
      }
      continue;
    }
    if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
      auto left = std::chrono::duration_cast<std::chrono::milliseconds>(
                      deadline - std::chrono::steady_clock::now())
                      .count();
      if (left <= 0) return false;
      struct pollfd pfd = {fd, POLLOUT, 0};
      if (poll(&pfd, 1, int(left)) <= 0) return false;
      continue;
    }
    if (n < 0 && errno == EINTR) continue;
    return false;
  }
  return true;
}

bool recv_exact(int fd, uint8_t* out, size_t len) {  // blocking socket
  size_t off = 0;
  while (off < len) {
    ssize_t n = ::recv(fd, out + off, len - off, 0);
    if (n > 0) {
      off += size_t(n);
      continue;
    }
    if (n < 0 && errno == EINTR) continue;
    return false;
  }
  return true;
}

// resolve host (name or dotted quad) to an IPv4 sockaddr; empty = loopback.
// inet_addr alone cannot resolve names like "localhost", which the Python
// transport handles — the two must accept the same addresses.
bool resolve_ipv4(const char* host, uint16_t port, struct sockaddr_in* out) {
  memset(out, 0, sizeof(*out));
  out->sin_family = AF_INET;
  out->sin_port = htons(port);
  if (host == nullptr || *host == 0) {
    out->sin_addr.s_addr = htonl(INADDR_LOOPBACK);
    return true;
  }
  struct in_addr a;
  if (inet_pton(AF_INET, host, &a) == 1) {
    out->sin_addr = a;
    return true;
  }
  struct addrinfo hints{};
  hints.ai_family = AF_INET;
  hints.ai_socktype = SOCK_STREAM;
  struct addrinfo* res = nullptr;
  if (getaddrinfo(host, nullptr, &hints, &res) != 0 || res == nullptr)
    return false;
  out->sin_addr = reinterpret_cast<struct sockaddr_in*>(res->ai_addr)->sin_addr;
  freeaddrinfo(res);
  return true;
}

// ---- storage read fast path ------------------------------------------------
// Serves StorageSerde.batchRead (service 3, method 11) fully in native
// code: decode the request, read through the chunk engine's C ABI (both
// .so's live in this process; the engine's ce_batch_read is handed over
// as a raw function pointer), encode the reply, writev it — the Python
// dispatch layer is never entered. This is the native end-to-end read
// data plane the reference gets for free from being all-C++
// (src/storage/service/StorageOperator.cc read path + AioReadWorker).
//
// SAFETY CONTRACT (enforced here, maintained by the Python side):
// the registry only ever contains CR targets that are locally UPTODATE
// and publicly readable, with their engine handle and chain id; entries
// are rebuilt by the storage app on every routing/target change and
// cleared on shutdown. Any op that does not match an entry exactly
// (unknown target, chain mismatch, schema drift, engine E_RANGE) makes
// the WHOLE request fall back to the Python path — the fast path serves
// only the unambiguous hot case.

// engine ABI mirror (native/chunk_engine.cpp — keep in sync)
struct FpReadOp {
  uint8_t key[12];
  uint32_t slot_len;
  uint64_t out_off;
  uint32_t offset;
  int32_t length;
};
struct FpOpResult {
  int32_t rc;
  uint32_t len;
  uint32_t crc;
  uint32_t aux;
  uint64_t ver;
};
typedef int (*fp_batch_read_t)(void* h, const FpReadOp* ops, uint8_t* out,
                               uint64_t cap, FpOpResult* res, int n);

struct FpTarget {
  void* engine = nullptr;
  int64_t chain_id = 0;
  uint64_t chunk_size = 0;
};

// ---- write fast path (chain-internal batchUpdate, method 15) --------------
// Serves the TAIL hop of batched CRAQ writes natively: the head (Python)
// forwards a fully-staged batch in one RPC; when the receiving target is
// the registered tail of its chain, decode + engine stage/commit + encode
// all happen here (ce_batch_write holds the engine mutex across both
// steps, closing the stage/commit interleave the Python path closes with
// per-chunk locks). Anything ambiguous — unknown chain, chain-version
// skew, duplicate chunks in one batch, inline (non-bulk) payloads, any
// engine code other than OK/stale — falls back to the Python dispatch;
// engine ops are idempotent (re-stage same ver, duplicate commit), so a
// post-partial fallback re-run is safe.

// engine ABI mirrors (native/chunk_engine.cpp CUpOp/COpResult — keep in sync)
struct FpUpOp {
  uint8_t key[12];
  uint8_t flags;
  uint8_t pad0[3];
  uint32_t offset;
  uint32_t data_len;
  uint32_t chunk_size;
  uint32_t aux;
  uint64_t data_off;
  uint64_t update_ver;
  uint32_t expected_crc;
  uint32_t pad1;
};
typedef int (*fp_batch_write_t)(void* h, uint64_t chain_ver,
                                const uint8_t* blob, const FpUpOp* ops,
                                FpOpResult* res, int n);

struct FpWriteChain {
  void* engine = nullptr;
  int64_t target_id = 0;   // the registered tail target (for invalidation)
  int64_t chain_ver = 0;
  uint64_t chunk_size = 0;
};

// ce_batch_commit mirror (native/chunk_engine.cpp): commit staged versions
typedef int (*fp_batch_commit_t)(void* h, uint64_t chain_ver,
                                 const uint8_t* keys, const uint64_t* vers,
                                 FpOpResult* res, int n);

// head-side write registration: the local HEAD target of a fully-SERVING
// replicated chain plus the socket route to its successor. Registered per
// sync tick by tpu3fs/storage/native_fastpath.py under the same
// eligibility rules the Python head would prove per-request (all members
// SERVING, no EC, no in-process replicator, no armed write-path fault
// rules); anything the registration cannot prove stays on the Python
// dispatch.
struct FpHeadChain {
  void* engine = nullptr;
  int64_t target_id = 0;       // the local head target
  int64_t chain_ver = 0;
  uint64_t chunk_size = 0;
  bool reject_create = false;  // near-full target: creates must refuse
  std::string succ_host;       // empty/0 = single-member chain (no forward)
  int succ_port = 0;
};

// status codes the fast path can emit (tpu3fs/utils/result.py)
enum FpCode : int64_t {
  FP_OK = 0,
  FP_CHUNK_NOT_FOUND = 500,
  FP_CHUNK_NOT_COMMIT = 501,
  FP_CHECKSUM_MISMATCH = 506,
  FP_ENGINE_ERROR = 515,
  FP_INVALID = 100,
};

int64_t fp_rc_to_code(int32_t rc) {
  switch (rc) {
    case -1:
      return FP_CHUNK_NOT_FOUND;
    case -2:
      return FP_CHUNK_NOT_COMMIT;
    case -7:
      return FP_INVALID;
    case -9:
      return FP_CHECKSUM_MISMATCH;
    default:
      return FP_ENGINE_ERROR;
  }
}

struct FpState {
  std::mutex mu;
  fp_batch_read_t batch_read = nullptr;
  std::map<int64_t, FpTarget> targets;
  fp_batch_write_t batch_write = nullptr;
  std::map<int64_t, FpWriteChain> write_chains;  // chain_id -> local tail
  // head-side write path: stage (ce_batch_update) + commit
  // (ce_batch_commit) around the chain forward, per registered head chain
  fp_batch_write_t batch_stage = nullptr;
  fp_batch_commit_t batch_commit = nullptr;
  std::map<int64_t, FpHeadChain> head_chains;  // chain_id -> local head
  std::atomic<uint64_t> hits{0};
  std::atomic<uint64_t> fallbacks{0};
  std::atomic<uint64_t> write_served{0};     // head writes served here
  std::atomic<uint64_t> write_fallbacks{0};  // head writes handed to Python
  std::atomic<uint64_t> forward_us{0};       // cumulative successor RTT
  // planted chaos bug native_commit_skip_crc (tpu3fs/chaos/bugs.py): when
  // armed the head commits + acks without verifying the successor's
  // result — no status check, no checksum cross-check
  std::atomic<bool> skip_crc{false};
  // readers currently inside an engine call: deregistration spins until
  // this drains so a caller may safely ce_close an engine after
  // del_target/clear returns (no use-after-free on in-flight reads)
  std::atomic<int64_t> inflight{0};
};

struct FpReq {
  int64_t chain_id;
  uint64_t file_id;
  uint32_t index;
  int64_t offset;
  int64_t length;
  int64_t target_id;
};

// decode ONE ReadReq at pos (shared by the batch and single forms: a
// wire-format change lands in exactly one place)
bool fp_decode_one(const uint8_t* d, size_t len, size_t& pos, FpReq& r) {
  uint64_t rf;
  if (!get_uvarint(d, len, pos, rf) || rf != 6) return false;
  int64_t tmp;
  if (!get_int(d, len, pos, r.chain_id)) return false;
  uint64_t cidf;
  if (!get_uvarint(d, len, pos, cidf) || cidf != 2) return false;
  if (!get_int(d, len, pos, tmp)) return false;
  r.file_id = uint64_t(tmp);
  if (!get_int(d, len, pos, tmp)) return false;
  r.index = uint32_t(tmp);
  if (!get_int(d, len, pos, r.offset)) return false;
  if (!get_int(d, len, pos, r.length)) return false;
  if (!get_int(d, len, pos, r.target_id)) return false;
  if (!get_int(d, len, pos, tmp)) return false;  // chunk_size (unused)
  return true;
}

// decode BatchReadReq{reqs: List[ReadReq]}; false => fall back to Python
bool fp_decode_req(const uint8_t* d, size_t len, std::vector<FpReq>& out) {
  size_t pos = 0;
  uint64_t nfields, count;
  if (!get_uvarint(d, len, pos, nfields) || nfields != 1) return false;
  if (!get_uvarint(d, len, pos, count) || count > 65536) return false;
  out.reserve(count);
  for (uint64_t i = 0; i < count; i++) {
    FpReq r;
    if (!fp_decode_one(d, len, pos, r)) return false;
    out.push_back(r);
  }
  return pos == len;
}

// decode one bare ReadReq (method 3); false => fall back to Python
bool fp_decode_single(const uint8_t* d, size_t len, FpReq& r) {
  size_t pos = 0;
  if (!fp_decode_one(d, len, pos, r)) return false;
  return pos == len;
}

void fp_put_reply(std::string& buf, int64_t code, uint64_t data_len,
                  const uint8_t* data, uint64_t ver, uint32_t crc,
                  uint32_t aux, bool inline_data) {
  // ReadReply{code, data, commit_ver, checksum{value,length}, logical_len}
  put_uvarint(buf, 5);
  put_int(buf, code);
  if (inline_data && data != nullptr) {
    put_uvarint(buf, data_len);
    buf.append(reinterpret_cast<const char*>(data), data_len);
  } else {
    put_uvarint(buf, 0);  // bulk mode or error: empty inline data
  }
  put_int(buf, int64_t(ver));
  put_uvarint(buf, 2);  // Checksum field count
  put_int(buf, int64_t(crc));
  put_int(buf, int64_t(data_len));
  put_int(buf, int64_t(aux));
}

// bulk-gather reply of a fast-path read batch: the control payload plus
// the bulk header and the engine group buffers the payload segments still
// live in — worker_main writev's straight from those buffers (no
// concatenation of the section; the data bytes are copied exactly once,
// engine -> group buffer, then DMA'd to the socket by the kernel).
struct FpReadOut {
  std::string payload;
  bool reply_bulk = false;
  std::string bulk_hdr;
  // owning buffers + the (ptr, len) segments into them, in reply order
  std::vector<std::unique_ptr<std::vector<uint8_t>>> bufs;
  std::vector<std::pair<const uint8_t*, size_t>> segs;
  size_t bulk_bytes() const {
    size_t total = bulk_hdr.size();
    for (auto& s : segs) total += s.second;
    return total;
  }
};

// true when handled (reply fields filled); false => fall back to Python.
// `single` = method 3 (one bare ReadReq in, one bare ReadReply out);
// otherwise method 11 (BatchReadReq/BatchReadRsp).
bool fp_try_batch_read(FpState& fp, const Packet& req, FpReadOut& out2,
                       bool single = false) {
  std::vector<FpReq> ops;
  const uint8_t* d = reinterpret_cast<const uint8_t*>(req.payload.data());
  if (single) {
    FpReq r;
    if (!fp_decode_single(d, req.payload.size(), r)) return false;
    if (r.target_id == 0) return false;  // selection belongs to Python
    ops.push_back(r);
  } else if (!fp_decode_req(d, req.payload.size(), ops)) {
    return false;
  }
  if (ops.empty()) return false;
  // resolve every op against the registry under one lock snapshot; the
  // inflight count is taken under the same lock so deregistration can
  // drain us before an engine is closed
  std::vector<FpTarget> tgts(ops.size());
  fp_batch_read_t engine_read;
  uint64_t total_slots = 0;
  {
    std::lock_guard<std::mutex> g(fp.mu);
    engine_read = fp.batch_read;
    if (engine_read == nullptr || fp.targets.empty()) return false;
    for (size_t i = 0; i < ops.size(); i++) {
      auto it = fp.targets.find(ops[i].target_id);
      if (it == fp.targets.end() || it->second.chain_id != ops[i].chain_id)
        return false;
      tgts[i] = it->second;
      total_slots += ops[i].length < 0
                         ? it->second.chunk_size
                         : std::min<uint64_t>(uint64_t(ops[i].length),
                                              it->second.chunk_size);
    }
    // the reply must fit one frame (length header is 4 bytes and the
    // Python peer rejects frames over kMaxPacket): oversized batches go
    // to the Python path, which answers with a clean error envelope —
    // this also bounds the buffer allocation below. 64 bytes/op covers
    // the per-reply envelope fields (code, lengths, ver, checksum, aux)
    // with margin; 1 MiB covers the packet envelope itself.
    if (total_slots + uint64_t(ops.size()) * 64 + (1u << 20) > kMaxPacket)
      return false;
    fp.inflight.fetch_add(1);
  }
  struct InflightGuard {
    FpState& fp;
    ~InflightGuard() { fp.inflight.fetch_sub(1); }
  } guard{fp};
  // group by engine handle: one ce_batch_read per engine
  std::map<void*, std::vector<size_t>> by_engine;
  for (size_t i = 0; i < ops.size(); i++)
    by_engine[tgts[i].engine].push_back(i);
  struct Out {
    int32_t rc = 0;
    uint64_t off = 0;  // offset into the group buffer
    uint32_t len = 0;
    uint32_t crc = 0;
    uint32_t aux = 0;
    uint64_t ver = 0;
    const std::vector<uint8_t>* buf = nullptr;
  };
  std::vector<Out> outs(ops.size());
  std::vector<std::unique_ptr<std::vector<uint8_t>>> bufs;
  for (auto& kv : by_engine) {
    auto& idxs = kv.second;
    std::vector<FpReadOp> rops(idxs.size());
    std::vector<FpOpResult> res(idxs.size());
    uint64_t total = 0;
    for (size_t j = 0; j < idxs.size(); j++) {
      const FpReq& r = ops[idxs[j]];
      const FpTarget& t = tgts[idxs[j]];
      FpReadOp& o = rops[j];
      // key layout: >QI big-endian (file_id u64, index u32)
      for (int b = 0; b < 8; b++)
        o.key[b] = uint8_t(r.file_id >> (8 * (7 - b)));
      for (int b = 0; b < 4; b++)
        o.key[8 + b] = uint8_t(r.index >> (8 * (3 - b)));
      o.offset = uint32_t(r.offset);
      o.length = int32_t(r.length);
      uint64_t slot = r.length < 0
                          ? t.chunk_size
                          : std::min<uint64_t>(uint64_t(r.length),
                                               t.chunk_size);
      o.slot_len = uint32_t(slot);
      o.out_off = total;
      total += slot;
    }
    auto buf = std::make_unique<std::vector<uint8_t>>(total);
    if (engine_read(kv.first, rops.data(), buf->data(), total, res.data(),
                    int(idxs.size())) != 0)
      return false;
    for (size_t j = 0; j < idxs.size(); j++) {
      if (res[j].rc == -10) return false;  // E_RANGE: Python re-reads
      Out& o = outs[idxs[j]];
      o.rc = res[j].rc;
      o.off = rops[j].out_off;
      o.len = res[j].len;
      o.crc = res[j].crc;
      o.aux = res[j].aux;
      o.ver = res[j].ver;
      o.buf = buf.get();
    }
    bufs.push_back(std::move(buf));
  }
  // encode BatchReadRsp{replies} (or one bare ReadReply when single);
  // data inline or as bulk SEGMENTS gathered straight from the group
  // buffers (no section concatenation — the multi-chunk bulk gather)
  std::string& payload = out2.payload;
  out2.reply_bulk = req.has_bulk;
  bool reply_bulk = out2.reply_bulk;
  payload.clear();
  if (!single) {
    put_uvarint(payload, 1);
    put_uvarint(payload, ops.size());
  }
  std::string& bulk_hdr = out2.bulk_hdr;
  if (reply_bulk) put_uvarint(bulk_hdr, ops.size());
  for (size_t i = 0; i < ops.size(); i++) {
    const Out& o = outs[i];
    if (o.rc != 0) {
      fp_put_reply(payload, fp_rc_to_code(o.rc), 0, nullptr, 0, 0, 0, true);
      if (reply_bulk) put_uvarint(bulk_hdr, 0);
      continue;
    }
    const uint8_t* data = o.buf->data() + o.off;
    if (reply_bulk) {
      fp_put_reply(payload, FP_OK, o.len, nullptr, o.ver, o.crc, o.aux,
                   false);
      put_uvarint(bulk_hdr, o.len);
      if (o.len) out2.segs.emplace_back(data, size_t(o.len));
    } else {
      fp_put_reply(payload, FP_OK, o.len, data, o.ver, o.crc, o.aux, true);
    }
  }
  out2.bufs = std::move(bufs);
  fp.hits.fetch_add(1);
  return true;
}

// ---- write fast path: decode / execute / encode ---------------------------

struct FpWReq {
  int64_t chain_id = 0;
  int64_t chain_ver = 0;
  uint64_t file_id = 0;
  uint32_t index = 0;
  int64_t offset = 0;
  int64_t chunk_size = 0;
  std::string client_id;  // exactly-once identity (head fast path)
  int64_t channel_id = 0;
  int64_t seqnum = 0;
  int64_t update_ver = 0;
  bool full_replace = false;
  int64_t from_target = 0;
  int64_t trusted_crc = -1;  // forwarded verbatim down the chain
};

// decode ONE WriteReq (13 fields; serde reflection order of
// storage/craq.py WriteReq). Returns false on any shape mismatch OR a
// non-empty inline data field (bulk mode keeps payloads out of the
// envelope; inline payloads take the Python path). trusted_crc is
// decoded but never TRUSTED here — the head fast path forwards it
// verbatim so the successor sees the same bytes a Python head would
// have forwarded; anything arriving over a socket is re-verified.
bool fp_decode_write_one(const uint8_t* d, size_t len, size_t& pos,
                         FpWReq& r) {
  uint64_t nf;
  if (!get_uvarint(d, len, pos, nf) || nf != 13) return false;
  int64_t tmp;
  if (!get_int(d, len, pos, r.chain_id)) return false;
  if (!get_int(d, len, pos, r.chain_ver)) return false;
  uint64_t cidf;
  if (!get_uvarint(d, len, pos, cidf) || cidf != 2) return false;
  if (!get_int(d, len, pos, tmp)) return false;
  r.file_id = uint64_t(tmp);
  if (!get_int(d, len, pos, tmp)) return false;
  r.index = uint32_t(tmp);
  if (!get_int(d, len, pos, r.offset)) return false;
  uint64_t data_len;
  if (!get_uvarint(d, len, pos, data_len) || data_len != 0) return false;
  if (!get_int(d, len, pos, r.chunk_size)) return false;
  uint64_t sl;  // client_id; `sl > len - pos`, NOT `pos + sl > len` —
                // the latter wraps for crafted huge varints (same guard
                // as get_str above)
  if (!get_uvarint(d, len, pos, sl) || sl > len - pos) return false;
  r.client_id.assign(reinterpret_cast<const char*>(d + pos), sl);
  pos += sl;
  if (!get_int(d, len, pos, r.channel_id)) return false;
  if (!get_int(d, len, pos, r.seqnum)) return false;
  if (!get_int(d, len, pos, r.update_ver)) return false;
  if (pos >= len) return false;
  r.full_replace = d[pos++] != 0;  // bool = one raw byte
  if (!get_int(d, len, pos, r.from_target)) return false;
  if (!get_int(d, len, pos, r.trusted_crc)) return false;
  return true;
}

// decode BatchWriteReq{reqs: List[WriteReq]}
bool fp_decode_write_reqs(const uint8_t* d, size_t len,
                          std::vector<FpWReq>& out) {
  size_t pos = 0;
  uint64_t nfields, count;
  if (!get_uvarint(d, len, pos, nfields) || nfields != 1) return false;
  if (!get_uvarint(d, len, pos, count) || count == 0 || count > 65536)
    return false;
  out.reserve(count);
  for (uint64_t i = 0; i < count; i++) {
    FpWReq r;
    if (!fp_decode_write_one(d, len, pos, r)) return false;
    out.push_back(r);
  }
  return pos == len;
}

// bulk section -> per-segment (offset, length) into the section buffer
bool fp_split_bulk(const std::string& bulk,
                   std::vector<std::pair<uint64_t, uint64_t>>& segs) {
  const uint8_t* d = reinterpret_cast<const uint8_t*>(bulk.data());
  size_t len = bulk.size(), pos = 0;
  uint64_t count;
  if (!get_uvarint(d, len, pos, count) || count > 65536) return false;
  std::vector<uint64_t> lens(count);
  uint64_t total = 0;
  for (uint64_t i = 0; i < count; i++) {
    if (!get_uvarint(d, len, pos, lens[i])) return false;
    total += lens[i];
  }
  if (pos + total != len) return false;
  segs.reserve(count);
  for (uint64_t i = 0; i < count; i++) {
    segs.emplace_back(pos, lens[i]);
    pos += lens[i];
  }
  return true;
}

void fp_put_update_reply(std::string& buf, int64_t code, int64_t update_ver,
                         int64_t commit_ver, uint32_t crc, uint32_t len,
                         const char* msg = nullptr) {
  // UpdateReply{code, update_ver, commit_ver, checksum{value,length}, msg}
  put_uvarint(buf, 5);
  put_int(buf, code);
  put_int(buf, update_ver);
  put_int(buf, commit_ver);
  put_uvarint(buf, 2);
  put_int(buf, int64_t(crc));
  put_int(buf, int64_t(len));
  if (msg == nullptr) {
    put_uvarint(buf, 0);  // empty message
  } else {
    size_t mlen = strlen(msg);
    put_uvarint(buf, mlen);
    buf.append(msg, mlen);
  }
}

constexpr int32_t kEngineStale = -3;  // chunk_engine E_STALE_UPDATE

// true when handled (payload filled); false => fall back to Python
bool fp_try_batch_write(FpState& fp, const Packet& req, std::string& payload) {
  if (!req.has_bulk) return false;
  std::vector<FpWReq> ops;
  const uint8_t* d = reinterpret_cast<const uint8_t*>(req.payload.data());
  if (!fp_decode_write_reqs(d, req.payload.size(), ops)) return false;
  std::vector<std::pair<uint64_t, uint64_t>> segs;
  if (!fp_split_bulk(req.bulk, segs) || segs.size() != ops.size())
    return false;
  std::vector<FpWriteChain> tgts(ops.size());
  std::vector<std::array<uint8_t, 12>> keys(ops.size());
  fp_batch_write_t engine_write;
  {
    std::lock_guard<std::mutex> g(fp.mu);
    engine_write = fp.batch_write;
    if (engine_write == nullptr || fp.write_chains.empty()) return false;
    std::set<std::array<uint8_t, 12>> seen;
    for (size_t i = 0; i < ops.size(); i++) {
      const FpWReq& r = ops[i];
      auto it = fp.write_chains.find(r.chain_id);
      // every guard mirrors a Python-path precondition: registered tail,
      // same chain version, chain-internal (head already staged/deduped),
      // an assigned version, and in-bounds extent
      if (it == fp.write_chains.end()) return false;
      if (r.chain_ver != it->second.chain_ver) return false;
      if (r.from_target == 0 || r.update_ver <= 0) return false;
      // a request-carried chunk_size that disagrees with the registered
      // target would make our accept/reject behavior diverge from the
      // Python tail (which honors `r.chunk_size or target.chunk_size`)
      if (r.chunk_size != 0 &&
          uint64_t(r.chunk_size) != it->second.chunk_size)
        return false;
      if (r.offset < 0 ||
          uint64_t(r.offset) + segs[i].second > it->second.chunk_size)
        return false;
      std::array<uint8_t, 12>& key = keys[i];  // >QI big-endian, once
      for (int b = 0; b < 8; b++)
        key[b] = uint8_t(r.file_id >> (8 * (7 - b)));
      for (int b = 0; b < 4; b++)
        key[8 + b] = uint8_t(r.index >> (8 * (3 - b)));
      if (!seen.insert(key).second)
        return false;  // same-chunk dups keep Python's ordered path
      tgts[i] = it->second;
    }
    fp.inflight.fetch_add(1);
  }
  struct InflightGuard {
    FpState& fp;
    ~InflightGuard() { fp.inflight.fetch_sub(1); }
  } guard{fp};
  // group by (engine, chain_ver): one ce_batch_write per engine
  std::map<void*, std::vector<size_t>> by_engine;
  for (size_t i = 0; i < ops.size(); i++)
    by_engine[tgts[i].engine].push_back(i);
  const uint8_t* blob = reinterpret_cast<const uint8_t*>(req.bulk.data());
  std::vector<FpOpResult> outs(ops.size());
  for (auto& kv : by_engine) {
    auto& idxs = kv.second;
    std::vector<FpUpOp> wops(idxs.size());
    std::vector<FpOpResult> res(idxs.size());
    for (size_t j = 0; j < idxs.size(); j++) {
      const FpWReq& r = ops[idxs[j]];
      FpUpOp& o = wops[j];
      memset(&o, 0, sizeof(o));
      memcpy(o.key, keys[idxs[j]].data(), 12);
      o.flags = r.full_replace ? 1 : 0;
      o.offset = uint32_t(r.offset);
      o.data_len = uint32_t(segs[idxs[j]].second);
      o.chunk_size = uint32_t(tgts[idxs[j]].chunk_size);
      o.data_off = segs[idxs[j]].first;
      o.update_ver = uint64_t(r.update_ver);
    }
    if (engine_write(kv.first, uint64_t(ops[idxs[0]].chain_ver), blob,
                     wops.data(), res.data(), int(idxs.size())) != 0)
      return false;
    for (size_t j = 0; j < idxs.size(); j++) {
      if (res[j].rc != 0 && res[j].rc != kEngineStale)
        return false;  // Python re-runs the batch; engine ops idempotent
      outs[idxs[j]] = res[j];
    }
  }
  payload.clear();
  put_uvarint(payload, 1);  // BatchWriteRsp field count
  put_uvarint(payload, ops.size());
  for (size_t i = 0; i < ops.size(); i++) {
    const FpOpResult& o = outs[i];
    // OK: committed at the staged version. Stale: idempotent duplicate —
    // report the committed state (mirrors the Python tail's replies)
    fp_put_update_reply(payload, 0, ops[i].update_ver, int64_t(o.ver),
                        o.crc, o.len);
  }
  fp.hits.fetch_add(1);
  return true;
}

constexpr int64_t kStorageServiceId = 3;
constexpr int64_t kBatchReadMethodId = 11;
constexpr int64_t kReadMethodId = 3;
constexpr int64_t kBatchUpdateMethodId = 15;
constexpr int64_t kWriteMethodId = 1;
constexpr int64_t kBatchWriteMethodId = 12;

// ---- server ---------------------------------------------------------------
// handler v4: returns status; on success fills *rsp (malloc'd) + *rsp_len;
// may fill *msg (malloc'd) with an error message. `flags` carries the
// request envelope's flag bits — the QoS traffic-class bits ride there
// (tpu3fs/qos/core.py class_to_flags), so the Python trampoline can admit
// and tag by the class the PEER declared instead of guessing from the
// method name. `req_msg` is the request envelope's message field (NUL-
// terminated; "" when absent) — a traced peer carries its TraceContext
// there (tpu3fs/analytics/spans.py), and the field is already part of
// the wire envelope, so old peers interop untouched. `bulk`/`bulk_len`
// carry the request's raw bulk section when has_bulk != 0; the handler
// may hand back a malloc'd reply bulk section via *rsp_bulk — the
// transport then writev's it after the envelope without copying. Called
// from workers.
typedef int64_t (*tpu3fs_handler_t)(int64_t service_id, int64_t method_id,
                                    int64_t flags, const char* req_msg,
                                    const uint8_t* req, size_t req_len,
                                    const uint8_t* bulk, size_t bulk_len,
                                    int has_bulk,
                                    uint8_t** rsp, size_t* rsp_len,
                                    uint8_t** rsp_bulk, size_t* rsp_bulk_len,
                                    char** msg);

struct Conn {
  int fd = -1;
  std::mutex write_mu;
  // read framing state (owned by the event loop thread)
  std::string inbuf;
  std::atomic<bool> closed{false};
  // the fd is closed ONLY here, when the last reference dies: a worker may
  // be inside send_iovs on this fd concurrently with the event loop closing
  // the connection, and an early ::close() would let the kernel hand the
  // same fd number to a new accept — the worker's reply bytes would then
  // land in an unrelated client's connection. shutdown() (in
  // server_close_conn) unblocks such senders; close() must wait for them.
  ~Conn() {
    if (fd >= 0) ::close(fd);
  }
};

struct Job {
  std::shared_ptr<Conn> conn;
  Packet req;
};

// ---- cheap QoS admission (the native mirror of tpu3fs/qos) ----------------
// A per-service-id token ceiling checked in the worker BEFORE the fast
// path or the Python handler run: under extreme overload frames are
// answered with the retryable OVERLOADED (108) + a retry-after hint
// without crossing the FFI at all. The full (service, method, class)
// admission lives in Python (qos/core.py AdmissionController); this is
// the coarse backstop configured from QosConfig.native_ceiling_rate.
constexpr int64_t kOverloaded = 108;  // tpu3fs/utils/result.py Code.OVERLOADED

struct QosBucket {
  std::mutex mu;
  double rate = 0.0;   // tokens/s; <= 0 = unlimited
  double burst = 1.0;
  double tokens = 1.0;
  double last_s = 0.0;

  // -> 0 when admitted, else suggested retry-after in ms
  int64_t try_take(int64_t fallback_ms, double cost = 1.0) {
    std::lock_guard<std::mutex> g(mu);
    if (rate <= 0.0) return 0;
    double now = mono_now();  // seconds
    if (now > last_s)
      tokens = std::min(burst, tokens + (now - last_s) * rate);
    last_s = now;
    if (tokens >= cost) {
      tokens -= cost;
      return 0;
    }
    int64_t ms = static_cast<int64_t>((cost - tokens) / rate * 1000.0) + 1;
    return std::max(fallback_ms, ms);
  }

  // undo a take whose request was NOT served here after all (a fast-path
  // fallback hands the op to Python, whose admission charges it again —
  // without the refund the op would pay two buckets for one read)
  void put_back(double cost = 1.0) {
    std::lock_guard<std::mutex> g(mu);
    if (rate > 0.0) tokens = std::min(burst, tokens + cost);
  }
};

// per-TENANT gate for ops served WITHOUT entering Python (the native
// read fast path): the C mirror of tpu3fs/tenant/quota.py's per-tenant
// iops/bytes buckets. The iops axis pre-charges (refundable on a Python
// fallback, where tenant/quota.py charges the op again); the bytes axis
// is availability-checked before serving and charged AFTER (the served
// byte count is only known then) — debt drains at the configured rate,
// throttling subsequent ops, which is the standard post-charge model.
constexpr int64_t kTenantThrottled = 1100;  // Code.TENANT_THROTTLED

struct TenantGate {
  QosBucket iops;
  QosBucket bytes;

  // availability probe for the post-charged bytes axis: 0 when tokens
  // are positive (or unlimited), else suggested retry-after ms
  int64_t bytes_blocked_ms(int64_t fallback_ms) {
    std::lock_guard<std::mutex> g(bytes.mu);
    if (bytes.rate <= 0.0) return 0;
    double now = mono_now();
    if (now > bytes.last_s)
      bytes.tokens =
          std::min(bytes.burst, bytes.tokens + (now - bytes.last_s) * bytes.rate);
    bytes.last_s = now;
    if (bytes.tokens > 0.0) return 0;
    int64_t ms = static_cast<int64_t>(-bytes.tokens / bytes.rate * 1000.0) + 1;
    return std::max(fallback_ms, ms);
  }

  // post-serve charge: may push the bytes axis into debt
  void charge_bytes(double cost) {
    std::lock_guard<std::mutex> g(bytes.mu);
    if (bytes.rate > 0.0) bytes.tokens -= cost;
  }
};

struct QosState {
  std::mutex mu;  // guards the map shape; buckets lock themselves
  std::map<int64_t, std::unique_ptr<QosBucket>> buckets;
  // per-(service, traffic class) gates for ops served WITHOUT entering
  // Python (the native read fast path): keyed service_id << 8 | class
  // code, where the class code is the envelope's 4 flag bits
  // ((flags >> 8) & 0xF; 0 = untagged). Installed from QosConfig's
  // per-class sections by tpu3fs/rpc/native_net.py.
  std::map<int64_t, std::unique_ptr<QosBucket>> class_buckets;
  // exact-name tenant gates installed from the [tenants] quota table by
  // tpu3fs/rpc/native_net.py (hot pushes re-sync via the registry's
  // reload hook). Unconfigured tenants pass free here — Python's
  // lazily-minted default-quota buckets cover them on the fallback path,
  // and a shared default bucket in C would mis-attribute one tenant's
  // flood to every unknown peer.
  std::map<std::string, std::unique_ptr<TenantGate>> tenant_gates;
  // envelope class codes exempt from tenant gating (background/recovery
  // classes: system work is never tenant-charged, tenant/quota.py)
  std::atomic<uint64_t> tenant_exempt_mask{0};
  std::atomic<uint64_t> shed{0};
  std::atomic<uint64_t> tenant_shed{0};
  int64_t retry_after_ms = 50;

  QosBucket* find(int64_t service_id) {
    std::lock_guard<std::mutex> g(mu);
    auto it = buckets.find(service_id);
    return it == buckets.end() ? nullptr : it->second.get();
  }

  QosBucket* find_class(int64_t service_id, int64_t class_code) {
    std::lock_guard<std::mutex> g(mu);
    auto it = class_buckets.find((service_id << 8) | (class_code & 0xF));
    return it == class_buckets.end() ? nullptr : it->second.get();
  }

  TenantGate* find_tenant(const std::string& name) {
    if (name.empty()) return nullptr;
    std::lock_guard<std::mutex> g(mu);
    auto it = tenant_gates.find(name);
    return it == tenant_gates.end() ? nullptr : it->second.get();
  }
};

// parse the u1.<tenant> token off a request envelope message — the C
// mirror of tenant/identity.py decode_tenant: skip the 4 trace fields
// when the message is traced, then step over 2-field tokens until u1.
// Returns "" (-> gate skipped, "default" semantics) on absent/malformed.
std::string parse_tenant(const std::string& msg) {
  if (msg.empty() || msg.find("u1") == std::string::npos) return "";
  std::vector<std::string> parts;
  size_t start = 0;
  while (true) {
    size_t dot = msg.find('.', start);
    if (dot == std::string::npos) {
      parts.push_back(msg.substr(start));
      break;
    }
    parts.push_back(msg.substr(start, dot - start));
    start = dot + 1;
  }
  size_t idx = (!parts.empty() && parts[0] == "t1") ? 4 : 0;
  while (idx + 1 < parts.size()) {
    if (parts[idx] == "u1") {
      const std::string& name = parts[idx + 1];
      if (name.empty() || name.size() > 64) return "";
      for (char c : name)
        if (!((c >= 'a' && c <= 'z') || (c >= '0' && c <= '9') ||
              c == '_' || c == '-'))
          return "";
      return name;
    }
    idx += 2;
  }
  return "";
}

// ---- exactly-once channel table (the C mirror of craq._ChannelTable) ------
// ONE table serves both paths: the native head write path consults it
// below the GIL, and the Python dispatch consults the same table through
// the tpu3fs_rpc_chan_* exports (storage/native_fastpath.py swaps the
// service's Python table for a wrapper), so a retry replayed across the
// fast path / fallback boundary still dedupes. Semantics are verbatim
// _ChannelTable: LRU capacity 1024 with a 60 s eviction grace (a slot
// younger than the grace blocks eviction — the table may overshoot),
// every hit refreshes recency BEFORE the seqnum comparison.
struct ChanTable {
  std::mutex mu;
  size_t capacity = 1024;
  double grace_s = 60.0;
  struct Slot {
    int64_t seq = 0;
    std::string reply;  // encoded UpdateReply payload, replayed verbatim
    double last_touch = 0.0;
    std::list<std::string>::iterator pos;
  };
  std::list<std::string> order;  // LRU order: front = oldest
  std::unordered_map<std::string, Slot> slots;

  static std::string key_of(const std::string& client_id,
                            int64_t channel_id) {
    std::string k = client_id;
    k.push_back('\0');
    k += std::to_string(channel_id);
    return k;
  }

  // -> 0 fresh (proceed), 1 cached duplicate (*out = stored reply), 2 stale
  int check(const std::string& key, int64_t seq, std::string* out) {
    std::lock_guard<std::mutex> g(mu);
    auto it = slots.find(key);
    if (it == slots.end()) return 0;
    it->second.last_touch = mono_now();
    order.splice(order.end(), order, it->second.pos);
    if (seq == it->second.seq) {
      if (out != nullptr) *out = it->second.reply;
      return 1;
    }
    return seq < it->second.seq ? 2 : 0;
  }

  void store(const std::string& key, int64_t seq, const uint8_t* reply,
             size_t len) {
    std::lock_guard<std::mutex> g(mu);
    double now = mono_now();
    auto it = slots.find(key);
    if (it == slots.end()) {
      order.push_back(key);
      it = slots.emplace(key, Slot{}).first;
      it->second.pos = std::prev(order.end());
    } else {
      order.splice(order.end(), order, it->second.pos);
    }
    it->second.seq = seq;
    it->second.reply.assign(reinterpret_cast<const char*>(reply), len);
    it->second.last_touch = now;
    while (slots.size() > capacity) {
      auto oit = slots.find(order.front());
      if (oit == slots.end()) {
        order.pop_front();
        continue;
      }
      if (now - oit->second.last_touch < grace_s) break;  // in-grace: keep
      order.pop_front();
      slots.erase(oit);
    }
  }

  size_t prune_client(const std::string& client_id) {
    std::string prefix = client_id;
    prefix.push_back('\0');
    std::lock_guard<std::mutex> g(mu);
    size_t reaped = 0;
    for (auto it = slots.begin(); it != slots.end();) {
      if (it->first.compare(0, prefix.size(), prefix) == 0) {
        order.erase(it->second.pos);
        it = slots.erase(it);
        ++reaped;
      } else {
        ++it;
      }
    }
    return reaped;
  }

  size_t size() {
    std::lock_guard<std::mutex> g(mu);
    return slots.size();
  }
};

// ---- per-chunk write interlock --------------------------------------------
// The head fast path serializes stage -> forward -> commit per chunk the
// way the Python head's per-chunk locks do. The Python write paths take
// THESE locks too (through tpu3fs_rpc_chunk_lock, after their own Python
// locks) whenever the native head path is registered, so a native-served
// write and a fallback-served write to the same chunk can never
// interleave between stage and commit. Acquisition is all-or-wait over
// the caller's full (deduped) key set — no incremental holds, so lock
// order cannot deadlock.
struct ChunkLocks {
  std::mutex mu;
  std::condition_variable cv;
  std::set<std::string> held;  // 12-byte chunk keys

  void lock_keys(const std::vector<std::string>& keys) {
    std::unique_lock<std::mutex> lk(mu);
    cv.wait(lk, [&] {
      for (const auto& k : keys)
        if (held.count(k)) return false;
      return true;
    });
    for (const auto& k : keys) held.insert(k);
  }

  void unlock_keys(const std::vector<std::string>& keys) {
    {
      std::lock_guard<std::mutex> g(mu);
      for (const auto& k : keys) held.erase(k);
    }
    cv.notify_all();
  }
};

// the client entry points live further down this file; the forward pool
// below reuses them for the head's successor hop (same C linkage)
extern "C" void* tpu3fs_rpc_client_connect(const char* host, int port,
                                           int connect_timeout_ms,
                                           int call_timeout_ms);
extern "C" void tpu3fs_rpc_client_close(void* cli);

// ---- pooled successor connections (the head's chain-forward hop) ----------
// take/put discipline: a worker takes the parked connection exclusively
// for one send..recv round trip and parks it back on success; transport
// trouble closes it (the next forward redials). Concurrent forwards to
// the same successor simply dial extra connections; only one parks.
struct FwdPool {
  std::mutex mu;
  std::map<std::string, void*> conns;  // "host:port" -> parked Client*

  void* take(const std::string& addr) {
    std::lock_guard<std::mutex> g(mu);
    auto it = conns.find(addr);
    if (it == conns.end()) return nullptr;
    void* c = it->second;
    conns.erase(it);
    return c;
  }

  bool put(const std::string& addr, void* cli) {
    std::lock_guard<std::mutex> g(mu);
    if (conns.count(addr)) return false;  // slot taken: caller closes
    conns[addr] = cli;
    return true;
  }

  ~FwdPool() {
    for (auto& kv : conns) tpu3fs_rpc_client_close(kv.second);
  }
};

struct Server {
  int listen_fd = -1;
  int epoll_fd = -1;
  int wake_pipe[2] = {-1, -1};
  int port = 0;
  tpu3fs_handler_t handler = nullptr;
  std::thread loop_thread;
  std::vector<std::thread> workers;
  std::atomic<bool> running{true};

  std::mutex q_mu;
  std::condition_variable q_cv;
  std::deque<Job> queue;

  std::mutex conns_mu;
  std::map<int, std::shared_ptr<Conn>> conns;

  FpState fastpath;
  QosState qos;
  ChanTable channels;
  ChunkLocks chunk_locks;
  FwdPool fwd_pool;
};

// outcome of a head-write fast-path attempt (definition follows the
// client helpers it forwards through)
enum FpWriteOutcome {
  FPW_FALLBACK = 0,  // hand the frame to the Python dispatch untouched
  FPW_SERVED = 1,    // out_payload holds the reply payload (envelope OK)
  FPW_SHED = 2,      // out_status/out_msg carry a gate-shed envelope
};
// the definition lives in the helper namespace nested inside the
// extern "C" block (it rides the client send/recv halves for the chain
// forward), so this forward declaration must carry C language linkage
// to name the same function
extern "C" {
FpWriteOutcome fp_try_head_write(Server* s, const Packet& req, bool single,
                                 std::string& out_payload,
                                 int64_t& out_status, std::string& out_msg);
}

void server_close_conn(Server* s, const std::shared_ptr<Conn>& c) {
  bool was = c->closed.exchange(true);
  if (!was) {
    {
      std::lock_guard<std::mutex> g(s->conns_mu);
      s->conns.erase(c->fd);
    }
    epoll_ctl(s->epoll_fd, EPOLL_CTL_DEL, c->fd, nullptr);
    // shutdown unblocks any worker currently in send_iovs on this fd; the
    // actual ::close() is deferred to ~Conn so the fd number cannot be
    // reused while a worker still holds a reference (see Conn)
    ::shutdown(c->fd, SHUT_RDWR);
  }
}

void worker_main(Server* s) {
  while (true) {
    Job job;
    {
      std::unique_lock<std::mutex> lk(s->q_mu);
      s->q_cv.wait(lk, [&] { return !s->running || !s->queue.empty(); });
      if (!s->running && s->queue.empty()) return;
      job = std::move(s->queue.front());
      s->queue.pop_front();
    }
    Packet& req = job.req;
    req.ts[3] = mono_now();  // server_dequeue
    Packet rsp;
    rsp.uuid = req.uuid;
    rsp.service_id = req.service_id;
    rsp.method_id = req.method_id;
    rsp.flags = 0;
    memcpy(rsp.ts, req.ts, sizeof(req.ts));
    rsp.ts[4] = mono_now();  // server_run_start
    // cheap QoS ceiling: shed before the fast path or any FFI crossing
    if (QosBucket* qb = s->qos.find(req.service_id)) {
      int64_t ra = qb->try_take(s->qos.retry_after_ms);
      if (ra > 0) {
        s->qos.shed.fetch_add(1);
        rsp.status = kOverloaded;
        rsp.message = "retry_after_ms=" + std::to_string(ra) +
                      " (native ceiling)";
        rsp.ts[5] = mono_now();
        std::string envq = encode_packet(rsp);
        uint64_t totalq = envq.size();
        uint8_t hdrq[4] = {uint8_t(totalq >> 24), uint8_t(totalq >> 16),
                           uint8_t(totalq >> 8), uint8_t(totalq)};
        struct iovec iovq[2] = {
            {hdrq, 4},
            {const_cast<char*>(envq.data()), envq.size()},
        };
        std::lock_guard<std::mutex> g(job.conn->write_mu);
        if (!job.conn->closed.load() &&
            !send_iovs(job.conn->fd, iovq, 2, kServerDrainTimeoutMs)) {
          server_close_conn(s, job.conn);
        }
        continue;
      }
    }
    // native read fast path: batchRead AND single read against
    // registered native-engine targets never enter Python (so neither do
    // Python-side read metrics / fault-injection points for those ops);
    // anything ambiguous falls through
    if (req.service_id == kStorageServiceId &&
        (req.method_id == kBatchReadMethodId ||
         req.method_id == kReadMethodId)) {
      // per-class gate (the envelope's traffic-class flag bits): ops the
      // fast path serves never reach Python's AdmissionController, so
      // the class limits are enforced HERE; a fallback refunds the take
      // because the Python dispatch charges the op again
      QosBucket* cb =
          s->qos.find_class(req.service_id, (req.flags >> 8) & 0xF);
      if (cb != nullptr) {
        int64_t ra = cb->try_take(s->qos.retry_after_ms);
        if (ra > 0) {
          s->qos.shed.fetch_add(1);
          rsp.status = kOverloaded;
          rsp.message = "retry_after_ms=" + std::to_string(ra) +
                        " (native class gate)";
          rsp.ts[5] = mono_now();
          std::string envq = encode_packet(rsp);
          uint64_t totalq = envq.size();
          uint8_t hdrq[4] = {uint8_t(totalq >> 24), uint8_t(totalq >> 16),
                             uint8_t(totalq >> 8), uint8_t(totalq)};
          struct iovec iovq[2] = {
              {hdrq, 4},
              {const_cast<char*>(envq.data()), envq.size()},
          };
          std::lock_guard<std::mutex> g(job.conn->write_mu);
          if (!job.conn->closed.load() &&
              !send_iovs(job.conn->fd, iovq, 2, kServerDrainTimeoutMs)) {
            server_close_conn(s, job.conn);
          }
          continue;
        }
      }
      // per-TENANT gate (the ROADMAP carried follow-up: reads served
      // below Python bypassed tenant buckets). The envelope's u1.* token
      // names the owner; background classes are exempt (system work);
      // the iops take is REFUNDED on a Python fallback because the
      // Python read admission charges the op again.
      TenantGate* tg = nullptr;
      uint64_t class_code = uint64_t((req.flags >> 8) & 0xF);
      if ((s->qos.tenant_exempt_mask.load() & (1ull << class_code)) == 0) {
        std::string tname = parse_tenant(req.message);
        tg = s->qos.find_tenant(tname.empty() ? "default" : tname);
      }
      if (tg != nullptr) {
        int64_t tra = tg->iops.try_take(s->qos.retry_after_ms);
        if (tra == 0) {
          int64_t bra = tg->bytes_blocked_ms(s->qos.retry_after_ms);
          if (bra > 0) {
            tg->iops.put_back();
            tra = bra;
          }
        }
        if (tra > 0) {
          if (cb != nullptr) cb->put_back();
          s->qos.tenant_shed.fetch_add(1);
          rsp.status = kTenantThrottled;
          rsp.message = "retry_after_ms=" + std::to_string(tra) +
                        " (native tenant gate)";
          rsp.ts[5] = mono_now();
          std::string envq = encode_packet(rsp);
          uint64_t totalq = envq.size();
          uint8_t hdrq[4] = {uint8_t(totalq >> 24), uint8_t(totalq >> 16),
                             uint8_t(totalq >> 8), uint8_t(totalq)};
          struct iovec iovq[2] = {
              {hdrq, 4},
              {const_cast<char*>(envq.data()), envq.size()},
          };
          std::lock_guard<std::mutex> g(job.conn->write_mu);
          if (!job.conn->closed.load() &&
              !send_iovs(job.conn->fd, iovq, 2, kServerDrainTimeoutMs)) {
            server_close_conn(s, job.conn);
          }
          continue;
        }
      }
      FpReadOut fpo;
      bool handled = false;
      try {
        handled = fp_try_batch_read(s->fastpath, req, fpo,
                                    req.method_id == kReadMethodId);
      } catch (...) {
        // allocation or engine failure must fall back, never kill the
        // worker thread (InflightGuard unwinds the in-flight count)
        handled = false;
      }
      if (handled) {
        // post-serve charge of the bytes axis (size known only now);
        // debt throttles the tenant's NEXT ops at the gate above
        if (tg != nullptr)
          tg->charge_bytes(double(fpo.reply_bulk ? fpo.bulk_bytes()
                                                 : fpo.payload.size()));
        rsp.status = OK;
        rsp.payload = std::move(fpo.payload);
        if (fpo.reply_bulk) rsp.flags |= kFlagBulk;
        rsp.ts[5] = mono_now();
        std::string env2 = encode_packet(rsp);
        uint64_t total2 = env2.size() + (fpo.reply_bulk ? fpo.bulk_bytes()
                                                        : 0);
        uint8_t hdr2[4] = {uint8_t(total2 >> 24), uint8_t(total2 >> 16),
                           uint8_t(total2 >> 8), uint8_t(total2)};
        // gather: header + envelope + bulk header + every payload segment
        // writev'd straight from the engine group buffers
        std::vector<struct iovec> iov2;
        iov2.reserve(3 + fpo.segs.size());
        iov2.push_back({hdr2, 4});
        iov2.push_back({const_cast<char*>(env2.data()), env2.size()});
        if (fpo.reply_bulk) {
          iov2.push_back({const_cast<char*>(fpo.bulk_hdr.data()),
                          fpo.bulk_hdr.size()});
          for (auto& seg : fpo.segs)
            iov2.push_back({const_cast<uint8_t*>(seg.first), seg.second});
        }
        std::lock_guard<std::mutex> g(job.conn->write_mu);
        if (!job.conn->closed.load() &&
            !send_iovs(job.conn->fd, iov2.data(), int(iov2.size()),
                       kServerDrainTimeoutMs)) {
          server_close_conn(s, job.conn);
        }
        continue;
      }
      if (cb != nullptr) cb->put_back();
      if (tg != nullptr) tg->iops.put_back();  // Python charges it again
      s->fastpath.fallbacks.fetch_add(1);
    }
    // native HEAD write fast path: client-facing write/batchWrite against
    // a registered local head — gate, exactly-once check, engine stage,
    // chain forward, CRC cross-check, commit, all below the GIL. Any
    // guard the C side can't prove hands the untouched frame to Python.
    if (req.service_id == kStorageServiceId &&
        (req.method_id == kWriteMethodId ||
         req.method_id == kBatchWriteMethodId)) {
      std::string fp_payload;
      std::string fp_msg;
      int64_t fp_status = OK;
      FpWriteOutcome out = FPW_FALLBACK;
      try {
        out = fp_try_head_write(s, req, req.method_id == kWriteMethodId,
                                fp_payload, fp_status, fp_msg);
      } catch (...) {
        out = FPW_FALLBACK;  // fall back; guards unwind locks/inflight
      }
      if (out != FPW_FALLBACK) {
        rsp.status = out == FPW_SERVED ? OK : fp_status;
        rsp.payload = std::move(fp_payload);
        rsp.message = std::move(fp_msg);
        rsp.ts[5] = mono_now();
        std::string env2 = encode_packet(rsp);
        uint64_t total2 = env2.size();
        uint8_t hdr2[4] = {uint8_t(total2 >> 24), uint8_t(total2 >> 16),
                           uint8_t(total2 >> 8), uint8_t(total2)};
        struct iovec iov2[2] = {
            {hdr2, 4},
            {const_cast<char*>(env2.data()), env2.size()},
        };
        std::lock_guard<std::mutex> g(job.conn->write_mu);
        if (!job.conn->closed.load() &&
            !send_iovs(job.conn->fd, iov2, 2, kServerDrainTimeoutMs)) {
          server_close_conn(s, job.conn);
        }
        continue;
      }
      s->fastpath.write_fallbacks.fetch_add(1);
    }
    // native write fast path: the chain-internal batchUpdate hop against
    // a registered tail target never enters Python either
    if (req.service_id == kStorageServiceId &&
        req.method_id == kBatchUpdateMethodId) {
      std::string fp_payload;
      bool handled = false;
      try {
        handled = fp_try_batch_write(s->fastpath, req, fp_payload);
      } catch (...) {
        handled = false;  // fall back; InflightGuard unwinds the count
      }
      if (handled) {
        rsp.status = OK;
        rsp.payload = std::move(fp_payload);
        rsp.ts[5] = mono_now();
        std::string env2 = encode_packet(rsp);
        uint64_t total2 = env2.size();
        uint8_t hdr2[4] = {uint8_t(total2 >> 24), uint8_t(total2 >> 16),
                           uint8_t(total2 >> 8), uint8_t(total2)};
        struct iovec iov2[2] = {
            {hdr2, 4},
            {const_cast<char*>(env2.data()), env2.size()},
        };
        std::lock_guard<std::mutex> g(job.conn->write_mu);
        if (!job.conn->closed.load() &&
            !send_iovs(job.conn->fd, iov2, 2, kServerDrainTimeoutMs)) {
          server_close_conn(s, job.conn);
        }
        continue;
      }
      s->fastpath.fallbacks.fetch_add(1);
    }
    uint8_t* out = nullptr;
    size_t out_len = 0;
    uint8_t* out_bulk = nullptr;
    size_t out_bulk_len = 0;
    char* msg = nullptr;
    int64_t status = INTERNAL;
    if (s->handler) {
      status = s->handler(req.service_id, req.method_id, req.flags,
                          req.message.c_str(),
                          reinterpret_cast<const uint8_t*>(req.payload.data()),
                          req.payload.size(),
                          reinterpret_cast<const uint8_t*>(req.bulk.data()),
                          req.bulk.size(), req.has_bulk ? 1 : 0,
                          &out, &out_len, &out_bulk, &out_bulk_len, &msg);
    }
    rsp.status = status;
    if (out != nullptr) {
      if (status == OK)
        rsp.payload.assign(reinterpret_cast<char*>(out), out_len);
      free(out);
    }
    if (msg != nullptr) {
      rsp.message = msg;
      free(msg);
    }
    bool reply_bulk = (status == OK && out_bulk != nullptr);
    if (reply_bulk) rsp.flags |= kFlagBulk;
    rsp.ts[5] = mono_now();  // server_run_end
    // envelope assembled once; the bulk section rides from the handler's
    // buffer straight into writev — the reply data is never copied again
    std::string env = encode_packet(rsp);
    uint64_t total = env.size() + (reply_bulk ? out_bulk_len : 0);
    if (total > kMaxPacket) {
      // mirror the Python server's MAX_PACKET guard: an oversized reply
      // must become an error envelope, never a mis-framed/truncated
      // 4-byte length that desyncs the stream
      rsp.flags &= ~kFlagBulk;
      reply_bulk = false;
      rsp.status = INTERNAL;
      rsp.payload.clear();
      rsp.message = "reply exceeds max packet";
      env = encode_packet(rsp);
      total = env.size();
    }
    uint8_t hdr[4] = {uint8_t(total >> 24), uint8_t(total >> 16),
                      uint8_t(total >> 8), uint8_t(total)};
    struct iovec iov[3] = {
        {hdr, 4},
        {const_cast<char*>(env.data()), env.size()},
        {out_bulk, reply_bulk ? out_bulk_len : 0},
    };
    {
      std::lock_guard<std::mutex> g(job.conn->write_mu);
      if (!job.conn->closed.load() &&
          !send_iovs(job.conn->fd, iov, reply_bulk ? 3 : 2,
                     kServerDrainTimeoutMs)) {
        server_close_conn(s, job.conn);
      }
    }
    if (out_bulk != nullptr) free(out_bulk);
  }
}

void loop_main(Server* s) {
  constexpr int kMaxEvents = 64;
  struct epoll_event evs[kMaxEvents];
  while (s->running.load()) {
    int n = epoll_wait(s->epoll_fd, evs, kMaxEvents, 200);
    if (n < 0) {
      if (errno == EINTR) continue;
      break;
    }
    for (int i = 0; i < n; i++) {
      if (evs[i].data.fd == s->listen_fd) {
        while (true) {
          int cfd = ::accept(s->listen_fd, nullptr, nullptr);
          if (cfd < 0) break;
          int one = 1;
          setsockopt(cfd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
          int bufsz = 1 << 20;  // MiB-scale bulk frames: fewer syscalls
          setsockopt(cfd, SOL_SOCKET, SO_SNDBUF, &bufsz, sizeof(bufsz));
          setsockopt(cfd, SOL_SOCKET, SO_RCVBUF, &bufsz, sizeof(bufsz));
          set_nonblocking(cfd, true);
          auto conn = std::make_shared<Conn>();
          conn->fd = cfd;
          {
            std::lock_guard<std::mutex> g(s->conns_mu);
            s->conns[cfd] = conn;
          }
          struct epoll_event ev{};
          ev.events = EPOLLIN;
          ev.data.fd = cfd;
          epoll_ctl(s->epoll_fd, EPOLL_CTL_ADD, cfd, &ev);
        }
        continue;
      }
      if (evs[i].data.fd == s->wake_pipe[0]) {
        char buf[16];
        while (read(s->wake_pipe[0], buf, sizeof(buf)) > 0) {
        }
        continue;
      }
      std::shared_ptr<Conn> conn;
      {
        std::lock_guard<std::mutex> g(s->conns_mu);
        auto it = s->conns.find(evs[i].data.fd);
        if (it == s->conns.end()) continue;
        conn = it->second;
      }
      // drain the socket into the framing buffer
      bool dead = false;
      char tmp[64 * 1024];
      while (true) {
        ssize_t r = ::recv(conn->fd, tmp, sizeof(tmp), 0);
        if (r > 0) {
          conn->inbuf.append(tmp, size_t(r));
          continue;
        }
        if (r == 0) {
          dead = true;
          break;
        }
        if (errno == EAGAIN || errno == EWOULDBLOCK) break;
        if (errno == EINTR) continue;
        dead = true;
        break;
      }
      // parse complete frames
      double now = mono_now();
      size_t off = 0;
      while (conn->inbuf.size() - off >= 4) {
        const uint8_t* b =
            reinterpret_cast<const uint8_t*>(conn->inbuf.data()) + off;
        uint32_t frame_len = (uint32_t(b[0]) << 24) | (uint32_t(b[1]) << 16) |
                             (uint32_t(b[2]) << 8) | uint32_t(b[3]);
        if (frame_len > kMaxPacket) {
          dead = true;
          break;
        }
        if (conn->inbuf.size() - off - 4 < frame_len) break;
        Packet req;
        if (decode_packet(b + 4, frame_len, req) &&
            (!req.has_bulk || bulk_section_valid(req.bulk))) {
          req.ts[2] = now;  // server_receive
          {
            std::lock_guard<std::mutex> lk(s->q_mu);
            s->queue.push_back(Job{conn, std::move(req)});
          }
          s->q_cv.notify_one();
        } else {
          dead = true;
        }
        off += 4 + frame_len;
      }
      if (off) conn->inbuf.erase(0, off);
      if (dead) server_close_conn(s, conn);
    }
  }
}

// ---- client ---------------------------------------------------------------
struct Client {
  int fd = -1;
  int call_timeout_ms = 30000;
  std::mt19937_64 rng{std::random_device{}()};
  std::mutex mu;  // one in-flight call per connection
  // uuid of the request sent by tpu3fs_rpc_client_send, awaiting its
  // reply via tpu3fs_rpc_client_recv (the pipelined split of call3:
  // callers may issue on MANY connections before collecting any reply)
  std::string pending_uuid;
};

std::string gen_uuid(std::mt19937_64& rng) {
  static const char* hex = "0123456789abcdef";
  std::string out(32, '0');
  for (int i = 0; i < 32; i++) out[i] = hex[rng() & 0xF];
  return out;
}

}  // namespace

// ---- C ABI ----------------------------------------------------------------
extern "C" {

void* tpu3fs_rpc_alloc(size_t n) { return malloc(n); }
void tpu3fs_rpc_free(void* p) { free(p); }

void* tpu3fs_rpc_server_create(const char* host, int port,
                               tpu3fs_handler_t handler, int num_workers) {
  auto* s = new Server();
  s->handler = handler;
  s->listen_fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (s->listen_fd < 0) {
    delete s;
    return nullptr;
  }
  int one = 1;
  setsockopt(s->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  struct sockaddr_in addr{};
  if (!resolve_ipv4(host, uint16_t(port), &addr)) {
    ::close(s->listen_fd);
    delete s;
    return nullptr;
  }
  if (bind(s->listen_fd, reinterpret_cast<struct sockaddr*>(&addr),
           sizeof(addr)) < 0 ||
      listen(s->listen_fd, 128) < 0) {
    ::close(s->listen_fd);
    delete s;
    return nullptr;
  }
  socklen_t alen = sizeof(addr);
  getsockname(s->listen_fd, reinterpret_cast<struct sockaddr*>(&addr), &alen);
  s->port = ntohs(addr.sin_port);
  set_nonblocking(s->listen_fd, true);
  if (pipe(s->wake_pipe) == 0) {
    set_nonblocking(s->wake_pipe[0], true);
    set_nonblocking(s->wake_pipe[1], true);
  }
  s->epoll_fd = epoll_create1(0);
  struct epoll_event ev{};
  ev.events = EPOLLIN;
  ev.data.fd = s->listen_fd;
  epoll_ctl(s->epoll_fd, EPOLL_CTL_ADD, s->listen_fd, &ev);
  ev.data.fd = s->wake_pipe[0];
  epoll_ctl(s->epoll_fd, EPOLL_CTL_ADD, s->wake_pipe[0], &ev);
  if (num_workers < 1) num_workers = 4;
  for (int i = 0; i < num_workers; i++)
    s->workers.emplace_back(worker_main, s);
  s->loop_thread = std::thread(loop_main, s);
  return s;
}

int tpu3fs_rpc_server_port(void* srv) {
  return srv ? static_cast<Server*>(srv)->port : -1;
}

void tpu3fs_rpc_server_stop(void* srv) {
  if (!srv) return;
  auto* s = static_cast<Server*>(srv);
  s->running.store(false);
  if (s->wake_pipe[1] >= 0) {
    char b = 1;
    ssize_t ignored = write(s->wake_pipe[1], &b, 1);
    (void)ignored;
  }
  s->q_cv.notify_all();
  if (s->loop_thread.joinable()) s->loop_thread.join();
  for (auto& w : s->workers)
    if (w.joinable()) w.join();
  {
    std::lock_guard<std::mutex> g(s->conns_mu);
    for (auto& kv : s->conns) {
      kv.second->closed.store(true);
      ::shutdown(kv.second->fd, SHUT_RDWR);  // ::close happens in ~Conn
    }
    s->conns.clear();
  }
  ::close(s->listen_fd);
  ::close(s->epoll_fd);
  if (s->wake_pipe[0] >= 0) ::close(s->wake_pipe[0]);
  if (s->wake_pipe[1] >= 0) ::close(s->wake_pipe[1]);
  delete s;
}

void* tpu3fs_rpc_client_connect(const char* host, int port,
                                int connect_timeout_ms, int call_timeout_ms) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return nullptr;
  struct sockaddr_in addr{};
  if (!resolve_ipv4(host, uint16_t(port), &addr)) {
    ::close(fd);
    return nullptr;
  }
  // nonblocking connect bounded by connect_timeout_ms, then blocking IO
  // bounded by call_timeout_ms — same split as the Python RpcClient
  set_nonblocking(fd, true);
  int rc = connect(fd, reinterpret_cast<struct sockaddr*>(&addr),
                   sizeof(addr));
  if (rc < 0 && errno == EINPROGRESS) {
    struct pollfd pfd = {fd, POLLOUT, 0};
    if (poll(&pfd, 1, connect_timeout_ms) <= 0) {
      ::close(fd);
      return nullptr;
    }
    int err = 0;
    socklen_t elen = sizeof(err);
    if (getsockopt(fd, SOL_SOCKET, SO_ERROR, &err, &elen) < 0 || err != 0) {
      ::close(fd);
      return nullptr;
    }
  } else if (rc < 0) {
    ::close(fd);
    return nullptr;
  }
  set_nonblocking(fd, false);
  struct timeval tv{};
  tv.tv_sec = call_timeout_ms / 1000;
  tv.tv_usec = (call_timeout_ms % 1000) * 1000;
  setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  int bufsz = 1 << 20;  // MiB-scale bulk frames: fewer syscalls
  setsockopt(fd, SOL_SOCKET, SO_SNDBUF, &bufsz, sizeof(bufsz));
  setsockopt(fd, SOL_SOCKET, SO_RCVBUF, &bufsz, sizeof(bufsz));
  auto* c = new Client();
  c->fd = fd;
  c->call_timeout_ms = call_timeout_ms;
  return c;
}

// ABI version marker: the Python loader rebuilds a stale .so whose symbols
// predate the current surface (v5: the head-side native write path —
// fastpath_install_head / head-chain registry / shared channel table /
// chunk locks / fastpath_serve; a silent mismatch would corrupt the
// callback stack instead of failing loud)
int tpu3fs_rpc_abi_version() { return 5; }

namespace {

// send half: frame + writev the request (gathering caller bulk buffers);
// stores the uuid in c->pending_uuid for the matching recv. extra_flags
// carries the envelope flag bits beyond kFlagIsReq — the QoS traffic
// class of the calling thread rides there (class_to_flags). `msg` (may
// be null) rides the envelope message field — the trace context of a
// traced caller (spans.py to_wire).
// Caller must hold c->mu.
int client_send_locked(Client* c, int64_t service_id, int64_t method_id,
                       int64_t extra_flags, const char* msg,
                       const uint8_t* req,
                       size_t req_len, const uint8_t* const* iov_ptrs,
                       const size_t* iov_lens, int64_t n_iovs) {
  Packet pkt;
  pkt.uuid = gen_uuid(c->rng);
  pkt.service_id = service_id;
  pkt.method_id = method_id;
  pkt.flags = kFlagIsReq | extra_flags;
  pkt.status = OK;
  if (msg != nullptr) pkt.message = msg;
  pkt.payload.assign(reinterpret_cast<const char*>(req), req_len);
  bool bulk = n_iovs >= 0;
  if (bulk)
    pkt.flags |= kFlagBulk;
  else
    pkt.flags &= ~kFlagBulk;  // extra_flags must not forge a bulk frame
  pkt.ts[0] = mono_now();  // client_build
  pkt.ts[1] = mono_now();  // client_send
  std::string env = encode_packet(pkt);
  std::string bulk_hdr;
  uint64_t bulk_data = 0;
  if (bulk) {
    put_uvarint(bulk_hdr, uint64_t(n_iovs));
    for (int64_t i = 0; i < n_iovs; i++) {
      put_uvarint(bulk_hdr, iov_lens[i]);
      bulk_data += iov_lens[i];
    }
  }
  uint64_t total = env.size() + bulk_hdr.size() + bulk_data;
  if (total > kMaxPacket) return -5;
  uint8_t hdr4[4] = {uint8_t(total >> 24), uint8_t(total >> 16),
                     uint8_t(total >> 8), uint8_t(total)};
  std::vector<struct iovec> iov;
  iov.reserve(3 + size_t(bulk ? n_iovs : 0));
  iov.push_back({hdr4, 4});
  iov.push_back({const_cast<char*>(env.data()), env.size()});
  if (bulk) {
    if (!bulk_hdr.empty())
      iov.push_back({const_cast<char*>(bulk_hdr.data()), bulk_hdr.size()});
    for (int64_t i = 0; i < n_iovs; i++)
      if (iov_lens[i] > 0)
        iov.push_back({const_cast<uint8_t*>(iov_ptrs[i]), iov_lens[i]});
  }
  if (!send_iovs(c->fd, iov.data(), int(iov.size()), c->call_timeout_ms))
    return -1;
  c->pending_uuid = pkt.uuid;
  return 0;
}

// recv half: read one reply frame and hand the fields out (malloc'd).
// Caller must hold c->mu; c->pending_uuid names the expected reply.
//
// ZERO-COPY bulk hand-off: a bulk reply's *out_bulk is the whole malloc'd
// FRAME buffer (recv'd straight from the kernel) and *out_bulk_off names
// the section's offset inside it — the Python side views the section in
// place and frees the buffer when its views die. The payload/message
// control fields are small and copied out as before.
int client_recv_locked(Client* c, int64_t* out_status, uint8_t** out_rsp,
                       size_t* out_rsp_len, uint8_t** out_bulk,
                       size_t* out_bulk_off, size_t* out_bulk_len,
                       int* out_has_bulk, char** out_msg) {
  if (c->pending_uuid.empty()) return -6;  // recv without a send
  uint8_t hdr[4];
  if (!recv_exact(c->fd, hdr, 4)) return -2;
  uint32_t n = (uint32_t(hdr[0]) << 24) | (uint32_t(hdr[1]) << 16) |
               (uint32_t(hdr[2]) << 8) | uint32_t(hdr[3]);
  if (n > kMaxPacket) return -3;
  uint8_t* body = static_cast<uint8_t*>(malloc(n ? n : 1));
  if (!recv_exact(c->fd, body, n)) {
    free(body);
    return -2;
  }
  Packet rsp;
  size_t bulk_off = 0;
  if (!decode_packet(body, n, rsp, &bulk_off)) {
    free(body);
    return -3;
  }
  if (rsp.has_bulk &&
      !bulk_section_valid_raw(body + bulk_off, n - bulk_off)) {
    free(body);
    return -3;
  }
  if (rsp.uuid != c->pending_uuid) {
    free(body);
    return -4;
  }
  c->pending_uuid.clear();
  *out_status = rsp.status;
  *out_rsp_len = rsp.payload.size();
  *out_rsp = static_cast<uint8_t*>(malloc(rsp.payload.size() + 1));
  memcpy(*out_rsp, rsp.payload.data(), rsp.payload.size());
  if (out_has_bulk != nullptr) *out_has_bulk = rsp.has_bulk ? 1 : 0;
  bool bulk_escaped = false;
  if (out_bulk != nullptr && out_bulk_len != nullptr) {
    if (rsp.has_bulk) {
      *out_bulk = body;  // ownership passes to the caller
      if (out_bulk_off != nullptr) *out_bulk_off = bulk_off;
      *out_bulk_len = n - bulk_off;
      bulk_escaped = true;
    } else {
      *out_bulk = nullptr;
      if (out_bulk_off != nullptr) *out_bulk_off = 0;
      *out_bulk_len = 0;
    }
  }
  if (out_msg != nullptr) {
    *out_msg = static_cast<char*>(malloc(rsp.message.size() + 1));
    memcpy(*out_msg, rsp.message.data(), rsp.message.size());
    (*out_msg)[rsp.message.size()] = 0;
  }
  if (!bulk_escaped) free(body);
  return 0;
}

// ---- head write fast path: gate / dedupe / stage / forward / commit -------

// the successor hop dials with the same budget shape the Python
// forwarder uses (conservative; a timeout falls back to Python, whose
// retry ladder owns the slow-successor policy)
constexpr int kFwdConnectTimeoutMs = 5000;
constexpr int kFwdCallTimeoutMs = 30000;

struct FpUpdRep {
  int64_t code = 0;
  int64_t update_ver = 0;
  int64_t commit_ver = 0;
  int64_t crc = 0;
  int64_t crc_len = 0;
};

// decode one UpdateReply off a BatchWriteRsp (5-field native replies and
// 6-field Python replies both appear on the wire; trailing-field rule)
bool fp_decode_update_reply(const uint8_t* d, size_t len, size_t& pos,
                            FpUpdRep& r) {
  uint64_t nf;
  if (!get_uvarint(d, len, pos, nf) || nf < 5 || nf > 6) return false;
  if (!get_int(d, len, pos, r.code)) return false;
  if (!get_int(d, len, pos, r.update_ver)) return false;
  if (!get_int(d, len, pos, r.commit_ver)) return false;
  uint64_t cf;
  if (!get_uvarint(d, len, pos, cf) || cf != 2) return false;
  if (!get_int(d, len, pos, r.crc)) return false;
  if (!get_int(d, len, pos, r.crc_len)) return false;
  uint64_t mlen;  // message: skipped (only the code/crc matter here)
  if (!get_uvarint(d, len, pos, mlen) || mlen > len - pos) return false;
  pos += mlen;
  if (nf >= 6) {
    int64_t ra;
    if (!get_int(d, len, pos, ra)) return false;
  }
  return true;
}

// encode one forwarded WriteReq: the C mirror of craq._make_forward_req —
// replace(req, from_target=<head>, update_ver=<staged>, chain_ver=<ours>),
// every other field (identity, seqnum, trusted_crc) passed through
// verbatim so the successor observes exactly what a Python head forwards.
void fp_put_forward_req(std::string& buf, const FpWReq& r,
                        uint64_t staged_ver, const FpHeadChain& hc) {
  put_uvarint(buf, 13);
  put_int(buf, r.chain_id);
  put_int(buf, hc.chain_ver);
  put_uvarint(buf, 2);  // ChunkId{file_id, index}
  put_int(buf, int64_t(r.file_id));
  put_int(buf, int64_t(r.index));
  put_int(buf, r.offset);
  put_uvarint(buf, 0);  // data: empty (the payload rides the bulk section)
  put_int(buf, r.chunk_size);
  put_uvarint(buf, r.client_id.size());
  buf.append(r.client_id);
  put_int(buf, r.channel_id);
  put_int(buf, r.seqnum);
  put_int(buf, int64_t(staged_ver));
  buf.push_back(r.full_replace ? 1 : 0);
  put_int(buf, hc.target_id);  // from_target: chain-internal marker
  put_int(buf, r.trusted_crc);
}

// one chain-forward round trip to the successor: batchUpdate with the
// staged versions, reusing a pooled connection when one is parked.
// Returns 0 and fills `reps` (one per forwarded op, in order) on a clean
// decode; negative on transport/shape trouble (-100 remote non-OK
// envelope, -101 reply shape mismatch) — every non-zero return means
// "fall back to Python", whose forwarder re-runs the idempotent hop.
int fp_forward_to_successor(Server* s, const FpHeadChain& hc,
                            const Packet& req,
                            const std::vector<FpWReq>& ops,
                            const std::vector<size_t>& fresh,
                            const std::vector<std::pair<uint64_t, uint64_t>>& segs,
                            const std::vector<FpOpResult>& staged,
                            std::vector<FpUpdRep>& reps) {
  std::string payload;
  put_uvarint(payload, 1);  // BatchWriteReq field count
  put_uvarint(payload, fresh.size());
  std::vector<const uint8_t*> ptrs(fresh.size());
  std::vector<size_t> lens(fresh.size());
  const uint8_t* blob = reinterpret_cast<const uint8_t*>(req.bulk.data());
  for (size_t j = 0; j < fresh.size(); j++) {
    fp_put_forward_req(payload, ops[fresh[j]], staged[j].ver, hc);
    ptrs[j] = blob + segs[fresh[j]].first;
    lens[j] = size_t(segs[fresh[j]].second);
  }
  std::string addr = hc.succ_host + ":" + std::to_string(hc.succ_port);
  void* cli = s->fwd_pool.take(addr);
  if (cli == nullptr) {
    cli = tpu3fs_rpc_client_connect(hc.succ_host.c_str(), hc.succ_port,
                                    kFwdConnectTimeoutMs, kFwdCallTimeoutMs);
    if (cli == nullptr) return -1;
  }
  Client* c = static_cast<Client*>(cli);
  int64_t status = 0;
  uint8_t* rsp = nullptr;
  size_t rsp_len = 0;
  int rc;
  {
    std::lock_guard<std::mutex> g(c->mu);
    rc = client_send_locked(c, kStorageServiceId, kBatchUpdateMethodId,
                            req.flags & 0xF00, req.message.c_str(),
                            reinterpret_cast<const uint8_t*>(payload.data()),
                            payload.size(), ptrs.data(), lens.data(),
                            int64_t(fresh.size()));
    if (rc == 0)
      rc = client_recv_locked(c, &status, &rsp, &rsp_len, nullptr, nullptr,
                              nullptr, nullptr, nullptr);
  }
  if (rc != 0) {
    tpu3fs_rpc_client_close(cli);  // transport trouble: never park it
    return rc;
  }
  if (!s->fwd_pool.put(addr, cli)) tpu3fs_rpc_client_close(cli);
  if (status != 0) {
    if (rsp != nullptr) free(rsp);
    return -100;  // remote shed/error envelope: Python owns the retry
  }
  size_t pos = 0;
  uint64_t nfields = 0, count = 0;
  bool ok = get_uvarint(rsp, rsp_len, pos, nfields) && nfields == 1 &&
            get_uvarint(rsp, rsp_len, pos, count) && count == fresh.size();
  if (ok) {
    reps.resize(count);
    for (uint64_t i = 0; ok && i < count; i++)
      ok = fp_decode_update_reply(rsp, rsp_len, pos, reps[i]);
  }
  if (rsp != nullptr) free(rsp);
  return ok ? 0 : -101;
}

// Serve a head-side write/batchWrite end-to-end without the GIL:
// decode -> registry guards -> QoS/tenant gates -> exactly-once channel
// check -> per-chunk locks -> engine stage (CRC32C inside ce_batch_update)
// -> chain forward -> successor checksum cross-check -> commit -> encode.
// ANY condition the C side can't prove returns FPW_FALLBACK with every
// gate take refunded and no state mutated beyond idempotent stages — the
// Python dispatch then serves the identical request from scratch.
FpWriteOutcome fp_try_head_write(Server* s, const Packet& req, bool single,
                                 std::string& out_payload,
                                 int64_t& out_status, std::string& out_msg) {
  FpState& fp = s->fastpath;
  if (!req.has_bulk) return FPW_FALLBACK;  // inline payloads: Python path
  uint64_t class_code = uint64_t((req.flags >> 8) & 0xF);
  if (class_code == 10) return FPW_FALLBACK;  // KVCACHE: kv_charge is Python
  // decode ops + bulk segments
  std::vector<FpWReq> ops;
  const uint8_t* d = reinterpret_cast<const uint8_t*>(req.payload.data());
  if (single) {
    size_t pos = 0;
    FpWReq r;
    if (!fp_decode_write_one(d, req.payload.size(), pos, r) ||
        pos != req.payload.size())
      return FPW_FALLBACK;
    ops.push_back(std::move(r));
  } else {
    if (!fp_decode_write_reqs(d, req.payload.size(), ops))
      return FPW_FALLBACK;
  }
  std::vector<std::pair<uint64_t, uint64_t>> segs;
  if (!fp_split_bulk(req.bulk, segs) || segs.size() != ops.size())
    return FPW_FALLBACK;
  // registry snapshot + per-op guards (every guard mirrors a Python-path
  // precondition the head would check; anything else falls back)
  FpHeadChain hc;
  fp_batch_write_t stage_fn;
  fp_batch_commit_t commit_fn;
  std::vector<std::array<uint8_t, 12>> keys(ops.size());
  {
    std::lock_guard<std::mutex> g(fp.mu);
    stage_fn = fp.batch_stage;
    commit_fn = fp.batch_commit;
    if (stage_fn == nullptr || commit_fn == nullptr ||
        fp.head_chains.empty())
      return FPW_FALLBACK;
    auto it = fp.head_chains.find(ops[0].chain_id);
    if (it == fp.head_chains.end()) return FPW_FALLBACK;
    hc = it->second;
    std::set<std::array<uint8_t, 12>> seen;
    for (size_t i = 0; i < ops.size(); i++) {
      const FpWReq& r = ops[i];
      if (r.chain_id != ops[0].chain_id) return FPW_FALLBACK;
      if (r.chain_ver != hc.chain_ver) return FPW_FALLBACK;
      // chain-internal hops (resync, forwarded), client-pinned versions
      // and full replaces keep Python's richer semantics
      if (r.from_target != 0 || r.update_ver != 0) return FPW_FALLBACK;
      if (r.full_replace) return FPW_FALLBACK;
      if (r.chunk_size != 0 && uint64_t(r.chunk_size) != hc.chunk_size)
        return FPW_FALLBACK;
      if (r.offset < 0 ||
          uint64_t(r.offset) + segs[i].second > hc.chunk_size)
        return FPW_FALLBACK;
      if (segs[i].second == 0) return FPW_FALLBACK;  // zero-len: Python
      std::array<uint8_t, 12>& key = keys[i];  // >QI big-endian
      for (int b = 0; b < 8; b++)
        key[b] = uint8_t(r.file_id >> (8 * (7 - b)));
      for (int b = 0; b < 4; b++)
        key[8 + b] = uint8_t(r.index >> (8 * (3 - b)));
      if (!seen.insert(key).second)
        return FPW_FALLBACK;  // same-chunk dups keep Python's ordered path
    }
    fp.inflight.fetch_add(1);
  }
  struct InflightGuard {
    FpState& fp;
    ~InflightGuard() { fp.inflight.fetch_sub(1); }
  } guard{fp};
  // admission gates, the cost shape of craq._admit_write: iops cost = op
  // count, bytes = payload sum (post-charged). Fast-path-served writes
  // never reach Python's AdmissionController, so the limits bind HERE;
  // every later fallback refunds because Python charges the op again.
  double cost = double(ops.size());
  uint64_t nbytes = 0;
  for (auto& sg : segs) nbytes += sg.second;
  int64_t gate_code = int64_t(class_code);
  if (gate_code == 0)  // untagged: infer like craq.infer_write_class
    gate_code = ops[0].client_id.rfind("migration-", 0) == 0 ? 6 : 2;
  QosBucket* cb = s->qos.find_class(kStorageServiceId, gate_code);
  if (cb != nullptr) {
    int64_t ra = cb->try_take(s->qos.retry_after_ms, cost);
    if (ra > 0) {
      s->qos.shed.fetch_add(1);
      out_status = kOverloaded;
      out_msg = "retry_after_ms=" + std::to_string(ra) +
                " (native write gate)";
      return FPW_SHED;
    }
  }
  TenantGate* tg = nullptr;
  if ((s->qos.tenant_exempt_mask.load() & (1ull << uint64_t(gate_code))) ==
      0) {
    std::string tname = parse_tenant(req.message);
    tg = s->qos.find_tenant(tname.empty() ? "default" : tname);
  }
  if (tg != nullptr) {
    int64_t tra = tg->iops.try_take(s->qos.retry_after_ms, cost);
    if (tra == 0) {
      int64_t bra = tg->bytes_blocked_ms(s->qos.retry_after_ms);
      if (bra > 0) {
        tg->iops.put_back(cost);
        tra = bra;
      }
    }
    if (tra > 0) {
      if (cb != nullptr) cb->put_back(cost);
      s->qos.tenant_shed.fetch_add(1);
      out_status = kTenantThrottled;
      out_msg = "retry_after_ms=" + std::to_string(tra) +
                " (native tenant gate)";
      return FPW_SHED;
    }
  }
  auto refund = [&] {
    if (cb != nullptr) cb->put_back(cost);
    if (tg != nullptr) tg->iops.put_back(cost);
  };
  // exactly-once channel pre-check (the shared C mirror of the head's
  // _ChannelTable): cached duplicates replay their stored reply, stale
  // seqnums answer CHUNK_STALE_UPDATE, fresh ops proceed to the engine
  std::vector<std::string> slots(ops.size());
  std::vector<size_t> fresh;
  for (size_t i = 0; i < ops.size(); i++) {
    const FpWReq& r = ops[i];
    if (r.client_id.empty() || r.channel_id == 0) {
      fresh.push_back(i);
      continue;
    }
    std::string ck = ChanTable::key_of(r.client_id, r.channel_id);
    int crc_ = s->channels.check(ck, r.seqnum, &slots[i]);
    if (crc_ == 1) continue;  // cached duplicate: slots[i] holds the reply
    if (crc_ == 2) {
      slots[i].clear();
      fp_put_update_reply(slots[i], 502, 0, 0, 0, 0, "stale seqnum");
      continue;
    }
    fresh.push_back(i);
  }
  if (!fresh.empty()) {
    // per-chunk interlock shared with the Python write paths: stage ->
    // forward -> commit is atomic per chunk across BOTH dispatch planes
    std::vector<std::string> lock_keys;
    lock_keys.reserve(fresh.size());
    for (size_t j : fresh)
      lock_keys.emplace_back(reinterpret_cast<const char*>(keys[j].data()),
                             12);
    s->chunk_locks.lock_keys(lock_keys);
    struct UnlockGuard {
      ChunkLocks& locks;
      const std::vector<std::string>& keys;
      ~UnlockGuard() { locks.unlock_keys(keys); }
    } unlock{s->chunk_locks, lock_keys};
    // stage on the head engine: ce_batch_update assigns committed+1,
    // computes CRC32C, appends ONE WAL record — all under one mutex
    const uint8_t* blob = reinterpret_cast<const uint8_t*>(req.bulk.data());
    std::vector<FpUpOp> wops(fresh.size());
    std::vector<FpOpResult> staged(fresh.size());
    for (size_t j = 0; j < fresh.size(); j++) {
      const FpWReq& r = ops[fresh[j]];
      FpUpOp& o = wops[j];
      memset(&o, 0, sizeof(o));
      memcpy(o.key, keys[fresh[j]].data(), 12);
      o.flags = hc.reject_create ? 8 : 0;  // near-full: no new chunks
      o.offset = uint32_t(r.offset);
      o.data_len = uint32_t(segs[fresh[j]].second);
      o.chunk_size = uint32_t(hc.chunk_size);
      o.data_off = segs[fresh[j]].first;
      o.update_ver = 0;  // head assigns committed+1
    }
    if (stage_fn(hc.engine, uint64_t(hc.chain_ver), blob, wops.data(),
                 staged.data(), int(fresh.size())) != 0) {
      refund();
      return FPW_FALLBACK;
    }
    for (auto& st : staged) {
      if (st.rc != 0) {  // NO_SPACE/IO/...: Python re-runs & phrases it
        refund();
        return FPW_FALLBACK;
      }
    }
    // chain forward + the successor checksum cross-check the Python head
    // performs; the planted chaos bug native_commit_skip_crc turns this
    // into a fire-and-forget hop (commit + ack with NO verification)
    bool skip = fp.skip_crc.load();
    if (hc.succ_port > 0) {
      double t0 = mono_now();
      std::vector<FpUpdRep> reps;
      int frc = fp_forward_to_successor(s, hc, req, ops, fresh, segs,
                                        staged, reps);
      fp.forward_us.fetch_add(
          uint64_t(std::max(0.0, (mono_now() - t0) * 1e6)));
      if (!skip) {
        if (frc != 0) {
          refund();
          return FPW_FALLBACK;  // stage is idempotent: Python re-runs
        }
        for (size_t j = 0; j < fresh.size(); j++) {
          if (reps[j].code != 0 ||
              uint32_t(reps[j].crc) != staged[j].crc) {
            refund();
            return FPW_FALLBACK;  // divergence: Python's mismatch path
          }
        }
      }
    }
    // commit the staged versions (idempotent: a fallback re-run commits
    // the same versions again harmlessly)
    std::string ckeys;
    ckeys.reserve(12 * fresh.size());
    std::vector<uint64_t> cvers(fresh.size());
    for (size_t j = 0; j < fresh.size(); j++) {
      ckeys.append(reinterpret_cast<const char*>(keys[fresh[j]].data()), 12);
      cvers[j] = staged[j].ver;
    }
    std::vector<FpOpResult> cres(fresh.size());
    if (commit_fn(hc.engine, uint64_t(hc.chain_ver),
                  reinterpret_cast<const uint8_t*>(ckeys.data()),
                  cvers.data(), cres.data(), int(fresh.size())) != 0) {
      refund();
      return FPW_FALLBACK;
    }
    for (auto& cr : cres) {
      if (cr.rc != 0) {
        refund();
        return FPW_FALLBACK;
      }
    }
    // encode replies + record them in the shared exactly-once table
    for (size_t j = 0; j < fresh.size(); j++) {
      const FpWReq& r = ops[fresh[j]];
      std::string& slot = slots[fresh[j]];
      slot.clear();
      fp_put_update_reply(slot, 0, int64_t(staged[j].ver),
                          int64_t(cres[j].ver), staged[j].crc,
                          staged[j].len);
      if (!r.client_id.empty() && r.channel_id != 0)
        s->channels.store(ChanTable::key_of(r.client_id, r.channel_id),
                          r.seqnum,
                          reinterpret_cast<const uint8_t*>(slot.data()),
                          slot.size());
    }
  }
  out_payload.clear();
  if (single) {
    out_payload = slots[0];
  } else {
    put_uvarint(out_payload, 1);  // BatchWriteRsp field count
    put_uvarint(out_payload, ops.size());
    for (auto& slot : slots) out_payload += slot;
  }
  if (tg != nullptr) tg->charge_bytes(double(nbytes));
  fp.write_served.fetch_add(1);
  return FPW_SERVED;
}

}  // namespace

// returns 0 on transport success (out_status carries the remote status code);
// negative on transport failure: -1 send failed, -2 recv failed/timeout,
// -3 decode failed, -4 uuid mismatch, -5 request exceeds kMaxPacket
// (found before any bytes moved: the connection is still healthy),
// -6 recv without a pending send.
//
// Bulk riders: n_iovs < 0 means "no bulk section" (a plain call);
// n_iovs >= 0 sends kFlagBulk with the given segments gathered into
// writev straight from the caller's buffers (n_iovs == 0 is the empty
// section that asks the server to reply in bulk). On success with a
// bulk reply, *out_bulk is the malloc'd raw section (*out_has_bulk = 1).
// `flags` carries extra envelope flag bits (QoS traffic class). A bulk
// reply's *out_bulk is the malloc'd FRAME buffer with the raw section at
// *out_bulk_off (zero-copy hand-off — the caller views it in place and
// frees the buffer when done).
int tpu3fs_rpc_client_call3(void* cli, int64_t service_id, int64_t method_id,
                            int64_t flags, const char* msg,
                            const uint8_t* req, size_t req_len,
                            const uint8_t* const* iov_ptrs,
                            const size_t* iov_lens, int64_t n_iovs,
                            int64_t* out_status, uint8_t** out_rsp,
                            size_t* out_rsp_len, uint8_t** out_bulk,
                            size_t* out_bulk_off, size_t* out_bulk_len,
                            int* out_has_bulk, char** out_msg) {
  auto* c = static_cast<Client*>(cli);
  std::lock_guard<std::mutex> g(c->mu);
  int rc = client_send_locked(c, service_id, method_id, flags, msg, req,
                              req_len, iov_ptrs, iov_lens, n_iovs);
  if (rc != 0) return rc;
  return client_recv_locked(c, out_status, out_rsp, out_rsp_len, out_bulk,
                            out_bulk_off, out_bulk_len, out_has_bulk,
                            out_msg);
}

// pipelined split of call3: issue the request now, collect the reply
// later — the caller may send on MANY connections before receiving any
// reply (the striped multi-connection read fan-out). One in-flight
// request per connection; the Python side serializes send..recv pairs
// per connection with its own lease lock.
int tpu3fs_rpc_client_send(void* cli, int64_t service_id, int64_t method_id,
                           int64_t flags, const char* msg,
                           const uint8_t* req, size_t req_len,
                           const uint8_t* const* iov_ptrs,
                           const size_t* iov_lens, int64_t n_iovs) {
  auto* c = static_cast<Client*>(cli);
  std::lock_guard<std::mutex> g(c->mu);
  return client_send_locked(c, service_id, method_id, flags, msg, req,
                            req_len, iov_ptrs, iov_lens, n_iovs);
}

int tpu3fs_rpc_client_recv(void* cli, int64_t* out_status, uint8_t** out_rsp,
                           size_t* out_rsp_len, uint8_t** out_bulk,
                           size_t* out_bulk_off, size_t* out_bulk_len,
                           int* out_has_bulk, char** out_msg) {
  auto* c = static_cast<Client*>(cli);
  std::lock_guard<std::mutex> g(c->mu);
  return client_recv_locked(c, out_status, out_rsp, out_rsp_len, out_bulk,
                            out_bulk_off, out_bulk_len, out_has_bulk,
                            out_msg);
}

int tpu3fs_rpc_client_call(void* cli, int64_t service_id, int64_t method_id,
                           const uint8_t* req, size_t req_len,
                           int64_t* out_status, uint8_t** out_rsp,
                           size_t* out_rsp_len, char** out_msg) {
  return tpu3fs_rpc_client_call3(cli, service_id, method_id, 0, nullptr,
                                 req, req_len,
                                 nullptr, nullptr, -1, out_status, out_rsp,
                                 out_rsp_len, nullptr, nullptr, nullptr,
                                 nullptr, out_msg);
}

void tpu3fs_rpc_client_close(void* cli) {
  if (!cli) return;
  auto* c = static_cast<Client*>(cli);
  ::close(c->fd);
  delete c;
}

// ---- storage read fast path control (see FpState) -------------------------

// install the chunk engine's ce_batch_read (a raw fn pointer — the engine
// .so lives in this same process; Python hands the address over via ctypes)
void tpu3fs_rpc_fastpath_install(void* srv, void* batch_read_fn) {
  auto* s = static_cast<Server*>(srv);
  std::lock_guard<std::mutex> g(s->fastpath.mu);
  s->fastpath.batch_read = reinterpret_cast<fp_batch_read_t>(batch_read_fn);
}

void tpu3fs_rpc_fastpath_set_target(void* srv, int64_t target_id,
                                    void* engine, int64_t chain_id,
                                    uint64_t chunk_size) {
  auto* s = static_cast<Server*>(srv);
  std::lock_guard<std::mutex> g(s->fastpath.mu);
  s->fastpath.targets[target_id] = FpTarget{engine, chain_id, chunk_size};
}

// drain in-flight fast-path reads: after erasing entries, wait for every
// reader that resolved BEFORE the erase to leave its engine call, so the
// caller may ce_close the engine as soon as del/clear returns
void fp_drain(FpState& fp) {
  while (fp.inflight.load() > 0)
    std::this_thread::sleep_for(std::chrono::microseconds(50));
}

void tpu3fs_rpc_fastpath_del_target(void* srv, int64_t target_id) {
  auto* s = static_cast<Server*>(srv);
  {
    std::lock_guard<std::mutex> g(s->fastpath.mu);
    s->fastpath.targets.erase(target_id);
    // write registry is keyed by chain; drop any entry whose tail is this
    // target (offline_target's immediate-refusal contract covers writes)
    for (auto it = s->fastpath.write_chains.begin();
         it != s->fastpath.write_chains.end();) {
      if (it->second.target_id == target_id)
        it = s->fastpath.write_chains.erase(it);
      else
        ++it;
    }
    for (auto it = s->fastpath.head_chains.begin();
         it != s->fastpath.head_chains.end();) {
      if (it->second.target_id == target_id)
        it = s->fastpath.head_chains.erase(it);
      else
        ++it;
    }
  }
  fp_drain(s->fastpath);
}

void tpu3fs_rpc_fastpath_clear(void* srv) {
  auto* s = static_cast<Server*>(srv);
  {
    std::lock_guard<std::mutex> g(s->fastpath.mu);
    s->fastpath.targets.clear();
    s->fastpath.write_chains.clear();
    s->fastpath.head_chains.clear();
  }
  fp_drain(s->fastpath);
}

// ---- write fast path control ----------------------------------------------

void tpu3fs_rpc_fastpath_install_write(void* srv, void* batch_write_fn) {
  auto* s = static_cast<Server*>(srv);
  std::lock_guard<std::mutex> g(s->fastpath.mu);
  s->fastpath.batch_write =
      reinterpret_cast<fp_batch_write_t>(batch_write_fn);
}

void tpu3fs_rpc_fastpath_set_write_chain(void* srv, int64_t chain_id,
                                         void* engine, int64_t target_id,
                                         int64_t chain_ver,
                                         uint64_t chunk_size) {
  auto* s = static_cast<Server*>(srv);
  std::lock_guard<std::mutex> g(s->fastpath.mu);
  s->fastpath.write_chains[chain_id] =
      FpWriteChain{engine, target_id, chain_ver, chunk_size};
}

// hits and fallbacks, for tests and metrics
// ---- cheap QoS ceiling configuration (see QosState above) ------------------
// Configured by tpu3fs/rpc/native_net.py from QosConfig.native_ceiling_*;
// re-synced on every hot config update via the controller's reload hook.

void tpu3fs_rpc_qos_set(void* srv, int64_t service_id, double rate_per_s,
                        double burst, int64_t retry_after_ms) {
  Server* s = static_cast<Server*>(srv);
  if (s == nullptr) return;
  std::lock_guard<std::mutex> g(s->qos.mu);
  auto& slot = s->qos.buckets[service_id];
  if (!slot) slot = std::make_unique<QosBucket>();
  std::lock_guard<std::mutex> bg(slot->mu);
  slot->rate = rate_per_s;
  slot->burst = std::max(1.0, burst);
  slot->tokens = slot->burst;
  slot->last_s = mono_now();
  if (retry_after_ms > 0) s->qos.retry_after_ms = retry_after_ms;
}

// per-(service, traffic class) gate for natively-served ops (the read
// fast path): class_code is the envelope's 4-bit class field
// ((flags >> 8) & 0xF; 0 = untagged). Consulted ONLY by the fast-path
// branch — Python-dispatched ops are admitted by the Python controller,
// and a fast-path fallback refunds its take so no op pays twice.
void tpu3fs_rpc_qos_set_class(void* srv, int64_t service_id,
                              int64_t class_code, double rate_per_s,
                              double burst, int64_t retry_after_ms) {
  Server* s = static_cast<Server*>(srv);
  if (s == nullptr) return;
  std::lock_guard<std::mutex> g(s->qos.mu);
  auto& slot =
      s->qos.class_buckets[(service_id << 8) | (class_code & 0xF)];
  if (!slot) slot = std::make_unique<QosBucket>();
  std::lock_guard<std::mutex> bg(slot->mu);
  slot->rate = rate_per_s;
  slot->burst = std::max(1.0, burst);
  slot->tokens = slot->burst;
  slot->last_s = mono_now();
  if (retry_after_ms > 0) s->qos.retry_after_ms = retry_after_ms;
}

void tpu3fs_rpc_qos_clear(void* srv) {
  Server* s = static_cast<Server*>(srv);
  if (s == nullptr) return;
  // disable rather than erase: a worker may hold a bucket pointer from
  // QosState::find while this runs, so buckets live as long as the server
  std::lock_guard<std::mutex> g(s->qos.mu);
  for (auto& kv : s->qos.buckets) {
    std::lock_guard<std::mutex> bg(kv.second->mu);
    kv.second->rate = 0.0;
  }
  for (auto& kv : s->qos.class_buckets) {
    std::lock_guard<std::mutex> bg(kv.second->mu);
    kv.second->rate = 0.0;
  }
}

uint64_t tpu3fs_rpc_qos_shed_count(void* srv) {
  Server* s = static_cast<Server*>(srv);
  return s == nullptr ? 0 : s->qos.shed.load();
}

// ---- per-tenant fast-path gate configuration (see TenantGate above) --------
// Installed from the [tenants] quota table by tpu3fs/rpc/native_net.py
// (re-synced on hot pushes via TenantRegistry.add_reload_hook). Rates
// <= 0 = unlimited on that axis, matching tenant/quota.py.

void tpu3fs_rpc_tenant_set(void* srv, const char* tenant, double iops_rate,
                           double iops_burst, double bytes_rate,
                           double bytes_burst) {
  Server* s = static_cast<Server*>(srv);
  if (s == nullptr || tenant == nullptr) return;
  std::lock_guard<std::mutex> g(s->qos.mu);
  auto& slot = s->qos.tenant_gates[std::string(tenant)];
  if (!slot) slot = std::make_unique<TenantGate>();
  {
    std::lock_guard<std::mutex> bg(slot->iops.mu);
    slot->iops.rate = iops_rate;
    slot->iops.burst = std::max(1.0, iops_burst);
    slot->iops.tokens = slot->iops.burst;
    slot->iops.last_s = mono_now();
  }
  {
    std::lock_guard<std::mutex> bg(slot->bytes.mu);
    slot->bytes.rate = bytes_rate;
    slot->bytes.burst = std::max(1.0, bytes_burst);
    slot->bytes.tokens = slot->bytes.burst;
    slot->bytes.last_s = mono_now();
  }
}

void tpu3fs_rpc_tenant_clear(void* srv) {
  Server* s = static_cast<Server*>(srv);
  if (s == nullptr) return;
  // disable rather than erase (same lifetime rule as qos_clear): a
  // worker may hold a gate pointer from find_tenant while this runs
  std::lock_guard<std::mutex> g(s->qos.mu);
  for (auto& kv : s->qos.tenant_gates) {
    std::lock_guard<std::mutex> ig(kv.second->iops.mu);
    kv.second->iops.rate = 0.0;
    std::lock_guard<std::mutex> bg(kv.second->bytes.mu);
    kv.second->bytes.rate = 0.0;
  }
}

void tpu3fs_rpc_tenant_exempt_classes(void* srv, uint64_t mask) {
  Server* s = static_cast<Server*>(srv);
  if (s != nullptr) s->qos.tenant_exempt_mask.store(mask);
}

uint64_t tpu3fs_rpc_tenant_shed_count(void* srv) {
  Server* s = static_cast<Server*>(srv);
  return s == nullptr ? 0 : s->qos.tenant_shed.load();
}

void tpu3fs_rpc_fastpath_stats(void* srv, uint64_t* hits,
                               uint64_t* fallbacks) {
  auto* s = static_cast<Server*>(srv);
  if (hits != nullptr) *hits = s->fastpath.hits.load();
  if (fallbacks != nullptr) *fallbacks = s->fastpath.fallbacks.load();
}

// ---- head-side write fast path control (ABI v5) ---------------------------
// Registered per sync tick by tpu3fs/storage/native_fastpath.py: the
// engine stage/commit entry points plus, per eligible chain, the local
// head target and the socket route to its successor.

void tpu3fs_rpc_fastpath_install_head(void* srv, void* stage_fn,
                                      void* commit_fn) {
  auto* s = static_cast<Server*>(srv);
  std::lock_guard<std::mutex> g(s->fastpath.mu);
  s->fastpath.batch_stage = reinterpret_cast<fp_batch_write_t>(stage_fn);
  s->fastpath.batch_commit = reinterpret_cast<fp_batch_commit_t>(commit_fn);
}

void tpu3fs_rpc_fastpath_set_head_chain(void* srv, int64_t chain_id,
                                        void* engine, int64_t target_id,
                                        int64_t chain_ver,
                                        uint64_t chunk_size,
                                        int reject_create,
                                        const char* succ_host,
                                        int succ_port) {
  auto* s = static_cast<Server*>(srv);
  std::lock_guard<std::mutex> g(s->fastpath.mu);
  FpHeadChain hc;
  hc.engine = engine;
  hc.target_id = target_id;
  hc.chain_ver = chain_ver;
  hc.chunk_size = chunk_size;
  hc.reject_create = reject_create != 0;
  hc.succ_host = succ_host == nullptr ? "" : succ_host;
  hc.succ_port = succ_port;
  s->fastpath.head_chains[chain_id] = std::move(hc);
}

// planted chaos bug native_commit_skip_crc (tpu3fs/chaos/bugs.py): armed
// per sync tick when the bug fires — the head commits + acks without
// verifying the successor's result
void tpu3fs_rpc_fastpath_skip_crc(void* srv, int enable) {
  auto* s = static_cast<Server*>(srv);
  s->fastpath.skip_crc.store(enable != 0);
}

void tpu3fs_rpc_fastpath_write_stats(void* srv, uint64_t* served,
                                     uint64_t* fallbacks,
                                     uint64_t* forward_us) {
  auto* s = static_cast<Server*>(srv);
  if (served != nullptr) *served = s->fastpath.write_served.load();
  if (fallbacks != nullptr) *fallbacks = s->fastpath.write_fallbacks.load();
  if (forward_us != nullptr) *forward_us = s->fastpath.forward_us.load();
}

// ---- shared exactly-once channel table (see ChanTable above) --------------
// The Python head swaps its _ChannelTable for a wrapper over these when
// the native write path is live, so duplicates dedupe across BOTH
// dispatch planes. -> 0 fresh, 1 cached (*out_reply malloc'd), 2 stale.

int tpu3fs_rpc_chan_check(void* srv, const char* client_id,
                          int64_t channel_id, int64_t seqnum,
                          uint8_t** out_reply, size_t* out_len) {
  auto* s = static_cast<Server*>(srv);
  if (out_reply != nullptr) *out_reply = nullptr;
  if (out_len != nullptr) *out_len = 0;
  if (client_id == nullptr || client_id[0] == 0 || channel_id == 0)
    return 0;
  std::string stored;
  int rc = s->channels.check(ChanTable::key_of(client_id, channel_id),
                             seqnum, &stored);
  if (rc == 1 && out_reply != nullptr && out_len != nullptr) {
    *out_reply = static_cast<uint8_t*>(malloc(stored.size() + 1));
    memcpy(*out_reply, stored.data(), stored.size());
    *out_len = stored.size();
  }
  return rc;
}

void tpu3fs_rpc_chan_store(void* srv, const char* client_id,
                           int64_t channel_id, int64_t seqnum,
                           const uint8_t* reply, size_t len) {
  auto* s = static_cast<Server*>(srv);
  if (client_id == nullptr || client_id[0] == 0 || channel_id == 0) return;
  s->channels.store(ChanTable::key_of(client_id, channel_id), seqnum,
                    reply, len);
}

uint64_t tpu3fs_rpc_chan_prune(void* srv, const char* client_id) {
  auto* s = static_cast<Server*>(srv);
  if (client_id == nullptr || client_id[0] == 0) return 0;
  return uint64_t(s->channels.prune_client(client_id));
}

uint64_t tpu3fs_rpc_chan_len(void* srv) {
  auto* s = static_cast<Server*>(srv);
  return uint64_t(s->channels.size());
}

// ---- shared per-chunk write interlock (see ChunkLocks above) --------------
// `keys` is n concatenated 12-byte chunk keys. The Python write paths
// take these AFTER their own per-chunk locks whenever the native head
// path is registered (the ctypes call releases the GIL, so blocking here
// while a native worker holds the chunk is safe).

void tpu3fs_rpc_chunk_lock(void* srv, const uint8_t* keys, int n) {
  auto* s = static_cast<Server*>(srv);
  std::vector<std::string> ks;
  ks.reserve(size_t(n));
  for (int i = 0; i < n; i++)
    ks.emplace_back(reinterpret_cast<const char*>(keys + 12 * i), 12);
  s->chunk_locks.lock_keys(ks);
}

void tpu3fs_rpc_chunk_unlock(void* srv, const uint8_t* keys, int n) {
  auto* s = static_cast<Server*>(srv);
  std::vector<std::string> ks;
  ks.reserve(size_t(n));
  for (int i = 0; i < n; i++)
    ks.emplace_back(reinterpret_cast<const char*>(keys + 12 * i), 12);
  s->chunk_locks.unlock_keys(ks);
}

// ---- out-of-loop serve entry (the USRBIO ring host) -----------------------
// Lets a request that arrived OUTSIDE the socket loop (shm ring SQEs)
// ride the same native write machinery: the Python ring host hands the
// decoded frame fields here (the ctypes call releases the GIL for the
// whole stage/forward/commit). Returns 1 when served (*out_status +
// malloc'd *out_payload/*out_msg filled), 0 when the caller must run the
// Python dispatch.
int tpu3fs_rpc_fastpath_serve(void* srv, int64_t service_id,
                              int64_t method_id, int64_t flags,
                              const char* msg, const uint8_t* payload,
                              size_t payload_len,
                              const uint8_t* const* iov_ptrs,
                              const size_t* iov_lens, int64_t n_iovs,
                              int64_t* out_status, uint8_t** out_payload,
                              size_t* out_len, char** out_msg) {
  auto* s = static_cast<Server*>(srv);
  *out_status = OK;
  *out_payload = nullptr;
  *out_len = 0;
  *out_msg = nullptr;
  if (service_id != kStorageServiceId) return 0;
  bool head_write =
      method_id == kWriteMethodId || method_id == kBatchWriteMethodId;
  if (!head_write && method_id != kBatchUpdateMethodId) return 0;
  Packet req;
  req.service_id = service_id;
  req.method_id = method_id;
  req.flags = flags;
  if (msg != nullptr) req.message = msg;
  req.payload.assign(reinterpret_cast<const char*>(payload), payload_len);
  req.has_bulk = n_iovs >= 0;
  if (req.has_bulk) {  // rebuild the wire bulk section from the segments
    std::string bulk;
    put_uvarint(bulk, uint64_t(n_iovs));
    for (int64_t i = 0; i < n_iovs; i++) put_uvarint(bulk, iov_lens[i]);
    for (int64_t i = 0; i < n_iovs; i++)
      bulk.append(reinterpret_cast<const char*>(iov_ptrs[i]), iov_lens[i]);
    req.bulk = std::move(bulk);
  }
  std::string fp_payload;
  std::string fp_msg;
  int64_t fp_status = OK;
  if (head_write) {
    FpWriteOutcome out = FPW_FALLBACK;
    try {
      out = fp_try_head_write(s, req, method_id == kWriteMethodId,
                              fp_payload, fp_status, fp_msg);
    } catch (...) {
      out = FPW_FALLBACK;
    }
    if (out == FPW_FALLBACK) {
      s->fastpath.write_fallbacks.fetch_add(1);
      return 0;
    }
    *out_status = out == FPW_SERVED ? OK : fp_status;
  } else {
    bool handled = false;
    try {
      handled = fp_try_batch_write(s->fastpath, req, fp_payload);
    } catch (...) {
      handled = false;
    }
    if (!handled) {
      s->fastpath.fallbacks.fetch_add(1);
      return 0;
    }
  }
  *out_payload = static_cast<uint8_t*>(malloc(fp_payload.size() + 1));
  memcpy(*out_payload, fp_payload.data(), fp_payload.size());
  *out_len = fp_payload.size();
  if (!fp_msg.empty()) {
    *out_msg = static_cast<char*>(malloc(fp_msg.size() + 1));
    memcpy(*out_msg, fp_msg.data(), fp_msg.size());
    (*out_msg)[fp_msg.size()] = 0;
  }
  return 1;
}

}  // extern "C"
