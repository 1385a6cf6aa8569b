// tpu3fs USRBIO external load generator.
//
// The analogue of the reference's fio engine
// (benchmarks/fio_usrbio/hf3fs_usrbio.cpp): a FOREIGN process — no Python,
// no shared address space with the agent — that speaks the raw USRBIO ABI:
//
//   * shm segments in /dev/shm with the fixed struct layouts of
//     tpu3fs/usrbio/ring.py (_HDR/_SQE/_CQE little-endian structs),
//   * POSIX named semaphores ("/<ring>-sq", "/<ring>-cq") for wakeups,
//   * the 3fs-virt magic-symlink protocol through a kernel FUSE mount for
//     registration: symlink under 3fs-virt/iovs|iors registers buffers and
//     rings (fuse/ops.py:_virt_register), symlink under 3fs-virt/fds +
//     readlink-back assigns a virtual fd (the hf3fs_reg_fd handshake).
//
// Usage:
//   usrbio_loadgen <mountpoint> <file-mib> <block-kib> <depth> <iters> [rw]
//
// Writes a pattern file through the ring, reads it back through the ring,
// verifies every byte, prints one JSON line per phase.

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include <fcntl.h>
#include <semaphore.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <time.h>
#include <unistd.h>

namespace {

constexpr uint32_t kMagic = 0x3F5B10;
constexpr uint32_t kVersion = 2;  // ring ABI v2 (docs/usrbio_abi.md)
constexpr size_t kHdrSize = 64;
constexpr size_t kSqeSize = 224;  // <QQQQQiIHHQIHH156s (v2 extended SQE)
constexpr size_t kCqeSize = 24;   // <qQQ
constexpr uint32_t kSqeFlagRead = 1;

double now_s() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return double(ts.tv_sec) + double(ts.tv_nsec) * 1e-9;
}

struct Shm {
  uint8_t* base = nullptr;
  size_t size = 0;
  std::string path;

  bool create(const std::string& name, size_t n) {
    path = "/dev/shm/" + name;
    int fd = ::open(path.c_str(), O_RDWR | O_CREAT, 0600);
    if (fd < 0) return false;
    if (ftruncate(fd, off_t(n)) != 0) {
      ::close(fd);
      return false;
    }
    base = static_cast<uint8_t*>(
        mmap(nullptr, n, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0));
    ::close(fd);
    size = n;
    return base != MAP_FAILED;
  }

  void destroy() {
    if (base && base != MAP_FAILED) munmap(base, size);
    if (!path.empty()) unlink(path.c_str());
  }
};

// the ring counters are 8-byte aligned u64s at fixed offsets; cross-process
// single-producer/single-consumer, so release/acquire atomics suffice
struct Ring {
  Shm shm;
  uint32_t entries = 0;
  sem_t* sq_sem = nullptr;
  sem_t* cq_sem = nullptr;
  std::string name;

  uint64_t load(size_t off) const {
    return __atomic_load_n(
        reinterpret_cast<const uint64_t*>(shm.base + off), __ATOMIC_ACQUIRE);
  }
  void store(size_t off, uint64_t v) {
    __atomic_store_n(reinterpret_cast<uint64_t*>(shm.base + off), v,
                     __ATOMIC_RELEASE);
  }
  uint64_t sq_tail() const { return load(16); }
  uint64_t cq_head() const { return load(24); }
  uint64_t cq_tail() const { return load(32); }

  bool create(const std::string& ring_name, uint32_t n) {
    name = ring_name;
    entries = n;
    if (!shm.create(ring_name, kHdrSize + n * (kSqeSize + kCqeSize)))
      return false;
    memset(shm.base, 0, shm.size);
    memcpy(shm.base, &kMagic, 4);
    memcpy(shm.base + 4, &n, 4);
    // v2 header trailer: version + owner pid (offsets 40/44) — the
    // agent-side reaper collects rings whose stamped owner died
    uint32_t version = kVersion;
    uint32_t owner = uint32_t(getpid());
    memcpy(shm.base + 40, &version, 4);
    memcpy(shm.base + 44, &owner, 4);
    sq_sem = sem_open(("/" + ring_name + "-sq").c_str(), O_CREAT, 0644, 0);
    cq_sem = sem_open(("/" + ring_name + "-cq").c_str(), O_CREAT, 0644, 0);
    return sq_sem != SEM_FAILED && cq_sem != SEM_FAILED;
  }

  // -1 = ring full (in-flight bounded by unreaped CQEs, like the client)
  int prep(uint64_t iov_off, uint64_t len, uint64_t file_off, int32_t fd,
           bool read, uint64_t userdata, uint32_t iov_id) {
    uint64_t tail = sq_tail();
    if (tail - cq_head() >= entries) return -1;
    size_t slot = size_t(tail % entries);
    uint8_t* sqe = shm.base + kHdrSize + slot * kSqeSize;
    uint32_t flags = read ? kSqeFlagRead : 0;
    memset(sqe, 0, kSqeSize);  // rpc/rsp/token fields zero for file ops
    memcpy(sqe + 0, &iov_off, 8);
    memcpy(sqe + 8, &len, 8);
    memcpy(sqe + 16, &file_off, 8);
    memcpy(sqe + 40, &fd, 4);
    memcpy(sqe + 44, &flags, 4);
    memcpy(sqe + 52, &userdata, 8);
    memcpy(sqe + 60, &iov_id, 4);
    store(16, tail + 1);
    return int(slot);
  }

  void submit() { sem_post(sq_sem); }

  // reap up to max CQEs into out; returns count
  size_t reap(std::vector<std::pair<int64_t, uint64_t>>& out) {
    uint64_t head = cq_head(), tail = cq_tail();
    size_t got = 0;
    size_t cq_base = kHdrSize + size_t(entries) * kSqeSize;
    while (head < tail) {
      uint8_t* cqe = shm.base + cq_base + size_t(head % entries) * kCqeSize;
      int64_t result;
      uint64_t userdata;
      memcpy(&result, cqe, 8);
      memcpy(&userdata, cqe + 8, 8);
      out.emplace_back(result, userdata);
      head++;
      got++;
    }
    store(24, head);
    return got;
  }

  bool wait_cq(int timeout_s) {
    struct timespec ts;
    clock_gettime(CLOCK_REALTIME, &ts);
    ts.tv_sec += timeout_s;
    while (sem_timedwait(cq_sem, &ts) != 0) {
      if (errno == EINTR) continue;
      return false;
    }
    return true;
  }

  void destroy() {
    shm.destroy();
    if (sq_sem != SEM_FAILED && sq_sem != nullptr) sem_close(sq_sem);
    if (cq_sem != SEM_FAILED && cq_sem != nullptr) sem_close(cq_sem);
    sem_unlink(("/" + name + "-sq").c_str());
    sem_unlink(("/" + name + "-cq").c_str());
  }
};

bool make_symlink(const std::string& target, const std::string& link) {
  unlink(link.c_str());
  return symlink(target.c_str(), link.c_str()) == 0;
}

int die(const char* what) {
  fprintf(stderr, "usrbio_loadgen: %s: %s\n", what, strerror(errno));
  return 1;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 6) {
    fprintf(stderr,
            "usage: %s <mountpoint> <file-mib> <block-kib> <depth> <iters>\n",
            argv[0]);
    return 2;
  }
  std::string mnt = argv[1];
  size_t file_bytes = size_t(atol(argv[2])) << 20;
  size_t block = size_t(atol(argv[3])) << 10;
  uint32_t depth = uint32_t(atoi(argv[4]));
  int iters = atoi(argv[5]);
  pid_t pid = getpid();
  std::string tag = "lg" + std::to_string(pid);

  // 1. registered buffer (iov) + ring, created by THIS process
  Shm iov;
  size_t iov_bytes = block * depth;
  if (!iov.create("tpu3fs-iov-" + tag, iov_bytes)) return die("iov shm");
  Ring ring;
  if (!ring.create("tpu3fs-ior-" + tag, depth)) return die("ring shm");

  std::string virt = mnt + "/3fs-virt";
  if (!make_symlink(iov.path.substr(strlen("/dev/shm/")),
                    virt + "/iovs/" + tag))
    return die("iov register symlink");
  if (!make_symlink(ring.name + "?entries=" + std::to_string(depth) +
                        "&rw=r&prio=1&iov=" + tag,
                    virt + "/iors/" + tag))
    return die("ring register symlink");

  // 2. fd registration: symlink + readlink-back (hf3fs_reg_fd handshake)
  std::string fpath = "/bench-" + tag + ".bin";
  {  // create the file through the plain FUSE path first
    int fd = ::open((mnt + fpath).c_str(), O_WRONLY | O_CREAT, 0644);
    if (fd < 0) return die("create bench file");
    ::close(fd);
  }
  auto reg_fd = [&](const char* rw, const std::string& name) -> int {
    if (!make_symlink(fpath + "?rw=" + rw, virt + "/fds/" + name)) return -1;
    char buf[512];
    ssize_t n = readlink((virt + "/fds/" + name).c_str(), buf, sizeof(buf));
    if (n <= 0) return -1;
    std::string t(buf, size_t(n));
    auto pos = t.rfind("&fd=");
    if (pos == std::string::npos) return -1;
    return atoi(t.c_str() + pos + 4);
  };
  int wfd = reg_fd("w", tag + "-w");
  if (wfd < 0) return die("reg_fd write");

  size_t blocks_per_iter = file_bytes / block;
  std::vector<std::pair<int64_t, uint64_t>> cqes;

  // 3. write phase: pattern blocks through the ring
  double t0 = now_s();
  size_t wrote = 0;
  for (int it = 0; it < iters; it++) {
    size_t next = 0, inflight = 0, done = 0;
    while (done < blocks_per_iter) {
      while (next < blocks_per_iter && inflight < depth) {
        size_t slot_off = (next % depth) * block;
        // pattern: byte = (block_index + iteration) & 0xFF
        memset(iov.base + slot_off, int((next + size_t(it)) & 0xFF), block);
        if (ring.prep(slot_off, block, next * block, wfd, false,
                      next, 0) < 0)
          break;
        next++;
        inflight++;
      }
      ring.submit();
      if (!ring.wait_cq(60)) return die("cq wait (write)");
      cqes.clear();
      size_t got = ring.reap(cqes);
      for (auto& c : cqes) {
        if (c.first != int64_t(block)) {
          fprintf(stderr, "write cqe result %lld\n", (long long)c.first);
          return 1;
        }
      }
      done += got;
      inflight -= got;
      wrote += got;
    }
  }
  double wdt = now_s() - t0;
  printf("{\"metric\": \"usrbio_loadgen_write\", \"value\": %.3f, "
         "\"unit\": \"GiB/s\", \"iops\": %.1f, \"block\": %zu, "
         "\"depth\": %u}\n",
         double(wrote) * double(block) / wdt / (1 << 30),
         double(wrote) / wdt, block, depth);

  // 4. read phase: read back + verify the LAST iteration's pattern
  int rfd = reg_fd("r", tag + "-r");
  if (rfd < 0) return die("reg_fd read");
  t0 = now_s();
  size_t read_blocks = 0;
  for (int it = 0; it < iters; it++) {
    size_t next = 0, inflight = 0, done = 0;
    while (done < blocks_per_iter) {
      while (next < blocks_per_iter && inflight < depth) {
        if (ring.prep((next % depth) * block, block, next * block, rfd,
                      true, next, 0) < 0)
          break;
        next++;
        inflight++;
      }
      ring.submit();
      if (!ring.wait_cq(60)) return die("cq wait (read)");
      cqes.clear();
      size_t got = ring.reap(cqes);
      for (auto& c : cqes) {
        if (c.first != int64_t(block)) {
          fprintf(stderr, "read cqe result %lld\n", (long long)c.first);
          return 1;
        }
        uint8_t expect = uint8_t((c.second + size_t(iters - 1)) & 0xFF);
        uint8_t* blk = iov.base + (size_t(c.second) % depth) * block;
        for (size_t b = 0; b < block; b++) {
          if (blk[b] != expect) {
            fprintf(stderr, "verify fail block %llu byte %zu: %u != %u\n",
                    (unsigned long long)c.second, b, blk[b], expect);
            return 1;
          }
        }
      }
      done += got;
      inflight -= got;
      read_blocks += got;
    }
  }
  double rdt = now_s() - t0;
  printf("{\"metric\": \"usrbio_loadgen_read\", \"value\": %.3f, "
         "\"unit\": \"GiB/s\", \"iops\": %.1f, \"block\": %zu, "
         "\"depth\": %u, \"verified\": true}\n",
         double(read_blocks) * double(block) / rdt / (1 << 30),
         double(read_blocks) / rdt, block, depth);

  // 5. teardown through the same symlink protocol
  unlink((virt + "/fds/" + tag + "-w").c_str());
  unlink((virt + "/fds/" + tag + "-r").c_str());
  unlink((virt + "/iors/" + tag).c_str());
  unlink((virt + "/iovs/" + tag).c_str());
  unlink((mnt + fpath).c_str());
  ring.destroy();
  iov.destroy();
  return 0;
}
