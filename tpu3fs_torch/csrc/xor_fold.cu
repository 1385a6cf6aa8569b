// The chain ring's stand-in checksum: out[b] = XOR of row b's little-endian
// 32-bit words, the row zero-padded to a multiple of 4 bytes.
//
// Replaces the XLA-lowered tpu3fs/parallel/chain.py:_xor_fold_crc (:30-45),
// which the chain write uses when no CRC function is given.
//
// Bound on this card: memory. The kernel reads each input byte once and
// writes 4 bytes per row: at B = 12, S = 1 MiB that is 12.6 MB, 0.00376 ms
// at 3.35 TB/s. So the design is about bytes in flight and fixed costs.
//
// Design (entry tpu3fs_xor_fold): one launch, no memset; each output word
// is written once, by a plain store. The wrapper (ops/xor_fold.py,
// fold_plan) sizes the grid to the card and hands out work by bytes; the
// kernels derive their byte ranges from the plan's numbers alone:
//   route 0, rows: short rows; a block takes rows_per_cta whole rows, one
//     warp a row; the dry run's (2, 128) is one block;
//   route 1, cluster: a row is split over the `cluster` blocks of one
//     thread-block cluster (at most 16); each block folds its share, the
//     cluster combines the shares through distributed shared memory and
//     rank 0 stores the word;
//   route 2, grid: long rows (over 16 x 128 KiB) too few to give clusters
//     half the SMs (1 x 64 MiB): a cooperative grid cut by bytes over the
//     flat input, each block's range at most two rows; the blocks' partial
//     words go to a per-call workspace, and after a grid barrier block 0
//     folds them. The barrier and the cooperative launch cost about 2.6 us,
//     so this route is only for rows that 16 SMs would read slowly.
// A range (fold_span) is read in 16-byte loads, 16 of them in flight per
// thread before the first XOR (8 for a warp's row), over its
// 16-byte-aligned body; the
// body's word belongs at byte (start + t) % 4 of the fold, a rotation by
// the body's row offset mod 4. The ragged head and tail are read byte by
// byte, each byte shifted to its own lane. Any S and any base alignment
// take these paths.
//
// Entry tpu3fs_xor_fold_atomic keeps the earlier form (a memset, then a
// grid of 32 KiB segments per row folding into the output with atomicXor)
// as the yardstick; the main path does not reach it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockLoads = 16;  // loads in flight a thread, block-wide folds
constexpr long long kMaxGridY = 65535;
constexpr long long kMaxGridRows = 64;  // route 2 takes at most this many rows

__device__ __forceinline__ uint32_t rotl_bytes(uint32_t x, int bytes) {
  return bytes ? (x << (8 * bytes)) | (x >> (32 - 8 * bytes)) : x;
}

__device__ __forceinline__ uint32_t warp_xor(uint32_t v) {
  for (int off = 16; off > 0; off >>= 1)
    v ^= __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The block's XOR of v, in thread 0 (others get a partial value).
__device__ __forceinline__ uint32_t block_xor(uint32_t v, uint32_t* scratch) {
  v = warp_xor(v);
  if (threadIdx.x % 32 == 0) scratch[threadIdx.x / 32] = v;
  __syncthreads();
  if (threadIdx.x == 0)
    for (int w = 1; w < kWarps; ++w) v ^= scratch[w];
  __syncthreads();  // scratch may be reused at once
  return v;
}

// Part r of n of a span of `len` bytes whose first byte lies at address
// `start`: the span's 16-byte-aligned body is cut into n runs of whole
// vectors; part 0 also takes the head before the body, part n - 1 the tail
// after it. [*lo, *hi) are offsets into the span. ops/xor_fold.py
// (_part_range) computes the same cut.
__device__ __forceinline__ void part_range(uintptr_t start, long long len,
                                           long long r, long long n,
                                           long long* lo, long long* hi) {
  long long head = static_cast<long long>((16 - start % 16) % 16);
  if (head > len) head = len;
  const long long nvec = (len - head) / 16;
  const long long per = (nvec + n - 1) / n;
  const long long a = r * per < nvec ? r * per : nvec;
  const long long b = (r + 1) * per < nvec ? (r + 1) * per : nvec;
  *lo = r == 0 ? 0 : head + 16 * a;
  *hi = r == n - 1 ? len : head + 16 * b;
}

// Thread t of n's share of the fold of bytes [a, b) of `row`, each byte at
// byte (row offset % 4) of the word; kLoads 16-byte loads in flight.
template <int kLoads>
__device__ __forceinline__ uint32_t fold_span(const uint8_t* __restrict__ row,
                                              long long a, long long b,
                                              int t, int n) {
  const long long len = b - a;
  if (len <= 0) return 0;
  const uint8_t* p = row + a;
  long long head = static_cast<long long>(
      (16 - reinterpret_cast<uintptr_t>(p) % 16) % 16);
  if (head > len) head = len;
  const long long nvec = (len - head) / 16;
  const uint4* body = reinterpret_cast<const uint4*>(p + head);
  uint32_t acc = 0;
  for (long long v = t; v < nvec; v += static_cast<long long>(kLoads) * n) {
    uint4 w[kLoads];
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const long long i = v + static_cast<long long>(k) * n;
      w[k] = i < nvec ? __ldg(body + i) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int k = 0; k < kLoads; ++k) acc ^= w[k].x ^ w[k].y ^ w[k].z ^ w[k].w;
  }
  acc = rotl_bytes(acc, static_cast<int>((a + head) % 4));
  for (long long o = t; o < head; o += n)
    acc ^= static_cast<uint32_t>(p[o]) << (8 * ((a + o) % 4));
  for (long long o = head + nvec * 16 + t; o < len; o += n)
    acc ^= static_cast<uint32_t>(p[o]) << (8 * ((a + o) % 4));
  return acc;
}

// Route 0: block g takes rows [g R, g R + R), one warp a row.
__global__ void __launch_bounds__(kThreads)
fold_rows_kernel(const uint8_t* __restrict__ x, uint32_t* __restrict__ out,
                 long long B, long long S, long long R) {
  const int lane = threadIdx.x % 32;
  const long long first = static_cast<long long>(blockIdx.x) * R;
  const long long end = first + R < B ? first + R : B;
  for (long long b = first + threadIdx.x / 32; b < end; b += kWarps) {
    const uint32_t acc = warp_xor(fold_span<8>(x + b * S, 0, S, lane, 32));
    if (lane == 0) out[b] = acc;
  }
}

// Route 1: the cluster of blocks (0..C-1, y) folds rows y, y + gridDim.y,
// ..., block r taking part r of C of each; rank 0 reads the blocks' words
// from their shared memory and stores the row's word.
__global__ void __launch_bounds__(kThreads)
fold_cluster_kernel(const uint8_t* __restrict__ x, uint32_t* __restrict__ out,
                    long long B, long long S) {
  __shared__ uint32_t scratch[kWarps];
  __shared__ uint32_t part;
  cg::cluster_group cluster = cg::this_cluster();
  const long long C = gridDim.x, r = blockIdx.x;  // cluster = (C, 1, 1)
  for (long long b = blockIdx.y; b < B; b += gridDim.y) {
    const uint8_t* row = x + b * S;
    long long lo, hi;
    part_range(reinterpret_cast<uintptr_t>(row), S, r, C, &lo, &hi);
    const uint32_t acc = block_xor(
        fold_span<kBlockLoads>(row, lo, hi, threadIdx.x, kThreads), scratch);
    if (threadIdx.x == 0) part = acc;
    cluster.sync();  // every word written, every block running
    if (r == 0 && threadIdx.x < 32) {
      uint32_t all = threadIdx.x < C
                         ? *cluster.map_shared_rank(&part, threadIdx.x) : 0;
      all = warp_xor(all);
      if (threadIdx.x == 0) out[b] = all;
    }
    cluster.sync();  // no block leaves or rewrites `part` before the read
  }
}

// Route 2: block i of G takes part i of G of the flat B x S input, which
// lies in at most two rows (the plan sees to it; B <= kMaxGridRows);
// ws[2 i], ws[2 i + 1] hold its words for the first row and the next.
__global__ void __launch_bounds__(kThreads)
fold_grid_kernel(const uint8_t* __restrict__ x, uint32_t* __restrict__ out,
                 uint32_t* __restrict__ ws, long long B, long long S) {
  __shared__ uint32_t scratch[kWarps];
  const long long T = B * S, G = gridDim.x, i = blockIdx.x;
  const uintptr_t base = reinterpret_cast<uintptr_t>(x);
  long long lo, hi;
  part_range(base, T, i, G, &lo, &hi);
  const long long r0 = lo / S;
  uint32_t acc0 = 0, acc1 = 0;
  if (lo < hi) {
    const long long split = hi < (r0 + 1) * S ? hi : (r0 + 1) * S;
    acc0 = fold_span<kBlockLoads>(x + r0 * S, lo - r0 * S, split - r0 * S,
                                  threadIdx.x, kThreads);
    if (split < hi)
      acc1 = fold_span<kBlockLoads>(x + (r0 + 1) * S, 0, hi - split,
                                    threadIdx.x, kThreads);
  }
  acc0 = block_xor(acc0, scratch);
  acc1 = block_xor(acc1, scratch);
  if (threadIdx.x == 0) {
    ws[2 * i] = acc0;
    ws[2 * i + 1] = acc1;
  }
  cg::this_grid().sync();
  if (i != 0) return;
  // block 0 folds the partials, one block j a thread at a time, into a
  // word a row in shared memory
  __shared__ uint32_t rows[kMaxGridRows];
  for (long long b = threadIdx.x; b < B; b += kThreads) rows[b] = 0;
  __syncthreads();
  for (long long j = threadIdx.x; j < G; j += kThreads) {
    long long lj, hj;
    part_range(base, T, j, G, &lj, &hj);
    const long long rj = lj / S;
    if (rj < B) atomicXor(rows + rj, __ldcg(ws + 2 * j));
    if (rj + 1 < B) atomicXor(rows + rj + 1, __ldcg(ws + 2 * j + 1));
  }
  __syncthreads();
  for (long long b = threadIdx.x; b < B; b += kThreads) out[b] = rows[b];
}

// The earlier form of this kernel: blocks of kSegVecs vectors per row,
// combined with atomicXor into an output zeroed first.
constexpr long long kSegVecs = 2048;   // 16-byte vectors per block and row
constexpr long long kMaxGrid = 65535;

__global__ void __launch_bounds__(kThreads)
xor_fold_atomic_kernel(const uint8_t* __restrict__ x,
                       uint32_t* __restrict__ out, long long B, long long S) {
  __shared__ uint32_t warp_acc[kWarps];
  const int tid = threadIdx.x;
  for (long long b = blockIdx.y; b < B; b += gridDim.y) {
    const uint8_t* row = x + b * S;
    long long head = (16 - static_cast<long long>(
                              reinterpret_cast<uintptr_t>(row) % 16)) % 16;
    if (head > S) head = S;
    const long long nvec = (S - head) / 16;
    const uint4* body = reinterpret_cast<const uint4*>(row + head);
    uint32_t acc = 0;
    for (long long lo = blockIdx.x * kSegVecs; lo < nvec;
         lo += gridDim.x * kSegVecs) {
      const long long hi = lo + kSegVecs < nvec ? lo + kSegVecs : nvec;
      long long v = lo + tid;
      for (; v + 3 * kThreads < hi; v += 4 * kThreads) {  // 4 loads in flight
        const uint4 w0 = body[v], w1 = body[v + kThreads];
        const uint4 w2 = body[v + 2 * kThreads], w3 = body[v + 3 * kThreads];
        acc ^= w0.x ^ w0.y ^ w0.z ^ w0.w ^ w1.x ^ w1.y ^ w1.z ^ w1.w;
        acc ^= w2.x ^ w2.y ^ w2.z ^ w2.w ^ w3.x ^ w3.y ^ w3.z ^ w3.w;
      }
      for (; v < hi; v += kThreads) {
        const uint4 w = body[v];
        acc ^= w.x ^ w.y ^ w.z ^ w.w;
      }
    }
    acc = rotl_bytes(acc, static_cast<int>(head % 4));
    if (blockIdx.x == 0) {  // the ragged ends, byte by byte
      for (long long o = tid; o < head; o += kThreads)
        acc ^= static_cast<uint32_t>(row[o]) << (8 * (o % 4));
      for (long long o = head + nvec * 16 + tid; o < S; o += kThreads)
        acc ^= static_cast<uint32_t>(row[o]) << (8 * (o % 4));
    }
    for (int off = 16; off > 0; off >>= 1)
      acc ^= __shfl_xor_sync(0xffffffffu, acc, off);
    if (tid % 32 == 0) warp_acc[tid / 32] = acc;
    __syncthreads();
    if (tid == 0) {
      uint32_t all = 0;
      for (int w = 0; w < kWarps; ++w) all ^= warp_acc[w];
      if (all) atomicXor(out + b, all);
    }
    __syncthreads();  // warp_acc is reused by the next row
  }
}

}  // namespace

// x: (B, S) uint8, contiguous, any alignment; out: (B,) 32-bit words;
// ws: 2 * grid words for route 2, else unused. route, grid, cluster and
// rows_per_cta come from ops/xor_fold.py:fold_plan.
extern "C" int tpu3fs_xor_fold(const void* x, void* out, void* ws,
                               long long B, long long S, long long route,
                               long long grid, long long cluster,
                               long long rows_per_cta, void* stream) {
  if (B <= 0 || S <= 0) return 0;  // nothing to launch
  if (grid <= 0 || grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  const uint8_t* xp = static_cast<const uint8_t*>(x);
  uint32_t* op = static_cast<uint32_t*>(out);
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  cfg.attrs = attr;
  cudaError_t rc;
  if (route == 0) {
    if (rows_per_cta <= 0 || grid * rows_per_cta < B)
      return cudaErrorInvalidValue;
    cfg.gridDim = dim3(static_cast<unsigned>(grid));
    rc = cudaLaunchKernelEx(&cfg, fold_rows_kernel, xp, op, B, S,
                            rows_per_cta);
  } else if (route == 1) {
    if (cluster < 1 || cluster > 16 || grid % cluster ||
        grid / cluster > kMaxGridY)
      return cudaErrorInvalidValue;
    static bool wide = false;  // a cluster of 9-16 blocks allowed
    if (cluster > 8 && !wide) {
      rc = cudaFuncSetAttribute(fold_cluster_kernel,
                                cudaFuncAttributeNonPortableClusterSizeAllowed,
                                1);
      if (rc != cudaSuccess) return static_cast<int>(rc);
      wide = true;
    }
    cfg.gridDim = dim3(static_cast<unsigned>(cluster),
                       static_cast<unsigned>(grid / cluster));
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.numAttrs = 1;
    rc = cudaLaunchKernelEx(&cfg, fold_cluster_kernel, xp, op, B, S);
  } else if (route == 2) {
    if (ws == nullptr || B > kMaxGridRows) return cudaErrorInvalidValue;
    cfg.gridDim = dim3(static_cast<unsigned>(grid));
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    cfg.numAttrs = 1;
    rc = cudaLaunchKernelEx(&cfg, fold_grid_kernel, xp, op,
                            static_cast<uint32_t*>(ws), B, S);
  } else {
    return cudaErrorInvalidValue;
  }
  if (rc != cudaSuccess) {
    cudaGetLastError();  // clear it: the wrapper raises on rc
    return static_cast<int>(rc);
  }
  return static_cast<int>(cudaGetLastError());
}

// The earlier form, kept as the yardstick: a memset of out, then the
// atomic kernel.
extern "C" int tpu3fs_xor_fold_atomic(const void* x, void* out, long long B,
                                      long long S, void* stream) {
  if (B <= 0) return 0;  // nothing to launch
  if (S < 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t rc = cudaMemsetAsync(out, 0, B * sizeof(uint32_t), st);
  if (rc != cudaSuccess || S == 0) return static_cast<int>(rc);
  const long long segs = (S / 16 + kSegVecs - 1) / kSegVecs;
  const dim3 grid(static_cast<unsigned>(segs < 1 ? 1 : (segs < kMaxGrid ? segs : kMaxGrid)),
                  static_cast<unsigned>(B < kMaxGrid ? B : kMaxGrid));
  xor_fold_atomic_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const uint8_t*>(x), static_cast<uint32_t*>(out), B, S);
  return static_cast<int>(cudaGetLastError());
}
