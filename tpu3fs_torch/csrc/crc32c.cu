// Batched CRC32C (Castagnoli) of fixed-size rows.
//
// Replaces tpu3fs/ops/crc32c.py:BatchCrc32c._compute (:242-257), which XLA
// lowered (it is not a Pallas kernel): there each block of `block` bytes is
// expanded into 8 * block bit-planes and multiplied by an (8 * block, 32)
// GF(2) matrix B^T to give the block's raw register, and 32x32 shift
// matrices Ks[j] fold the block registers into the row's register:
//
//   crc(row) = const XOR  XOR_j Ks[j] @ raw(0, block_j),  raw = B^T . bits
//
// Two kernels compute it; the wrapper (ops/crc32c.py) picks one by shape.
//
// crc32c_mma_kernel, the main one. The block product raw = B^T . bits is a
// GF(2) matrix product, and Hopper's tensor cores take 1-bit operands:
// mma.m16n8k256 .b1 with .and.popc gives popcount(a AND b), whose low bit is
// the GF(2) dot product of two 256-bit vectors. The bytes of a block are
// used as they lie in memory: 32 bytes are one 256-bit K vector, with no
// expansion into bit-planes.
//   - A operand: 16 consecutive blocks (M = 16), in registers. Lane (g, t)
//     loads 16 bytes at 16t and at 64 + 16t of each 128-byte chunk of
//     blocks g and g + 8: a warp load covers 64 contiguous bytes of 8
//     blocks, whole sectors, and nothing is staged in shared memory.
//     K-step u of a chunk takes word u of each of those loads (so the K
//     order is a fixed permutation of the block's bits, the same for A and
//     B).
//   - B operand: B^T as 4 N-tiles of 8 register bits, packed on the host
//     (BatchCrc32c._setup) in fragment order, (steps, 32 lanes, 8) words,
//     16 KB at block 512, staged in shared memory once per CTA and read
//     with conflict-free 16-byte loads.
//   - Epilogue: acc & 1 gives 8 register bits of each of the lane's two
//     blocks; two shuffles OR them into the full raw register; each lane of
//     a quad folds 8 of the 32 columns of Ks[j] (masked XOR), and the parts
//     XOR-reduce by shuffles into one atomicXor per row per 16 blocks, into
//     an output pre-filled with the constant. XOR is exact in any order.
//   Shapes: block % 32 == 0, 32 <= block <= 2048 (B^T fits in shared
//   memory), a 16-byte-aligned base. That is every CRC the stripe codec
//   makes (block 512, or block = a shard under 512 B, a multiple of 64).
//
// crc32c_blocks_kernel, every other shape (block 1000, a 9-byte row, an
// unaligned base): one thread per block walks the 256-entry table in
// shared memory, then folds as above (one atomicXor per warp or block).
//
// Bound on this card: memory. 192 rows of 1 MiB are 192 MiB read, at least
// about 60 us at 3.35 TB/s. The table kernel is bound by a dependent,
// bank-conflicted shared-memory lookup per byte and by 512-byte-strided
// lane loads (3.4x its bound). The mma kernel issues about 1.6 M
// tensor-core instructions at that shape (about 15 us at the rate
// csrc/mma_rate.cu measures) and reads each byte once, coalesced, 8 KB per
// warp in flight: it runs near 1.3x its bytes bound (PERF.md holds the
// measured times).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kPolyReflected = 0x82F63B78u;

__device__ __forceinline__ uint32_t crc_byte(const uint32_t* table,
                                             uint32_t c, uint32_t byte) {
  return (c >> 8) ^ table[(c ^ byte) & 0xFFu];
}

// x: (rows, size) contiguous; ks_cols: (size / block, 32), column t of Ks[j]
// packed LSB first; out: (rows,) pre-filled with the constant.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
crc32c_blocks_kernel(const uint8_t* __restrict__ x,
                     const uint32_t* __restrict__ ks_cols,
                     uint32_t* __restrict__ out, long long nblocks,
                     long long block, long long total) {
  __shared__ uint32_t table[256];
  for (int i = threadIdx.x; i < 256; i += kThreads) {
    uint32_t c = i;
#pragma unroll
    for (int b = 0; b < 8; ++b) c = (c & 1u) ? (c >> 1) ^ kPolyReflected : c >> 1;
    table[i] = c;
  }
  __syncthreads();

  const long long g = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const bool active = g < total;
  const long long row = active ? g / nblocks : -1;
  uint32_t part = 0;
  if (active) {
    const long long j = g - row * nblocks;
    const uint8_t* p = x + g * block;  // rows are contiguous: row*size + j*block
    uint32_t c = 0;
    if (kVec) {
      for (long long q = 0; q < block; q += 16) {
        const uint4 v = *reinterpret_cast<const uint4*>(p + q);
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int s = 0; s < 32; s += 8) c = crc_byte(table, c, w[i] >> s);
      }
    } else {
      for (long long q = 0; q < block; ++q) c = crc_byte(table, c, p[q]);
    }
    const uint4* col = reinterpret_cast<const uint4*>(ks_cols + j * 32);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const uint4 v = col[q];
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        part ^= (0u - ((c >> (4 * q + i)) & 1u)) & w[i];
    }
  }

  const unsigned full = 0xFFFFFFFFu;
  const long long row0 = __shfl_sync(full, row, 0);
  if (__all_sync(full, !active || row == row0)) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) part ^= __shfl_xor_sync(full, part, off);
    if ((threadIdx.x & 31) == 0 && row0 >= 0) atomicXor(out + row0, part);
  } else if (active) {
    atomicXor(out + row, part);
  }
}

// ---- tensor-core kernel ----------------------------------------------------

constexpr int kMmaWarps = 8;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kTileBlocks = 16;   // M of one mma
constexpr int kChunk = 128;       // bytes of a block per 4 K-steps
constexpr int kHeldChunks = 4;    // chunks of each block held in registers
constexpr int kMaxMmaBlock = 2048;

// d += popc(a AND b) over K = 256, per (m, n): low bit = GF(2) dot product
__device__ __forceinline__ void mma_b1(int (&d)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm(  // a pure function of its operands: free to schedule
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void load16(const uint8_t* p, bool ok,
                                       uint32_t (&w)[4]) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (ok) v = __ldcs(reinterpret_cast<const uint4*>(p));  // read once: stream
  w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
}

// x: (total blocks of `block` bytes) contiguous, 16-byte aligned;
// frags: (steps, 32, 8) words of B^T in B-fragment order (steps =
// 4 * ceil(block / 128)); ks_cols and out as for crc32c_blocks_kernel.
__global__ void __launch_bounds__(kMmaThreads, 2)
crc32c_mma_kernel(const uint8_t* __restrict__ x,
                  const uint4* __restrict__ frags,
                  const uint32_t* __restrict__ ks_cols,
                  uint32_t* __restrict__ out, long long nblocks, int block,
                  long long total) {
  extern __shared__ uint4 sfrag[];  // (steps, 32 lanes, 2) x 16 bytes
  const int steps = 4 * ((block + kChunk - 1) / kChunk);
  for (int i = threadIdx.x; i < steps * 64; i += kMmaThreads) sfrag[i] = frags[i];
  __syncthreads();

  const unsigned full = 0xFFFFFFFFu;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const long long ntiles = (total + kTileBlocks - 1) / kTileBlocks;
  const long long nwarps = static_cast<long long>(gridDim.x) * kMmaWarps;
  for (long long tile = static_cast<long long>(blockIdx.x) * kMmaWarps +
                        (threadIdx.x >> 5);
       tile < ntiles; tile += nwarps) {
    const long long gA = tile * kTileBlocks + g, gB = gA + 8;  // mma rows g, g+8
    const bool okA = gA < total, okB = gB < total;
    const uint8_t* pA = x + gA * block;
    const uint8_t* pB = x + gB * block;
    const long long rowA = gA / nblocks, rowB = gB / nblocks;
    // Ks[j] columns 8t..8t+7 of both blocks, loaded early (L2-resident)
    uint32_t kA[8] = {}, kB[8] = {};
    if (okA) {
      const uint4* c = reinterpret_cast<const uint4*>(ks_cols + (gA - rowA * nblocks) * 32 + 8 * t);
      const uint4 u0 = c[0], u1 = c[1];
      kA[0] = u0.x; kA[1] = u0.y; kA[2] = u0.z; kA[3] = u0.w;
      kA[4] = u1.x; kA[5] = u1.y; kA[6] = u1.z; kA[7] = u1.w;
    }
    if (okB) {
      const uint4* c = reinterpret_cast<const uint4*>(ks_cols + (gB - rowB * nblocks) * 32 + 8 * t);
      const uint4 u0 = c[0], u1 = c[1];
      kB[0] = u0.x; kB[1] = u0.y; kB[2] = u0.z; kB[3] = u0.w;
      kB[4] = u1.x; kB[5] = u1.y; kB[6] = u1.z; kB[7] = u1.w;
    }

    int acc[4][4] = {};
    for (int c0 = 0; c0 < block; c0 += kHeldChunks * kChunk) {
      uint32_t dA[kHeldChunks][2][4], dB[kHeldChunks][2][4];
#pragma unroll
      for (int c = 0; c < kHeldChunks; ++c)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int off = c0 + c * kChunk + h * 64 + 16 * t;
          load16(pA + off, okA && off < block, dA[c][h]);
          load16(pB + off, okB && off < block, dB[c][h]);
        }
#pragma unroll
      for (int c = 0; c < kHeldChunks; ++c) {
        if (c0 + c * kChunk >= block) break;  // the same for the whole warp
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int s = (c0 / kChunk + c) * 4 + u;
          const uint4 f0 = sfrag[(s * 32 + lane) * 2];
          const uint4 f1 = sfrag[(s * 32 + lane) * 2 + 1];
          const uint32_t a0 = dA[c][0][u], a1 = dB[c][0][u];
          const uint32_t a2 = dA[c][1][u], a3 = dB[c][1][u];
          mma_b1(acc[0], a0, a1, a2, a3, f0.x, f0.y);
          mma_b1(acc[1], a0, a1, a2, a3, f0.z, f0.w);
          mma_b1(acc[2], a0, a1, a2, a3, f1.x, f1.y);
          mma_b1(acc[3], a0, a1, a2, a3, f1.z, f1.w);
        }
      }
    }

    // D: lane (g, t) holds register bits 8n + 2t, 8n + 2t + 1 of blocks
    // gA (acc[n][0..1]) and gB (acc[n][2..3])
    uint32_t rA = 0, rB = 0;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int b = 8 * n + 2 * t;
      rA |= (static_cast<uint32_t>(acc[n][0]) & 1u) << b;
      rA |= (static_cast<uint32_t>(acc[n][1]) & 1u) << (b + 1);
      rB |= (static_cast<uint32_t>(acc[n][2]) & 1u) << b;
      rB |= (static_cast<uint32_t>(acc[n][3]) & 1u) << (b + 1);
    }
    rA |= __shfl_xor_sync(full, rA, 1);
    rA |= __shfl_xor_sync(full, rA, 2);
    rB |= __shfl_xor_sync(full, rB, 1);
    rB |= __shfl_xor_sync(full, rB, 2);
    uint32_t partA = 0, partB = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      partA ^= (0u - ((rA >> (8 * t + i)) & 1u)) & kA[i];
      partB ^= (0u - ((rB >> (8 * t + i)) & 1u)) & kB[i];
    }

    const long long first = tile * kTileBlocks;
    const long long last = first + kTileBlocks - 1;
    if (last < total && first / nblocks == last / nblocks) {
      uint32_t part = partA ^ partB;  // all 16 blocks in one row
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) part ^= __shfl_xor_sync(full, part, off);
      if (lane == 0) atomicXor(out + first / nblocks, part);
    } else {
      partA ^= __shfl_xor_sync(full, partA, 1);
      partA ^= __shfl_xor_sync(full, partA, 2);
      partB ^= __shfl_xor_sync(full, partB, 1);
      partB ^= __shfl_xor_sync(full, partB, 2);
      if (t == 0 && okA) atomicXor(out + rowA, partA);
      if (t == 0 && okB) atomicXor(out + rowB, partB);
    }
  }
}

int sm_count() {
  static int n = 0;
  if (!n) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

}  // namespace

extern "C" int tpu3fs_crc32c_blocks(const void* x, const void* ks_cols,
                                    void* out, long long rows, long long size,
                                    long long block, void* stream) {
  if (rows <= 0) return 0;  // nothing to launch
  if (block <= 0 || size <= 0 || size % block) return cudaErrorInvalidValue;
  const long long nblocks = size / block;
  const long long total = rows * nblocks;
  const unsigned grid = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  const bool vec = block % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* in = static_cast<const uint8_t*>(x);
  const auto* ks = static_cast<const uint32_t*>(ks_cols);
  auto* o = static_cast<uint32_t*>(out);
  if (vec)
    crc32c_blocks_kernel<true><<<grid, kThreads, 0, st>>>(in, ks, o, nblocks,
                                                          block, total);
  else
    crc32c_blocks_kernel<false><<<grid, kThreads, 0, st>>>(in, ks, o, nblocks,
                                                           block, total);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpu3fs_crc32c_mma(const void* x, const void* frags,
                                 const void* ks_cols, void* out,
                                 long long rows, long long size,
                                 long long block, void* stream) {
  if (rows <= 0) return 0;  // nothing to launch
  if (block < 32 || block > kMaxMmaBlock || block % 32 || size <= 0 ||
      size % block || reinterpret_cast<uintptr_t>(x) % 16)
    return cudaErrorInvalidValue;
  const long long nblocks = size / block;
  const long long total = rows * nblocks;
  const long long ntiles = (total + kTileBlocks - 1) / kTileBlocks;
  const int steps = 4 * static_cast<int>((block + kChunk - 1) / kChunk);
  const int smem = steps * 32 * 32;  // (steps, 32 lanes, 8 words)
  static int per_sm_cache[4 * (kMaxMmaBlock / kChunk) + 1] = {};  // by steps
  int& per_sm = per_sm_cache[steps];
  if (!per_sm) {
    cudaError_t rc = cudaFuncSetAttribute(
        crc32c_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        4 * (kMaxMmaBlock / kChunk) * 32 * 32);
    if (rc == cudaSuccess)
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, crc32c_mma_kernel, kMmaThreads, smem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
  }
  const long long want = (ntiles + kMmaWarps - 1) / kMmaWarps;
  const long long resident = static_cast<long long>(per_sm) * sm_count();
  const unsigned grid = static_cast<unsigned>(want < resident ? want : resident);
  crc32c_mma_kernel<<<grid, kMmaThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<const uint4*>(frags),
      static_cast<const uint32_t*>(ks_cols), static_cast<uint32_t*>(out),
      nblocks, static_cast<int>(block), total);
  return static_cast<int>(cudaGetLastError());
}
