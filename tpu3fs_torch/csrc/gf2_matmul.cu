// GF(2^8) matrix applied to byte stripes: y[b, i, s] = XOR_j c_ij * x[b, j, s].
//
// Replaces the Pallas TPU kernel tpu3fs/ops/pallas_rs.py:_gf2_kernel
// (:47-57, driven by _gf2_matmul_3d, pallas_call at :68). That kernel
// unpacks each byte into 8 bit-planes, runs an int8 matmul with the
// (8o, 8k) GF(2) bit matrix and packs the result mod 2. Two kernels here
// compute the same product; the wrapper (ops/gf2_matmul.py) picks one by
// shape.
//
// gf2_mma_kernel, the main one: the same bit-matrix product on the tensor
// cores with 1-bit operands (mma.m16n8k256 .b1 .and.popc; the low bit of
// popcount(a AND b) is the GF(2) dot product), so no byte is expanded.
//   - K vector of byte position s: the k bytes x[b, 0..k-1, s], 8k bits,
//     one K-step of 256 bits per 32 symbols (k = 12 uses 96 live bits).
//   - Data: a CTA tile is 1024 positions of one stripe (512 when k > 32);
//     per K-step its symbol rows are copied into shared memory with
//     16-byte cp.async, in a ring of 5 (8) stages so that enough bytes are
//     in flight to keep HBM busy. Rows are padded by 16 bytes, which makes
//     the fragment reads below free of bank conflicts between quads.
//   - k <= 32 (every RS(k, m) of the stripe codec) is one K-step: each
//     output symbol's sums are finished as soon as they are made, 16 live
//     accumulators instead of 64, so 3 CTAs fit on an SM.
//   - A operand: lane (g, t) reads 8 positions of symbol rows 4t..4t+3
//     (and 16+4t..) as 8-byte words and transposes them with __byte_perm
//     4x4 byte transposes, so that each word holds 4 symbols of one
//     position: the A fragment of 4 M-tiles of 16 positions.
//   - B operand: one N-tile of 8 output bits per output symbol, built in
//     shared memory at the CTA's start from the (o, k, 8) columns that
//     prepare_matrix makes (bit u of cols[i, j, t] is entry (8i+u, 8j+t)),
//     4 output symbols per pass, so any o <= 255 and k <= 256 fits.
//   - Epilogue: acc & 1 gives 2 bits of an output byte per lane; two
//     shuffles OR the 4 lanes of a quad into the byte, and lane t stores 8
//     bytes of output symbol t: a warp store covers 64 contiguous bytes of
//     4 output rows.
//   Shapes: S % 16 == 0 and 16-byte-aligned data and output, which is every
//   shard size shard_size_of makes (multiples of 64).
//
// gf2_matmul_kernel, every other shape (a ragged S, an unaligned base):
// the bit matrix applied bit-sliced on 32-bit words on the integer units:
// column t of the 8x8 block (i, j) is the byte c_ij * 2^t, so
//
//   c_ij * x = XOR_t (bit t of x ? col_t : 0)
//
// and for four bytes held in one uint32 the select is a mask:
//   mask = ((x >> t) & 0x01010101) * 0xFF;  acc ^= mask & (col_t * 0x01010101)
//
// Each thread owns 16 bytes along S of one stripe and up to kOutTile output
// sums; about 56 integer operations per input word at o = 4.
//
// Bound on this card: memory. At RS(12,4), B = 12, S = 1 MiB the kernel
// reads 144 MiB and writes 48 MiB, at least about 60 us at 3.35 TB/s. The
// bit-sliced kernel is bound by instruction issue there (about 2.1 G
// integer operations, 2.2x the bound). The mma kernel does 3.1 M
// tensor-core instructions (about 30 us at the rate csrc/mma_rate.cu
// measures), but extracting one output bit from each 32-bit accumulator,
// the byte transposes and the copy loop cost about as many issue slots as
// its bytes take to load: it is bound by both together, near 1.8x its
// bytes bound (PERF.md holds the measured times).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kOutTile = 4;   // output symbols accumulated per pass
constexpr int kMaxK = 256;    // k + m <= 256 for GF(2^8)
constexpr int kBytes = 16;    // bytes of S per thread

template <bool kVec>
__device__ __forceinline__ void load16(const uint8_t* row, long long s0,
                                       long long S, uint32_t v[4]) {
  if (kVec) {
    const uint4 q = *reinterpret_cast<const uint4*>(row + s0);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      uint32_t word = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const long long s = s0 + 4 * w + q;
        if (s < S) word |= static_cast<uint32_t>(row[s]) << (8 * q);
      }
      v[w] = word;
    }
  }
}

template <bool kVec>
__device__ __forceinline__ void store16(uint8_t* row, long long s0,
                                        long long S, const uint32_t v[4]) {
  if (kVec) {
    *reinterpret_cast<uint4*>(row + s0) = make_uint4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int w = 0; w < 4; ++w) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const long long s = s0 + 4 * w + q;
        if (s < S) row[s] = static_cast<uint8_t>(v[w] >> (8 * q));
      }
    }
  }
}

// cols: (o, k, 8) bytes, cols[i, j, t] = c_ij * 2^t (bit u = row 8i+u,
// column 8j+t of the symbol-major expand_to_bits matrix).
// x: (B, k, S) and y: (B, o, S), both contiguous.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
gf2_matmul_kernel(const uint8_t* __restrict__ cols,
                  const uint8_t* __restrict__ x, uint8_t* __restrict__ y,
                  long long B, int k, int o, long long S) {
  __shared__ uint32_t rep[kOutTile * kMaxK * 8];  // col bytes x 0x01010101
  const long long s0 =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kBytes;
  const bool active = s0 < S;
  for (long long b = blockIdx.y; b < B; b += gridDim.y) {
    const uint8_t* xb = x + b * k * S;
    uint8_t* yb = y + b * o * S;
    for (int i0 = 0; i0 < o; i0 += kOutTile) {
      const int ot = min(kOutTile, o - i0);
      __syncthreads();  // the previous tile's readers are done
      for (int e = threadIdx.x; e < ot * k * 8; e += kThreads)
        rep[e] = cols[static_cast<long long>(i0) * k * 8 + e] * 0x01010101u;
      __syncthreads();
      if (!active) continue;
      uint32_t acc[kOutTile][4] = {};
      for (int j = 0; j < k; ++j) {
        uint32_t v[4];
        load16<kVec>(xb + j * S, s0, S, v);
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          uint32_t mask[4];
#pragma unroll
          for (int w = 0; w < 4; ++w)
            mask[w] = ((v[w] >> t) & 0x01010101u) * 0xFFu;
#pragma unroll
          for (int ii = 0; ii < kOutTile; ++ii) {
            if (ii < ot) {
              const uint32_t c = rep[(ii * k + j) * 8 + t];
#pragma unroll
              for (int w = 0; w < 4; ++w) acc[ii][w] ^= mask[w] & c;
            }
          }
        }
      }
#pragma unroll
      for (int ii = 0; ii < kOutTile; ++ii)
        if (ii < ot) store16<kVec>(yb + (i0 + ii) * S, s0, S, acc[ii]);
    }
  }
}

// ---- tensor-core kernel ----------------------------------------------------

constexpr int kMmaWarps = 8;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kStepRows = 32;              // symbols per 256-bit K-step
constexpr int kGroup = 4;                  // output symbols (N-tiles) per pass
constexpr int kMaxSteps = kMaxK / kStepRows;

// The CTA tile: positions, 64-position sub-tiles per warp, padded row
// bytes (a row stride of 4 mod 32 words makes the fragment reads free of
// bank conflicts) and cp.async ring depth. One K-step keeps 16 sums per
// lane, so a tile can be wide; more steps keep 64 and take 512 positions.
template <bool kOneStep>
struct Tile {
  static constexpr int kPos = kOneStep ? 1024 : 512;
  static constexpr int kSub = kPos / (64 * kMmaWarps);
  static constexpr int kRowBytes = kPos + 16;
  static constexpr int kStages = kOneStep ? 5 : 8;
};

// rows a stage holds: k rounded up to 4 when one K-step covers k, else 32
__host__ __device__ __forceinline__ int stage_rows(int k) {
  return k <= kStepRows ? (k + 3) / 4 * 4 : kStepRows;
}

// d (+)= popc(a AND b) over K = 256, per (m, n): low bit = GF(2) dot
// product. kFirst takes C = 0, so the first K-step needs no zeroed sums.
template <bool kFirst>
__device__ __forceinline__ void mma_b1(int (&d)[4], const uint32_t (&a)[4],
                                       uint2 b) {
  if (kFirst)
    asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
        : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y),
          "r"(0));
  else
    asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// w[r] holds bytes (p0..p0+3) of row r -> w[p] holds bytes (row 0..3) of p
__device__ __forceinline__ void transpose4x4(uint32_t (&w)[4]) {
  const uint32_t x0 = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t x1 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t x2 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t x3 = __byte_perm(w[2], w[3], 0x7362);
  w[0] = __byte_perm(x0, x2, 0x5410);
  w[1] = __byte_perm(x0, x2, 0x7632);
  w[2] = __byte_perm(x1, x3, 0x5410);
  w[3] = __byte_perm(x1, x3, 0x7632);
}

// The 8 output bytes of one symbol at the lane's positions pw..pw+7 from
// the sums d[q][v] of its 4 M-tiles: lane (g, t) holds bits 2t (v = 0, 2)
// and 2t + 1 (v = 1, 3) of positions pw + 2q (v < 2) and pw + 2q + 1; the
// low byte of a popcount carries its parity. The 4 lanes of a quad OR
// their bits together, so every lane of the quad returns the bytes.
__device__ __forceinline__ uint2 out_bytes(const int (&d)[4][4], int t) {
  uint32_t word[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int* d0 = d[2 * half];
    const int* d1 = d[2 * half + 1];
    const uint32_t e = __byte_perm(__byte_perm(d0[0], d0[2], 0x0040),
                                   __byte_perm(d1[0], d1[2], 0x0040), 0x5410);
    const uint32_t od = __byte_perm(__byte_perm(d0[1], d0[3], 0x0040),
                                    __byte_perm(d1[1], d1[3], 0x0040), 0x5410);
    uint32_t v = ((e & 0x01010101u) | ((od & 0x01010101u) << 1)) << (2 * t);
    v |= __shfl_xor_sync(0xFFFFFFFFu, v, 1);
    v |= __shfl_xor_sync(0xFFFFFFFFu, v, 2);
    word[half] = v;
  }
  return make_uint2(word[0], word[1]);
}

// cols: (o, k, 8) as for gf2_matmul_kernel; x: (B, k, S), y: (B, o, S),
// S % 16 == 0, both 16-byte aligned. kOneStep: k <= 32, one K-step, so each
// output symbol's sums are finished as soon as they are made (16 live
// accumulators instead of 64: more warps fit on an SM).
template <bool kOneStep>
__global__ void __launch_bounds__(kMmaThreads, kOneStep ? 3 : 2)
gf2_mma_kernel(const uint8_t* __restrict__ cols,
               const uint8_t* __restrict__ x, uint8_t* __restrict__ y,
               long long B, int k, int o, long long S) {
  constexpr int kSteps = kOneStep ? 1 : kMaxSteps;
  constexpr int kTilePos = Tile<kOneStep>::kPos;
  constexpr int kRowBytes = Tile<kOneStep>::kRowBytes;
  constexpr int kStages = Tile<kOneStep>::kStages;
  extern __shared__ __align__(16) uint8_t ring[];  // kStages x stage_bytes
  __shared__ uint2 bfrag[kSteps * kGroup * 32];     // (step, n, lane) words

  // 32-bit tile arithmetic (the entry checks B * tiles * steps < 2^31),
  // and no division per iteration: it costs about as much as the mma
  const int steps = (k + kStepRows - 1) / kStepRows;
  const unsigned tps = static_cast<unsigned>((S + kTilePos - 1) / kTilePos);
  const unsigned ntiles = static_cast<unsigned>(B) * tps;
  if (blockIdx.x >= ntiles) return;
  const unsigned my_tiles = (ntiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const unsigned iters = my_tiles * steps;
  const unsigned grid_b = gridDim.x / tps, grid_p = gridDim.x % tps;
  const int srows = stage_rows(k);
  const int stage_bytes = srows * kRowBytes;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int warp_pos = 64 * Tile<kOneStep>::kSub * (threadIdx.x >> 5);

  // (stripe, tile of the stripe, K-step) of an iteration, advanced in order
  struct Cursor {
    unsigned b, pt;
    int st;
  };
  auto first = [&]() {
    const unsigned b = blockIdx.x / tps;
    return Cursor{b, blockIdx.x - b * tps, 0};
  };
  auto advance = [&](Cursor& c) {
    if (++c.st < steps) return;
    c.st = 0;
    c.b += grid_b;
    c.pt += grid_p;
    if (c.pt >= tps) {
      c.pt -= tps;
      ++c.b;
    }
  };
  // copy the stage rows of one iteration into a stage: thread slot e is
  // row e / 32, 16-byte column e % 32
  auto issue = [&](const Cursor& c, unsigned it) {
    uint8_t* stage = ring + (it % kStages) * stage_bytes;
    const long long p0 = static_cast<long long>(c.pt) * kTilePos;
    for (int e = threadIdx.x; e < srows * (kTilePos / 16); e += kMmaThreads) {
      const int r = e / (kTilePos / 16), col = e % (kTilePos / 16);
      const int j = c.st * kStepRows + r;
      const long long p = p0 + 16 * col;
      if (j < k && p < S)
        cp_async16(stage + r * kRowBytes + 16 * col,
                   x + (static_cast<long long>(c.b) * k + j) * S + p);
    }
  };

  for (int i0 = 0; i0 < o; i0 += kGroup) {
    const int nlive = min(kGroup, o - i0);
    __syncthreads();  // the previous pass no longer reads bfrag
    // B fragments: lane (g, t), half h of N-tile n at step st holds column
    // g (bit g of output symbol i0 + n) over symbols st*32 + 4(t + 4h) + r,
    // bit 8r + q = bit g of cols[i, j, q]
    auto* bw = reinterpret_cast<uint32_t*>(bfrag);
    for (int e = threadIdx.x; e < steps * kGroup * 64; e += kMmaThreads) {
      const int h = e & 1, ln = (e >> 1) & 31, n = (e >> 6) & 3, st = e >> 8;
      const int i = i0 + n, gg = ln >> 2, w = (ln & 3) + 4 * h;
      uint32_t word = 0;
      if (i < o) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = st * kStepRows + 4 * w + r;
          if (j >= k) break;
          const uint8_t* c8 = cols + (static_cast<long long>(i) * k + j) * 8;
#pragma unroll
          for (int q = 0; q < 8; ++q)
            word |= ((static_cast<uint32_t>(c8[q]) >> gg) & 1u) << (8 * r + q);
        }
      }
      bw[e] = word;
    }
    __syncthreads();

    Cursor ic = first(), cc = first();  // the issue and compute cursors
    for (unsigned s = 0; s < kStages - 1; ++s) {
      if (s < iters) {
        issue(ic, s);
        advance(ic);
      }
      cp_async_commit();
    }
    int acc[kOneStep ? 1 : kGroup][4][4];  // [n][M-tile q][v]
    for (unsigned it = 0; it < iters; ++it) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // stage `it` has landed; stage it-1 is free again
      if (it + kStages - 1 < iters) {
        issue(ic, it + kStages - 1);
        advance(ic);
      }
      cp_async_commit();

      const int st = cc.st;
      const uint8_t* stage = ring + (it % kStages) * stage_bytes;
#pragma unroll
      for (int sub = 0; sub < Tile<kOneStep>::kSub; ++sub) {
        const int pw = warp_pos + 64 * sub + 8 * g;  // the lane's 8 positions
        // a[q]: the A fragment of M-tile q (positions pw + 2q, pw + 2q + 1):
        // symbols 4t..4t+3 (low half) and 16+4t.. (high half, all zero when
        // the step has no symbol past 16) of each position
        uint32_t a[4][4] = {};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (h == 1 && st * kStepRows + 16 >= k) break;
          uint32_t lo[4], hi[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int row = 16 * h + 4 * t + r;
            uint2 v = make_uint2(0u, 0u);
            if (st * kStepRows + row < k)
              v = *reinterpret_cast<const uint2*>(stage + row * kRowBytes + pw);
            lo[r] = v.x;
            hi[r] = v.y;
          }
          transpose4x4(lo);
          transpose4x4(hi);
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            a[q][2 * h] = lo[2 * q];
            a[q][2 * h + 1] = lo[2 * q + 1];
            a[2 + q][2 * h] = hi[2 * q];
            a[2 + q][2 * h + 1] = hi[2 * q + 1];
          }
        }

        const long long p = static_cast<long long>(cc.pt) * kTilePos + pw;
        uint2 mine = make_uint2(0u, 0u);
#pragma unroll
        for (int n = 0; n < kGroup; ++n) {
          if (n >= nlive) break;
          const uint2 bv = bfrag[(st * kGroup + n) * 32 + lane];
          int (&d)[4][4] = acc[kOneStep ? 0 : n];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (kOneStep || st == 0)
              mma_b1<true>(d[q], a[q], bv);
            else
              mma_b1<false>(d[q], a[q], bv);
          }
          if (kOneStep || st == steps - 1) {
            const uint2 bytes = out_bytes(d, t);
            if (n == t) mine = bytes;
          }
        }
        if ((kOneStep || st == steps - 1) && t < nlive && p < S)
          *reinterpret_cast<uint2*>(
              y + (static_cast<long long>(cc.b) * o + i0 + t) * S + p) = mine;
      }
      advance(cc);
    }
    cp_async_wait<0>();
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

// CTAs of the kernel that fit on an SM at `rows` stage rows, asked once
template <bool kOneStep>
int resident_per_sm(int rows) {
  using T = Tile<kOneStep>;
  static int cache[kStepRows + 1] = {};
  if (!cache[rows]) {
    const int smem = T::kStages * rows * T::kRowBytes;
    cudaError_t rc = cudaFuncSetAttribute(
        gf2_mma_kernel<kOneStep>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        T::kStages * kStepRows * T::kRowBytes);
    if (rc == cudaSuccess)
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &cache[rows], gf2_mma_kernel<kOneStep>, kMmaThreads, smem);
    if (rc != cudaSuccess) return -static_cast<int>(rc);
  }
  return cache[rows];
}

template <bool kOneStep>
int launch_mma(const uint8_t* cols, const uint8_t* x, uint8_t* y, long long B,
               int k, int o, long long S, cudaStream_t stream) {
  const int per_sm = resident_per_sm<kOneStep>(stage_rows(k));
  if (per_sm < 0) return -per_sm;
  if (per_sm == 0) return cudaErrorInvalidConfiguration;
  using T = Tile<kOneStep>;
  const long long ntiles = B * ((S + T::kPos - 1) / T::kPos);
  const long long resident = static_cast<long long>(per_sm) * sm_count();
  const unsigned grid = static_cast<unsigned>(ntiles < resident ? ntiles : resident);
  const int smem = T::kStages * stage_rows(k) * T::kRowBytes;
  gf2_mma_kernel<kOneStep><<<grid, kMmaThreads, smem, stream>>>(cols, x, y, B, k,
                                                               o, S);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int tpu3fs_gf2_matmul(const void* cols, const void* x, void* y,
                                 long long B, long long k, long long o,
                                 long long S, void* stream) {
  if (B <= 0 || o <= 0 || S <= 0) return 0;  // nothing to launch
  if (k < 1 || k > kMaxK || o > kMaxK) return cudaErrorInvalidValue;
  const long long chunks = (S + kBytes - 1) / kBytes;
  const dim3 grid(static_cast<unsigned>((chunks + kThreads - 1) / kThreads),
                  static_cast<unsigned>(B < 65535 ? B : 65535));
  const bool vec = S % kBytes == 0 &&
                   reinterpret_cast<uintptr_t>(x) % kBytes == 0 &&
                   reinterpret_cast<uintptr_t>(y) % kBytes == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const uint8_t*>(cols);
  const auto* in = static_cast<const uint8_t*>(x);
  auto* out = static_cast<uint8_t*>(y);
  if (vec)
    gf2_matmul_kernel<true><<<grid, kThreads, 0, st>>>(c, in, out, B, (int)k,
                                                       (int)o, S);
  else
    gf2_matmul_kernel<false><<<grid, kThreads, 0, st>>>(c, in, out, B, (int)k,
                                                        (int)o, S);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpu3fs_gf2_mma(const void* cols, const void* x, void* y,
                              long long B, long long k, long long o,
                              long long S, void* stream) {
  if (B <= 0 || o <= 0 || S <= 0) return 0;  // nothing to launch
  if (k < 1 || k > kMaxK || o > kMaxK || S % 16 ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(y) % 16)
    return cudaErrorInvalidValue;
  const long long min_tile = Tile<false>::kPos;
  if (B * ((S + min_tile - 1) / min_tile) * ((k + kStepRows - 1) / kStepRows) >=
      (1LL << 31))
    return cudaErrorInvalidValue;
  const auto* c = static_cast<const uint8_t*>(cols);
  const auto* in = static_cast<const uint8_t*>(x);
  auto* out = static_cast<uint8_t*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return k <= kStepRows ? launch_mma<true>(c, in, out, B, (int)k, (int)o, S, st)
                        : launch_mma<false>(c, in, out, B, (int)k, (int)o, S, st);
}

extern "C" const char* tpu3fs_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
