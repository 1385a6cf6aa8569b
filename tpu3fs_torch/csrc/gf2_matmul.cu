// GF(2^8) matrix applied to byte stripes: y[b, i, s] = XOR_j c_ij * x[b, j, s].
//
// Replaces the Pallas TPU kernel tpu3fs/ops/pallas_rs.py:_gf2_kernel (driven
// by _gf2_matmul_3d). That kernel unpacks each byte into 8 bit-planes, runs
// an int8 matmul with the (8o, 8k) GF(2) bit matrix and packs the result
// mod 2. Here the same bit matrix is applied bit-sliced on 32-bit words:
// column t of the 8x8 block (i, j) is the byte c_ij * 2^t, so
//
//   c_ij * x = XOR_t (bit t of x ? col_t : 0)
//
// and for four bytes held in one uint32 the select is a mask:
//   mask = ((x >> t) & 0x01010101) * 0xFF;  acc ^= mask & (col_t * 0x01010101)
//
// Bound on this card: memory. At RS(12,4), B = 12, S = 1 MiB the kernel reads
// 144 MiB and writes 48 MiB, at least about 60 us at 3.35 TB/s; the int8
// tensor-core form of the same product would be about 77 G ops, about 39 us
// at 1,979 TOP/s. This first design is simple: each thread owns 16 bytes
// along S of one stripe, keeps the masks of one input symbol in registers
// and the sums of up to kOutTile output symbols, and reads the matrix from
// shared memory (one tile of kOutTile output rows at a time, so any o <= 255
// and k <= 255 fits). The masks of one input symbol are shared by the output
// rows of a tile, so it does about 4 to 6 integer operations per input byte
// and output row: at o = 4 it may be bound by instruction issue rather than
// by memory (PERF.md holds the measured time). A later design moves it to
// int8 mma/wgmma or to nibble tables.

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

extern "C" const char* tpu3fs_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
