// XOR of the k shard rows of each stripe: y[b, s] = XOR_j x[b, j, s].
//
// Replaces the XLA-lowered tpu3fs/ops/rs.py:_xor_reduce_shards (:42-47),
// the single-loss rebuild: when parity row 0 (all ones) covers the lost
// shard, the lost bytes are the plain XOR of the k survivors.
//
// Bound on this card: memory. The kernel reads each input byte once and
// writes each output byte once, (k + 1) * B * S bytes: at k = 12, B = 12,
// S = 1 MiB that is 163.6 MB, 0.0488 ms at 3.35 TB/s. The plain torch
// version makes k - 1 passes, each reading the output back.
//
// Design: one pass. A thread owns 16 bytes of one stripe's output; it
// loads the 16 bytes at that offset of each of the k rows (row stride S),
// four rows at a time so their loads are in flight together, XORs them
// in registers and stores 16 bytes once. Neighbouring threads hold
// neighbouring 16-byte columns, so every warp load is 512 contiguous bytes
// of one row. Grid-stride loops run over the B stripes (grid y) and the
// S/16 columns (grid x).
//
// Shapes: the 16-byte variant needs S % 16 == 0 and 16-byte-aligned input
// and output; the entry picks the byte variant (one byte per thread) for
// any other shape, by shape, never on an error.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxGridX = 1 << 16;

__device__ __forceinline__ void xor_into(uint4& acc, const uint4 v) {
  acc.x ^= v.x;
  acc.y ^= v.y;
  acc.z ^= v.z;
  acc.w ^= v.w;
}

__device__ __forceinline__ void xor_into(uint8_t& acc, const uint8_t v) {
  acc ^= v;
}

// T = uint4 (16 bytes a thread) or uint8_t (one byte). x: (B, k, cols)
// and y: (B, 1, cols) in units of T, both contiguous.
template <typename T>
__global__ void __launch_bounds__(kThreads)
xor_reduce_kernel(const T* __restrict__ x, T* __restrict__ y, long long B,
                  int k, long long cols) {
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (long long b = blockIdx.y; b < B; b += gridDim.y) {
    const T* xb = x + b * k * cols;
    T* yb = y + b * cols;
    for (long long c = static_cast<long long>(blockIdx.x) * kThreads +
                       threadIdx.x;
         c < cols; c += step) {
      const T* row = xb + c;
      T acc = row[0];
      int j = 1;
      for (; j + 4 <= k; j += 4) {  // four loads in flight, then the XORs
        const T v0 = row[j * cols], v1 = row[(j + 1) * cols];
        const T v2 = row[(j + 2) * cols], v3 = row[(j + 3) * cols];
        xor_into(acc, v0);
        xor_into(acc, v1);
        xor_into(acc, v2);
        xor_into(acc, v3);
      }
      for (; j < k; ++j) xor_into(acc, row[j * cols]);
      yb[c] = acc;
    }
  }
}

template <typename T>
int launch(const void* x, void* y, long long B, int k, long long cols,
           cudaStream_t stream) {
  const long long want = (cols + kThreads - 1) / kThreads;
  const dim3 grid(static_cast<unsigned>(want < kMaxGridX ? want : kMaxGridX),
                  static_cast<unsigned>(B < 65535 ? B : 65535));
  xor_reduce_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), B, k, cols);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (B, k, S) uint8, y: (B, 1, S) uint8, both contiguous.
extern "C" int tpu3fs_xor_reduce(const void* x, void* y, long long B,
                                 long long k, long long S, void* stream) {
  if (B <= 0 || S <= 0) return 0;  // nothing to launch
  if (k < 1 || k > 256) return cudaErrorInvalidValue;
  const bool vec = S % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return vec ? launch<uint4>(x, y, B, static_cast<int>(k), S / 16, st)
             : launch<uint8_t>(x, y, B, static_cast<int>(k), S, st);
}
