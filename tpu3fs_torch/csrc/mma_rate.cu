// Throughput probe of the tensor-core instructions the kernels use.
//
// The H100 data sheet gives int8 and fp8 tensor rates but no 1-bit one, and
// the 1-bit mma (m16n8k256 .b1 .and.popc) decides whether K1 and K2 can be
// bound by their bytes. Each warp issues `iters` rounds of 8 independent
// mma.sync of one kind on register operands (no memory traffic), so the
// time of a launch that fills every SM measures the instruction's rate.
// kind 0: m16n8k256 .b1 .and.popc; kind 1: m16n8k32 .s8 (the int8 form of
// the same GF(2) product on 0/1 bit-planes).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kProbeThreads = 256;
constexpr int kIndependent = 8;

template <int kKind>
__global__ void __launch_bounds__(kProbeThreads)
mma_rate_kernel(long long iters, int* __restrict__ out) {
  int acc[kIndependent][4] = {};
  const uint32_t a = threadIdx.x * 0x9E3779B9u, b = blockIdx.x * 0x85EBCA6Bu;
  for (long long i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < kIndependent; ++j) {
      if (kKind == 0)
        asm volatile(
            "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+r"(acc[j][0]), "+r"(acc[j][1]), "+r"(acc[j][2]), "+r"(acc[j][3])
            : "r"(a), "r"(a + j), "r"(a ^ j), "r"(a + 1), "r"(b), "r"(b + j));
      else
        asm volatile(
            "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+r"(acc[j][0]), "+r"(acc[j][1]), "+r"(acc[j][2]), "+r"(acc[j][3])
            : "r"(a), "r"(a + j), "r"(a ^ j), "r"(a + 1), "r"(b), "r"(b + j));
    }
  }
  int s = 0;
#pragma unroll
  for (int j = 0; j < kIndependent; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  atomicAdd(out, s);  // keeps the products live
}

}  // namespace

// grid: `blocks` CTAs of 256 threads; mma per launch = blocks * 8 warps *
// iters * 8
extern "C" int tpu3fs_mma_rate(long long kind, long long blocks,
                               long long iters, void* out, void* stream) {
  if (blocks <= 0 || iters <= 0 || (kind != 0 && kind != 1))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<int*>(out);
  if (kind == 0)
    mma_rate_kernel<0><<<static_cast<unsigned>(blocks), kProbeThreads, 0, st>>>(iters, o);
  else
    mma_rate_kernel<1><<<static_cast<unsigned>(blocks), kProbeThreads, 0, st>>>(iters, o);
  return static_cast<int>(cudaGetLastError());
}
