// A two-dimensional copy from host memory to the card by the copy engine:
// `height` rows of `width` bytes, rows `spitch` bytes apart in the source
// and `dpitch` apart in the destination. The KV cache lands a call's pages
// so (kvcache/landing.py): from page-locked staging laid out layer-first
// into a layer-first pool, one copy a run of consecutive slots, with no
// kernel on the card.
//
// cudaMemcpy2DAsync takes pitches up to the device's memPitch (2^31 - 1 on
// this card); a wider pool is copied a row at a time on the same stream.

#include <climits>
#include <cuda_runtime.h>

extern "C" int tpu3fs_copy2d_h2d(void* dst, long long dpitch, const void* src,
                                 long long spitch, long long width,
                                 long long height, void* stream) {
  if (width <= 0 || height <= 0) return 0;  // nothing to copy
  if (width > dpitch || width > spitch) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dpitch <= INT_MAX && spitch <= INT_MAX)
    return cudaMemcpy2DAsync(dst, (size_t)dpitch, src, (size_t)spitch,
                             (size_t)width, (size_t)height,
                             cudaMemcpyHostToDevice, st);
  auto* d = static_cast<char*>(dst);
  const auto* s = static_cast<const char*>(src);
  for (long long r = 0; r < height; ++r) {
    cudaError_t rc = cudaMemcpyAsync(d + r * dpitch, s + r * spitch,
                                     (size_t)width, cudaMemcpyHostToDevice, st);
    if (rc != cudaSuccess) return rc;
  }
  return cudaSuccess;
}
