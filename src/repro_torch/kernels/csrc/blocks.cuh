// Shared helpers of the persistence kernels (sm_90a).
//
// Every kernel treats its buffers as plain bytes cut into blocks of
// `block_bytes` (a multiple of 16). A buffer whose length is not a whole
// number of blocks reads as if zero-padded to the next block, which is
// what the plain versions (and the JAX package's `as_blocks`) do.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr unsigned kFullMask = 0xffffffffu;

// 16 bytes at byte offset `off` of a buffer that ends at `end`; bytes at
// or past `end` read as zero. `off` is a multiple of 16 and the buffer is
// 16-byte aligned, so the whole-vector load is aligned.
__device__ __forceinline__ uint4 load16(const unsigned char* p, long long off,
                                        long long end) {
  if (off + 16 <= end) return *reinterpret_cast<const uint4*>(p + off);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  for (int i = 0; i < 16; ++i) {
    if (off + i < end) w[i >> 2] |= uint32_t(p[off + i]) << (8 * (i & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Store the first `n` (1..16) bytes of `v` at `p` (no alignment needed).
__device__ __forceinline__ void store_partial(unsigned char* p, uint4 v, int n) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  for (int i = 0; i < n; ++i) p[i] = (unsigned char)(w[i >> 2] >> (8 * (i & 3)));
}

__device__ __forceinline__ unsigned popc16(uint4 v) {
  return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
}

__device__ __forceinline__ bool differs16(uint4 a, uint4 b) {
  return ((a.x ^ b.x) | (a.y ^ b.y) | (a.z ^ b.z) | (a.w ^ b.w)) != 0u;
}

// Sum of `v` over the CTA; the result is valid in thread 0. Call at most
// once per kernel (the shared scratch is not re-synchronised for reuse).
template <int THREADS>
__device__ __forceinline__ unsigned block_sum(unsigned v) {
  static_assert(THREADS % 32 == 0 && THREADS <= 1024, "whole warps");
  __shared__ unsigned warp_sums[THREADS / 32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFullMask, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  unsigned s = 0u;
  if (warp == 0) {
    s = lane < THREADS / 32 ? warp_sums[lane] : 0u;
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(kFullMask, s, o);
  }
  return s;
}

}  // namespace repro
