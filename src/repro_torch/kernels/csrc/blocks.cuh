// Shared helpers of the persistence kernels (sm_90a).
//
// Every kernel treats its buffers as plain bytes cut into blocks of
// `block_bytes` (a multiple of 16). A buffer whose length is not a whole
// number of blocks reads as if zero-padded to the next block, which is
// what the plain versions (and the JAX package's `as_blocks`) do.
//
// Dirty flags compare lanes as the reference compares elements: a lane
// of a floating type differs iff `a != b` in IEEE terms (+0 equals -0, a
// NaN differs from everything, itself included); any other type compares
// bytes, which is its value compare. The compare works on the bits, so
// no float arithmetic (and no flush of denormals) takes part.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// How a dirty flag compares lanes; the wrapper derives it from the
// tensor's dtype (`repro_torch.kernels.common.compare_kind`).
enum Compare : int { kBytes = 0, kF16 = 1, kBF16 = 2, kF32 = 3 };

// IEEE `a != b` of two lanes of one float format, given as bits: `kAbs`
// masks off the sign, `kInf` is +infinity's bits.
template <typename U, U kAbs, U kInf>
__device__ __forceinline__ bool lane_differs(U a, U b) {
  const U ma = a & kAbs, mb = b & kAbs;
  if (ma > kInf || mb > kInf) return true;   // a NaN
  return a != b && (ma | mb) != 0;           // ±0 are equal
}

__device__ __forceinline__ bool half_differs(uint32_t a, uint32_t b, bool bf16) {
  const uint16_t a0 = (uint16_t)a, a1 = (uint16_t)(a >> 16);
  const uint16_t b0 = (uint16_t)b, b1 = (uint16_t)(b >> 16);
  if (bf16) {
    return lane_differs<uint16_t, 0x7fff, 0x7f80>(a0, b0) ||
           lane_differs<uint16_t, 0x7fff, 0x7f80>(a1, b1);
  }
  return lane_differs<uint16_t, 0x7fff, 0x7c00>(a0, b0) ||
         lane_differs<uint16_t, 0x7fff, 0x7c00>(a1, b1);
}

__device__ __forceinline__ bool word_differs(uint32_t a, uint32_t b) {
  return lane_differs<uint32_t, 0x7fffffffu, 0x7f800000u>(a, b);
}

// Whether any lane of two 16-byte vectors differs under compare `K`.
template <int K>
__device__ __forceinline__ bool differs16(uint4 a, uint4 b) {
  if constexpr (K == kBytes) {
    return ((a.x ^ b.x) | (a.y ^ b.y) | (a.z ^ b.z) | (a.w ^ b.w)) != 0u;
  } else if constexpr (K == kF16 || K == kBF16) {
    return half_differs(a.x, b.x, K == kBF16) | half_differs(a.y, b.y, K == kBF16) |
           half_differs(a.z, b.z, K == kBF16) | half_differs(a.w, b.w, K == kBF16);
  } else {
    static_assert(K == kF32, "unknown compare");
    return word_differs(a.x, b.x) | word_differs(a.y, b.y) | word_differs(a.z, b.z) |
           word_differs(a.w, b.w);
  }
}

// Calls `f(std::integral_constant<int, K>{})` for the runtime compare
// `kind`, so a launch picks its kernel's template; an unknown kind is
// refused as cudaErrorInvalidValue before anything launches.
template <class F>
cudaError_t with_compare(int kind, F&& f) {
  switch (kind) {
    case kBytes: f(std::integral_constant<int, kBytes>{}); break;
    case kF16: f(std::integral_constant<int, kF16>{}); break;
    case kBF16: f(std::integral_constant<int, kBF16>{}); break;
    case kF32: f(std::integral_constant<int, kF32>{}); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaSuccess;
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

// One CTA's scan of block `blockIdx.x` (flush_scan, and flush_pack's
// first launch): flag = some lane of `cur` differs from `snap` under
// compare `K`, count = popcount of the block's live bytes, both read in
// one pass of 16-byte vectors and written by thread 0.
template <int K, int THREADS>
__device__ __forceinline__ void scan_block(const unsigned char* __restrict__ cur,
                                           const unsigned char* __restrict__ snap,
                                           long long nbytes, long long block_bytes,
                                           int* __restrict__ flags,
                                           unsigned* __restrict__ counts) {
  const long long b = blockIdx.x;
  const long long lo = b * block_bytes;
  const long long hi = lo + block_bytes < nbytes ? lo + block_bytes : nbytes;
  unsigned c = 0u;
  int d = 0;
#pragma unroll 4
  for (long long off = lo + 16LL * threadIdx.x; off < hi; off += 16LL * THREADS) {
    const uint4 a = load16(cur, off, hi);
    c += popc16(a);
    d |= differs16<K>(a, load16(snap, off, hi));
  }
  d = __syncthreads_or(d);
  c = block_sum<THREADS>(c);
  if (threadIdx.x == 0) {
    flags[b] = d ? 1 : 0;
    counts[b] = c;
  }
}

}  // namespace repro
