// Per-block dirty flag of a live buffer against its last-flushed snapshot:
// flag[b] = 1 iff some lane of block b differs.
//
// Replaces the TPU kernel `dirty_diff_blocked` / `_dirty_diff_kernel` of
// src/repro/kernels/dirty_diff/kernel.py, which compares `cur != snap` in
// the array's dtype. Lanes compare as the wrapper's `kind` says: a typed
// float tensor by IEEE value (+0 equals -0, a NaN always differs), as the
// reference does; anything else by bytes. The checkpoint passes uint8
// views, so there a change of -0.0 to +0.0, or of one NaN payload to
// another, is a change it persists, in both packages.
//
// Bound: device-memory bytes. It reads both buffers once and writes 4
// bytes per block. One CTA per block streams 16-byte vectors of both
// buffers and ORs the lane verdicts; `__syncthreads_or` reduces the
// CTA's verdict.
#include "blocks.cuh"

namespace {

constexpr int kThreads = 128;

template <int K>
__global__ void __launch_bounds__(kThreads)
dirty_diff_kernel(const unsigned char* __restrict__ cur,
                  const unsigned char* __restrict__ snap, long long nbytes,
                  long long block_bytes, int* __restrict__ flags) {
  const long long b = blockIdx.x;
  const long long lo = b * block_bytes;
  const long long hi = lo + block_bytes < nbytes ? lo + block_bytes : nbytes;
  int d = 0;
#pragma unroll 4
  for (long long off = lo + 16LL * threadIdx.x; off < hi; off += 16LL * kThreads) {
    d |= repro::differs16<K>(repro::load16(cur, off, hi), repro::load16(snap, off, hi));
  }
  d = __syncthreads_or(d);
  if (threadIdx.x == 0) flags[b] = d ? 1 : 0;
}

}  // namespace

// cur, snap: `nbytes` bytes each, 16-byte aligned. kind: a repro::Compare.
// flags: `nblocks` int32. Returns the cudaError_t of the launch.
extern "C" int dirty_diff(const void* cur, const void* snap, long long nbytes,
                          long long block_bytes, long long nblocks, int kind,
                          void* flags, void* stream) {
  if (nblocks <= 0) return (int)cudaGetLastError();
  const cudaError_t e = repro::with_compare(kind, [&](auto k) {
    dirty_diff_kernel<decltype(k)::value>
        <<<(unsigned)nblocks, kThreads, 0, (cudaStream_t)stream>>>(
            static_cast<const unsigned char*>(cur), static_cast<const unsigned char*>(snap),
            nbytes, block_bytes, static_cast<int*>(flags));
  });
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}
