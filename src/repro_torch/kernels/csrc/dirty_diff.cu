// Per-block dirty flag of a live buffer against its last-flushed snapshot:
// flag[b] = 1 iff any byte of block b differs.
//
// Replaces the TPU kernel `dirty_diff_blocked` / `_dirty_diff_kernel` of
// src/repro/kernels/dirty_diff/kernel.py. The comparison is of bytes, not
// of floating-point values: a change of -0.0 to +0.0, or of one NaN
// payload to another, is a change the checkpoint has to persist.
//
// Bound: device-memory bytes. It reads both buffers once and writes 4
// bytes per block. One CTA per block streams 16-byte vectors of both
// buffers and ORs the XORs; `__syncthreads_or` reduces the CTA's verdict.
#include "blocks.cuh"

namespace {

constexpr int kThreads = 128;

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
    d |= repro::differs16(repro::load16(cur, off, hi), repro::load16(snap, off, hi));
  }
  d = __syncthreads_or(d);
  if (threadIdx.x == 0) flags[b] = d ? 1 : 0;
}

}  // namespace

// cur, snap: `nbytes` bytes each, 16-byte aligned. flags: `nblocks` int32.
// Returns the cudaError_t of the launch.
extern "C" int dirty_diff(const void* cur, const void* snap, long long nbytes,
                          long long block_bytes, long long nblocks, void* flags,
                          void* stream) {
  if (nblocks > 0) {
    dirty_diff_kernel<<<(unsigned)nblocks, kThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const unsigned char*>(cur), static_cast<const unsigned char*>(snap),
        nbytes, block_bytes, static_cast<int*>(flags));
  }
  return (int)cudaGetLastError();
}
