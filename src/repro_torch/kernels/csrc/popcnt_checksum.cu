// Per-block popcount of a byte buffer: the Zero-log validity word at
// block scale (checksum = sum + 1 mod 2^32, taken by the caller).
//
// Replaces the TPU kernel `popcnt_blocked` / `_popcnt_kernel` of
// src/repro/kernels/popcnt_checksum/kernel.py.
//
// Bound: device-memory bytes. It reads each byte once and writes 4 bytes
// per block, about one integer operation per byte read. One CTA per
// block; each thread streams 16-byte vectors (`uint4`), counts them with
// `__popc` on each 32-bit word, and the CTA reduces with warp shuffles.
// Many small CTAs (a 4 KiB block is 2 vectors per thread) keep enough
// loads in flight across the 132 SMs.
#include "blocks.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
popcnt_blocks_kernel(const unsigned char* __restrict__ x, long long nbytes,
                     long long block_bytes, unsigned* __restrict__ counts) {
  const long long b = blockIdx.x;
  const long long lo = b * block_bytes;
  const long long hi = lo + block_bytes < nbytes ? lo + block_bytes : nbytes;
  unsigned c = 0u;
#pragma unroll 4
  for (long long off = lo + 16LL * threadIdx.x; off < hi; off += 16LL * kThreads) {
    c += repro::popc16(repro::load16(x, off, hi));
  }
  c = repro::block_sum<kThreads>(c);
  if (threadIdx.x == 0) counts[b] = c;
}

}  // namespace

// x: `nbytes` bytes, 16-byte aligned. counts: `nblocks` uint32 (written).
// Returns the cudaError_t of the launch.
extern "C" int popcnt_blocks(const void* x, long long nbytes, long long block_bytes,
                             long long nblocks, void* counts, void* stream) {
  if (nblocks > 0) {
    popcnt_blocks_kernel<<<(unsigned)nblocks, kThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const unsigned char*>(x), nbytes, block_bytes,
        static_cast<unsigned*>(counts));
  }
  return (int)cudaGetLastError();
}
