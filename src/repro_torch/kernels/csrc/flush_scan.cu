// The one-pass flush scan: per-block dirty flag of a live buffer against
// its snapshot and popcount of the live bytes, with no prefix sum and no
// pack (flush_pack's first launch, on its own).
//
// Replaces the TPU kernel `flush_scan_blocked` / `_flush_scan_kernel` of
// src/repro/kernels/flush_scan/kernel.py. That kernel's grid runs over
// tiles of TILE_BLOCKS blocks and its caller pads the block count to a
// whole tile; here one CTA scans one block, so nothing is padded and the
// outputs have exactly `nblocks` entries. Lanes compare as the wrapper's
// `kind` says (IEEE values for a float dtype, else bytes), as the
// reference's `cur != snap` does in the array's dtype.
//
// Bound: device-memory bytes. It reads both buffers once and writes 8
// bytes per block, about one integer operation per byte read. One CTA per
// block streams 16-byte vectors of both buffers (`repro::scan_block`,
// shared with flush_pack.cu): the flag reduces with `__syncthreads_or`,
// the count with warp shuffles.
#include "blocks.cuh"

namespace {

constexpr int kThreads = 128;

template <int K>
__global__ void __launch_bounds__(kThreads)
flush_scan_kernel(const unsigned char* __restrict__ cur,
                  const unsigned char* __restrict__ snap, long long nbytes,
                  long long block_bytes, int* __restrict__ flags,
                  unsigned* __restrict__ counts) {
  repro::scan_block<K, kThreads>(cur, snap, nbytes, block_bytes, flags, counts);
}

}  // namespace

// cur, snap: `nbytes` bytes each, 16-byte aligned; kind: a repro::Compare.
// flags int32[nblocks] and counts uint32[nblocks] are written. Returns the
// cudaError_t of the launch.
extern "C" int flush_scan(const void* cur, const void* snap, long long nbytes,
                          long long block_bytes, long long nblocks, int kind,
                          void* flags, void* counts, void* stream) {
  if (nblocks <= 0) return (int)cudaGetLastError();
  const cudaError_t e = repro::with_compare(kind, [&](auto k) {
    flush_scan_kernel<decltype(k)::value>
        <<<(unsigned)nblocks, kThreads, 0, (cudaStream_t)stream>>>(
            static_cast<const unsigned char*>(cur), static_cast<const unsigned char*>(snap),
            nbytes, block_bytes, static_cast<int*>(flags), static_cast<unsigned*>(counts));
  });
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}
