// The restore path's device pass: for packed block i, popcount it,
// compare with expected[i], and write it over block idx[i] of `out`, in
// place (the blocks of `out` that no idx names keep their bytes).
//
// Replaces the TPU kernel `apply_unpack_blocked` / `_apply_unpack_kernel`
// of src/repro/kernels/apply_unpack/kernel.py, which aliased the base
// image into its output; here `out` is the caller's base tensor, updated
// in place. On restore one block is one page (128-256 KiB), so each CTA
// loops over its page.
//
// Bound: device-memory bytes. It reads each packed byte once and writes
// it once (plus 8 bytes per block of verdicts). One CTA per packed block
// streams 16-byte vectors, counts them while they are in registers,
// stores them to the destination, and reduces the count with warp
// shuffles. A destination past the end of `out` is skipped (as a dropped
// scatter update) and the tail of a partial last block is clipped.
#include "blocks.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
apply_unpack_kernel(const unsigned char* __restrict__ packed, long long block_bytes,
                    const int* __restrict__ idx, const long long* __restrict__ expected,
                    unsigned char* __restrict__ out, long long out_nbytes,
                    int* __restrict__ ok, unsigned* __restrict__ counts) {
  const long long i = blockIdx.x;
  const long long d = idx[i];
  const long long dlo = d * block_bytes;
  const bool write = d >= 0 && dlo < out_nbytes;
  const long long dhi = dlo + block_bytes < out_nbytes ? dlo + block_bytes : out_nbytes;
  const unsigned char* src = packed + i * block_bytes;
  unsigned c = 0u;
#pragma unroll 4
  for (long long off = 16LL * threadIdx.x; off < block_bytes; off += 16LL * kThreads) {
    const uint4 v = *reinterpret_cast<const uint4*>(src + off);
    c += repro::popc16(v);
    if (write) {
      const long long o = dlo + off;
      if (o + 16 <= dhi) {
        *reinterpret_cast<uint4*>(out + o) = v;
      } else if (o < dhi) {
        repro::store_partial(out + o, v, (int)(dhi - o));
      }
    }
  }
  c = repro::block_sum<kThreads>(c);
  if (threadIdx.x == 0) {
    counts[i] = c;
    ok[i] = (long long)c == expected[i] ? 1 : 0;
  }
}

}  // namespace

// packed: k*block_bytes bytes, out: `out_nbytes` bytes, both 16-byte
// aligned. idx int32[k], expected int64[k]; ok int32[k] and counts
// uint32[k] are written. Returns the cudaError_t of the launch.
extern "C" int apply_unpack(const void* packed, long long block_bytes, long long k,
                            const void* idx, const void* expected, void* out,
                            long long out_nbytes, void* ok, void* counts, void* stream) {
  if (k > 0) {
    apply_unpack_kernel<<<(unsigned)k, kThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const unsigned char*>(packed), block_bytes, static_cast<const int*>(idx),
        static_cast<const long long*>(expected), static_cast<unsigned char*>(out), out_nbytes,
        static_cast<int*>(ok), static_cast<unsigned*>(counts));
  }
  return (int)cudaGetLastError();
}
