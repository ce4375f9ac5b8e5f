// Block copies driven by an index vector: the staged chain's delta gather
// (out[i] = src[idx[i]]) and its in-place scatter (out[idx[i]] = upd[i]).
//
// Replaces the TPU kernels `delta_pack_blocked` / `_copy_kernel` and
// `delta_apply_blocked` / `_apply_kernel` of
// src/repro/kernels/delta_pack/kernel.py. There the index arrives in SMEM
// by scalar prefetch before the grid runs, and a BlockSpec index map
// turns it into each step's DMA. Hopper has neither, so each CTA reads its
// own block id from device memory and computes its addresses; the
// scatter's base is the caller's tensor, updated in place, where the TPU
// aliased it into the output.
//
// Bound: device-memory bytes. Each copy reads k blocks and writes k
// blocks, plus 4 bytes of index per block; nothing is computed. The grid
// is (k, chunks): CTA (i, c) streams chunk c (kChunk bytes) of block i in
// 16-byte vectors, so a 4 KiB block is one CTA and a 128 KiB page is
// sixteen, enough CTAs in flight to cover the card's memory latency
// either way. The flat source or base may end in a ragged block: the
// gather reads bytes past its end as zero, the scatter writes only the
// bytes below it (the reference's zero-padded `as_blocks`). A block id
// outside [0, nblocks) reads as a zero block and is dropped as a
// destination. TMA bulk copies are later work.
#include "blocks.cuh"

namespace {

constexpr int kThreads = 128;
constexpr long long kChunk = 16LL * kThreads * 4;  // 8 KiB: 4 vectors a thread

__global__ void __launch_bounds__(kThreads)
gather_kernel(const unsigned char* __restrict__ src, long long nbytes,
              long long block_bytes, const int* __restrict__ idx,
              unsigned char* __restrict__ out) {
  const long long i = blockIdx.x;
  const long long s = idx[i];
  const long long slo = s * block_bytes;
  const bool inside = s >= 0 && slo < nbytes;
  unsigned char* dst = out + i * block_bytes;
  const long long c0 = (long long)blockIdx.y * kChunk;
  const long long c1 = c0 + kChunk < block_bytes ? c0 + kChunk : block_bytes;
  if (inside && slo + block_bytes <= nbytes) {  // whole block: plain vector copy
#pragma unroll 4
    for (long long off = c0 + 16LL * threadIdx.x; off < c1; off += 16LL * kThreads) {
      *reinterpret_cast<uint4*>(dst + off) = *reinterpret_cast<const uint4*>(src + slo + off);
    }
  } else {  // the ragged last block, or an id outside the buffer: zeros
    for (long long off = c0 + 16LL * threadIdx.x; off < c1; off += 16LL * kThreads) {
      *reinterpret_cast<uint4*>(dst + off) =
          inside ? repro::load16(src, slo + off, nbytes) : make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
scatter_kernel(const unsigned char* __restrict__ upd, long long block_bytes,
               const int* __restrict__ idx, unsigned char* __restrict__ out,
               long long nbytes) {
  const long long i = blockIdx.x;
  const long long d = idx[i];
  const long long dlo = d * block_bytes;
  if (d < 0 || dlo >= nbytes) return;  // dropped, as a JAX scatter drops it
  const long long dhi = dlo + block_bytes < nbytes ? dlo + block_bytes : nbytes;
  const unsigned char* s = upd + i * block_bytes;
  const long long c0 = (long long)blockIdx.y * kChunk;
  const long long c1 = c0 + kChunk < block_bytes ? c0 + kChunk : block_bytes;
#pragma unroll 4
  for (long long off = c0 + 16LL * threadIdx.x; off < c1; off += 16LL * kThreads) {
    const uint4 v = *reinterpret_cast<const uint4*>(s + off);
    const long long o = dlo + off;
    if (o + 16 <= dhi) {
      *reinterpret_cast<uint4*>(out + o) = v;
    } else if (o < dhi) {
      repro::store_partial(out + o, v, (int)(dhi - o));
    }
  }
}

dim3 grid_for(long long k, long long block_bytes) {
  return dim3((unsigned)k, (unsigned)((block_bytes + kChunk - 1) / kChunk));
}

}  // namespace

// src: `nbytes` bytes, 16-byte aligned; idx int32[k]; out: k*block_bytes
// bytes, 16-byte aligned, all written. Returns the cudaError_t of the
// launch.
extern "C" int delta_gather(const void* src, long long nbytes, long long block_bytes,
                            long long k, const void* idx, void* out, void* stream) {
  if (k > 0) {
    gather_kernel<<<grid_for(k, block_bytes), kThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const unsigned char*>(src), nbytes, block_bytes,
        static_cast<const int*>(idx), static_cast<unsigned char*>(out));
  }
  return (int)cudaGetLastError();
}

// upd: k*block_bytes bytes, 16-byte aligned; idx int32[k], duplicate-free;
// out: `nbytes` bytes, 16-byte aligned, updated in place. Returns the
// cudaError_t of the launch.
extern "C" int delta_scatter(const void* upd, long long block_bytes, long long k,
                             const void* idx, void* out, long long nbytes,
                             void* stream) {
  if (k > 0) {
    scatter_kernel<<<grid_for(k, block_bytes), kThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const unsigned char*>(upd), block_bytes, static_cast<const int*>(idx),
        static_cast<unsigned char*>(out), nbytes);
  }
  return (int)cudaGetLastError();
}
