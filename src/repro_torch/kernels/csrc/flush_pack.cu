// The save path's device pass: dirty flags, per-block popcounts, the
// exclusive prefix sum of the flags, and the dirty blocks packed in
// ascending order with their ids, tails zeroed.
//
// Replaces the TPU kernel `flush_pack_blocked` / `_flush_pack_kernel` of
// src/repro/kernels/flush_pack/kernel.py. That kernel carries the running
// prefix sum in SMEM across a grid that runs in order; CTAs on Hopper run
// in no order, so the pass is three launches on one stream:
//   1. scan:        one CTA per block — flag (some lane differs, under the
//                   wrapper's compare kind) and popcount of the live
//                   bytes, one read of each buffer (`repro::scan_block`,
//                   shared with flush_scan.cu);
//   2. prefix_sum:  one CTA loops over the flags (at most ~124k per leaf
//                   at 4 KiB blocks) with warp-shuffle scans, carrying the
//                   running total in shared memory; writes n+1 offsets,
//                   the last being the dirty total;
//   3. pack:        one CTA per block — a dirty block copies itself to
//                   row offsets[b] of `packed` and writes its id to
//                   index[offsets[b]]; a CTA whose own row lies at or past
//                   the total zeroes that row and index entry. Every row
//                   is written exactly once, so no memset precedes it.
//
// Bound: device-memory bytes. Launch 1 reads live and snapshot once
// (2n bytes); launch 3 re-reads the dirty blocks and writes all of
// `packed` (n rounded up to blocks). The re-read of dirty blocks is the
// price of the order-free grid; the save path never reads `packed` back,
// so a no-pack mode would leave 2n bytes (ROADMAP).
#include "blocks.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 4;

template <int K>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const unsigned char* __restrict__ cur, const unsigned char* __restrict__ snap,
            long long nbytes, long long block_bytes, int* __restrict__ flags,
            unsigned* __restrict__ counts) {
  repro::scan_block<K, kThreads>(cur, snap, nbytes, block_bytes, flags, counts);
}

// offsets[i] = sum(flags[:i]) for i in [0, n]; offsets[n] is the total.
__global__ void __launch_bounds__(kScanThreads)
prefix_sum_kernel(const int* __restrict__ flags, long long n, int* __restrict__ offsets) {
  __shared__ int warp_excl[kScanThreads / 32];
  __shared__ int carry;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (long long base = 0; base < n; base += (long long)kScanThreads * kScanItems) {
    const long long i0 = base + (long long)threadIdx.x * kScanItems;
    int v[kScanItems];
    int local = 0;
#pragma unroll
    for (int j = 0; j < kScanItems; ++j) {
      v[j] = (i0 + j < n && flags[i0 + j] != 0) ? 1 : 0;
      local += v[j];
    }
    int incl = local;  // inclusive scan of the per-thread sums in the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(repro::kFullMask, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) warp_excl[warp] = incl;
    __syncthreads();
    if (warp == 0) {  // exclusive scan of the 32 warp totals
      const int t = warp_excl[lane];
      int s = t;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(repro::kFullMask, s, o);
        if (lane >= o) s += y;
      }
      warp_excl[lane] = s - t;
    }
    __syncthreads();
    int run = carry + warp_excl[warp] + (incl - local);
#pragma unroll
    for (int j = 0; j < kScanItems; ++j) {
      if (i0 + j < n) offsets[i0 + j] = run;
      run += v[j];
    }
    __syncthreads();  // every thread has read `carry` and `warp_excl`
    if (threadIdx.x == kScanThreads - 1) carry = run;
    __syncthreads();
  }
  if (threadIdx.x == 0) offsets[n] = carry;
}

__global__ void __launch_bounds__(kThreads)
pack_kernel(const unsigned char* __restrict__ cur, long long nbytes,
            long long block_bytes, const int* __restrict__ flags,
            const int* __restrict__ offsets, long long nblocks,
            unsigned char* __restrict__ packed, int* __restrict__ index) {
  const long long b = blockIdx.x;
  const long long total = offsets[nblocks];
  if (flags[b]) {
    const long long row = offsets[b];
    const long long lo = b * block_bytes;
    unsigned char* dst = packed + row * block_bytes;
    if (lo + block_bytes <= nbytes) {  // whole block: plain vector copy
      for (long long off = 16LL * threadIdx.x; off < block_bytes; off += 16LL * kThreads) {
        *reinterpret_cast<uint4*>(dst + off) = *reinterpret_cast<const uint4*>(cur + lo + off);
      }
    } else {  // the ragged last block: zero past the end
      for (long long off = 16LL * threadIdx.x; off < block_bytes; off += 16LL * kThreads) {
        *reinterpret_cast<uint4*>(dst + off) = repro::load16(cur, lo + off, nbytes);
      }
    }
    if (threadIdx.x == 0) index[row] = (int)b;
  }
  if (b >= total) {
    unsigned char* dst = packed + b * block_bytes;
    for (long long off = 16LL * threadIdx.x; off < block_bytes; off += 16LL * kThreads) {
      *reinterpret_cast<uint4*>(dst + off) = make_uint4(0u, 0u, 0u, 0u);
    }
    if (threadIdx.x == 0) index[b] = 0;
  }
}

}  // namespace

// cur, snap: `nbytes` bytes each, 16-byte aligned; kind: a repro::Compare.
// Outputs (all written):
// flags, offsets[0:nblocks+1] int32; counts uint32; packed
// nblocks*block_bytes bytes (16-byte aligned); index int32[nblocks].
// Returns the cudaError_t of the first launch that failed, else 0.
extern "C" int flush_pack(const void* cur, const void* snap, long long nbytes,
                          long long block_bytes, long long nblocks, int kind,
                          void* flags, void* counts, void* offsets, void* packed,
                          void* index, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned char* c = static_cast<const unsigned char*>(cur);
  if (nblocks > 0) {
    cudaError_t e = repro::with_compare(kind, [&](auto k) {
      scan_kernel<decltype(k)::value><<<(unsigned)nblocks, kThreads, 0, s>>>(
          c, static_cast<const unsigned char*>(snap), nbytes, block_bytes,
          static_cast<int*>(flags), static_cast<unsigned*>(counts));
    });
    if (e == cudaSuccess) e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  prefix_sum_kernel<<<1, kScanThreads, 0, s>>>(static_cast<const int*>(flags), nblocks,
                                               static_cast<int*>(offsets));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || nblocks == 0) return (int)e;
  pack_kernel<<<(unsigned)nblocks, kThreads, 0, s>>>(
      c, nbytes, block_bytes, static_cast<const int*>(flags),
      static_cast<const int*>(offsets), nblocks, static_cast<unsigned char*>(packed),
      static_cast<int*>(index));
  return (int)cudaGetLastError();
}
