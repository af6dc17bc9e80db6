// Shared machinery of the ring-buffered walks (encode_walks.cu,
// decode_walks.cu).
//
// A walk CTA keeps its walkers in warp 0 and its helper warps in warps
// 1..: the helpers fill a ring of kStages shared-memory stages, each a
// chunk of L positions, with cp.async, and run the carry-free pre-pass
// (and, where a walk has one, the post-pass and the store) while warp 0
// steps through the previous chunk. The stage layouts are each walk's
// own; every array in them starts 16-byte aligned (arr). The Python
// mirrors of the layouts and the launch geometry are
// bitstream/encode_kernels.walk_geometry and
// bitstream/decode_kernels.rng_geometry, and prepare_walk refuses a
// geometry whose shared-memory bytes differ from the kernel's layout.

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kStages = 2;
constexpr int kMaxThreads = 256;
// the encode walks: a CTA holds kTile streams x kCand candidates, whose
// kWalkers walkers fill warp 0
constexpr int kCand = 8;
constexpr int kTile = 4;
constexpr int kWalkers = kTile * kCand;

// Bytes of n 4-byte elements, rounded up to 16 so every array starts
// 16-byte aligned. Mirrored by encode_kernels._arr.
__host__ __device__ constexpr int arr(int n) { return (n * 4 + 15) / 16 * 16; }

// Positions [lo, hi) of chunk k in walk order.
struct Span {
  int lo, hi;
};
__device__ __forceinline__ Span chunk_span(int k, int L, int P, bool reverse) {
  if (reverse) {
    const int hi = P - k * L;
    return {max(hi - L, 0), hi};
  }
  const int lo = k * L;
  return {lo, min(lo + L, P)};
}

// The helper warps' own barrier (warp 0 walks meanwhile).
__device__ __forceinline__ void helpers_sync(int nh) {
  asm volatile("bar.sync 1, %0;" ::"r"(nh) : "memory");
}

// rows [row0, row0 + n) x streams [b0, b0 + ns) of a [rows, B] plane ->
// dst[i * ld + j], one 4-byte cp.async each (so any B is served)
__device__ __forceinline__ void copy_rows(int* dst, int ld, const int* src, int row0, int n,
                                          int B, int b0, int ns, int h, int nh) {
  for (int e = h; e < n * ns; e += nh) {
    const int i = e / ns, j = e - i * ns;
    __pipeline_memcpy_async(dst + i * ld + j, src + static_cast<size_t>(row0 + i) * B + b0 + j,
                            4);
  }
}

// rows [row0, row0 + n) of a [P, B, 8] plane, streams [b0, b0 + ns) ->
// dst[i * kWalkers + lane], 16-byte cp.async pieces
__device__ __forceinline__ void copy_cand_rows(int* dst, const int* src, int row0, int n, int B,
                                               int b0, int ns, int h, int nh) {
  const int per_row = ns * 2;
  for (int e = h; e < n * per_row; e += nh) {
    const int i = e / per_row, q = e - i * per_row;
    __pipeline_memcpy_async(dst + i * kWalkers + q * 4,
                            src + (static_cast<size_t>(row0 + i) * B + b0) * kCand + q * 4, 16);
  }
}

constexpr int kMaxDevices = 64;

// Checks the geometry the wrapper passes against the kernel's layout
// (want_smem), and lets the kernel take that much dynamic shared memory.
// allowed[device] is the most the kernel may already take there (the
// caller keeps one static array per kernel): the attribute is set only
// when a launch needs more, not at every launch: setting it stalls the
// host (on an H100, setting it at every RNG-expand launch cost the
// host-bound decode path 15 % of its realtime factor). Returns a
// cudaError_t.
template <typename Kernel>
int prepare_walk(Kernel kernel, int* allowed, int L, int threads, int smem, int want_smem) {
  if (L < 2 || L % 2 || threads < 2 * kWarp || threads > kMaxThreads || threads % kWarp ||
      smem != want_smem)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < kMaxDevices && allowed[dev] >= smem) return 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && dev < kMaxDevices) allowed[dev] = smem;
  return static_cast<int>(err);
}

}  // namespace
