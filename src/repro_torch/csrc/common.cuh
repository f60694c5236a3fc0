// Shared pieces of the port's CUDA kernels: the two join orders, the
// per-element counts, the kind dispatch of the C entry points, the warp-
// and block-reduced integer counters, and the 16-byte chunks and launch
// shape of the elementwise kernels.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// Pointwise max order: ℕ-max states (int32) and 0/1-or states (uint8).
struct MaxOp {
  template <class T> __device__ static T join(T a, T b) { return a > b ? a : b; }
  // Δ(d, x) element and its irreducible count: novel iff d > x.
  template <class T> __device__ static T novel(T d, T x) { return d > x ? d : T(0); }
  template <class T> __device__ static int novel_count(T d, T x) { return d > x; }
  template <class T> __device__ static int count(T v) { return v != 0; }
};

// Bit-packed sets: one irreducible per bit of a uint32 word.
struct OrOp {
  __device__ static uint32_t join(uint32_t a, uint32_t b) { return a | b; }
  __device__ static uint32_t novel(uint32_t d, uint32_t x) { return d & ~x; }
  __device__ static int novel_count(uint32_t d, uint32_t x) { return __popc(d & ~x); }
  __device__ static int count(uint32_t v) { return __popc(v); }
};

// Kind codes of the C entry points (kernels/_build.py KIND_CODES). The sync
// kernels take the first three; join and delta_extract also take int8 max
// (signed compares).
enum KindCode { KIND_MAX_U8 = 0, KIND_MAX_I32 = 1, KIND_OR_U32 = 2,
                KIND_MAX_I8 = 3 };

// Sum v over the warp and add it to a shared-memory counter. Every lane of
// the warp must call it (control flow in the kernels is warp-uniform).
__device__ __forceinline__ void warp_add(int* counter, int v) {
  int s = __reduce_add_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0 && s != 0) atomicAdd(counter, s);
}

// Sum v over the block and add it to a device-memory counter with one
// atomicAdd: a warp sum each, then the first warp sums the warps' sums.
// Every thread of the block must call it; blockDim.x is a multiple of 32.
__device__ __forceinline__ void block_add(int* counter, int v) {
  __shared__ int part[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = __reduce_add_sync(0xffffffffu, v);
  if (lane == 0) part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? part[lane] : 0;
    v = __reduce_add_sync(0xffffffffu, v);
    if (lane == 0 && v != 0) atomicAdd(counter, v);
  }
}

// 16 bytes of T: one vector load or store.
template <class T>
union Chunk {
  uint4 v;
  T e[16 / sizeof(T)];
};

static inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The elementwise kernels' launch shape: THREADS threads a block, each
// thread UNROLL 16-byte chunks, all loads issued before the first store.
constexpr int EW_THREADS = 256;
constexpr int EW_UNROLL = 2;

// Blocks covering `chunks` chunks at EW_UNROLL chunks a thread (at least
// one; 0 if more than a 1-D grid can hold).
static unsigned ew_blocks(long long chunks) {
  const long long per = (long long)EW_THREADS * EW_UNROLL;
  const long long b = (chunks + per - 1) / per;
  return b < 1 ? 1u : (b > 0x7fffffffLL ? 0u : (unsigned)b);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
