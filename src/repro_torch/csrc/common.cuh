// Shared pieces of the port's CUDA kernels: the two join orders, the
// per-element counts, the kind dispatch of the C entry points, and the
// warp-reduced integer counters.
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

// Kind codes of the C entry points (kernels/_build.py KIND_CODES).
enum KindCode { KIND_MAX_U8 = 0, KIND_MAX_I32 = 1, KIND_OR_U32 = 2 };

// Sum v over the warp and add it to a shared-memory counter. Every lane of
// the warp must call it (control flow in the kernels is warp-uniform).
__device__ __forceinline__ void warp_add(int* counter, int v) {
  int s = __reduce_add_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0 && s != 0) atomicAdd(counter, s);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
