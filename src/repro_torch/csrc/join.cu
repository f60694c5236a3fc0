// Elementwise lattice join, c = a ⊔ b, over the flat elements of two
// states of one shape: pointwise max (GCounter and GMap entries, bool and
// uint8 0/1 flags, int8) or bitwise or (bit-packed sets).
//
// Replaces the TPU kernel join_2d / _join_kernel
// (src/repro/kernels/join.py:37, body :25).
//
// Bound on the H100: bytes. Each element of a and b is read once and c
// written once, one compare or or per element: for 15 × 4,194,304 int32
// entries that is 3 × 251.7 MB, at least 0.225 ms at 3.35 TB/s.
//
// Design: the TPU kernel joins (512, 1024) tiles of ⊥-padded 2-D operands;
// here the wrapper hands over the states' own contiguous memory, flat, and
// nothing past element n is read, so no padding is needed. A 1-D grid:
// each thread takes EW_UNROLL 16-byte chunks, EW_THREADS chunks apart, and
// issues all their loads before its first store (one vector load of each
// operand and one vector store per chunk when all three pointers are
// 16-byte aligned; the last, partial chunk and unaligned operands element
// by element). Neighbouring threads touch neighbouring chunks, so every
// access is coalesced.

#include "common.cuh"

template <class T, class Op, bool VEC>
__global__ void join_kernel(const T* __restrict__ a, const T* __restrict__ b,
                            T* __restrict__ out, long long n) {
  constexpr int W = 16 / sizeof(T);           // elements per chunk
  const long long first =
      (long long)blockIdx.x * EW_THREADS * EW_UNROLL + threadIdx.x;
  Chunk<T> x[EW_UNROLL], y[EW_UNROLL];
#pragma unroll
  for (int u = 0; u < EW_UNROLL; ++u) {       // every load first
    const long long at = (first + (long long)u * EW_THREADS) * W;
    if (VEC && at + W <= n) {
      x[u].v = *reinterpret_cast<const uint4*>(a + at);
      y[u].v = *reinterpret_cast<const uint4*>(b + at);
    }
  }
#pragma unroll
  for (int u = 0; u < EW_UNROLL; ++u) {
    const long long at = (first + (long long)u * EW_THREADS) * W;
    if (VEC && at + W <= n) {
      Chunk<T> o;
#pragma unroll
      for (int k = 0; k < W; ++k) o.e[k] = Op::join(x[u].e[k], y[u].e[k]);
      *reinterpret_cast<uint4*>(out + at) = o.v;
    } else {
#pragma unroll
      for (int k = 0; k < W; ++k)
        if (at + k < n) out[at + k] = Op::join(a[at + k], b[at + k]);
    }
  }
}

template <class T, class Op>
static int launch(const void* a, const void* b, void* out, long long n,
                  cudaStream_t stream) {
  constexpr int W = 16 / sizeof(T);
  const unsigned blocks = ew_blocks((n + W - 1) / W);
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  auto ap = static_cast<const T*>(a);
  auto bp = static_cast<const T*>(b);
  auto op = static_cast<T*>(out);
  if (aligned16(a) && aligned16(b) && aligned16(out))
    join_kernel<T, Op, true><<<blocks, EW_THREADS, 0, stream>>>(ap, bp, op,
                                                                n);
  else
    join_kernel<T, Op, false><<<blocks, EW_THREADS, 0, stream>>>(ap, bp, op,
                                                                 n);
  return static_cast<int>(cudaGetLastError());
}

// a, b, out: n contiguous elements of the kind's type (uint8 and int8 for
// max, int32 for max, 32-bit words for or).
extern "C" int join_launch(int kind, const void* a, const void* b, void* out,
                           long long n, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case KIND_MAX_U8: return launch<uint8_t, MaxOp>(a, b, out, n, s);
    case KIND_MAX_I32: return launch<int32_t, MaxOp>(a, b, out, n, s);
    case KIND_OR_U32: return launch<uint32_t, OrOp>(a, b, out, n, s);
    case KIND_MAX_I8: return launch<int8_t, MaxOp>(a, b, out, n, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
