// Leave-one-out buffer fold: the per-neighbour sends of the BP flavours
// (paper §IV, Algorithm 2 line 11),
//
//     send[j] = ⊔ { buf[o] | o ≠ j },   j = 0 .. K-2,
//
// over K origin slots (K = P neighbours + 1 self slot).
//
// Replaces the TPU kernel buffer_fold_2d / _fold_kernel
// (src/repro/kernels/buffer_fold.py:59, body :34).
//
// Bound on the H100: bytes. Each element of the K input slots is read once
// and each of the K-1 sends written once, with one join per slot; at
// 3.35 TB/s an int32 buffer of the paper's mesh (K = 5) over 4,194,304 keys
// and 15 nodes (1.26 GB in, 1.01 GB out) takes at least 0.68 ms.
//
// Design: one thread per column of the slot-major [K, C] layout (C = N·U
// for the sync engine's [K, N, U] buffer), so neighbouring threads touch
// neighbouring addresses in every slot plane. The
// kernel is compiled for each K up to MAX_SLOTS, so the K slots of the
// element stay in about 2K registers (one generic 16-slot version needed
// 128-162 and fit one block per SM); a suffix pass then a prefix pass give
// all K-1 sends with 2K joins instead of the naive K².

#include "common.cuh"

constexpr int MAX_SLOTS = 16;

template <class T, class Op, int K>
__global__ void fold_kernel(const T* __restrict__ in, T* __restrict__ out,
                            long long cols) {
  for (long long c = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       c < cols; c += (long long)gridDim.x * blockDim.x) {
    T v[K], suf[K];
#pragma unroll
    for (int s = 0; s < K; ++s) v[s] = in[s * cols + c];
    T acc = T(0);
#pragma unroll
    for (int s = K - 1; s >= 0; --s) {
      suf[s] = acc;
      acc = Op::join(acc, v[s]);
    }
    acc = T(0);
#pragma unroll
    for (int s = 0; s < K - 1; ++s) {
      out[s * cols + c] = Op::join(acc, suf[s]);
      acc = Op::join(acc, v[s]);
    }
  }
}

template <class T, class Op, int K>
static int launch_k(const void* in, void* out, long long cols,
                    cudaStream_t stream) {
  const int threads = 256;
  long long want = (cols + threads - 1) / threads;
  const unsigned blocks = (unsigned)(want < 8192 ? want : 8192);
  fold_kernel<T, Op, K><<<blocks, threads, 0, stream>>>(
      static_cast<const T*>(in), static_cast<T*>(out), cols);
  return static_cast<int>(cudaGetLastError());
}

// One instantiation per slot count, so the K slots stay in registers.
template <class T, class Op>
static int launch(const void* in, void* out, int k, long long cols,
                  cudaStream_t stream) {
  switch (k) {
#define FOLD_CASE(K) \
    case K: return launch_k<T, Op, K>(in, out, cols, stream);
    FOLD_CASE(2) FOLD_CASE(3) FOLD_CASE(4) FOLD_CASE(5) FOLD_CASE(6)
    FOLD_CASE(7) FOLD_CASE(8) FOLD_CASE(9) FOLD_CASE(10) FOLD_CASE(11)
    FOLD_CASE(12) FOLD_CASE(13) FOLD_CASE(14) FOLD_CASE(15) FOLD_CASE(16)
#undef FOLD_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// in [k, cols] -> out [k-1, cols], both contiguous.
extern "C" int buffer_fold_launch(int kind, const void* in, void* out, int k,
                                  long long cols, void* stream) {
  if (k < 2 || k > MAX_SLOTS || cols < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case KIND_MAX_U8: return launch<uint8_t, MaxOp>(in, out, k, cols, s);
    case KIND_MAX_I32: return launch<int32_t, MaxOp>(in, out, k, cols, s);
    case KIND_OR_U32: return launch<uint32_t, OrOp>(in, out, k, cols, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
