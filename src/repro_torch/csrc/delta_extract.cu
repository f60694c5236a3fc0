// Fused optimal-delta extraction, the RR step (paper §IV, Algorithm 2
// line 15), over the flat elements of two states d and x of one shape:
//
//     s  = Δ(d, x)   (d's element where its irreducibles are ⋢ x, else ⊥)
//     xj = x ⊔ d
//     count += |⇓s|  (max: the elements with d > x; or: the popcount of
//                     d & ~x)
//
// Replaces the TPU kernel delta_extract_2d / _delta_kernel
// (src/repro/kernels/delta_extract.py:50, body :30).
//
// Bound on the H100: bytes. d and x are read once, s and xj written once
// (4 planes): for 15 × 4,194,304 int32 entries 4 × 251.7 MB, at least
// 0.300 ms at 3.35 TB/s. The count is 4 bytes.
//
// Design: as join.cu — a 1-D grid, EW_UNROLL 16-byte chunks a thread with
// every load issued first, vector accesses when all four arrays are
// 16-byte aligned, and no padding (nothing past element n is read). The
// TPU kernel writes one count per tile and sums them afterwards; here each
// thread counts in a register, the block sums its threads (a warp
// __reduce_add_sync each, then one more over the warps' sums in shared
// memory) and adds the sum to the int32 count with one atomicAdd. Integer
// addition is exact in any order, so the count does not depend on the
// schedule. The grid covers the array (one block per 512 chunks), so an
// atomicAdd per warp instead would put tens of thousands of atomics on
// one address.

#include "common.cuh"

template <class T, class Op, bool VEC>
__global__ void delta_kernel(const T* __restrict__ d, const T* __restrict__ x,
                             T* __restrict__ s, T* __restrict__ xj,
                             int* __restrict__ count, long long n) {
  constexpr int W = 16 / sizeof(T);           // elements per chunk
  const long long first =
      (long long)blockIdx.x * EW_THREADS * EW_UNROLL + threadIdx.x;
  Chunk<T> dv[EW_UNROLL], xv[EW_UNROLL];
#pragma unroll
  for (int u = 0; u < EW_UNROLL; ++u) {       // every load first
    const long long at = (first + (long long)u * EW_THREADS) * W;
    if (VEC && at + W <= n) {
      dv[u].v = *reinterpret_cast<const uint4*>(d + at);
      xv[u].v = *reinterpret_cast<const uint4*>(x + at);
    }
  }
  int c = 0;
#pragma unroll
  for (int u = 0; u < EW_UNROLL; ++u) {
    const long long at = (first + (long long)u * EW_THREADS) * W;
    if (VEC && at + W <= n) {
      Chunk<T> sv, jv;
#pragma unroll
      for (int k = 0; k < W; ++k) {
        sv.e[k] = Op::novel(dv[u].e[k], xv[u].e[k]);
        jv.e[k] = Op::join(xv[u].e[k], dv[u].e[k]);
        c += Op::novel_count(dv[u].e[k], xv[u].e[k]);
      }
      *reinterpret_cast<uint4*>(s + at) = sv.v;
      *reinterpret_cast<uint4*>(xj + at) = jv.v;
    } else {
#pragma unroll
      for (int k = 0; k < W; ++k) {
        if (at + k < n) {
          const T dk = d[at + k], xk = x[at + k];
          s[at + k] = Op::novel(dk, xk);
          xj[at + k] = Op::join(xk, dk);
          c += Op::novel_count(dk, xk);
        }
      }
    }
  }
  block_add(count, c);          // every thread reaches this line
}

template <class T, class Op>
static int launch(const void* d, const void* x, void* s, void* xj,
                  void* count, long long n, cudaStream_t stream) {
  constexpr int W = 16 / sizeof(T);
  const unsigned blocks = ew_blocks((n + W - 1) / W);
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  auto dp = static_cast<const T*>(d);
  auto xp = static_cast<const T*>(x);
  auto sp = static_cast<T*>(s);
  auto jp = static_cast<T*>(xj);
  auto cp = static_cast<int*>(count);
  if (aligned16(d) && aligned16(x) && aligned16(s) && aligned16(xj))
    delta_kernel<T, Op, true><<<blocks, EW_THREADS, 0, stream>>>(
        dp, xp, sp, jp, cp, n);
  else
    delta_kernel<T, Op, false><<<blocks, EW_THREADS, 0, stream>>>(
        dp, xp, sp, jp, cp, n);
  return static_cast<int>(cudaGetLastError());
}

// d, x, s, xj: n contiguous elements of the kind's type; count: one int32,
// zeroed by the caller, to which the novel irreducibles are added.
extern "C" int delta_extract_launch(int kind, const void* d, const void* x,
                                    void* s, void* xj, void* count,
                                    long long n, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case KIND_MAX_U8:
      return launch<uint8_t, MaxOp>(d, x, s, xj, count, n, st);
    case KIND_MAX_I32:
      return launch<int32_t, MaxOp>(d, x, s, xj, count, n, st);
    case KIND_OR_U32:
      return launch<uint32_t, OrOp>(d, x, s, xj, count, n, st);
    case KIND_MAX_I8:
      return launch<int8_t, MaxOp>(d, x, s, xj, count, n, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
