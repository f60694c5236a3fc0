// Slot-order receive of one sync round (Algorithm 2, lines 14-17): for each
// row (node) m and column (universe slot) u,
//
//     for q in 0 .. P-1:                      (slot order)
//         d        = active[m, q] ? d_in[q, m, u] : ⊥
//         stored_q = Δ(d, x)                  (RR extraction, vs the RUNNING x)
//         cnt[m,q] += |⇓stored_q|,  dsz[m,q] += |⇓d|,  cov[m,u] += |⇓d|
//         x        = x ⊔ d
//
// Replaces the TPU kernel round_recv_2d / _round_recv_kernel
// (src/repro/kernels/round_recv.py:126, body :60).
//
// Bound on the H100: bytes. Per element it reads P gathered δ-groups and x
// and writes x', and P extractions when emit_stored; the paper's mesh (P=4)
// over 4,194,304 int32 keys and 15 nodes moves 1.51 GB (2.52 GB with
// emit_stored): at least 0.45 ms (0.75 ms) at 3.35 TB/s.
//
// Design: one thread per (row, column), grid-striding over the columns of
// its row, so each slot's loads are coalesced and x stays in a register
// across the P slots (one read, one write). The per-(row, slot) counts are
// sums over the columns: each warp reduces its lanes (__reduce_add_sync)
// into shared-memory counters, and the block adds those to the zeroed int32
// outputs with one atomicAdd per counter. Integer atomics are exact in any
// order, so the counts are deterministic.

#include "common.cuh"

template <class T, class Op>
__global__ void recv_kernel(const T* __restrict__ d, const T* __restrict__ x,
                            const int32_t* __restrict__ active,
                            T* __restrict__ xo, T* __restrict__ stored,
                            int32_t* __restrict__ cov, int32_t* cnt,
                            int32_t* dsz, int p, long long m, long long u) {
  extern __shared__ int smem[];
  int* s_act = smem;           // [P] active flags of this row
  int* s_cnt = smem + p;       // [P] novel counts
  int* s_dsz = smem + 2 * p;   // [P] received sizes
  const long long row = blockIdx.y;
  for (int i = threadIdx.x; i < p; i += blockDim.x) {
    s_act[i] = active[row * p + i];
    s_cnt[i] = 0;
    s_dsz[i] = 0;
  }
  __syncthreads();
  // The loop bound is block-uniform so every lane reaches the warp sums.
  for (long long base = blockIdx.x * (long long)blockDim.x; base < u;
       base += (long long)gridDim.x * blockDim.x) {
    const long long col = base + threadIdx.x;
    const bool valid = col < u;
    const long long at = row * u + col;
    T xv = valid ? x[at] : T(0);
    int tally = 0;
    for (int q = 0; q < p; ++q) {
      const long long dq_at = (q * m + row) * u + col;
      const T dv = (valid && s_act[q]) ? d[dq_at] : T(0);
      if (stored != nullptr && valid) stored[dq_at] = Op::novel(dv, xv);
      const int c = Op::novel_count(dv, xv);
      const int z = Op::count(dv);
      tally += z;
      xv = Op::join(xv, dv);
      warp_add(&s_cnt[q], c);
      warp_add(&s_dsz[q], z);
    }
    if (valid) {
      xo[at] = xv;
      if (cov != nullptr) cov[at] = tally;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < p; i += blockDim.x) {
    if (s_cnt[i]) atomicAdd(&cnt[row * p + i], s_cnt[i]);
    if (s_dsz[i]) atomicAdd(&dsz[row * p + i], s_dsz[i]);
  }
}

template <class T, class Op>
static int launch(const void* d, const void* x, const void* active, void* xo,
                  void* stored, void* cov, void* cnt, void* dsz, int p,
                  long long m, long long u, cudaStream_t stream) {
  const int threads = 256;
  long long want = (u + threads - 1) / threads;
  dim3 grid((unsigned)(want < 1024 ? want : 1024), (unsigned)m);
  recv_kernel<T, Op><<<grid, threads, 3 * p * sizeof(int), stream>>>(
      static_cast<const T*>(d), static_cast<const T*>(x),
      static_cast<const int32_t*>(active), static_cast<T*>(xo),
      static_cast<T*>(stored), static_cast<int32_t*>(cov),
      static_cast<int32_t*>(cnt), static_cast<int32_t*>(dsz), p, m, u);
  return static_cast<int>(cudaGetLastError());
}

// d [P, M, U], x [M, U], active int32 [M, P]; outputs xo [M, U],
// stored [P, M, U] (nullable), cov int32 [M, U] (nullable), and the zeroed
// int32 counts cnt/dsz [M, P]. All contiguous.
extern "C" int round_recv_launch(int kind, const void* d, const void* x,
                                 const void* active, void* xo, void* stored,
                                 void* cov, void* cnt, void* dsz, int p,
                                 long long m, long long u, void* stream) {
  if (p < 1 || m < 1 || m > 65535 || u < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case KIND_MAX_U8:
      return launch<uint8_t, MaxOp>(d, x, active, xo, stored, cov, cnt, dsz, p, m, u, s);
    case KIND_MAX_I32:
      return launch<int32_t, MaxOp>(d, x, active, xo, stored, cov, cnt, dsz, p, m, u, s);
    case KIND_OR_U32:
      return launch<uint32_t, OrOp>(d, x, active, xo, stored, cov, cnt, dsz, p, m, u, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
