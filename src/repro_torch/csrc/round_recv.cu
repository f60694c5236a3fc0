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
// Two shapes of rows, two kernels. A lane holds one vector of a row — 16
// bytes where every row starts on a 16-byte boundary, else one element —
// and keeps x in registers across the P slots (one read, one write), so
// each slot's loads are coalesced.
//
// - Short rows (at most 32 vectors: a keyed store's objects, a sweep's
//   small states): a group of G lanes of a warp (G a power of two, the
//   row's vectors rounded up) works one row, so a warp works 32/G rows at
//   once and the grid strides over the rows as one flat index (any row
//   count; 64-bit offsets). The group sums each slot's counts by xor-
//   shuffles inside itself and its first lane writes them: no atomics.
// - Long rows (the paper-size states): blocks of 256 threads grid-stride
//   over a row's columns, each warp reduces its lanes (__reduce_add_sync)
//   into shared-memory counters and the block adds those to the zeroed
//   outputs with one atomicAdd per counter; the rows stride over gridDim.y
//   (any row count).
// Integer sums are exact in any order, so the counts are deterministic.

#include "common.cuh"

template <class T, class Op, int VB>
__global__ void short_kernel(const T* __restrict__ d, const T* __restrict__ x,
                             const int32_t* __restrict__ active,
                             T* __restrict__ xo, T* __restrict__ stored,
                             int32_t* __restrict__ cov, int32_t* cnt,
                             int32_t* dsz, int p, long long m, long long u,
                             int lg) {
  using L = Lane<T, VB>;
  constexpr int V = L::V;
  const int lane = threadIdx.x & 31;
  const int g = 1 << lg;                       // lanes a row
  const int sub = lane & (g - 1);              // the lane's vector
  const int per_warp = 32 >> lg;               // rows a warp step
  const long long col = (long long)sub * V;    // the lane's first column
  const bool in_row = col < u;                 // a vector is all in or out
  const long long warp = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
  const long long plane = m * u;
  // The loop bound is warp-uniform so every lane reaches the shuffles.
  for (long long base = warp * per_warp; base < m; base += warps * per_warp) {
    const long long row = base + (lane >> lg);
    const bool valid = row < m && in_row;
    const long long at = row * u + col;
    L xv;
    if (valid) xv.load(x + at);
    else xv.zero();
    int tally[V];
#pragma unroll
    for (int j = 0; j < V; ++j) tally[j] = 0;
    for (int q = 0; q < p; ++q) {
      const bool on = valid && active[row * p + q] != 0;
      L dv, nv;
      if (on) dv.load(d + q * plane + at);
      else dv.zero();
      int c = 0, z = 0;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        nv.e[j] = Op::novel(dv.e[j], xv.e[j]);
        c += Op::novel_count(dv.e[j], xv.e[j]);
        const int zj = Op::count(dv.e[j]);
        z += zj;
        tally[j] += zj;
      }
      if (stored != nullptr && valid) nv.store(stored + q * plane + at);
      xv.template join<Op>(dv);
      for (int off = g >> 1; off > 0; off >>= 1) {
        c += __shfl_xor_sync(0xffffffffu, c, off);
        z += __shfl_xor_sync(0xffffffffu, z, off);
      }
      if (sub == 0 && row < m) {
        cnt[row * p + q] = c;
        dsz[row * p + q] = z;
      }
    }
    if (valid) {
      xv.store(xo + at);
      if (cov != nullptr)
#pragma unroll
        for (int j = 0; j < V; ++j) cov[at + j] = tally[j];
    }
  }
}

template <class T, class Op>
__global__ void long_kernel(const T* __restrict__ d, const T* __restrict__ x,
                            const int32_t* __restrict__ active,
                            T* __restrict__ xo, T* __restrict__ stored,
                            int32_t* __restrict__ cov, int32_t* cnt,
                            int32_t* dsz, int p, long long m, long long u) {
  extern __shared__ int smem[];
  int* s_act = smem;           // [P] active flags of this row
  int* s_cnt = smem + p;       // [P] novel counts
  int* s_dsz = smem + 2 * p;   // [P] received sizes
  for (long long row = blockIdx.y; row < m; row += gridDim.y) {
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
    __syncthreads();           // the counters are reset for the next row
  }
}

constexpr int THREADS = 256;

template <class T, class Op>
static int launch(const void* d, const void* x, const void* active, void* xo,
                  void* stored, void* cov, void* cnt, void* dsz, int p,
                  long long m, long long u, int vec, long long max_blocks,
                  cudaStream_t stream) {
  constexpr int V16 = 16 / (int)sizeof(T);
  const long long vecs = vec ? u / V16 : u;    // vectors a row
  if (vecs <= 32) {
    int lg = 0;
    while ((1LL << lg) < vecs) ++lg;
    const long long threads = m << lg;
    long long blocks = (threads + THREADS - 1) / THREADS;
    if (blocks > max_blocks) blocks = max_blocks;
#define SHORT_ARGS                                                             \
  static_cast<const T*>(d), static_cast<const T*>(x),                         \
      static_cast<const int32_t*>(active), static_cast<T*>(xo),               \
      static_cast<T*>(stored), static_cast<int32_t*>(cov),                    \
      static_cast<int32_t*>(cnt), static_cast<int32_t*>(dsz), p, m, u, lg
    if (vec)
      short_kernel<T, Op, 16><<<(unsigned)blocks, THREADS, 0, stream>>>(SHORT_ARGS);
    else
      short_kernel<T, Op, 0><<<(unsigned)blocks, THREADS, 0, stream>>>(SHORT_ARGS);
#undef SHORT_ARGS
    return static_cast<int>(cudaGetLastError());
  }
  long long want = (u + THREADS - 1) / THREADS;
  long long rows = m < 65535 ? m : 65535;
  if (rows > max_blocks) rows = max_blocks;
  dim3 grid((unsigned)(want < 1024 ? want : 1024), (unsigned)rows);
  long_kernel<T, Op><<<grid, THREADS, 3 * p * sizeof(int), stream>>>(
      static_cast<const T*>(d), static_cast<const T*>(x),
      static_cast<const int32_t*>(active), static_cast<T*>(xo),
      static_cast<T*>(stored), static_cast<int32_t*>(cov),
      static_cast<int32_t*>(cnt), static_cast<int32_t*>(dsz), p, m, u);
  return static_cast<int>(cudaGetLastError());
}

// d [P, M, U], x [M, U], active int32 [M, P]; outputs xo [M, U],
// stored [P, M, U] (nullable), cov int32 [M, U] (nullable), and the zeroed
// int32 counts cnt/dsz [M, P]. All contiguous. `vec`: every row of every
// operand starts on a 16-byte boundary (U·elem a multiple of 16, aligned
// bases), so a lane may move 16 bytes. `max_blocks` caps the short rows'
// blocks and the long rows' gridDim.y; both grid-stride beyond it.
extern "C" int round_recv_launch(int kind, const void* d, const void* x,
                                 const void* active, void* xo, void* stored,
                                 void* cov, void* cnt, void* dsz, int p,
                                 long long m, long long u, int vec,
                                 long long max_blocks, void* stream) {
  if (p < 1 || m < 1 || u < 1 || max_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case KIND_MAX_U8:
      return launch<uint8_t, MaxOp>(d, x, active, xo, stored, cov, cnt, dsz, p, m, u, vec, max_blocks, s);
    case KIND_MAX_I32:
      return launch<int32_t, MaxOp>(d, x, active, xo, stored, cov, cnt, dsz, p, m, u, vec, max_blocks, s);
    case KIND_OR_U32:
      return launch<uint32_t, OrOp>(d, x, active, xo, stored, cov, cnt, dsz, p, m, u, vec, max_blocks, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
