// One whole synchronous round of Algorithms 1/2 in one launch, for the dense
// δ-family flavours (state / classic / bp / rr / bprr):
//
//   1. local join:  x ⊔= δ, and δ joins the self slot (per-origin: slot K-1)
//                   or the flat buffer (slot 0);
//   2. sends:       state broadcast (K = 0), flat-buffer broadcast (K = 1), or
//                   the leave-one-out fold send[j] = ⊔_{o≠j} slot[o] (K = P+1);
//   3. ack-gated clear of the buffer where delivered[b, n] != 0;
//   4. routing:     inbox[n, q] = send[rev[n, q]] of node nbrs[n, q];
//   5. P-slot receive in slot order under active[b, n, q], novelty judged
//      against the RUNNING state;
//   6. optionally the RR Δ-merge of each extraction into the cleared buffer
//      (extracts) and the active-masked inbox as an output (emit_inbox).
//
// Counts (int32, summed over the universe): nodecnt[b, n] = (|⇓δ|, |⇓x'|),
// and per slot ssend (send sizes), cnt (novel), dsz (received).
//
// Replaces the TPU kernel round_step_2d / _round_step_kernel
// (src/repro/kernels/round_step.py:148, body :60).
//
// Bound on the H100: bytes. Every element of δ, x and the K buffer slots is
// read once and x' and the K slots written once (plus P inbox planes with
// emit_inbox). For bprr on the paper's mesh (K = 5) over 4,194,304 int32
// keys and 15 nodes that is 13 planes of 252 MB, 3.27 GB: at least 0.98 ms
// at 3.35 TB/s. The sends and the routed inbox never touch device memory.
//
// Design. Routing mixes nodes but never universe columns, so a block owns
// COLS = 32 columns of one config and holds their whole working set in
// shared memory: x [N], the K slots [K·N] and the S sends [S·N] (S = P for
// the leave-one-out fold, else one broadcast plane), each a row of 32
// values. Its threads are (column, node) pairs — warp w handles node w (and
// w + NY, ... when N > 32) for the 32 columns — so every device access of a
// warp is one coalesced row, every shared access hits 32 distinct banks,
// and a warp's lanes share one (node, slot) count, which it reduces with
// __reduce_add_sync into a shared counter. Phases (1)-(2) write each
// node's sends; a barrier; phases (3)-(6) read the senders' rows. With one
// thread per (column, node) a thread's chain of dependent shared accesses
// is about N times shorter than with one thread per column. The paper's
// mesh runs 480 threads in 21 KB per block; at 56-64 registers a thread,
// the register file holds two such blocks (30 warps) per SM.
// The routing tables nbrs/rev and the config's active/delivered masks are
// loaded into shared memory once per block; the counters go to the zeroed
// int32 outputs with one atomicAdd each per block, exact in any order.

#include "common.cuh"

constexpr int COLS = 32;

#define ROW(base, v) (base)[(v) * COLS + tx]

template <class T, class Op>
__global__ void round_step_kernel(
    const T* __restrict__ delta, const T* __restrict__ x, const T* buf,
    const int32_t* __restrict__ active, const int32_t* __restrict__ delivered,
    const int32_t* __restrict__ nbrs, const int32_t* __restrict__ rev,
    T* __restrict__ xo, T* bo, T* __restrict__ inbox, int32_t* nodecnt,
    int32_t* ssend, int32_t* cnt, int32_t* dsz, int nb, int n, int p, int k,
    int per_origin, int extracts, long long u, int table_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int np = n * p;
  int* s_nbrs = reinterpret_cast<int*>(smem);  // [N·P] routing: sender node
  int* s_rev = s_nbrs + np;                    // [N·P] routing: sender slot
  int* s_act = s_rev + np;                     // [N·P] active slots
  int* s_dlv = s_act + np;                     // [N] delivered (clear) flags
  int* s_node = s_dlv + n;                     // [N·2] counts |⇓δ|, |⇓x'|
  int* s_ssend = s_node + 2 * n;               // [N·P] counts
  int* s_cnt = s_ssend + np;                   // [N·P] counts
  int* s_dsz = s_cnt + np;                     // [N·P] counts
  T* X = reinterpret_cast<T*>(smem + table_bytes);  // [N] rows
  T* SL = X + n * COLS;                             // [K·N] rows
  T* SD = SL + k * n * COLS;                        // [S·N] rows

  const int tx = threadIdx.x;                  // column within the block
  const int ny = blockDim.y;                   // node-threads per column
  const int tid = threadIdx.y * COLS + tx;
  const int nthreads = COLS * ny;
  const long long b = blockIdx.y;
  const int self_slot = per_origin ? k - 1 : 0;
  for (int i = tid; i < np; i += nthreads) {
    s_nbrs[i] = nbrs[i];
    s_rev[i] = rev[i];
    s_act[i] = active[b * np + i];
    s_ssend[i] = s_cnt[i] = s_dsz[i] = 0;
  }
  for (int i = tid; i < n; i += nthreads) {
    s_dlv[i] = delivered != nullptr ? delivered[b * n + i] : 0;
    s_node[2 * i] = s_node[2 * i + 1] = 0;
  }
  __syncthreads();

  // The chunk loop and the node loops are warp-uniform (a warp is one node
  // row), so every lane reaches the warp sums; lanes past the last column
  // carry ⊥ and count nothing.
  for (long long base = blockIdx.x * (long long)COLS; base < u;
       base += (long long)gridDim.x * COLS) {
    const long long col = base + tx;
    const bool valid = col < u;

    // (1) local join, (2) sends — each thread for its own nodes
    for (int i = threadIdx.y; i < n; i += ny) {
      const long long at = (b * n + i) * u + col;
      const T dv = valid ? delta[at] : T(0);
      T xv = valid ? x[at] : T(0);
      for (int s = 0; s < k; ++s) {
        T v = valid ? buf[((s * nb + b) * n + i) * u + col] : T(0);
        if (s == self_slot) v = Op::join(v, dv);
        ROW(SL, s * n + i) = v;
      }
      warp_add(&s_node[2 * i], Op::count(dv));
      xv = Op::join(xv, dv);
      ROW(X, i) = xv;
      if (k == 0 || !per_origin) {
        const T v = k == 0 ? xv : ROW(SL, i);
        ROW(SD, i) = v;
        const int c = Op::count(v);
        for (int j = 0; j < p; ++j) warp_add(&s_ssend[i * p + j], c);
      } else {
        // leave-one-out over the K = P+1 slots: suffix pass, then prefix
        T acc = T(0);
        for (int s = k - 1; s >= 0; --s) {
          if (s < p) ROW(SD, s * n + i) = acc;
          acc = Op::join(acc, ROW(SL, s * n + i));
        }
        acc = T(0);
        for (int j = 0; j < p; ++j) {
          const T v = Op::join(ROW(SD, j * n + i), acc);
          ROW(SD, j * n + i) = v;
          warp_add(&s_ssend[i * p + j], Op::count(v));
          acc = Op::join(acc, ROW(SL, j * n + i));
        }
      }
    }
    __syncthreads();                           // every node's sends written

    for (int i = threadIdx.y; i < n; i += ny) {
      // (3) ack-gated clear
      if (s_dlv[i])
        for (int s = 0; s < k; ++s) ROW(SL, s * n + i) = T(0);
      // (4)+(5)+(6) route and receive the P slots in order
      T xv = ROW(X, i);
      for (int q = 0; q < p; ++q) {
        const int e = i * p + q;
        const int plane = (per_origin && k > 0) ? s_rev[e] : 0;
        const T dv = s_act[e] ? ROW(SD, plane * n + s_nbrs[e]) : T(0);
        warp_add(&s_cnt[e], Op::novel_count(dv, xv));
        warp_add(&s_dsz[e], Op::count(dv));
        if (inbox != nullptr && valid)
          inbox[((q * (long long)nb + b) * n + i) * u + col] = dv;
        if (extracts) {
          const int t = per_origin ? q : 0;
          ROW(SL, t * n + i) = Op::join(ROW(SL, t * n + i), Op::novel(dv, xv));
        }
        xv = Op::join(xv, dv);
      }
      // write back x', the K slots and |⇓x'|
      warp_add(&s_node[2 * i + 1], Op::count(xv));
      if (valid) {
        xo[(b * n + i) * u + col] = xv;
        for (int s = 0; s < k; ++s)
          bo[((s * nb + b) * n + i) * u + col] = ROW(SL, s * n + i);
      }
    }
    __syncthreads();                           // sends read before reuse
  }

  for (int i = tid; i < np; i += nthreads) {
    if (s_ssend[i]) atomicAdd(&ssend[b * np + i], s_ssend[i]);
    if (s_cnt[i]) atomicAdd(&cnt[b * np + i], s_cnt[i]);
    if (s_dsz[i]) atomicAdd(&dsz[b * np + i], s_dsz[i]);
  }
  for (int i = tid; i < 2 * n; i += nthreads)
    if (s_node[i]) atomicAdd(&nodecnt[b * 2 * n + i], s_node[i]);
}

template <class T, class Op>
static int launch(const void* delta, const void* x, const void* buf,
                  const void* active, const void* delivered, const void* nbrs,
                  const void* rev, void* xo, void* bo, void* inbox,
                  void* nodecnt, void* ssend, void* cnt, void* dsz, int nb,
                  int n, int p, int k, int per_origin, int extracts,
                  long long u, int ny, int table_bytes, long long smem_bytes,
                  cudaStream_t stream) {
  auto kernel = round_step_kernel<T, Op>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long want = (u + COLS - 1) / COLS;
  dim3 grid((unsigned)(want < 8192 ? want : 8192), (unsigned)nb);
  dim3 block(COLS, ny);
  kernel<<<grid, block, smem_bytes, stream>>>(
      static_cast<const T*>(delta), static_cast<const T*>(x),
      static_cast<const T*>(buf), static_cast<const int32_t*>(active),
      static_cast<const int32_t*>(delivered),
      static_cast<const int32_t*>(nbrs), static_cast<const int32_t*>(rev),
      static_cast<T*>(xo), static_cast<T*>(bo), static_cast<T*>(inbox),
      static_cast<int32_t*>(nodecnt), static_cast<int32_t*>(ssend),
      static_cast<int32_t*>(cnt), static_cast<int32_t*>(dsz), nb, n, p, k,
      per_origin, extracts, u, table_bytes);
  return static_cast<int>(cudaGetLastError());
}

// All contiguous: delta/x/xo [B, N, U]; buf/bo [K, B, N, U] (nullable when
// K = 0); active int32 [B, N, P]; delivered
// int32 [B, N] (nullable); nbrs/rev int32 [N, P]; inbox [P, B, N, U]
// (nullable); zeroed int32 counts nodecnt [B, N, 2], ssend/cnt/dsz
// [B, N, P]. Blocks are COLS x ny threads (ny = min(N, 32) node-threads per
// column). The caller sizes the shared memory (kernels/round_step.py
// smem_bytes): table_bytes for the int tables, then (1 + K + S)·N rows of
// COLS elements.
extern "C" int round_step_launch(
    int kind, const void* delta, const void* x, const void* buf,
    const void* active, const void* delivered, const void* nbrs,
    const void* rev, void* xo, void* bo, void* inbox, void* nodecnt,
    void* ssend, void* cnt, void* dsz, int nb, int n, int p, int k,
    int per_origin, int extracts, long long u, int ny, int table_bytes,
    long long smem_bytes, void* stream) {
  if (nb < 1 || nb > 65535 || n < 1 || p < 1 || k < 0 || u < 1 ||
      (per_origin && k != p + 1) || (extracts && k == 0) || ny < 1 ||
      ny > 32 || ny > n)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ROUND_STEP_ARGS                                                       \
  delta, x, buf, active, delivered, nbrs, rev, xo, bo, inbox, nodecnt, ssend, \
      cnt, dsz, nb, n, p, k, per_origin, extracts, u, ny, table_bytes,        \
      smem_bytes, s
  switch (kind) {
    case KIND_MAX_U8: return launch<uint8_t, MaxOp>(ROUND_STEP_ARGS);
    case KIND_MAX_I32: return launch<int32_t, MaxOp>(ROUND_STEP_ARGS);
    case KIND_OR_U32: return launch<uint32_t, OrOp>(ROUND_STEP_ARGS);
  }
#undef ROUND_STEP_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
