// The Merkle-descent price of the digest messages of a digest-driven resync
// round: for every (slot p, row r), the 32-bit words of a descent of row r's
// tree against the tree of row src[p, r] (the sender's; the remote trees are
// the local ones, routed),
//
//     words = 3 · (1 + 2 · #{internal node i : tree_r[i] != tree_src[i]})
//
// where a tree is the leaf layer [nB, 3] (hash, count, agg) zero-padded to a
// power of two and folded pairwise up to its root: a parent's hash is
// mix(h_left) · PAIR_L + mix(h_right) · PAIR_R, its count the sum and its agg
// the unsigned max of its children's, all mod 2³² — as
// src/repro_torch/kernels/merkle_descent.py plain computes it.
//
// Replaces no TPU kernel: the JAX package prices the descent in plain jnp
// (src/repro/sync/digest.py descent_words), and the port's plain version
// issues some 40 PyTorch ops a tree level (16 levels at 65,536 blocks),
// which left the resync round bound by the host.
//
// Bound on the H100: launches. At 15 rows × 65,536 blocks the leaves and the
// trees are 11.8 MB each and the 60 compares read 94 MB, mostly from L2.
//
// Design. merkle_fold_kernel: a block of T threads folds 2T consecutive
// nodes of one row's level up to their subtree's root, one level per step,
// through shared memory (one array a channel), writing every node it makes
// into the row's tree, stored level by level from the root (a level of m
// nodes at node m - 1). The host loops merkle_fold_kernel over the levels
// that remain (two launches for 65,536 blocks, at T = 1,024).
// merkle_diff_kernel: a block per (p, r) compares the two trees' internal
// nodes and writes the words.

#include "common.cuh"

constexpr uint32_t PAIR_L = 0xC2B2AE35u;
constexpr uint32_t PAIR_R = 0x165667B1u;
constexpr int FOLD_THREADS = 1024;             // 2,048 nodes folded a block
constexpr int DIFF_THREADS = 512;

__device__ __forceinline__ uint32_t mix32(uint32_t v) {
  v ^= v >> 16;
  v *= 0x7FEB352Du;
  v ^= v >> 15;
  v *= 0x846CA68Bu;
  return v ^ (v >> 16);
}

struct Node {
  uint32_t h, c, a;
};

__device__ __forceinline__ Node parent(Node l, Node r) {
  return {mix32(l.h) * PAIR_L + mix32(r.h) * PAIR_R, l.c + r.c,
          l.a > r.a ? l.a : r.a};
}

__device__ __forceinline__ Node load(const uint32_t* p, long long i,
                                     long long valid) {
  if (i >= valid) return {0u, 0u, 0u};         // the zero padding
  return {p[3 * i], p[3 * i + 1], p[3 * i + 2]};
}

__device__ __forceinline__ void store(uint32_t* p, long long i, Node v) {
  p[3 * i] = v.h;
  p[3 * i + 1] = v.c;
  p[3 * i + 2] = v.a;
}

// in: rows of in_stride words holding a level's first `valid` nodes of n
// (n a power of two, ⊥ past `valid`); tree: rows of tree_stride words.
// blockDim.x = T nodes of the level above, n / (2T) blocks a row.
__global__ void __launch_bounds__(FOLD_THREADS) merkle_fold_kernel(
    const uint32_t* __restrict__ in, long long in_stride, long long valid,
    long long n, uint32_t* __restrict__ tree, long long tree_stride,
    long long rows) {
  __shared__ uint32_t sh[3][FOLD_THREADS];
  const int t = threadIdx.x;
  const long long width = blockDim.x;
  for (long long row = blockIdx.y; row < rows; row += gridDim.y) {
    const uint32_t* src = in + row * in_stride;
    uint32_t* dst = tree + row * tree_stride;
    long long m = n / 2;                       // nodes of the level built
    long long g = blockIdx.x * width + t;
    Node v = parent(load(src, 2 * g, valid), load(src, 2 * g + 1, valid));
    store(dst, m - 1 + g, v);
    for (long long w = width / 2; w >= 1; w /= 2) {
      sh[0][t] = v.h;
      sh[1][t] = v.c;
      sh[2][t] = v.a;
      __syncthreads();
      m /= 2;
      if (t < w) {
        v = parent({sh[0][2 * t], sh[1][2 * t], sh[2][2 * t]},
                   {sh[0][2 * t + 1], sh[1][2 * t + 1], sh[2][2 * t + 1]});
        store(dst, m - 1 + blockIdx.x * w + t, v);
      }
      __syncthreads();
    }
  }
}

// tree: rows of 3·nodes words; src [pairs] (pair = p · rows + r) the row
// whose tree row r's is compared with; out [pairs] the words.
__global__ void __launch_bounds__(DIFF_THREADS) merkle_diff_kernel(
    const uint32_t* __restrict__ tree, long long nodes,
    const long long* __restrict__ src, long long rows, long long pairs,
    int32_t* __restrict__ out) {
  __shared__ int part[DIFF_THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (long long pr = blockIdx.x; pr < pairs; pr += gridDim.x) {
    const uint32_t* a = tree + (pr % rows) * 3 * nodes;
    const uint32_t* b = tree + src[pr] * 3 * nodes;
    int cnt = 0;
    for (long long i = threadIdx.x; i < nodes; i += blockDim.x)
      cnt += (a[3 * i] != b[3 * i]) | (a[3 * i + 1] != b[3 * i + 1]) |
             (a[3 * i + 2] != b[3 * i + 2]);
    cnt = __reduce_add_sync(0xffffffffu, cnt);
    if (lane == 0) part[warp] = cnt;
    __syncthreads();
    if (warp == 0) {
      cnt = lane < DIFF_THREADS / 32 ? part[lane] : 0;
      cnt = __reduce_add_sync(0xffffffffu, cnt);
      if (lane == 0) out[pr] = 3 * (1 + 2 * cnt);
    }
    __syncthreads();
  }
}

// leaf int32 [rows, nb, 3] contiguous (bit-views of the digests' words);
// tree int32 scratch [rows, n - 1, 3] with n the least power of two >= nb
// (unused if n = 1); src int64 [pairs] in [0, rows), pairs a multiple of
// rows; out int32 [pairs].
extern "C" int merkle_descent_launch(const void* leaf, void* tree,
                                     const void* src, void* out,
                                     long long rows, long long nb,
                                     long long pairs, void* stream) {
  if (rows < 1 || nb < 1 || pairs < 1 || pairs % rows != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long n = 1;
  while (n < nb) n *= 2;
  const long long nodes = n - 1;               // internal nodes a tree
  const unsigned gy = rows < 65535 ? (unsigned)rows : 65535u;
  auto* tr = static_cast<uint32_t*>(tree);
  const auto* in = static_cast<const uint32_t*>(leaf);
  long long in_stride = 3 * nb, valid = nb;
  for (long long level = n; level > 1;) {      // nodes of the level folded
    const long long width = level / 2 < FOLD_THREADS ? level / 2
                                                     : FOLD_THREADS;
    const long long blocks = level / (2 * width);
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    merkle_fold_kernel<<<dim3((unsigned)blocks, gy), (unsigned)width, 0,
                         s>>>(in, in_stride, valid, level, tr, 3 * nodes,
                              rows);
    level = blocks;                            // the subtrees' roots
    in = tr + 3 * (level - 1);
    in_stride = 3 * nodes;
    valid = level;
  }
  // one leaf (nodes = 0): no internal node, the root alone is priced
  const long long grid = pairs < 65535 ? pairs : 65535;
  merkle_diff_kernel<<<(unsigned)grid, DIFF_THREADS, 0, s>>>(
      tr, nodes, static_cast<const long long*>(src), rows, pairs,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
