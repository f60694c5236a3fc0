// Blockwise digest of dense states: for each row m (a node) and each
// be-wide block b of its universe, three 32-bit words
//
//     hash  = Σ_pos mix((x[m, b·be + pos] + 1) · (2·pos + 1) · WMUL)  mod 2³²
//     count = #{pos : x[m, b·be + pos] != 0}
//     agg   = max over the block (unsigned), or its or-fold (bitor)
//
// with every value read as uint32 and the positions past U in the last
// block taken as the value 0 (they add to the hash only), exactly as
// src/repro/sync/digest.py digest_state computes it.
//
// Replaces the TPU kernel digest_blocks_2d / _digest_kernel
// (src/repro/kernels/digest.py:73, body :44).
//
// Bound on the H100: bytes. It reads the state once and writes 12 bytes per
// block: for 15 nodes × 4,194,304 int32 keys at be = 64 that is 263.5 MB, at
// least 0.079 ms at 3.35 TB/s. The mix is about 14 integer operations per
// element, 0.053 ms at the card's int32 rate.
//
// Design. A lane reads V elements with one load: 16 bytes (4 int32 or 16
// uint8) where rows are 16-byte aligned and be >= V, else one element. A
// digest block is L = be / V consecutive lane vectors, so a segment of
// min(L, 32) lanes owns a block. The grid is 2-D (row tasks × rows): no lane
// divides by the number of blocks, and offsets within a row are 32-bit
// vector indices. A warp task is max(32·UNROLL, L) vectors of one row; a
// lane issues all UNROLL loads of a step before its first mix, and its
// weights (2·pos + 1)·WMUL are computed once (plus a constant step when a
// block spans several warp steps). A segment then reduces its lanes with
// one redux.sync each (__reduce_add_sync: wrapping uint32 adds, exact mod
// 2³² in any order; __reduce_max_sync unsigned, or __reduce_or_sync), over
// the segment's lane mask. The task's records are consecutive blocks: they
// are staged in shared memory and written as one coalesced run of words.

#include "common.cuh"

constexpr uint32_t WMUL = 0x85EBCA77u;
constexpr int DG_THREADS = 256;                // 8 warps a block
constexpr int DG_WARPS = DG_THREADS / 32;
constexpr int UNROLL = 4;                      // loads a lane issues at once

__device__ __forceinline__ uint32_t mix32(uint32_t v) {
  v ^= v >> 16;
  v *= 0x7FEB352Du;
  v ^= v >> 15;
  v *= 0x846CA68Bu;
  return v ^ (v >> 16);
}

template <class T, bool BITOR, bool VEC>
__global__ void __launch_bounds__(DG_THREADS) digest_kernel(
    const T* __restrict__ x, int32_t* __restrict__ out, long long m,
    long long u, unsigned nb, int lL) {
  using Ln = Lane<T, VEC ? 16 : 0>;
  constexpr int V = Ln::V;
  __shared__ uint32_t rec[DG_WARPS][3 * 32 * UNROLL];
  const int L = 1 << lL;                       // vectors per digest block
  const int seg = L < 32 ? L : 32;             // lanes per segment
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned seg_mask =
      seg == 32 ? 0xffffffffu : ((1u << seg) - 1u) << (lane & ~(seg - 1));
  const unsigned tv = L > 32 * UNROLL ? L : 32 * UNROLL;   // task vectors
  const unsigned row_vecs = nb << lL;          // the zero-padded row
  const unsigned task = blockIdx.x * DG_WARPS + warp;
  const unsigned vbase = task * tv;
  if (vbase >= row_vecs) return;               // warp-uniform
  // the lane's weights at its first position of a warp step, and the step
  // between its positions in consecutive steps of one block (L > 32)
  uint32_t w[V];
#pragma unroll
  for (int j = 0; j < V; ++j)
    w[j] = (2u * ((lane & (seg - 1)) * V + j) + 1u) * WMUL;
  const uint32_t dw = 2u * 32u * V * WMUL;
  const unsigned first_blk = vbase >> lL;
  const unsigned nrec = tv >> lL;              // blocks of a task

  for (long long row = blockIdx.y; row < m; row += gridDim.y) {
    const T* xr = x + row * u;
    uint32_t h = 0, cnt = 0, agg = 0;          // a block spanning steps (L > 32)
    for (unsigned chunk = 0; chunk < tv; chunk += 32 * UNROLL) {
      Ln v[UNROLL];
#pragma unroll
      for (int s = 0; s < UNROLL; ++s) {
        const unsigned g = vbase + chunk + s * 32 + lane;
        if ((long long)g * V < u) v[s].load(xr + (long long)g * V);
        else v[s].zero();                      // ⊥ past U (and past the row)
      }
#pragma unroll
      for (int s = 0; s < UNROLL; ++s) {
        const unsigned at = chunk + s * 32;    // vector offset in the task
        if (L <= 32) { h = cnt = agg = 0; }
        // the step's weight offset within its block (L > 32)
        const uint32_t off = L > 32 ? ((at & (L - 1)) >> 5) * dw : 0u;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const uint32_t e = static_cast<uint32_t>(v[s].e[j]);
          h += mix32((e + 1u) * (w[j] + off));
          cnt += e != 0u;
          agg = BITOR ? (agg | e) : (agg > e ? agg : e);
        }
        if (L <= 32 || ((at + 32) & (L - 1)) == 0) {   // a block's last step
          const uint32_t hs = __reduce_add_sync(seg_mask, h);
          const uint32_t cs = __reduce_add_sync(seg_mask, cnt);
          const uint32_t as = BITOR ? __reduce_or_sync(seg_mask, agg)
                                    : __reduce_max_sync(seg_mask, agg);
          if ((lane & (seg - 1)) == 0) {
            const unsigned r = (at + (L <= 32 ? lane : 0)) >> lL;
            rec[warp][3 * r] = hs;
            rec[warp][3 * r + 1] = cs;
            rec[warp][3 * r + 2] = as;
          }
          h = cnt = agg = 0;
        }
      }
    }
    __syncwarp();
    // the task's records: consecutive blocks, one run of 3·nrec words
    const unsigned have = nb - first_blk < nrec ? nb - first_blk : nrec;
    int32_t* o = out + 3 * ((long long)row * nb + first_blk);
    for (unsigned t = lane; t < 3 * have; t += 32)
      o[t] = static_cast<int32_t>(rec[warp][t]);
    __syncwarp();
  }
}

template <class T, bool BITOR, bool VEC>
static int launch(const void* x, void* out, long long m, long long u, int be,
                  unsigned grid_x, unsigned grid_y, cudaStream_t stream) {
  constexpr int V = Lane<T, VEC ? 16 : 0>::V;
  if (be < V || (VEC && (!aligned16(x) || (u * sizeof(T)) % 16 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long nb = (u + be - 1) / be;
  const long long row_vecs = nb * (be / V);
  const long long tv = (be / V) > 32 * UNROLL ? be / V : 32 * UNROLL;
  const long long tasks = (row_vecs + tv - 1) / tv;
  if (row_vecs + tv > 0xFFFFFFFFll || (long long)grid_x * DG_WARPS < tasks ||
      grid_y < 1 || grid_y > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  digest_kernel<T, BITOR, VEC><<<dim3(grid_x, grid_y), DG_THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<int32_t*>(out), m, u,
      (unsigned)nb, __builtin_ctz(be / V));
  return static_cast<int>(cudaGetLastError());
}

template <class T, bool BITOR>
static int by_width(int vec, const void* x, void* out, long long m,
                    long long u, int be, unsigned gx, unsigned gy,
                    cudaStream_t s) {
  return vec ? launch<T, BITOR, true>(x, out, m, u, be, gx, gy, s)
             : launch<T, BITOR, false>(x, out, m, u, be, gx, gy, s);
}

// x [M, U] contiguous (uint8, int32, or uint32 words as int32 bit-views);
// out int32 [M, ceil(U / be), 3] contiguous; be a power of two >= 8 and
// ceil(U / be) · be < 2³². The plan is kernels/digest_blocks.py plan's:
// vec (16-byte loads: an aligned base, rows of 16-byte multiples and be at
// least a vector's elements; else one element a lane) and the grid.
extern "C" int digest_blocks_launch(int kind, const void* x, void* out,
                                    long long m, long long u, int be, int vec,
                                    unsigned grid_x, unsigned grid_y,
                                    void* stream) {
  if (m < 1 || u < 1 || be < 8 || (be & (be - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DIGEST_ARGS vec, x, out, m, u, be, grid_x, grid_y, s
  switch (kind) {
    case KIND_MAX_U8: return by_width<uint8_t, false>(DIGEST_ARGS);
    case KIND_MAX_I32: return by_width<int32_t, false>(DIGEST_ARGS);
    case KIND_OR_U32: return by_width<uint32_t, true>(DIGEST_ARGS);
  }
#undef DIGEST_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
