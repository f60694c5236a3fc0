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
// least 0.079 ms at 3.35 TB/s. The mix is about 12 integer operations per
// element, well under the card's integer rate at that byte rate.
//
// Design: a segment of seg = min(be, 32) lanes of a warp owns one
// (row, block); each lane strides over be/seg positions, so a warp's loads
// are one contiguous run of 32 elements (coalesced for every be). The
// segment then reduces its lanes with one redux.sync each
// (__reduce_add_sync: wrapping uint32 adds, exact mod 2³² in any order;
// __reduce_max_sync unsigned, or __reduce_or_sync), over the segment's lane
// mask. Segments are aligned, and the lane count of the grid is a multiple
// of seg, so a segment is either wholly valid or wholly idle; idle lanes
// reduce neutral values.

#include "common.cuh"

constexpr uint32_t WMUL = 0x85EBCA77u;

__device__ __forceinline__ uint32_t mix32(uint32_t v) {
  v ^= v >> 16;
  v *= 0x7FEB352Du;
  v ^= v >> 15;
  v *= 0x846CA68Bu;
  return v ^ (v >> 16);
}

template <class T, bool BITOR>
__global__ void digest_kernel(const T* __restrict__ x, int32_t* __restrict__ out,
                              long long u, unsigned nb, int be, int lseg,
                              long long lanes) {
  const int seg = 1 << lseg;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const int lane_in_seg = threadIdx.x & (seg - 1);
  // the lanes of this thread's segment within its warp
  const unsigned seg_mask =
      seg == 32 ? 0xffffffffu
                : ((1u << seg) - 1u) << ((threadIdx.x & 31) & ~(seg - 1));
  // The loop bound is warp-uniform (blockDim.x is a multiple of 32), so
  // every lane of a warp reaches every shuffle.
  for (long long base = (long long)blockIdx.x * blockDim.x; base < lanes;
       base += stride) {
    const long long g = base + threadIdx.x;
    const bool valid = g < lanes;
    const unsigned sid = (unsigned)(g >> lseg);  // (row, block) of the segment
    const unsigned row = sid / nb;
    const unsigned blk = sid - row * nb;
    uint32_t h = 0, agg = 0, cnt = 0;
    if (valid) {
      const T* xr = x + (long long)row * u;
      for (int pos = lane_in_seg; pos < be; pos += seg) {
        const long long col = (long long)blk * be + pos;
        const uint32_t v = col < u ? static_cast<uint32_t>(xr[col]) : 0u;
        h += mix32((v + 1u) * ((2u * pos + 1u) * WMUL));
        cnt += v != 0u;
        agg = BITOR ? (agg | v) : (agg > v ? agg : v);
      }
    }
    h = __reduce_add_sync(seg_mask, h);
    cnt = __reduce_add_sync(seg_mask, cnt);
    agg = BITOR ? __reduce_or_sync(seg_mask, agg)
                : __reduce_max_sync(seg_mask, agg);
    if (valid && lane_in_seg == 0) {
      int32_t* o = out + 3ll * sid;
      o[0] = static_cast<int32_t>(h);
      o[1] = static_cast<int32_t>(cnt);
      o[2] = static_cast<int32_t>(agg);
    }
  }
}

template <class T, bool BITOR>
static int launch(const void* x, void* out, long long m, long long u, int be,
                  cudaStream_t stream) {
  const long long nb = (u + be - 1) / be;
  const int lseg = be < 32 ? __builtin_ctz(be) : 5;
  if (m * nb > 0xFFFFFFFFll) return static_cast<int>(cudaErrorInvalidValue);
  const long long lanes = (m * nb) << lseg;
  const int threads = 256;
  long long want = (lanes + threads - 1) / threads;
  const unsigned blocks = (unsigned)(want < 65536 ? want : 65536);
  digest_kernel<T, BITOR><<<blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<int32_t*>(out), u, (unsigned)nb,
      be, lseg, lanes);
  return static_cast<int>(cudaGetLastError());
}

// x [M, U] contiguous (uint8, int32, or uint32 words as int32 bit-views);
// out int32 [M, ceil(U / be), 3] contiguous; be a power of two >= 8 and
// M · ceil(U / be) < 2³².
extern "C" int digest_blocks_launch(int kind, const void* x, void* out,
                                    long long m, long long u, int be,
                                    void* stream) {
  if (m < 1 || u < 1 || be < 8 || (be & (be - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case KIND_MAX_U8: return launch<uint8_t, false>(x, out, m, u, be, s);
    case KIND_MAX_I32: return launch<int32_t, false>(x, out, m, u, be, s);
    case KIND_OR_U32: return launch<uint32_t, true>(x, out, m, u, be, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
