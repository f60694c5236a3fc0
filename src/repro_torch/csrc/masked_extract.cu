// Per-slot masked block extraction of the digest-driven resync: for each
// slot q, row m (a node) and column c,
//
//     out[q, m, c] = masks[q, m, c / be] != 0 ? x[m, c] : ⊥ (0)
//
// — Δ(x, block mask of slot q), the state restricted to the blocks whose
// digests differ from neighbour q's.
//
// Replaces the TPU kernel masked_extract_2d / _extract_kernel
// (src/repro/kernels/digest.py:125, body :110).
//
// Bound on the H100: bytes. x is read once and written, or ⊥, to all P
// slots; the masks are one int32 per block and slot. For 15 nodes ×
// 4,194,304 int32 keys, P = 4 and be = 64 that is (1 + 4) · 251.7 MB +
// 15.7 MB = 1,274.0 MB, at least 0.380 ms at 3.35 TB/s.
//
// Design: a 1-D grid of threads over (row, 16-byte chunk) pairs, so the row
// count has no grid limit. A thread loads its chunk of x once (one 16-byte
// load when the rows are 16-byte aligned, else element by element), then
// for each slot reads that block's mask word and stores the chunk or zeros
// with one 16-byte store (or element stores). A chunk (16 bytes) lies in
// one block unless the block is narrower, which only happens for uint8
// states at be = 8: then its two halves read one mask word each. Neighbour
// threads touch neighbour chunks, so every load and store is coalesced.

#include "common.cuh"

template <class T, bool VEC>
__global__ void extract_kernel(const T* __restrict__ x,
                               const int32_t* __restrict__ masks,
                               T* __restrict__ out, int p, long long m,
                               long long u, long long nb, int lbe,
                               long long chunks_per_row) {
  constexpr int W = 16 / sizeof(T);           // elements per chunk
  const long long total = m * chunks_per_row;
  const long long plane = m * u;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long row = i / chunks_per_row;
    const long long c0 = (i - row * chunks_per_row) * W;
    const long long at = row * u + c0;
    Chunk<T> xv;
    if (VEC) {
      xv.v = *reinterpret_cast<const uint4*>(x + at);
    } else {
#pragma unroll
      for (int k = 0; k < W; ++k) xv.e[k] = c0 + k < u ? x[at + k] : T(0);
    }
    const long long b0 = c0 >> lbe;
    const long long b1 = (c0 + W - 1) >> lbe;  // b0, or b0 + 1 (uint8, be = 8)
    for (int q = 0; q < p; ++q) {
      const int32_t* mq = masks + ((long long)q * m + row) * nb;
      const bool k0 = mq[b0] != 0;
      const bool k1 = b1 == b0 ? k0 : (b1 < nb && mq[b1] != 0);
      Chunk<T> o;
#pragma unroll
      for (int k = 0; k < W; ++k)
        o.e[k] = (((c0 + k) >> lbe) == b0 ? k0 : k1) ? xv.e[k] : T(0);
      T* dst = out + q * plane + at;
      if (VEC) {
        *reinterpret_cast<uint4*>(dst) = o.v;
      } else {
#pragma unroll
        for (int k = 0; k < W; ++k)
          if (c0 + k < u) dst[k] = o.e[k];
      }
    }
  }
}

template <class T>
static int launch(const void* x, const void* masks, void* out, int p,
                  long long m, long long u, int be, int vec,
                  cudaStream_t stream) {
  constexpr int W = 16 / sizeof(T);
  const long long nb = (u + be - 1) / be;
  const long long chunks = (u + W - 1) / W;
  const int threads = 256;
  const long long want = (m * chunks + threads - 1) / threads;
  const unsigned blocks = (unsigned)(want < 65536 ? want : 65536);
  const int lbe = __builtin_ctz(be);
  auto xp = static_cast<const T*>(x);
  auto mp = static_cast<const int32_t*>(masks);
  auto op = static_cast<T*>(out);
  if (vec)
    extract_kernel<T, true><<<blocks, threads, 0, stream>>>(
        xp, mp, op, p, m, u, nb, lbe, chunks);
  else
    extract_kernel<T, false><<<blocks, threads, 0, stream>>>(
        xp, mp, op, p, m, u, nb, lbe, chunks);
  return static_cast<int>(cudaGetLastError());
}

// x [M, U] contiguous (uint8, or 32-bit words as int32), masks int32
// [P, M, ceil(U / be)], out [P, M, U] of x's type; be a power of two >= 8.
// vec != 0 promises that x and out start 16-byte aligned and that a row is a
// whole number of 16-byte chunks (U · sizeof(T) % 16 == 0).
extern "C" int masked_extract_launch(int kind, const void* x,
                                     const void* masks, void* out, int p,
                                     long long m, long long u, int be,
                                     int vec, void* stream) {
  if (p < 1 || m < 1 || u < 1 || be < 8 || (be & (be - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case KIND_MAX_U8:
      return launch<uint8_t>(x, masks, out, p, m, u, be, vec, s);
    case KIND_MAX_I32:
      return launch<int32_t>(x, masks, out, p, m, u, be, vec, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
