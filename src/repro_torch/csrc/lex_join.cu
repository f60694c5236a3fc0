// Lexicographic-pair map join and Δ, the LWWMap / LexCounter hot path, over
// the flat elements of two lex-pair states a = (ta, va) and b = (tb, vb)
// of one shape (int32 leaves, signed compares):
//
//     (t, v)   = a ⊔ b   t = max(ta, tb); v = the winner's value, and on
//                        equal timestamps max(va, vb)
//     (dt, dv) = Δ(b, a) b's pair where ¬(b ⊑ a) and b ≠ ⊥ = (0, 0), else ⊥
//     count   += the elements where Δ(b, a) ≠ ⊥
//
// Replaces the TPU kernel lex_join_delta_2d / _lex_kernel
// (src/repro/kernels/lex_join.py:43, body :25).
//
// Bound on the H100: bytes. Four planes in, four out: for 15 × 4,194,304
// pairs 8 × 251.7 MB, at least 0.601 ms at 3.35 TB/s.
//
// Design: the join couples the two leaves (the winner takes the value), so
// one thread holds all four inputs of its elements; otherwise as
// delta_extract.cu: a 1-D grid, EW_UNROLL chunks of 4 elements a thread
// with every load issued first, one 16-byte load or store per plane when
// all eight planes are 16-byte aligned (scalar accesses otherwise), and
// the count summed per block and added with one atomicAdd per block.

#include "common.cuh"

__device__ __forceinline__ void lex_one(int32_t ta, int32_t va, int32_t tb,
                                        int32_t vb, int32_t& t, int32_t& v,
                                        int32_t& dt, int32_t& dv, int& c) {
  const bool eq = ta == tb;
  const bool a_wins = ta > tb;
  t = a_wins ? ta : tb;
  v = eq ? (va > vb ? va : vb) : (a_wins ? va : vb);
  const bool leq_b_a = (tb < ta) || (eq && vb <= va);
  const bool bot_b = tb == 0 && vb == 0;
  const bool novel = !leq_b_a && !bot_b;
  dt = novel ? tb : 0;
  dv = novel ? vb : 0;
  c += novel;
}

template <bool VEC>
__global__ void lex_kernel(const int32_t* __restrict__ ta,
                           const int32_t* __restrict__ va,
                           const int32_t* __restrict__ tb,
                           const int32_t* __restrict__ vb,
                           int32_t* __restrict__ t, int32_t* __restrict__ v,
                           int32_t* __restrict__ dt, int32_t* __restrict__ dv,
                           int* __restrict__ count, long long n) {
  constexpr int W = 4;                        // int32 elements per chunk
  const long long first =
      (long long)blockIdx.x * EW_THREADS * EW_UNROLL + threadIdx.x;
  Chunk<int32_t> a0[EW_UNROLL], a1[EW_UNROLL], b0[EW_UNROLL], b1[EW_UNROLL];
#pragma unroll
  for (int u = 0; u < EW_UNROLL; ++u) {       // every load first
    const long long at = (first + (long long)u * EW_THREADS) * W;
    if (VEC && at + W <= n) {
      a0[u].v = *reinterpret_cast<const uint4*>(ta + at);
      a1[u].v = *reinterpret_cast<const uint4*>(va + at);
      b0[u].v = *reinterpret_cast<const uint4*>(tb + at);
      b1[u].v = *reinterpret_cast<const uint4*>(vb + at);
    }
  }
  int c = 0;
#pragma unroll
  for (int u = 0; u < EW_UNROLL; ++u) {
    const long long at = (first + (long long)u * EW_THREADS) * W;
    if (VEC && at + W <= n) {
      Chunk<int32_t> o0, o1, d0, d1;
#pragma unroll
      for (int k = 0; k < W; ++k)
        lex_one(a0[u].e[k], a1[u].e[k], b0[u].e[k], b1[u].e[k], o0.e[k],
                o1.e[k], d0.e[k], d1.e[k], c);
      *reinterpret_cast<uint4*>(t + at) = o0.v;
      *reinterpret_cast<uint4*>(v + at) = o1.v;
      *reinterpret_cast<uint4*>(dt + at) = d0.v;
      *reinterpret_cast<uint4*>(dv + at) = d1.v;
    } else {
#pragma unroll
      for (int k = 0; k < W; ++k)
        if (at + k < n)
          lex_one(ta[at + k], va[at + k], tb[at + k], vb[at + k], t[at + k],
                  v[at + k], dt[at + k], dv[at + k], c);
    }
  }
  block_add(count, c);          // every thread reaches this line
}

// ta, va, tb, vb (in) and t, v, dt, dv (out): n contiguous int32 each;
// count: one int32, zeroed by the caller.
extern "C" int lex_join_delta_launch(const void* ta, const void* va,
                                     const void* tb, const void* vb, void* t,
                                     void* v, void* dt, void* dv, void* count,
                                     long long n, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = ew_blocks((n + 3) / 4);
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  auto in = [](const void* p) { return static_cast<const int32_t*>(p); };
  auto out = [](void* p) { return static_cast<int32_t*>(p); };
  const bool vec = aligned16(ta) && aligned16(va) && aligned16(tb) &&
                   aligned16(vb) && aligned16(t) && aligned16(v) &&
                   aligned16(dt) && aligned16(dv);
  if (vec)
    lex_kernel<true><<<blocks, EW_THREADS, 0, s>>>(
        in(ta), in(va), in(tb), in(vb), out(t), out(v), out(dt), out(dv),
        static_cast<int*>(count), n);
  else
    lex_kernel<false><<<blocks, EW_THREADS, 0, s>>>(
        in(ta), in(va), in(tb), in(vb), out(t), out(v), out(dt), out(dv),
        static_cast<int*>(count), n);
  return static_cast<int>(cudaGetLastError());
}
