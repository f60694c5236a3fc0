// The versioned-slot op of the Retwis store (sync/workloads.py,
// versioned_slot_op): for each row of U int32 slots (one replica of one
// object) and its op count cnt,
//   ver = max(row),  s = ver mod U (the floor remainder of torch.remainder:
//   a negative version gives a non-negative slot),
//   out[c] = ((c - s) mod U < cnt) ? row[c] + 1 : 0.
//
// Replaces no TPU kernel: the JAX package writes the op in jnp
// (src/repro/sync/workloads.py, versioned_slot_op), which XLA fuses into one
// pass over the store. PyTorch's eager mode runs the plain version as seven
// kernels (amax, remainder, subtract, remainder, compare, add, where), five
// of them over full-size int32 or bool intermediates.
//
// Bound on the H100: the bytes it writes. The delta is dense, rows · U · 4
// bytes, while in almost every row cnt is 0 and the answer is 0 whatever
// the row holds. So the kernel writes the delta once, reads the counts once
// and reads a row of x only where its count is above 0: at [30,000, 50, 64]
// 384 MB written and 6 MB read, at least 0.116 ms at 3.35 TB/s.
//
// Design: a persistent grid (SMs × resident blocks, capped by max_blocks)
// whose warps walk batches of 32 rows. A warp loads its batch's 32 counts
// in one coalesced load and hands each row its count by a shuffle. Rows of
// the store's widths, 32 and 64 slots (U = 4·L int32, L = 8 or 16), on
// 16-byte aligned bases, take the vector path: L lanes a row, one 16-byte
// store each, 32 / L rows a warp step, so a step writes 512 contiguous
// bytes. A step holding a counted row loads x for
// those rows only and max-reduces each over its L lanes with xor shuffles.
// Any other U takes the row path: a warp a row, its lanes over the columns,
// the max by __reduce_max_sync. x + 1 wraps at INT32_MAX as PyTorch's int32
// add does: it is taken in unsigned arithmetic.

#include <climits>

#include "common.cuh"

constexpr int SB_THREADS = 256;
constexpr int SB_WARPS = SB_THREADS / 32;
constexpr int SB_RESIDENT = 2048 / SB_THREADS;   // blocks an SM holds
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int floor_mod(int32_t v, int u) {
  const int m = v % u;
  return m < 0 ? m + u : m;
}

// Slot `col` of a row whose bumps start at slot s, with count c.
__device__ __forceinline__ int32_t bumped(int32_t v, int col, int s, int u,
                                          int32_t c) {
  int d = col - s;
  if (d < 0) d += u;
  return d < c ? static_cast<int32_t>(static_cast<uint32_t>(v) + 1u) : 0;
}

// The count of row r0 + lane, 0 past the last row.
__device__ __forceinline__ int32_t batch_count(const int32_t* cnt,
                                               long long r0, long long rows,
                                               int lane) {
  return r0 + lane < rows ? cnt[r0 + lane] : 0;
}

template <int L>
__global__ void __launch_bounds__(SB_THREADS)
slot_bump_vec_kernel(const int32_t* __restrict__ x,
                     const int32_t* __restrict__ cnt,
                     int32_t* __restrict__ out, long long rows) {
  constexpr int U = 4 * L, PER = 32 / L;      // row width; rows a step
  const int lane = threadIdx.x & 31, sub = lane / L, col0 = (lane % L) * 4;
  const long long warps = (long long)gridDim.x * SB_WARPS;
  const long long batches = (rows + 31) / 32;
  for (long long b = (long long)blockIdx.x * SB_WARPS + threadIdx.x / 32;
       b < batches; b += warps) {
    const long long r0 = b * 32;
    const int32_t mine = batch_count(cnt, r0, rows, lane);
#pragma unroll 4
    for (int k = 0; k < 32; k += PER) {
      const long long r = r0 + k + sub;
      const int32_t c = __shfl_sync(FULL, mine, k + sub);
      int4 o = make_int4(0, 0, 0, 0);
      if (__any_sync(FULL, c > 0)) {            // warp-uniform
        int4 v = o;
        if (c > 0)                               // a counted row is < rows
          v = *reinterpret_cast<const int4*>(x + r * U + col0);
        int m = max(max(v.x, v.y), max(v.z, v.w));
#pragma unroll
        for (int off = L / 2; off > 0; off >>= 1)
          m = max(m, __shfl_xor_sync(FULL, m, off));
        if (c > 0) {
          const int s = floor_mod(m, U);
          o = make_int4(bumped(v.x, col0, s, U, c),
                        bumped(v.y, col0 + 1, s, U, c),
                        bumped(v.z, col0 + 2, s, U, c),
                        bumped(v.w, col0 + 3, s, U, c));
        }
      }
      if (r < rows) *reinterpret_cast<int4*>(out + r * U + col0) = o;
    }
  }
}

__global__ void __launch_bounds__(SB_THREADS)
slot_bump_row_kernel(const int32_t* __restrict__ x,
                     const int32_t* __restrict__ cnt,
                     int32_t* __restrict__ out, long long rows, int u) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * SB_WARPS;
  const long long batches = (rows + 31) / 32;
  for (long long b = (long long)blockIdx.x * SB_WARPS + threadIdx.x / 32;
       b < batches; b += warps) {
    const long long r0 = b * 32;
    const int32_t mine = batch_count(cnt, r0, rows, lane);
    const int last = rows - r0 < 32 ? (int)(rows - r0) : 32;
    for (int k = 0; k < last; ++k) {
      const int32_t c = __shfl_sync(FULL, mine, k);    // warp-uniform
      const int32_t* xr = x + (r0 + k) * u;
      int32_t* orow = out + (r0 + k) * u;
      if (c <= 0) {
        for (int col = lane; col < u; col += 32) orow[col] = 0;
        continue;
      }
      int m = INT_MIN;
      for (int col = lane; col < u; col += 32) m = max(m, xr[col]);
      const int s = floor_mod(__reduce_max_sync(FULL, m), u);
      for (int col = lane; col < u; col += 32)
        orow[col] = bumped(xr[col], col, s, u, c);
    }
  }
}

constexpr int MAX_DEVICES = 64;

static int sm_count() {
  static int sms[MAX_DEVICES] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_DEVICES)
    return 0;
  if (sms[dev] == 0 &&
      cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    sms[dev] = 0;
  return sms[dev];
}

// x and out: rows × u contiguous int32 on the current card; cnt: rows
// contiguous int32. max_blocks caps the grid; its warps walk the batches of
// 32 rows beyond it.
extern "C" int slot_bump_launch(const void* x, const void* cnt, void* out,
                                long long rows, long long u,
                                long long max_blocks, void* stream) {
  if (rows < 1 || u < 1 || u > INT_MAX || max_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int sms = sm_count();
  if (sms < 1) return static_cast<int>(cudaErrorInvalidDevice);
  long long blocks = ((rows + 31) / 32 + SB_WARPS - 1) / SB_WARPS;
  if (blocks > (long long)sms * SB_RESIDENT)
    blocks = (long long)sms * SB_RESIDENT;
  if (blocks > max_blocks) blocks = max_blocks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto xp = static_cast<const int32_t*>(x);
  auto cp = static_cast<const int32_t*>(cnt);
  auto op = static_cast<int32_t*>(out);
  const bool vec = aligned16(x) && aligned16(out);
  const dim3 grid((unsigned)blocks);
  if (vec && u == 64)
    slot_bump_vec_kernel<16><<<grid, SB_THREADS, 0, s>>>(xp, cp, op, rows);
  else if (vec && u == 32)
    slot_bump_vec_kernel<8><<<grid, SB_THREADS, 0, s>>>(xp, cp, op, rows);
  else
    slot_bump_row_kernel<<<grid, SB_THREADS, 0, s>>>(xp, cp, op, rows,
                                                     (int)u);
  return static_cast<int>(cudaGetLastError());
}
