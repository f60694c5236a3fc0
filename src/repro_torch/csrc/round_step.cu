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
// About 42 integer operations an element, 0.16 ms at the card's int32 rate.
//
// Design. Routing mixes nodes but never universe columns, so a block takes
// a tile of TC columns of one config with all N node rows. A thread is a
// (node row, lane) pair: warp w works node w (and w + 32, ... beyond 32
// nodes), lane l the VB bytes at column l·VB/elem of the tile, so a warp
// moves one 32·VB-byte run of a row per access and TC = 32·VB/elem (int32
// VB = 16: 128 columns; uint8 VB = 4, one element a register as for int32:
// 128 columns).
//
// - Loads. The tile's (2+K)·N input rows (δ, x, the K slots) are
//   contiguous runs of TC·elem bytes. They come into a ring of 2-3 stages
//   in shared memory by Hopper's bulk asynchronous copy (cp.async.bulk ...
//   mbarrier::complete_tx: no tensor map, only 16-byte aligned addresses
//   and sizes), each stage's mbarrier armed with the stage's bytes; every
//   thread waits on the stage's parity. Each warp issues its own node's
//   2+K rows, one lane a row (a copy takes uniform operands, so the
//   compiler issues a warp's copies one lane at a time: 105 rows from one
//   warp made that warp the block's straggler). A stage is refilled with
//   the tile `stages` ahead as soon as the block's barrier shows it read,
//   so 2-3 tiles' loads are in flight while a tile is worked. Rows whose
//   width or base is not 16-byte aligned load directly from device memory
//   into registers, one element a lane (VB = 0: the paper-size bool
//   states, U = 1,500); so do aligned rows (VB bytes a lane) where no ring
//   fits shared memory.
// - Registers. With N <= 16 and P <= PM (the paper's topologies) a
//   thread holds its node's δ, x, running x' and K slots in registers: the
//   leave-one-out sends are joins of those registers, the stage is free
//   once the sends are written, and x', the K slots and the inbox are
//   stored from registers, VB bytes a lane. Only the S send rows (S = P
//   for the fold, else one broadcast row) go to shared memory, because
//   routing reads other nodes' sends. They are double-buffered, so one
//   barrier a tile separates "sends written" from "sends read".
// - Counts. On that path each thread keeps its node's 3P+3 tallies in
//   registers over its whole walk and the block reduces them once, a warp
//   sum and one atomicAdd per counter. Otherwise (PM = 0: any N and P)
//   warps loop over their nodes, re-read the stage for phase 2, and add
//   into shared counters per tile (warp sums). Both are exact in any order.
// - Grid. A persistent grid: (blocks per config) × B, the blocks per config
//   the tiles or what the SMs hold resident
//   (cudaOccupancyMaxActiveBlocksPerMultiprocessor), whichever is fewer.
//   More than 65,535 configs (a keyed store's objects) launch in chunks of
//   at most 65,535 along gridDim.y, each chunk's first config `b0` passed
//   in; every offset is 64-bit. The wrapper (kernels/round_step.py plan)
//   picks VB and the stages that fit shared memory.

#include "common.cuh"

// -- Hopper primitives: mbarrier and the 1-D bulk copy ------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(bytes) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes),
      "r"(smem_addr(bar)) : "memory");
}

// Tally slots of the register counters: |⇓δ|, |⇓x'|, the broadcast send,
// then PM send, PM novel and PM received counts.
constexpr int T_DELTA = 0, T_X = 1, T_BCAST = 2, T_SEND = 3;

template <class T, class Op, int VB, int PM>
__global__ void __launch_bounds__(PM ? 512 : 1024) round_step_kernel(
    const T* __restrict__ delta, const T* __restrict__ x, const T* buf,
    const int32_t* __restrict__ active, const int32_t* __restrict__ delivered,
    const int32_t* __restrict__ nbrs, const int32_t* __restrict__ rev,
    T* __restrict__ xo, T* bo, T* __restrict__ inbox, int32_t* nodecnt,
    int32_t* ssend, int32_t* cnt, int32_t* dsz, int nb, int n, int p, int k,
    int per_origin, int extracts, long long u, int stages, int table_bytes,
    int bar_bytes, int b0) {
  using L = Lane<T, VB>;
  constexpr int V = L::V;
  constexpr int TC = 32 * V;                   // tile columns
  const bool bulk = stages > 0;                // else direct loads

  extern __shared__ __align__(128) unsigned char smem[];
  const int np = n * p;
  int* s_nbrs = reinterpret_cast<int*>(smem);  // [N·P] routing: sender node
  int* s_rev = s_nbrs + np;                    // [N·P] routing: sender slot
  int* s_act = s_rev + np;                     // [N·P] active slots
  int* s_dlv = s_act + np;                     // [N] delivered (clear) flags
  int* s_node = s_dlv + n;                     // [N·2] counts (PM = 0)
  int* s_ssend = s_node + 2 * n;               // [N·P] counts (PM = 0)
  int* s_cnt = s_ssend + np;                   // [N·P] counts (PM = 0)
  int* s_dsz = s_cnt + np;                     // [N·P] counts (PM = 0)
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + table_bytes);
  const bool fold = per_origin && k > 0;       // leave-one-out sends
  const int S = fold ? p : 1;                  // send rows per node
  const int rows_in = (2 + k) * n;             // δ, x, the K slots
  T* sends = reinterpret_cast<T*>(smem + table_bytes + bar_bytes);  // [2][S·N][TC]
  T* ring = sends + 2 * S * n * TC;            // [stages][rows_in][TC]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int b = b0 + blockIdx.y;
  const int self_slot = per_origin ? k - 1 : 0;
  const long long plane = (long long)nb * n * u;   // a [B, N, U] plane
  for (int i = threadIdx.x; i < np; i += blockDim.x) {
    s_nbrs[i] = nbrs[i];
    s_rev[i] = rev[i];
    s_act[i] = active[(long long)b * np + i];
    s_ssend[i] = s_cnt[i] = s_dsz[i] = 0;
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    s_dlv[i] = delivered != nullptr ? delivered[(long long)b * n + i] : 0;
    s_node[2 * i] = s_node[2 * i + 1] = 0;
  }
  if (bulk && threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const long long tiles = (u + TC - 1) / TC;

  if constexpr (PM != 0) {
    // -- one node a warp (N <= 16, P <= PM): its δ, x and K slots in
    //    registers for the tile, its tallies in registers for the walk
    constexpr int T_CNT = T_SEND + PM, T_DSZ = T_SEND + 2 * PM;
    int tal[3 + 3 * PM];
#pragma unroll
    for (int t = 0; t < 3 + 3 * PM; ++t) tal[t] = 0;
    const int i = warp;
    const long long row = (long long)b * n + i;
    const T* d_row = delta + row * u;
    const T* x_row = x + row * u;
    const T* b_row = buf + row * u;            // slot s at + s·plane
    T* xo_row = xo + row * u;
    T* bo_row = bo + row * u;
    T* ib_row = inbox + row * u;               // slot q at + q·plane
    const bool clear = s_dlv[i] != 0;
    int soff[PM];                              // the routed send row, or -1
#pragma unroll
    for (int q = 0; q < PM; ++q) {
      const int e = i * p + q;
      soff[q] = q < p && s_act[e]
                    ? ((fold ? s_rev[e] : 0) * n + s_nbrs[e]) * TC + lane * V
                    : -1;
    }
    // each warp brings in its own node's rows of the block's tile `it2`
    // (input row lane·N + i: δ, x, then slot lane-2) into stage st2, and
    // thread 0 arms the stage with the tile's bytes; a copy may land
    // before the arming (the transaction count goes negative meanwhile)
    auto issue_rows = [&](long long it2, int st2) {
      const long long c2 = blockIdx.x + it2 * gridDim.x;
      if (c2 >= tiles) return;
      const long long cb2 = c2 * TC;
      const uint32_t bytes =
          static_cast<uint32_t>((u - cb2 < TC ? u - cb2 : TC) * sizeof(T));
      if (threadIdx.x == 0) mbar_expect_tx(&bars[st2], bytes * rows_in);
      if (lane < 2 + k) {
        const T* src = lane == 0 ? d_row
                       : lane == 1 ? x_row
                                   : b_row + (lane - 2) * plane;
        bulk_load(ring + (st2 * rows_in + lane * n + i) * TC, src + cb2, bytes,
                  &bars[st2]);
      }
    };
    if (bulk)
      for (int s = 0; s < stages; ++s) issue_rows(s, s);
    int st = 0;
    uint32_t ph = 0;
    long long it = 0;
    for (long long c = blockIdx.x; c < tiles; c += gridDim.x, ++it) {
      const long long col = c * TC + lane * V;  // the lane's first column
      const bool valid = col < u;  // a lane's V columns are all in or all out
      T* sd = sends + (it & 1) * S * n * TC;
      const T* stage = ring + st * rows_in * TC + lane * V;
      if (bulk) mbar_wait(&bars[st], ph);
      auto ld = [&](L& v, int r, const T* g) {   // input row r (⊥ past U)
        if (!valid) v.zero();
        else if (bulk) v.load(stage + r * TC);
        else v.load(g + col);
      };

      // (1) local join, (2) sends
      L dv, xv, sl[PM + 1];
      ld(dv, i, d_row);
      ld(xv, n + i, x_row);
      tal[T_DELTA] += dv.template count<Op>();
      xv.template join<Op>(dv);
      const T* bq = b_row;
#pragma unroll
      for (int s = 0; s <= PM; ++s, bq += plane) {
        if (s < k) {
          ld(sl[s], 2 * n + s * n + i, bq);
          if (s == self_slot) sl[s].template join<Op>(dv);
        }
      }
      if (!fold) {
        L v = xv;                              // the broadcast
        if (k > 0) v = sl[0];
        v.store(sd + i * TC + lane * V);
        tal[T_BCAST] += v.template count<Op>();
      } else {
        // leave-one-out over the K = P+1 slots
#pragma unroll
        for (int j = 0; j < PM; ++j) {
          if (j < p) {
            L v;
            v.zero();
#pragma unroll
            for (int o = 0; o <= PM; ++o)
              if (o < k && o != j) v.template join<Op>(sl[o]);
            v.store(sd + (j * n + i) * TC + lane * V);
            tal[T_SEND + j] += v.template count<Op>();
          }
        }
      }
      __syncthreads();                         // every node's sends written
      // phase 2 reads no stage: refill this one with the tile `stages` ahead
      if (bulk) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        issue_rows(it + stages, st);
      }

      // (3) clear, (4)+(5)+(6) route and receive the P slots in order
      L ext;
      ext.zero();
      T* ip = ib_row + col;                    // inbox slot q
      T* bp = bo_row + col;                    // buf' slot q
#pragma unroll
      for (int q = 0; q < PM; ++q, ip += plane, bp += plane) {
        if (q < p) {
          L dq, nv;
          if (soff[q] >= 0) dq.load(sd + soff[q]);
          else dq.zero();
          int nov = 0;
#pragma unroll
          for (int j = 0; j < V; ++j) {
            nov += Op::novel_count(dq.e[j], xv.e[j]);
            nv.e[j] = Op::novel(dq.e[j], xv.e[j]);
          }
          tal[T_CNT + q] += nov;
          tal[T_DSZ + q] += dq.template count<Op>();
          if (inbox != nullptr && valid) dq.store(ip);
          if (extracts) {
            if (per_origin) {
              L v = sl[q];
              if (clear) v.zero();
              v.template join<Op>(nv);
              if (valid) v.store(bp);
            } else {
              ext.template join<Op>(nv);
            }
          }
          xv.template join<Op>(dq);
        }
      }
      // write back x', the K slots and |⇓x'|
      tal[T_X] += xv.template count<Op>();
      if (valid) {
        xv.store(xo_row + col);
        bp = bo_row + col;
#pragma unroll
        for (int s = 0; s <= PM; ++s, bp += plane) {
          if (s < k && !(extracts && per_origin && s < p)) {
            L v = sl[s];
            if (clear) v.zero();
            v.template join<Op>(ext);          // flat extracts: slot 0
            v.store(bp);
          }
        }
      }
      if (bulk && ++st == stages) { st = 0; ph ^= 1; }
    }

    // a warp sum and one atomicAdd per counter
    auto flush = [&](int32_t* dst, int v) {
      v = __reduce_add_sync(0xffffffffu, v);
      if (lane == 0 && v != 0) atomicAdd(dst, v);
    };
    flush(&nodecnt[2 * row], tal[T_DELTA]);
    flush(&nodecnt[2 * row + 1], tal[T_X]);
#pragma unroll
    for (int q = 0; q < PM; ++q) {
      if (q < p) {
        flush(&ssend[row * p + q], fold ? tal[T_SEND + q] : tal[T_BCAST]);
        flush(&cnt[row * p + q], tal[T_CNT + q]);
        flush(&dsz[row * p + q], tal[T_DSZ + q]);
      }
    }
  } else {
    // -- any N and P: warps loop over their nodes, re-read the stage in
    //    phase 2, and sum counts per tile into shared counters

    // device row of input row r (δ rows, x rows, then slot-major buffer rows)
    auto src_row = [&](int r) -> const T* {
      if (r < n) return delta + ((long long)b * n + r) * u;
      if (r < 2 * n) return x + ((long long)b * n + r - n) * u;
      const int s = (r - 2 * n) / n, i = (r - 2 * n) - s * n;
      return buf + (s * plane + ((long long)b * n + i) * u);
    };
    // warp 0: arm stage st and bring in the block's tile `it`
    auto issue = [&](long long it, int st) {
      const long long c = blockIdx.x + it * gridDim.x;
      if (c >= tiles) return;
      const long long cb = c * TC;
      const long long w = u - cb < TC ? u - cb : TC;
      const uint32_t bytes = static_cast<uint32_t>(w * sizeof(T));
      T* dst = ring + st * rows_in * TC;
      if (lane == 0) mbar_expect_tx(&bars[st], bytes * rows_in);
      __syncwarp();
      for (int r = lane; r < rows_in; r += 32)
        bulk_load(dst + r * TC, src_row(r) + cb, bytes, &bars[st]);
    };
    if (bulk && warp == 0)
      for (int s = 0; s < stages; ++s) issue(s, s);
    int st = 0, prev = stages - 1;
    uint32_t ph = 0;
    long long it = 0;
    for (long long c = blockIdx.x; c < tiles; c += gridDim.x, ++it) {
      const long long col = c * TC + lane * V;
      const bool valid = col < u;
      T* sd = sends + (it & 1) * S * n * TC;
      const T* stage = ring + st * rows_in * TC + lane * V;
      if (bulk) mbar_wait(&bars[st], ph);
      auto in = [&](int r, L& v) {             // input row r (⊥ past U)
        if (!valid) v.zero();
        else if (bulk) v.load(stage + r * TC);
        else v.load(src_row(r) + col);
      };
      auto send_at = [&](int r) { return sd + r * TC + lane * V; };

      // (1) local join, (2) sends — each warp for its own nodes
      for (int i = warp; i < n; i += nw) {
        L dv, xv;
        in(i, dv);
        in(n + i, xv);
        warp_add(&s_node[2 * i], dv.template count<Op>());
        xv.template join<Op>(dv);
        if (!fold) {
          L v = xv;
          if (k > 0) {
            in(2 * n + i, v);                  // the flat buffer, slot 0
            v.template join<Op>(dv);
          }
          v.store(send_at(i));
          warp_add(&s_ssend[i * p], v.template count<Op>());
        } else {
          // leave-one-out over the K = P+1 slots: suffix pass, then prefix
          L acc;
          acc.zero();
          for (int s = k - 1; s >= 0; --s) {
            L v;
            in(2 * n + s * n + i, v);
            if (s == self_slot) v.template join<Op>(dv);
            if (s < p) acc.store(send_at(s * n + i));
            acc.template join<Op>(v);
          }
          acc.zero();
          for (int j = 0; j < p; ++j) {
            L v, sj;
            sj.load(send_at(j * n + i));
            sj.template join<Op>(acc);
            sj.store(send_at(j * n + i));
            warp_add(&s_ssend[i * p + j], sj.template count<Op>());
            in(2 * n + j * n + i, v);          // j < P: never the self slot
            acc.template join<Op>(v);
          }
        }
      }
      __syncthreads();                         // every node's sends written
      // the block's previous tile is read by every thread: refill its
      // stage with the tile `stages` ahead of it
      if (bulk && warp == 0 && it > 0) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        issue(it - 1 + stages, prev);
      }

      for (int i = warp; i < n; i += nw) {
        L dv, xv, ext;
        in(i, dv);
        in(n + i, xv);
        xv.template join<Op>(dv);
        ext.zero();
        const bool clear = s_dlv[i] != 0;
        const long long orow = (long long)b * n + i;
        // slot s of buf' before the extractions: cleared, or with δ joined
        auto slot_out = [&](int s, L& v) {
          if (clear) {
            v.zero();
          } else {
            in(2 * n + s * n + i, v);
            if (s == self_slot) v.template join<Op>(dv);
          }
        };
        for (int q = 0; q < p; ++q) {
          const int e = i * p + q;
          L dq, nv;
          if (s_act[e])
            dq.load(send_at((fold ? s_rev[e] : 0) * n + s_nbrs[e]));
          else
            dq.zero();
          int nov = 0;
#pragma unroll
          for (int j = 0; j < V; ++j) {
            nov += Op::novel_count(dq.e[j], xv.e[j]);
            nv.e[j] = Op::novel(dq.e[j], xv.e[j]);
          }
          warp_add(&s_cnt[e], nov);
          warp_add(&s_dsz[e], dq.template count<Op>());
          if (inbox != nullptr && valid)
            dq.store(inbox + q * plane + orow * u + col);
          if (extracts) {
            if (per_origin) {
              L v;
              slot_out(q, v);
              v.template join<Op>(nv);
              if (valid) v.store(bo + q * plane + orow * u + col);
            } else {
              ext.template join<Op>(nv);
            }
          }
          xv.template join<Op>(dq);
        }
        // write back x', the K slots and |⇓x'|
        warp_add(&s_node[2 * i + 1], xv.template count<Op>());
        if (valid) {
          xv.store(xo + orow * u + col);
          for (int s = (extracts && per_origin) ? p : 0; s < k; ++s) {
            L v;
            slot_out(s, v);
            v.template join<Op>(ext);          // flat extracts: slot 0
            v.store(bo + s * plane + orow * u + col);
          }
        }
      }
      prev = st;
      if (bulk && ++st == stages) { st = 0; ph ^= 1; }
    }

    __syncthreads();
    for (int i = threadIdx.x; i < np; i += blockDim.x) {
      // a broadcast send's size sits in its node's first slot counter
      const int sv = fold ? s_ssend[i] : s_ssend[i - i % p];
      if (sv) atomicAdd(&ssend[(long long)b * np + i], sv);
      if (s_cnt[i]) atomicAdd(&cnt[(long long)b * np + i], s_cnt[i]);
      if (s_dsz[i]) atomicAdd(&dsz[(long long)b * np + i], s_dsz[i]);
    }
    for (int i = threadIdx.x; i < 2 * n; i += blockDim.x)
      if (s_node[i]) atomicAdd(&nodecnt[(long long)b * 2 * n + i], s_node[i]);
  }
}

constexpr int MAX_DEVICES = 64;

static int sm_count(int dev) {
  static int sms[MAX_DEVICES] = {};
  if (sms[dev] == 0 &&
      cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    sms[dev] = 0;
  return sms[dev];
}

// Blocks per config of a launch: the tiles, or the resident blocks of the
// current card spread over the B configs, whichever is fewer (>= 1); < 0 an
// error. The shared-memory attribute and the resident count belong to a
// card: they are cached per instantiation and card for the last (threads,
// shared bytes), since the paper-size rounds launch thousands of times with
// one plan and a sharded run alternates between cards.
template <class T, class Op, int VB, int PM>
static long long grid_x(int threads, long long smem_bytes, long long tiles,
                        int nb) {
  static int last_threads[MAX_DEVICES] = {}, per_sm[MAX_DEVICES] = {};
  static long long last_smem[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  if (dev < 0 || dev >= MAX_DEVICES)
    return -static_cast<long long>(cudaErrorInvalidDevice);
  if (threads != last_threads[dev] || smem_bytes != last_smem[dev]) {
    auto kernel = round_step_kernel<T, Op, VB, PM>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
    if (err != cudaSuccess) return -static_cast<long long>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm[dev], kernel, threads, (size_t)smem_bytes);
    if (err != cudaSuccess) return -static_cast<long long>(err);
    if (per_sm[dev] < 1)
      return -static_cast<long long>(cudaErrorInvalidConfiguration);
    last_threads[dev] = threads;
    last_smem[dev] = smem_bytes;
  }
  long long resident = (long long)per_sm[dev] * sm_count(dev);
  long long g = (resident + nb - 1) / nb;
  if (g > tiles) g = tiles;
  return g < 1 ? 1 : g;
}

constexpr int MAX_GRID_Y = 65535;   // configs a launch (kernels/round_step.py)

template <class T, class Op, int VB, int PM>
static int launch(const void* delta, const void* x, const void* buf,
                  const void* active, const void* delivered, const void* nbrs,
                  const void* rev, void* xo, void* bo, void* inbox,
                  void* nodecnt, void* ssend, void* cnt, void* dsz, int nb,
                  int n, int p, int k, int per_origin, int extracts,
                  long long u, int stages, int threads, int table_bytes,
                  int bar_bytes, long long smem_bytes, long long* blocks,
                  cudaStream_t stream) {
  constexpr int TC = 32 * Lane<T, VB>::V;
  for (int b0 = 0; b0 < nb; b0 += MAX_GRID_Y) {
    const int chunk = nb - b0 < MAX_GRID_Y ? nb - b0 : MAX_GRID_Y;
    long long g = grid_x<T, Op, VB, PM>(threads, smem_bytes,
                                        (u + TC - 1) / TC, chunk);
    if (g < 0) return static_cast<int>(-g);
    if (blocks != nullptr) *blocks = g;
    dim3 grid((unsigned)g, (unsigned)chunk);
    round_step_kernel<T, Op, VB, PM><<<grid, threads, smem_bytes, stream>>>(
        static_cast<const T*>(delta), static_cast<const T*>(x),
        static_cast<const T*>(buf), static_cast<const int32_t*>(active),
        static_cast<const int32_t*>(delivered),
        static_cast<const int32_t*>(nbrs), static_cast<const int32_t*>(rev),
        static_cast<T*>(xo), static_cast<T*>(bo), static_cast<T*>(inbox),
        static_cast<int32_t*>(nodecnt), static_cast<int32_t*>(ssend),
        static_cast<int32_t*>(cnt), static_cast<int32_t*>(dsz), nb, n, p, k,
        per_origin, extracts, u, stages, table_bytes, bar_bytes, b0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// uint8 lanes move 4 bytes: a lane keeps one element a register, so wider
// uint8 vectors would hold 16 registers where int32 holds 4.
template <class T, class Op, int PM, class... A>
static int by_width(int vb, A... a) {
  switch (vb) {
    case 0: return launch<T, Op, 0, PM>(a...);
    case 4: return launch<T, Op, 4, PM>(a...);
  }
  if constexpr (sizeof(T) == 4) {
    switch (vb) {
      case 8: return launch<T, Op, 8, PM>(a...);
      case 16: return launch<T, Op, 16, PM>(a...);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

constexpr int REG_TALLY_P = 4;   // kernels/round_step.py REG_TALLY_P

template <class T, class Op, class... A>
static int by_tally(int pm, int vb, A... a) {
  if (pm == REG_TALLY_P) return by_width<T, Op, REG_TALLY_P>(vb, a...);
  if (pm == 0) return by_width<T, Op, 0>(vb, a...);
  return static_cast<int>(cudaErrorInvalidValue);
}

// All contiguous: delta/x/xo [B, N, U]; buf/bo [K, B, N, U] (nullable when
// K = 0); active int32 [B, N, P]; delivered int32 [B, N] (nullable);
// nbrs/rev int32 [N, P]; inbox [P, B, N, U] (nullable); zeroed int32 counts
// nodecnt [B, N, 2], ssend/cnt/dsz [B, N, P]. The plan comes from
// kernels/round_step.py plan: vb (16, 8, 4 bytes a lane; 0: one element a
// lane), stages (>= 2: the bulk-copy ring, vb > 0; 0: direct loads), pm
// (REG_TALLY_P: register tallies, N <= 16 and P <= pm, `threads` = 32·N;
// 0: shared tallies, `threads` = 32·min(N, 32)) and the shared memory:
// table_bytes of int tables, bar_bytes of mbarriers, then the sends and
// the ring. `blocks` (nullable) receives the blocks per config. Any B >= 1:
// beyond 65,535 configs the launch is cut into chunks of 65,535.
extern "C" int round_step_launch(
    int kind, const void* delta, const void* x, const void* buf,
    const void* active, const void* delivered, const void* nbrs,
    const void* rev, void* xo, void* bo, void* inbox, void* nodecnt,
    void* ssend, void* cnt, void* dsz, int nb, int n, int p, int k,
    int per_origin, int extracts, long long u, int vb, int pm, int stages,
    int threads, int table_bytes, int bar_bytes, long long smem_bytes,
    long long* blocks, void* stream) {
  if (nb < 1 || n < 1 || p < 1 || k < 0 || u < 1 ||
      (per_origin && k != p + 1) || (extracts && k == 0) ||
      threads != 32 * (pm ? n : (n < 32 ? n : 32)) || (pm && (n > 16 || p > pm)) ||
      (stages != 0 && (vb == 0 || stages < 2 || bar_bytes < 8 * stages)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ROUND_STEP_ARGS                                                       \
  pm, vb, delta, x, buf, active, delivered, nbrs, rev, xo, bo, inbox,         \
      nodecnt, ssend, cnt, dsz, nb, n, p, k, per_origin, extracts, u, stages, \
      threads, table_bytes, bar_bytes, smem_bytes, blocks, s
  switch (kind) {
    case KIND_MAX_U8: return by_tally<uint8_t, MaxOp>(ROUND_STEP_ARGS);
    case KIND_MAX_I32: return by_tally<int32_t, MaxOp>(ROUND_STEP_ARGS);
    case KIND_OR_U32: return by_tally<uint32_t, OrOp>(ROUND_STEP_ARGS);
  }
#undef ROUND_STEP_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
