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
// (src/repro/kernels/round_step.py:148, body :60), whose tiles are
// [g, Np, bn]: g configs a tile, every node, bn universe columns.
//
// Bound on the H100: bytes. Every element of δ, x and the K buffer slots is
// read once and x' and the K slots written once (plus P inbox planes with
// emit_inbox). For bprr on the paper's mesh (K = 5) over 4,194,304 int32
// keys and 15 nodes that is 13 planes of 252 MB, 3.27 GB: at least 0.98 ms
// at 3.35 TB/s; for the keyed store's 30,000 objects of 50 nodes × 64 int32
// slots 4.99 GB, 1.49 ms. The sends and the routed inbox never touch device
// memory. About 42 integer operations an element, 0.16 ms at the card's
// int32 rate for the 4M-key round.
//
// Routing mixes nodes but never universe columns or configs. Two kernels,
// chosen by the row's width (kernels/round_step.py plan):
//
// Short rows (short_kernel: at most 32 vectors a (config, node) row,
// U·elem <= 512 bytes at 16-byte lanes; a keyed store's objects, a sweep's
// small states; P <= 4). The TPU kernel's g configs a tile:
// - Lane groups. A row is a group of L lanes (L a power of two <= 32, the
//   row's lanes rounded up), a lane one vector (16, 8 or 4 bytes where
//   every base and row is aligned to it, else one element) or, on the
//   ring, two 16-byte vectors L apart (vectors j and j + L: each access of
//   a warp stays one contiguous run), so a warp holds 32 / L rows. A block
//   holds g configs × N nodes, and the g configs' rows of a plane are one
//   contiguous run: every load and store is coalesced.
// - Registers. A thread holds its row's δ, x and K slots in registers,
//   joins, folds and receives there, and stores x', the K slots (and the
//   inbox) from there. Only the S send rows (S = P for the fold, else 1)
//   go to shared memory, because routing reads other nodes' sends.
// - Loads, two ways (the plan's `stages`). Ring (rows of an even number
//   of 16-byte vectors, half of it a power of two; 2-3 stages): a ring of
//   shared stages [2+K][g·N][U], one group of g configs each. The block's
//   last warp is the producer: one lane of it walks the block's groups up
//   to `stages` ahead of the other warps; for each it waits on the stage's
//   empty mbarrier, arms the full one with the group's bytes and issues
//   one bulk asynchronous copy a plane (δ, x, the K slots: a group's rows
//   of a plane are one contiguous run). The other warps wait on the full
//   mbarrier, read their rows into registers, and each arrives on the
//   empty mbarrier at once, so the next groups' loads are in flight while
//   a group joins, routes and stores. The sends go to one buffer
//   [S][g·N][U] between two barriers of those warps a group ("the last
//   group's sends read", "sends written"). Two vectors a lane halve the
//   threads, to at most RING_THREADS = 512 with the producer, and so give
//   a thread 128 registers: nothing spills, although the ring leaves the
//   L1 cache what the stages do not take. Direct (rows not 16-byte
//   aligned, uint8 rows, other widths, shapes where two stages do not fit):
//   each thread loads its 2+K vectors straight into registers, and the
//   sends go to two buffers [2][S][g·N][U], one barrier a group apart.
//   On the H100 at the Retwis store [30,000, 50, 64] bprr: the ring (g =
//   1, two stages of 89.6 KB, 448 threads) 1.852 ms, direct 2.06 (82% and
//   74% of the 1.524 ms byte bound); at a million objects [1,048,576, 16,
//   32]: ring g = 6 11.02 ms, direct 11.64 (bound 8.71). A receiver that
//   folded its sender's send from the stage instead of a send buffer, with
//   one 16-byte vector a lane, took 3.0-3.2 ms: 20 more shared reads a
//   thread a group, each send computed twice, and spills.
// - Tables. A thread's node is fixed over the walk, so it reads its
//   nbrs/rev entries once into registers (the offsets of its P routed send
//   rows); active and delivered are read per group.
// - Counts, no atomics. A row's 3P+2 counts are held two a word (16 bits
//   each) and reduced over its lane group by xor-shuffle halving (each
//   step sends half the words a lane holds and keeps the other half, the
//   last one half a word), after which each count sits in one lane, which
//   stores it: every (config, node) entry is written exactly once, so the
//   outputs need no zero-fill. Packing the counts took the direct path
//   from 2.37 to 2.06 ms at the Retwis store: 16 registers fewer a thread.
// - Grid. One persistent 1-D launch for any B: min(groups of g configs,
//   resident blocks × SMs, max_blocks) blocks walk the groups.
//
// Long rows (round_step_kernel: the paper-size states). A block takes a
// tile of TC columns of one config with all N node rows. A thread is a
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
//   stored from registers, VB bytes a lane. Only the S send rows go to
//   shared memory, double-buffered as on the short path.
// - Counts. On that path each thread keeps its node's 3P+3 tallies in
//   registers over its whole walk and the block reduces them once, a warp
//   sum and one atomicAdd per counter into zeroed outputs. Otherwise
//   (PM = 0: any N and P) warps loop over their nodes, re-read the stage
//   for phase 2, and add into shared counters per tile (warp sums). Both
//   are exact in any order.
// - Grid. A persistent grid: (blocks per config) × B, the blocks per config
//   the tiles or what the SMs hold resident
//   (cudaOccupancyMaxActiveBlocksPerMultiprocessor), whichever is fewer.
//   More than 65,535 configs launch in chunks of at most 65,535 along
//   gridDim.y, each chunk's first config `b0` passed in; every offset is
//   64-bit. The wrapper picks VB and the stages that fit shared memory.

#include <type_traits>

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

// Arrive once, releasing this thread's earlier reads and writes.
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar)) : "memory");
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

constexpr int REG_TALLY_P = 4;   // kernels/round_step.py REG_TALLY_P

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

// -- short rows: g configs a block, a lane group a row -------------------------

// A row's counts on the short path, in output order: |⇓δ|, |⇓x'|, then PM
// send sizes, PM novel and PM received counts; two a word, 16 bits each (a
// short row holds at most 512 bytes, 4,096 irreducibles), padded to 8
// words for the halving reduction.
constexpr int SP = REG_TALLY_P;
constexpr int C_SEND = 2, C_CNT = 2 + SP, C_DSZ = 2 + 2 * SP, NWORD = 8;
static_assert(C_DSZ + SP <= 2 * NWORD, "a row's counts exceed the reduction");

// Add v to count t (a constant once unrolled) of a row's packed counts.
__device__ __forceinline__ void tally(int (&tal)[NWORD], int t, int v) {
  tal[t >> 1] += (t & 1) ? v << 16 : v;
}

// One halving step of a lane group's sum of its counts: the lane `off` away
// holds the same words of other columns; the lane whose `off` bit is clear
// keeps the sums of words [0, H), the other those of [H, 2H), moved down
// to [0, H). Returns the first word the lane now holds, relative.
template <int H>
__device__ __forceinline__ int halve(int (&tal)[NWORD], int sub, int off) {
  const bool up = (sub & off) != 0;
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const int give = up ? tal[j] : tal[j + H];
    const int keep = up ? tal[j + H] : tal[j];
    tal[j] = keep + __shfl_xor_sync(0xffffffffu, give, off);
  }
  return up ? H : 0;
}

// A ring lane's share of a row: VB / 16 vectors of 16 bytes, `stride`
// elements apart (vector j of the lane's lane group, then vector j + L),
// so that each of a warp's accesses is one contiguous run.
template <class T, int VB>
struct Split {
  using L = Lane<T, 16>;
  static constexpr int W = VB / 16, V = W * L::V;
  T e[V];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < V; ++j) e[j] = T(0);
  }
  __device__ __forceinline__ void load(const T* p, int stride) {
#pragma unroll
    for (int w = 0; w < W; ++w) {
      L v;
      v.load(p + w * stride);
#pragma unroll
      for (int j = 0; j < L::V; ++j) e[w * L::V + j] = v.e[j];
    }
  }
  __device__ __forceinline__ void store(T* p, int stride) const {
#pragma unroll
    for (int w = 0; w < W; ++w) {
      L v;
#pragma unroll
      for (int j = 0; j < L::V; ++j) v.e[j] = e[w * L::V + j];
      v.store(p + w * stride);
    }
  }
  template <class Op> __device__ __forceinline__ void join(const Split& o) {
#pragma unroll
    for (int j = 0; j < V; ++j) e[j] = Op::join(e[j], o.e[j]);
  }
  template <class Op> __device__ __forceinline__ int count() const {
    int c = 0;
#pragma unroll
    for (int j = 0; j < V; ++j) c += Op::count(e[j]);
    return c;
  }
};

constexpr int RING_THREADS = 512;   // kernels/round_step.py RING_THREADS

// RING: a ring of `stages` shared stages [2+K][g·N][U], one group each,
// filled by the block's last warp with one bulk asynchronous copy a plane,
// each stage handed back as soon as the other warps have read their rows
// from it; one send buffer [S][g·N][U] between two barriers a group. Else
// each thread loads its vectors straight from device memory, and the
// sends go through two buffers [2][S][g·N][U], one barrier a group apart.
template <class T, class Op, int VB, bool RING>
__global__ void __launch_bounds__(RING ? RING_THREADS : 1024) short_kernel(
    const T* __restrict__ delta, const T* __restrict__ x, const T* buf,
    const int32_t* __restrict__ active, const int32_t* __restrict__ delivered,
    const int32_t* __restrict__ nbrs, const int32_t* __restrict__ rev,
    T* __restrict__ xo, T* bo, T* __restrict__ inbox,
    int32_t* __restrict__ nodecnt, int32_t* __restrict__ ssend,
    int32_t* __restrict__ cnt, int32_t* __restrict__ dsz, long long nb, int n,
    int p, int k, int per_origin, int extracts, int u, int lg, int g,
    int stages) {
  // a lane's columns: VB bytes of a row in one vector, or (RING) two
  // 16-byte vectors `half` columns apart
  using L = std::conditional_t<RING, Split<T, VB>, Lane<T, VB>>;
  constexpr int V = L::V;
  constexpr int VV = RING ? 16 / sizeof(T) : V;      // columns a vector
  static_assert(!RING || VB == 32, "ring lanes move two 16-byte vectors");
  extern __shared__ __align__(128) unsigned char smem[];
  T* const sh = reinterpret_cast<T*>(smem);
  const bool fold = per_origin && k > 0;       // leave-one-out sends
  const int rows = g * n;                      // rows of a group
  const int lanes = 1 << lg;
  const int consumers = (rows * lanes + 31) & ~31;   // threads with a row
  const int r = threadIdx.x >> lg;             // the thread's row of a group
  const int sub = threadIdx.x & (lanes - 1);   // its vector of the row
  const int c = r / n, i = r - c * n;          // its config in the group, node
  const int col = sub * VV;                    // its first column
  const int half = lanes * VV;                 // RING: to its second vector
  const bool in_row = r < rows && col < u;     // a vector is all in or out
  const int self_slot = per_origin ? k - 1 : 0;
  const long long plane = nb * n * u;          // a [B, N, U] plane
  const long long groups = (nb + g - 1) / g;
  const int group_elems = rows * u;            // a group's rows of a plane
  const int my_row = r * u + col;              // the thread's vector there
  // RING: the stages, the send buffer, then a full and an empty mbarrier a
  // stage; direct: the two send buffers
  const int stage_elems = (2 + k) * group_elems;
  const int buffer = (fold ? p : 1) * group_elems;   // one send buffer
  T* const sends = sh + stages * stage_elems;
  uint64_t* full = reinterpret_cast<uint64_t*>(sends + buffer);
  uint64_t* empty = full + stages;

  // the routed send row of each slot: an offset into a send buffer
  int soff[SP];
#pragma unroll
  for (int q = 0; q < SP; ++q) {
    soff[q] = 0;
    if (q < p && r < rows) {
      const int e = i * p + q;
      soff[q] = ((fold ? rev[e] : 0) * rows + c * n + nbrs[e]) * u + col;
    }
  }

  if constexpr (RING) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < stages; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], consumers >> 5);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x >= consumers) {
      // the producer: one lane brings the block's groups in, each into the
      // next stage once every consumer warp has read the group before it
      if (threadIdx.x == consumers) {
        int st = 0;
        uint32_t ph = 0;
        long long it = 0;
        for (long long grp = blockIdx.x; grp < groups;
             grp += gridDim.x, ++it) {
          if (it >= stages) {
            mbar_wait(&empty[st], ph ^ 1);
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          }
          const long long b0 = grp * g;
          const long long cfgs = nb - b0 < g ? nb - b0 : g;
          const uint32_t bytes =
              static_cast<uint32_t>(cfgs * n * u * sizeof(T));
          const long long off = b0 * n * u;
          T* dst = sh + st * stage_elems;
          mbar_expect_tx(&full[st], bytes * (2 + k));
          bulk_load(dst, delta + off, bytes, &full[st]);
          bulk_load(dst + group_elems, x + off, bytes, &full[st]);
          for (int s = 0; s < k; ++s)
            bulk_load(dst + (2 + s) * group_elems, buf + s * plane + off,
                      bytes, &full[st]);
          if (++st == stages) { st = 0; ph ^= 1; }
        }
      }
      return;
    }
  }
  // the barrier of the threads with a row (RING: not the producer)
  auto sync_rows = [&] {
    if constexpr (RING)
      asm volatile("bar.sync 1, %0;\n" ::"r"(consumers) : "memory");
    else
      __syncthreads();
  };

  // this thread's row of group grp2: its active slots (bits 0..P-1) and
  // its clear flag (bit P)
  auto flags = [&](long long grp2) {
    int f = 0;
    const long long b2 = grp2 * g + c;
    if (r < rows && b2 < nb) {
      const long long row2 = b2 * n + i;
#pragma unroll
      for (int q = 0; q < SP; ++q)
        if (q < p && active[row2 * p + q] != 0) f |= 1 << q;
      if (delivered != nullptr && delivered[row2] != 0) f |= 1 << SP;
    }
    return f;
  };

  // a lane's columns of the row at `from`, or to the row at `to`
  auto get = [&](L& v, const T* from) {
    if constexpr (RING) v.load(from, half);
    else v.load(from);
  };
  auto set = [&](const L& v, T* to) {
    if constexpr (RING) v.store(to, half);
    else v.store(to);
  };

  int st = 0;
  uint32_t ph = 0;
  long long it = 0;
  // The loop bound is uniform over the threads with a row: every one
  // reaches the barriers and every lane of a warp the shuffles.
  for (long long grp = blockIdx.x; grp < groups; grp += gridDim.x, ++it) {
    const long long b = grp * g + c;
    const bool live = r < rows && b < nb;      // the row exists
    const bool valid = in_row && b < nb;       // and so does the vector
    const long long row = b * n + i;
    const long long at = row * u + col;
    const int fl = flags(grp);
    const bool clear = (fl >> SP & 1) != 0;
    T* sd = RING ? sends : sh + (it & 1) * buffer;
    if constexpr (RING) mbar_wait(&full[st], ph);
    // input plane s of the row: the stage, or device memory
    const T* stage = sh + st * stage_elems + my_row;
    auto in = [&](L& v, int s, const T* src) {
      if (!valid) v.zero();
      else if constexpr (RING) get(v, stage + s * group_elems);
      else get(v, src + at);
    };
    L dv, xv, sl[SP + 1];
    in(dv, 0, delta);
    in(xv, 1, x);
#pragma unroll
    for (int s = 0; s <= SP; ++s)
      if (s < k) in(sl[s], 2 + s, buf + s * plane);
    if constexpr (RING) {
      // the warp's reads of the stage are done: hand it back
      __syncwarp();
      if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[st]);
      if (++st == stages) { st = 0; ph ^= 1; }
    }

    // (1) local join, (2) sends
    int tal[NWORD];
#pragma unroll
    for (int t = 0; t < NWORD; ++t) tal[t] = 0;
    tally(tal, 0, dv.template count<Op>());
    xv.template join<Op>(dv);
#pragma unroll
    for (int s = 0; s <= SP; ++s)
      if (s < k && s == self_slot) sl[s].template join<Op>(dv);
    if constexpr (RING) sync_rows();           // the last group's sends read
    if (!fold) {
      L v = xv;                                // the broadcast
      if (k > 0) v = sl[0];
      if (valid) set(v, sd + my_row);
      const int cv = v.template count<Op>();
#pragma unroll
      for (int q = 0; q < SP; ++q)
        if (q < p) tally(tal, C_SEND + q, cv);
    } else {
      // leave-one-out over the K = P+1 slots
#pragma unroll
      for (int j = 0; j < SP; ++j) {
        if (j < p) {
          L v;
          v.zero();
#pragma unroll
          for (int o = 0; o <= SP; ++o)
            if (o < k && o != j) v.template join<Op>(sl[o]);
          if (valid) set(v, sd + my_row + j * group_elems);
          tally(tal, C_SEND + j, v.template count<Op>());
        }
      }
    }
    sync_rows();                               // every row's sends written

    // (3) clear, (4)+(5)+(6) route and receive the P slots in order
    L ext;
    ext.zero();
#pragma unroll
    for (int q = 0; q < SP; ++q) {
      if (q < p) {
        L dq, nv;
        if (valid && (fl >> q & 1)) get(dq, sd + soff[q]);
        else dq.zero();
        int nov = 0;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          nov += Op::novel_count(dq.e[j], xv.e[j]);
          nv.e[j] = Op::novel(dq.e[j], xv.e[j]);
        }
        tally(tal, C_CNT + q, nov);
        tally(tal, C_DSZ + q, dq.template count<Op>());
        if (inbox != nullptr && valid) set(dq, inbox + q * plane + at);
        if (extracts) {
          if (per_origin) {
            L v = sl[q];
            if (clear) v.zero();
            v.template join<Op>(nv);
            if (valid) set(v, bo + q * plane + at);
          } else {
            ext.template join<Op>(nv);
          }
        }
        xv.template join<Op>(dq);
      }
    }
    // write back x' and the K slots
    tally(tal, 1, xv.template count<Op>());
    if (valid) {
      set(xv, xo + at);
#pragma unroll
      for (int s = 0; s <= SP; ++s) {
        if (s < k && !(extracts && per_origin && s < p)) {
          L v = sl[s];
          if (clear) v.zero();
          v.template join<Op>(ext);            // flat extracts: slot 0
          set(v, bo + s * plane + at);
        }
      }
    }

    // the row's counts over its lane group: three halving steps of words
    // across the lanes L/2, L/4, L/8 away (as many as L has), one of the
    // last word's two counts across the lanes L/16 away, then a plain sum
    // across the neighbour where L = 32; lane `sub` is left with words
    // base .. base + (8 >> lg) - 1, or (L >= 16) with count 2·base + upper
    // (with L = 32 both lanes of a pair: the even one writes)
    int base = 0, upper = 0;
    if (lg > 0) base += halve<4>(tal, sub, lanes >> 1);
    if (lg > 1) base += halve<2>(tal, sub, lanes >> 2);
    if (lg > 2) base += halve<1>(tal, sub, lanes >> 3);
    if (lg > 3) {
      const int off = lanes >> 4;
      upper = (sub & off) != 0;
      const unsigned w = static_cast<unsigned>(tal[0]);
      const int lo = w & 0xffffu, hi = w >> 16;
      tal[0] = (upper ? hi : lo) +
               __shfl_xor_sync(0xffffffffu, upper ? lo : hi, off);
    }
    if (lg > 4) tal[0] += __shfl_xor_sync(0xffffffffu, tal[0], 1);
    // count t's one entry in the outputs
    auto write = [&](int t, int v) {
      if (t < C_SEND) {
        nodecnt[2 * row + t] = v;
      } else if (t < C_CNT) {
        if (t - C_SEND < p) ssend[row * p + t - C_SEND] = v;
      } else if (t < C_DSZ) {
        if (t - C_CNT < p) cnt[row * p + t - C_CNT] = v;
      } else if (t < C_DSZ + SP) {
        if (t - C_DSZ < p) dsz[row * p + t - C_DSZ] = v;
      }
    };
    if (live && (lg <= 4 || (sub & 1) == 0)) {
      if (lg > 3) {
        write(2 * base + upper, tal[0]);
      } else {
#pragma unroll
        for (int j = 0; j < NWORD; ++j) {
          if (j < (NWORD >> lg)) {
            const unsigned w = static_cast<unsigned>(tal[j]);
            write(2 * (base + j), w & 0xffffu);
            write(2 * (base + j) + 1, w >> 16);
          }
        }
      }
    }
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

// Blocks of `kernel` the current card holds resident (>= 1) at `threads`
// and `smem_bytes` of shared memory; < 0 an error. The shared-memory
// attribute and the resident count belong to a card: `c` (one per kernel
// instantiation) caches them per card for the last (threads, shared bytes),
// since the paper-size rounds launch thousands of times with one plan and a
// sharded run alternates between cards.
struct Residency {
  int threads[MAX_DEVICES];
  long long smem[MAX_DEVICES];
  int per_sm[MAX_DEVICES];
};

template <class K>
static long long resident_blocks(K kernel, Residency& c, int threads,
                                 long long smem_bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  if (dev < 0 || dev >= MAX_DEVICES)
    return -static_cast<long long>(cudaErrorInvalidDevice);
  if (threads != c.threads[dev] || smem_bytes != c.smem[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
    if (err != cudaSuccess) return -static_cast<long long>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &c.per_sm[dev], kernel, threads, (size_t)smem_bytes);
    if (err != cudaSuccess) return -static_cast<long long>(err);
    if (c.per_sm[dev] < 1)
      return -static_cast<long long>(cudaErrorInvalidConfiguration);
    c.threads[dev] = threads;
    c.smem[dev] = smem_bytes;
  }
  return (long long)c.per_sm[dev] * sm_count(dev);
}

// Blocks per config of a long-row launch: the tiles, or the resident blocks
// spread over the B configs, whichever is fewer (>= 1); < 0 an error.
template <class T, class Op, int VB, int PM>
static long long grid_x(int threads, long long smem_bytes, long long tiles,
                        int nb) {
  static Residency cache;
  const long long resident = resident_blocks(
      round_step_kernel<T, Op, VB, PM>, cache, threads, smem_bytes);
  if (resident < 0) return resident;
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

// -- the short-row launch ------------------------------------------------------

template <class T, class Op, int VB, bool RING>
static int launch_short(const void* delta, const void* x, const void* buf,
                        const void* active, const void* delivered,
                        const void* nbrs, const void* rev, void* xo, void* bo,
                        void* inbox, void* nodecnt, void* ssend, void* cnt,
                        void* dsz, long long nb, int n, int p, int k,
                        int per_origin, int extracts, int u, int stages,
                        int lanes, int configs, int threads,
                        long long smem_bytes, long long max_blocks,
                        long long* blocks, cudaStream_t stream) {
  constexpr int V = VB ? VB / (int)sizeof(T) : 1;    // columns a lane
  int lg = 0;
  while ((1 << lg) < lanes) ++lg;
  const int S = per_origin && k > 0 ? p : 1;
  const long long rows = (long long)configs * n;
  const long long plane = rows * u * (long long)sizeof(T);  // a group's
  const long long consumers = (rows * lanes + 31) / 32 * 32;
  const long long need =
      RING ? stages * ((2 + k) * plane + 16) + S * plane : 2 * S * plane;
  if ((1 << lg) != lanes || lanes > 32 ||
      (RING ? lanes * V != u : (u + V - 1) / V > lanes || u % V != 0) ||
      threads != consumers + (RING ? 32 : 0) ||
      threads > (RING ? RING_THREADS : 1024) || smem_bytes < need)
    return static_cast<int>(cudaErrorInvalidValue);
  static Residency cache;
  const long long resident = resident_blocks(short_kernel<T, Op, VB, RING>,
                                             cache, threads, smem_bytes);
  if (resident < 0) return static_cast<int>(-resident);
  const long long groups = (nb + configs - 1) / configs;
  long long grid = groups < resident ? groups : resident;
  if (grid > max_blocks) grid = max_blocks;
  if (grid < 1) grid = 1;
  if (blocks != nullptr) *blocks = grid;
  short_kernel<T, Op, VB, RING><<<(unsigned)grid, threads, smem_bytes,
                                  stream>>>(
      static_cast<const T*>(delta), static_cast<const T*>(x),
      static_cast<const T*>(buf), static_cast<const int32_t*>(active),
      static_cast<const int32_t*>(delivered),
      static_cast<const int32_t*>(nbrs), static_cast<const int32_t*>(rev),
      static_cast<T*>(xo), static_cast<T*>(bo), static_cast<T*>(inbox),
      static_cast<int32_t*>(nodecnt), static_cast<int32_t*>(ssend),
      static_cast<int32_t*>(cnt), static_cast<int32_t*>(dsz), nb, n, p, k,
      per_origin, extracts, u, lg, configs, RING ? stages : 0);
  return static_cast<int>(cudaGetLastError());
}

template <class T, class Op, class... A>
static int short_by_width(int vb, int stages, A... a) {
  if ((stages != 0) != (vb == 32) || stages == 1)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (vb) {
    case 0: return launch_short<T, Op, 0, false>(a...);
    case 4: return launch_short<T, Op, 4, false>(a...);
  }
  if constexpr (sizeof(T) == 4) {
    switch (vb) {
      case 8: return launch_short<T, Op, 8, false>(a...);
      case 16: return launch_short<T, Op, 16, false>(a...);
      case 32: return launch_short<T, Op, 32, true>(a...);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The short-row kernel (kernels/round_step.py plan with lanes > 0): the
// operands of round_step_launch, but the counts need no zero-fill (each
// entry is written once) and P <= REG_TALLY_P, K <= P + 1. vb: 16, 8 or 4
// bytes a lane where every base and U·elem are multiples of it (uint8: 4),
// 0: one element a lane, all with direct loads (stages 0); or 32, two
// 16-byte vectors a lane, with the ring of `stages` >= 2 bulk-copied
// stages; lanes: L, a power of two <= 32 covering the row's vectors (the
// ring: exactly); configs: g a block; threads: g·N·L rounded up to whole
// warps, and with the ring one warp more (<= RING_THREADS, else 1,024);
// smem_bytes: the ring's stages·((2+K)·g·N·U·elem + 16) and one send
// buffer, S·g·N·U·elem, or direct two send buffers; max_blocks caps the
// persistent grid, whose blocks walk the groups of g configs beyond it.
// `blocks` (nullable) receives the grid's blocks. One launch for any B >= 1.
extern "C" int round_step_short_launch(
    int kind, const void* delta, const void* x, const void* buf,
    const void* active, const void* delivered, const void* nbrs,
    const void* rev, void* xo, void* bo, void* inbox, void* nodecnt,
    void* ssend, void* cnt, void* dsz, long long nb, int n, int p, int k,
    int per_origin, int extracts, int u, int vb, int stages, int lanes,
    int configs, int threads, long long smem_bytes, long long max_blocks,
    long long* blocks, void* stream) {
  if (nb < 1 || n < 1 || p < 1 || p > SP || k < 0 || k > SP + 1 || u < 1 ||
      (per_origin && k != p + 1) || (extracts && k == 0) || configs < 1 ||
      max_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SHORT_ARGS                                                            \
  vb, stages, delta, x, buf, active, delivered, nbrs, rev, xo, bo, inbox,     \
      nodecnt, ssend, cnt, dsz, nb, n, p, k, per_origin, extracts, u, stages, \
      lanes, configs, threads, smem_bytes, max_blocks, blocks, s
  switch (kind) {
    case KIND_MAX_U8: return short_by_width<uint8_t, MaxOp>(SHORT_ARGS);
    case KIND_MAX_I32: return short_by_width<int32_t, MaxOp>(SHORT_ARGS);
    case KIND_OR_U32: return short_by_width<uint32_t, OrOp>(SHORT_ARGS);
  }
#undef SHORT_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
