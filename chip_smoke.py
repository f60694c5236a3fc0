#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py            # every phase, on one card
    python3 chip_smoke.py --cards    # phase 9 (c) over several cards alone

Needs one sm_90 CUDA device (an H100) and ``nvcc``; builds the kernels from
``src/repro_torch/csrc`` on first use. Phases, each of which must pass:

1. environment: torch / CUDA versions and the card's name and power limit;
2. build: every kernel compiled by nvcc for sm_90a (one nvcc per source, in
   parallel), and its time;
3. kernels: each CUDA kernel against its plain PyTorch version on the card,
   exactly (tolerance 0: integers and bit patterns), over kinds max
   (int32, bool) and bitor (words with bit 31 set), buffers of
   K ∈ {0, 1, P+1}, extracts, the masked inbox, emit_stored/emit_cov,
   active/delivered masks with zeros (the fault masks), digest blocks
   be ∈ {8, ..., 1,024}, P ∈ {1, 4, 8} extraction masks all-zero, all-one
   and random, B = 2 configs, N ∈ {9, 15, 40}, U off tile and block
   multiples (rows not 16-byte aligned), 16-byte aligned rows of whole and
   ragged tiles, and views off 16 bytes; then each timed (CUDA events,
   median of 25 samples of 5 back-to-back calls) beside its plain version
   and its bound (bytes at 3.35 TB/s, int32 operations at the card's
   int32 rate from its maximum SM clock) at the scale phase's shapes,
   with the launch plan ``round_step`` and ``digest_blocks`` chose there
   (which must be their 16-byte bulk-copy and vector paths); the elementwise kernels (join over max uint8 / int8 / int32 /
   bool and bitor, delta_extract likewise, lex_join_delta) at small shapes
   off multiples of 4 and 16 and at views not 16-byte aligned, then at
   [15, 4,194,304] int32 beside their plain versions, the single library
   call where one exists (torch.maximum, torch.bitwise_or; join's ratio to
   torch.maximum printed) and their byte bounds; the batch shapes against
   the plain versions (``round_recv`` over 70,001 rows of short and long
   rows, ``round_step`` over 65,537 configs at U = 32 (one launch of the
   short-row kernel) and U = 160 (chunks of the long-row one), at U = 64 on
   mesh16 and mesh50, short rows about the 32-vector threshold (U = 1-128,
   N = 3-64, every flavour, bool rows, words, a base off 16 bytes) and
   with the grid capped at 3 blocks, the five path kernels on [B, N, U]
   rows) and ``round_step`` (the short-row kernel under its default plan,
   which must launch once, beside the long-row kernel, equal), ``round_recv``
   and ``buffer_fold`` timed at the store's shapes (30,000 × mesh50 × 64
   slots, bprr and classic; 1,048,576 × mesh16 × 32, bprr) beside their
   bounds;
4. paper size, each run on all three engines (bit-identical, each kernel
   engine's launches equal to its rounds):
   - ``benchmarks/results/fig7_transmission.json`` (GSet, GCounter) and the
     GMap 10% / 100% rows of ``fig8_gmap.json``: the five δ-family
     algorithms on the paper's tree and mesh, 100 active + 20 quiet rounds;
   - ``fig_digest.json``: the join table (state, bprr, state_driven,
     digest_driven × divergence 5–75%) and the heal table (partition
     widths 4–16 ∘ 2% loss);
   - ``BENCH_fault.json``: the five δ-family algorithms under loss 0/1/10%,
     a partition and churn, 40 + 80 rounds;
5. scale, ms per round (median, min and max of 5 timed runs), byte bound,
   peak device memory, and per-round metrics against oracles:
   - GMap with 4,194,304 keys (K = 10%) bprr / classic on the mesh and the
     tree, and BitGSet with 2^27 bits (27,962 × the GCounter(15) run; the
     GSet(180) run);
   - (a) a GMap join at 4,194,304 keys (state and state_driven: 4,096 × the
     GSet(1,024) r25 join of phase 4; digest_driven on all three engines),
     (b) a BitGSet join at 2^27 bits (digest_driven), (c) GMap bprr under
     10% loss (fused and mega against the reference engine);
6. the batched main path (sweeps and the keyed store), launch counters
   zeroed again: BENCH_fault's scenarios and fig_digest's join and heal
   grids as one ``simulate_sweep`` per algorithm on all three engines
   (every cell equal to the committed value and to its phase-4 single
   run); ``fig11_retwis.json`` value for value (every zipf row on the
   reference engine, ``fused``/``mega`` bit-identical to it, the resync
   block); Retwis at 50 nodes × 30,000 objects × 64 slots, 100 + 13
   rounds, classic and bprr on three engines (ms per round, peak memory,
   the byte bound; engines equal, 8 sampled objects equal to their own
   ``simulate``, every object converged; a profile of 3 rounds); 1,048,576
   objects in chunks of 5 rounds with ``object_metrics=False`` on ``mega``
   and ``fused``, checkpointed at every boundary and resumed from round
   10, against an ``object_metrics=True`` run and 8 per-object runs;
7. the lex-pair main path: LWWMap with 4,194,304 keys (the GMap 10% key
   blocks written as (timestamp + 1, node id + 1)), bprr and classic on the
   mesh, 12 + 8 rounds on the reference engine (ms per round, peak memory;
   27,962 × the GCounter(15) run; ``engine="mega"`` resolves to the
   reference and launches nothing); replicas merging the results through
   ``ops.lex_join_delta``, ``ops.join`` and ``ops.delta_extract``; LWWMap
   at 65,536 keys under 10% loss and in a digest_driven join, each run on
   the card equal to the CPU run; ``repro_torch.quickstart`` on the card
   equal to the CPU; ``repro_torch.retwis_app`` on the card equal to the
   CPU and to the JAX example's numbers (``RETWIS_APP_EXPECT``), launching
   nothing;
8. observability and the Scuttlebutt baseline, launch counters zeroed
   again (each part's seconds and its oracles' seconds printed):
   (a) ``fig_telemetry.json``'s 18 cells value for value on three engines;
   (b) ``benchmarks/fig_provenance.py``'s scenarios on three engines and
   the CPU, all equal, attribution exhaustive, bprr back-propagating
   nothing, the two anomalies classified; (c) GMap 4,194,304 keys bprr /
   classic with telemetry and provenance on three engines: the run
   unchanged, the channels 27,962 × the GCounter(15) run's, mega timed
   off / telemetry / both; in (a)-(c) every run's channels (and
   provenance) also equal ``repro_torch.obs.oracle``'s replays on the
   card, the [15, 4,194,304] lineage matrices included, and no oracle
   call launches a kernel; (d) Scuttlebutt's fig7 rows, fig10 column and
   fig9 entries, and its GMap codec at 4,194,304 keys; (e) phase 6's
   sweeps and the committed Retwis store with telemetry and provenance,
   every cell and object equal to its single run, and Retwis at the paper
   setting with telemetry and ``object_metrics=False``, timed against the
   run without, checkpointed and resumed; its trace is written beside the
   JSON log (``obs_trace.json``, ``obs_trace.jsonl``);
9. the gossip runtime, padding and shards (each part's seconds printed;
   (a) and (b) launch no kernel and run right after phase 3, before any
   profiler window, beside a probe of the host's launch cost that is
   repeated after the last profile; (c) runs after phase 8 with the
   launch counters zeroed again): (a) ``repro_torch.elastic_churn`` on the
   card, equal to its CPU run and to the JAX example's numbers (suspected
   at round 10, dp_size 11, a 78-element bootstrap, checkpoint 19, 142,336
   tokens, 5,815 novel / 13,316 redundant); (b) a 256-node control plane
   (the 16 × 16 production mesh; membership, heartbeats, a GCounter(512),
   a CheckpointRegistry(1024), a ShardLedger(1024)) with 8 nodes down in
   rounds 6–16 under 3% loss, drained until every store converged, on the
   card and, at the same time, on the CPU in a worker process: equal value
   for value, 256 members, progress 512 × the up node-rounds, checkpoint
   19; s/round on both; (c) the committed Retwis store with ``pad_to=5``,
   in five blocks on the card (``["cuda:0"] * 5``) and with ``shard=True``
   over the card (the unsharded run's launches), each equal to the
   unpadded run on three engines; the paper-setting store in four blocks
   with ``object_metrics=False``, its [4, T] partials equal to phase 6's
   per-object run summed by block, ms/round beside phase 6's; with
   several cards visible, the committed store over every card
   (``device="cuda"``) equal to the unpadded run, and the paper store in
   one block a card against the same blocks on card 0 (equal partials,
   ms/round of both; ``--cards`` runs this part alone);
10. profile: ``torch.profiler`` over three GMap rounds per kernel engine
   (bprr; on ``mega`` also with telemetry and provenance), three LWWMap
   rounds (reference) and three digest_driven rounds
   on ``fused`` — device time by kernel and the device's busy share; a
   profiler failure fails the run;
11. the model side's server (plain PyTorch; run after phase 10, the
   launch counters zeroed and read: no kernel of the eight launches), each
   architecture at its full width with weights from seed 0 drawn on the
   card: qwen3-0.6b whole (28 layers) on R1 (``ServeRun``'s defaults:
   batch 4, prompt 32, 16 new tokens) and R2 (batch 8, prompt 2,048, 32
   new), recurrentgemma-2b and rwkv6-1.6b whole on R2, the other six one
   pattern group deep on batch 4, prompt 512, 16 new (musicgen-large and
   internvl2-26b, whose frontends ``generate`` refuses, through
   ``forward``): prefill ms beside its FLOP bound, decode ms a step beside
   its byte bound, tokens/s, peak memory, a ``torch.profiler`` window of 4
   decode steps (busy share, kernels a step); oracles: (i) the last step of
   a decode teacher-forced with the generated tokens equals a re-prefill
   of prompt + generated tokens, (ii) the card equals the card machine's
   CPU (batch 2, prompt 32, 4 teacher-forced steps, weights copied), each
   in float32 (weights upcast on both sides) at 0.15 and in bf16 at rtol
   0.15 and atol 0.15 or twice the reference's own bf16 noise
   (``ORACLE_TOL``), each also rejecting planted faults (zeroed, negated,
   shifted logits), MoE routing pinned between the runs except at
   near-ties; (iii) finite logits, tokens in range;
   (iv) no sync kernel launched;
12. the model side's trainer (plain PyTorch; the launch counters zeroed
   and read: no kernel of the eight launches), weights from seed 0 drawn
   on the card: (a) qwen3-0.6b whole at full width (28 layers, remat
   ``"nothing"``), sequence 4,096 (the registry's ``train_4k``), batch 4
   (cut from 256), ``make_train_step`` at microbatches 1 and 2, each a
   warm-up step then 3 timed: ms/step beside the FLOP bound (6 × active
   non-embedding params × tokens, 3 × the causal attention pairs' FLOPs,
   3 × the head's, at 989 TFLOP/s bf16), tokens/s, peak memory, one
   profiled step (busy share, kernels a step); oracles: a finite step-1
   loss within 1 of ln V, the microbatched loss within rtol 5e-3 and its
   first moments within 5e-2 of the unbatched step's (lr 0, no decay), the
   reference's dtype rule (bf16 params after an unbatched step, float32
   after a microbatched one); (b) every architecture one pattern group
   deep at full width, one step, the card against the card machine's CPU
   (batch 2, 32 positions after any patches, weights drawn on the card and
   copied, MoE routing pinned, remat off; the CPU's halves on a worker
   thread, beside (a) for the models drawn before it): in float32 the
   loss, every gradient leaf (rtol and
   atol 1e-3 of the leaf's largest entry) and the params after one AdamW
   step (atol = rtol = 1e-4 where the clipped gradient is at least 1e-6,
   2·lr below), the AdamW part where its 7 float32 copies fit in 12 GiB of
   host memory; in bf16 the loss and every gradient leaf (in L2) within
   twice the CPU's own bf16 noise; each comparison rejects a zeroed, a
   negated and a
   shifted leaf; (c) ``python -m repro_torch.train_100m``'s default run
   (qwen3-100m, 200 steps, batch 8, seq 256, checkpoints every 50; the
   loss must fall), its step-100 bundle resumed to 200 against the
   uninterrupted run within 2e-2;
13. the autotuner, the model side's meshes and the dry-run, with the
   autotune cache pointed at an empty file of the smoke's own from the
   start (every earlier phase runs the default plans): (a) every plan of
   ``round_step.plans`` at the scale phase's GMap 4,194,304 bprr round
   (mesh15d4, K = P + 1, per-origin) and at the store's [30,000, 50, 64]
   and [1,048,576, 16, 32] bprr rounds (the short-row kernel's plans)
   against the plain version exactly; ``ops.
   sync_round_block`` tuning into a fresh file (each candidate's ms by
   CUDA events, the winner beside the default plan and the byte bound),
   then resolving from it (source "cache"); a mega GMap 4M bprr run (12 +
   8 rounds) under the tuned plan equal to the default plan's run, its
   launches counted as the "tuned" path; (b) a one-rank NCCL group and a
   (1, 1) mesh on the card: qwen3-0.6b whole in float32, weights from seed
   0 placed by ``param_specs`` / ``to_named``, one train step (batch 2 ×
   512) with hints and ``grad_specs`` equal to the plain step (loss, every
   gradient leaf, the params after AdamW at phase 12's float32
   allowances, each rejecting planted faults), a prefill and four decode
   steps through ``make_prefill`` / ``make_decode(hints=)`` equal to the
   plain ones; (c) on the CPU, in subprocesses started before phase 11
   (fake process group, no card, one thread each): the dry-run of qwen3-0.6b
   train_4k on the 16 × 16 mesh and of mixtral-8x22b decode_32k on 4 × 4
   (exit 0, ``OK`` lines), and qwen3-0.6b at batch 4 × 4,096 on (1, 1),
   its predicted peak memory and FLOPs beside phase 12 (a)'s measured
   peak and FLOP count.

Phases 4–5 are the sync engines' main path, phase 6 its batched form,
phase 7 the lex-pair one (the elementwise kernels' users), phase 8 the
observability path and phase 9 the sharded one (the runtime launches no
kernel), phases 11 and 12 the model side's (which launch none of them):
the launch counters are zeroed before and read after each. Prints
per-phase seconds, one ``{"kernels": [...]}`` line, the card's
``nvidia-smi`` name and power limit, and last ``{"ok": true, "device":
{...}}``; exits non-zero, without that line, if anything fails or no card
is present. Details go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import gc
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO / "src"))
# The million-object fused store peaks at 62 GiB of the card's 80 and
# allocates 10 GiB buffers; repeated runs fragment fixed-size segments
# until one no longer fits. Expandable segments map pages as needed.
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
INT32_LANES_PER_SM = 64          # Hopper: 16 INT32 lanes per SM sub-partition
INT_OPS_PER_S = None             # set by main(): lanes x SMs x max SM clock
REPS = 25                        # timed samples of a kernel
BATCH = 5                        # back-to-back calls in one sample
SCALE_RUNS = 5                   # timed runs of each scale configuration
SCALE_KEYS = 4_194_304
BIT_UNIVERSE = 2 ** 27
DIGEST_BLOCK = 64                # fig_digest.json's block_elems


class Checks:
    def __init__(self):
        self.failed = []

    def __call__(self, ok: bool, what: str) -> bool:
        if not ok:
            self.failed.append(what)
            print(f"FAIL {what}", flush=True)
        return ok


def time_ms(fn, reps=REPS):
    """Median over ``reps`` samples of the CUDA-event time per call of
    BATCH back-to-back calls of ``fn``, after two warm-up calls. A sample
    starts behind one more call, so the device is busy while the timed
    calls are queued: each call's host work (the Python wrapper, the
    launch) overlaps the device work queued before it, and a sample times
    the device rather than the wrapper's overhead."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        fn()
        start.record()
        for _ in range(BATCH):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / BATCH)
    return statistics.median(times)


def bound(nbytes: float, ops: float):
    """Least time for the work (ms) and what bounds it."""
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = ops / INT_OPS_PER_S * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def max_abs_err(got, want) -> float:
    import torch

    pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
    err = 0.0
    for g, w in pairs:
        if g is None or w is None:
            if (g is None) != (w is None):
                return float("inf")
            continue
        g64, w64 = g.to(torch.int64), w.to(torch.int64)
        if g64.shape != w64.shape:
            return float("inf")
        if g64.numel():
            err = max(err, float((g64 - w64).abs().max()))
    return err


def nvidia_smi(query="name,power.limit") -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi: not available"


def int_ops_per_s(check) -> float:
    """The card's peak int32 rate: INT32_LANES_PER_SM lanes on every SM at
    the maximum SM clock nvidia-smi reports (an H100 SXM at 1,980 MHz:
    16.7e12 operations/s). Not the float32 rate: Hopper has half as many
    int32 lanes as float32 lanes, and an integer operation is not an FMA
    counted twice."""
    import torch

    smi = nvidia_smi("clocks.max.sm")
    m = re.match(r"\s*(\d+(?:\.\d+)?)\s*MHz", smi)
    check(m is not None, f"nvidia-smi clocks.max.sm unreadable: {smi!r}")
    mhz = float(m.group(1)) if m else float("nan")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rate = INT32_LANES_PER_SM * sms * mhz * 1e6
    print(f"int32 peak: {INT32_LANES_PER_SM} lanes x {sms} SMs x {mhz:.0f} "
          f"MHz = {rate:.4g} ops/s", flush=True)
    return rate


# -- phase 3: kernels against their plain versions ----------------------------

def rand_state(g, dtype, shape, dev):
    import torch

    if dtype == torch.bool:
        return torch.randint(0, 2, shape, generator=g, device=dev).bool()
    if dtype == "words":         # full 32-bit words, bit 31 included
        return torch.randint(-2**31, 2**31, shape, generator=g, device=dev,
                             dtype=torch.int64).to(torch.int32)
    return torch.randint(0, 13, shape, generator=g, device=dev,
                         dtype=torch.int32)


KINDS = (("max", "int32"), ("max", "bool"), ("bitor", "words"))


def kernel_grid(check, dev, log):
    """Every flag combination at small odd shapes, kernel vs plain."""
    import torch

    from repro_torch.kernels import buffer_fold as kf
    from repro_torch.kernels import digest_blocks as kd
    from repro_torch.kernels import masked_extract as ke
    from repro_torch.kernels import round_recv as kr
    from repro_torch.kernels import round_step as ks
    from repro_torch.sync import topology

    g = torch.Generator(device=dev).manual_seed(0)
    errs = {name: 0.0 for name in SYNC_KERNELS}
    cases = {name: 0 for name in SYNC_KERNELS}
    for kind, tname in KINDS:
        dtype = {"int32": torch.int32, "bool": torch.bool,
                 "words": "words"}[tname]
        # U = 1001: rows not 16-byte aligned (direct loads); 1024: whole
        # bulk-copy tiles; 1000 int32: aligned rows, a ragged last tile
        # (bool: not aligned); 4,096 bool: whole 512-column tiles; an
        # offset view of aligned rows: direct loads
        widths = (1001, 1024, 4096 if tname == "bool" else 1000, -1024)
        # N = 40: more nodes than a round_step block has node-threads
        for topo in (topology.partial_mesh(9, 4), topology.tree(15),
                     topology.partial_mesh(40, 4)):
            t = topo.on(dev)
            n, p = topo.num_nodes, topo.max_degree
            for flavor, k, per_origin, extracts in (
                    ("state", 0, False, False), ("classic", 1, False, False),
                    ("bp", p + 1, True, False), ("rr", 1, False, True),
                    ("bprr", p + 1, True, True)):
                for w in widths:
                    b, u, off = 2, abs(w), int(w < 0)
                    delta = offset_view(rand_state(g, dtype, (b, n, u), dev),
                                        off)
                    x = rand_state(g, dtype, (b, n, u), dev)
                    buf = rand_state(g, dtype, (k, b, n, u), dev) if k else None
                    act = torch.randint(0, 2, (b, n, p), generator=g,
                                        device=dev, dtype=torch.int32) \
                        * t.mask.to(torch.int32)
                    dlv = torch.randint(0, 2, (b, n), generator=g, device=dev,
                                        dtype=torch.int32) if k else None
                    args = (delta, x, buf, act, dlv, t.nbrs, t.rev)
                    views = [None if a is None else
                             (a.view(torch.uint8) if a.dtype == torch.bool else a)
                             for a in args]
                    for emit_inbox in (False, True):
                        kw = dict(kind=kind, per_origin=per_origin,
                                  extracts=extracts, emit_inbox=emit_inbox)
                        got = ks.round_step(*args, **kw)
                        want = ks.plain(*views, **kw)
                        want = tuple(None if w_ is None else
                                     (w_.view(torch.bool)
                                      if w_.dtype == torch.uint8 else w_)
                                     for w_ in want)
                        e = max_abs_err(got, want)
                        errs["round_step"] = max(errs["round_step"], e)
                        cases["round_step"] += 1
                        check(e == 0, f"round_step {kind}/{tname} {topo.name} "
                                      f"{flavor} u={u} offset={off} "
                                      f"inbox={emit_inbox} plan "
                                      f"{ks.last_launch}: err {e}")
        for emit_stored in (False, True):
            for emit_cov in (False, True):
                p, m, u = 4, 15, 1001
                d = rand_state(g, dtype, (p, m, u), dev)
                x = rand_state(g, dtype, (m, u), dev)
                act = torch.randint(0, 2, (m, p), generator=g, device=dev,
                                    dtype=torch.int32)
                kw = dict(kind=kind, active=act, emit_stored=emit_stored,
                          emit_cov=emit_cov)
                got = kr.round_recv(d, x, **kw)
                dv = d.view(torch.uint8) if d.dtype == torch.bool else d
                xv = x.view(torch.uint8) if x.dtype == torch.bool else x
                want = kr.plain(dv, xv, act, kind, emit_stored, emit_cov)
                want = tuple(None if w is None else
                             (w.view(torch.bool) if w.dtype == torch.uint8 else w)
                             for w in want)
                e = max_abs_err(got, want)
                errs["round_recv"] = max(errs["round_recv"], e)
                cases["round_recv"] += 1
                check(e == 0, f"round_recv {kind}/{tname} stored={emit_stored} "
                              f"cov={emit_cov}: err {e}")
        for k in (2, 5, 9):
            for shape in ((k, 15, 1001), (k, 2, 15, 1001)):
                buf = rand_state(g, dtype, shape, dev)
                got = kf.buffer_fold(buf, kind=kind)
                bv = buf.view(torch.uint8) if buf.dtype == torch.bool else buf
                want = kf.plain(bv, kind)
                if buf.dtype == torch.bool:
                    want = want.view(torch.bool)
                e = max_abs_err(got, want)
                errs["buffer_fold"] = max(errs["buffer_fold"], e)
                cases["buffer_fold"] += 1
                check(e == 0, f"buffer_fold {kind}/{tname} {shape}: err {e}")
        # digests and extractions: U off the block and 32-element multiples
        # (1001, 333, 70), 16-byte aligned rows (1024, 4,096; 1,000 int32
        # with a zero-padded last block) and an offset view of aligned rows
        for n, w in ((9, 1001), (15, 333), (40, 70), (15, 1024),
                     (15, 4096 if tname == "bool" else 1000), (9, -1024)):
            u, off = abs(w), int(w < 0)
            x = offset_view(rand_state(g, dtype, (n, u), dev), off)
            xv = x.view(torch.uint8) if x.dtype == torch.bool else x
            # be 256 / 1,024: a block of more lanes than a warp has
            for be in (8, 32, 64, 128, 256, 1024):
                e = max_abs_err(kd.digest_blocks(x, block_elems=be, kind=kind),
                                kd.plain(xv, be, kind))
                errs["digest_blocks"] = max(errs["digest_blocks"], e)
                cases["digest_blocks"] += 1
                check(e == 0, f"digest_blocks {kind}/{tname} n={n} u={u} "
                              f"offset={off} be={be} plan {kd.last_launch}: "
                              f"err {e}")
                if be > 128 or off:
                    continue
                nb = -(-u // be)
                for p in (1, 4, 8):
                    for fill in ("zeros", "ones", "random"):
                        masks = torch.randint(
                            0, 2, (p, n, nb), generator=g, device=dev,
                            dtype=torch.int32) if fill == "random" else \
                            torch.full((p, n, nb), int(fill == "ones"),
                                       dtype=torch.int32, device=dev)
                        got = ke.masked_extract(x, masks.bool(),
                                                block_elems=be)
                        want = ke.plain(xv, masks, be)
                        if x.dtype == torch.bool:
                            want = want.view(torch.bool)
                        e = max_abs_err(got, want)
                        errs["masked_extract"] = max(errs["masked_extract"], e)
                        cases["masked_extract"] += 1
                        check(e == 0, f"masked_extract {kind}/{tname} n={n} "
                                      f"u={u} be={be} p={p} {fill}: err {e}")
    torch.cuda.synchronize()
    log["kernel_grid"] = {"cases": cases, "max_abs_err": errs}
    print(f"kernel grid: {cases} cases, max_abs_err {errs}", flush=True)
    return errs


def kernel_timings(check, dev, log):
    """Each kernel at the scale phase's shapes (GMap, 4,194,304 keys, the
    paper's mesh, bprr): exact check, then kernel / plain time and bound."""
    import torch

    from repro_torch.kernels import buffer_fold as kf
    from repro_torch.kernels import digest_blocks as kd
    from repro_torch.kernels import masked_extract as ke
    from repro_torch.kernels import round_recv as kr
    from repro_torch.kernels import round_step as ks
    from repro_torch.sync import topology

    g = torch.Generator(device=dev).manual_seed(1)
    topo = topology.partial_mesh(15, 4).on(dev)
    n, p, u, k = 15, 4, SCALE_KEYS, 5
    plane = n * u * 4                                 # one [N, U] int32 plane
    out = {}

    # round_step, bprr: δ, x [1, N, U]; the engine's [K, N, U] buffer as a
    # [K, 1, N, U] view
    delta = rand_state(g, torch.int32, (1, n, u), dev)
    x = rand_state(g, torch.int32, (1, n, u), dev)
    buf = rand_state(g, torch.int32, (k, 1, n, u), dev)
    act = topo.mask.to(torch.int32)[None].contiguous()
    dlv = torch.ones((1, n), dtype=torch.int32, device=dev)
    args = (delta, x, buf, act, dlv, topo.nbrs, topo.rev)
    kw = dict(kind="max", per_origin=True, extracts=True, emit_inbox=False)
    e = max_abs_err(ks.round_step(*args, **kw), ks.plain(*args, **kw))
    ms = time_ms(lambda: ks.round_step(*args, **kw))
    plain_ms = time_ms(lambda: ks.plain(*args, **kw))
    per_elem_ops = 2 + 3 * k + 6 * p + 1
    out["round_step"] = (e, ms, plain_ms, *bound((2 * k + 3) * plane,
                                                 per_elem_ops * n * u))
    del delta, x, buf
    pl, blocks = ks.last_launch
    log["round_step_plan"] = dict(pl._asdict(), blocks=blocks)
    print(f"plan round_step [1, {n}, {u}] int32 K={k}: tile {pl.tile} "
          f"columns, {pl.stages} stages, {blocks} blocks, {pl.threads} "
          f"threads, {pl.smem} B shared, "
          f"{'bulk copies' if pl.bulk else 'synchronous loads'} of "
          f"{pl.vec_bytes or 'one element'} B a lane, "
          f"{'register' if pl.reg_tally else 'shared'} tallies", flush=True)
    check(pl.bulk and pl.vec_bytes == 16,
          f"round_step at the scale shapes took {pl}, not 16-byte bulk copies")

    # round_recv, bprr's fused receive: P gathered groups, the extractions out
    d = rand_state(g, torch.int32, (p, n, u), dev)
    x = rand_state(g, torch.int32, (n, u), dev)
    act2 = act[0]
    kw = dict(kind="max", active=act2, emit_stored=True, emit_cov=False)
    e = max_abs_err(kr.round_recv(d, x, **kw),
                    kr.plain(d, x, act2, "max", True, False))
    ms = time_ms(lambda: kr.round_recv(d, x, **kw))
    plain_ms = time_ms(lambda: kr.plain(d, x, act2, "max", True, False))
    out["round_recv"] = (e, ms, plain_ms, *bound((2 * p + 2) * plane,
                                                 5 * p * n * u))
    del d, x

    # buffer_fold, bprr's sends: the [K, N, U] buffer folded over its slots
    buf = rand_state(g, torch.int32, (k, n, u), dev)
    e = max_abs_err(kf.buffer_fold(buf, kind="max"), kf.plain(buf, "max"))
    ms = time_ms(lambda: kf.buffer_fold(buf, kind="max"))
    plain_ms = time_ms(lambda: kf.plain(buf, "max"))
    out["buffer_fold"] = (e, ms, plain_ms, *bound((2 * k - 1) * plane,
                                                  2 * k * n * u))
    del buf

    # the digest_driven round of the scale join (a): GMap int32 states, the
    # 64-wide blocks, the mesh's P = 4 slot masks
    be = DIGEST_BLOCK
    nb = u // be
    x = rand_state(g, torch.int32, (n, u), dev)
    e = max_abs_err(kd.digest_blocks(x, block_elems=be, kind="max"),
                    kd.plain(x, be, "max"))
    ms = time_ms(lambda: kd.digest_blocks(x, block_elems=be, kind="max"))
    plain_ms = time_ms(lambda: kd.plain(x, be, "max"))
    out["digest_blocks"] = (e, ms, plain_ms, *bound(plane + 12 * n * nb,
                                                    14 * n * u))
    dp = kd.last_launch
    log["digest_blocks_plan"] = dp._asdict()
    print(f"plan digest_blocks [{n}, {u}] int32 be={be}: "
          f"{'16-byte' if dp.vector else 'synchronous one-element'} loads "
          f"({dp.vec} elements a lane), {dp.lanes_per_block} lanes a block, "
          f"{dp.task_blocks} blocks a warp task, grid {dp.grid_x} x "
          f"{dp.grid_y} blocks", flush=True)
    check(dp.vector, f"digest_blocks at the scale shapes took {dp}, not "
                     f"16-byte loads")
    masks = torch.randint(0, 2, (p, n, nb), generator=g, device=dev,
                          dtype=torch.int32).bool()
    mk = masks.to(torch.int32)
    e = max_abs_err(ke.masked_extract(x, masks, block_elems=be),
                    ke.plain(x, mk, be))
    ms = time_ms(lambda: ke.masked_extract(x, masks, block_elems=be))
    plain_ms = time_ms(lambda: ke.plain(x, mk, be))
    out["masked_extract"] = (e, ms, plain_ms, *bound(
        (1 + p) * plane + 4 * p * n * nb, p * n * u))
    # the resync receive: round_recv without the stored extractions
    d = rand_state(g, torch.int32, (p, n, u), dev)
    e = max_abs_err(kr.round_recv(d, x, kind="max", emit_stored=False),
                    kr.plain(d, x, torch.ones((n, p), dtype=torch.int32,
                                              device=dev), "max", False))
    ms = time_ms(lambda: kr.round_recv(d, x, kind="max", emit_stored=False))
    recv_join = (e, ms, *bound((p + 2) * plane, 4 * p * n * u))
    check(e == 0, f"round_recv join at scale shapes: err {e}")
    print(f"kernel round_recv (resync join, no stored): {ms:.4f} ms (bound "
          f"{recv_join[2]:.4f} ms by {recv_join[3]})", flush=True)
    del x, masks, mk, d
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    for name, (e, ms, plain_ms, b_ms, b_by) in out.items():
        check(e == 0, f"{name} at scale shapes: err {e}")
        print(f"kernel {name}: {ms:.4f} ms (plain {plain_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms by {b_by}), max_abs_err {e}", flush=True)
    log["kernel_timings"] = {n_: dict(zip(
        ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by"), v))
        for n_, v in out.items()}
    log["kernel_timings"]["round_recv_join"] = dict(zip(
        ("max_abs_err", "ms", "bound_ms", "bound_by"), recv_join))
    return out


def batch_kernel_grid(check, dev, log):
    """The store's and the sweep's shapes against the plain versions on the
    card: ``round_recv`` over more than 65,535 rows (short rows of 32 / 64
    int32, 32 bools, 3 words; a long row of 200 int32), ``round_step`` over
    more than 65,535 configs (mesh16, U = 32: short rows, one launch; U =
    160: long rows, chunks) and at U = 64 (mesh16; mesh50), short rows
    about the 32-vector threshold and a warp (every flavour, bool rows,
    words, a base off 16 bytes) at B = g + 1, both kernels' grids capped
    at 3 blocks (every walk loops), and the five path kernels on a batch's
    [B, N, U] operands as rows; each ``round_step`` call's launches by the
    wrapper's rule. Returns the largest error per kernel."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import round_recv as kr
    from repro_torch.kernels import round_step as ks
    from repro_torch.sync import topology

    g = torch.Generator(device=dev).manual_seed(7)
    errs = {k: 0.0 for k in SYNC_KERNELS}
    t0 = time.perf_counter()
    for dtype, u in ((torch.int32, 32), (torch.int32, 64), (torch.bool, 32),
                     ("words", 3), (torch.int32, 200)):
        kind = "bitor" if dtype == "words" else "max"
        p, m = 4, 70_001
        d = rand_state(g, dtype, (p, m, u), dev)
        x = rand_state(g, dtype, (m, u), dev)
        act = torch.randint(0, 2, (m, p), generator=g, device=dev,
                            dtype=torch.int32)
        got = ops.round_recv(d, x, kind=kind, active=act, emit_stored=True,
                             emit_cov=True)
        want = ops.round_recv(d.cpu(), x.cpu(), kind=kind, active=act.cpu(),
                              emit_stored=True, emit_cov=True)
        e = max_abs_err(tuple(t.cpu() for t in got), want)
        errs["round_recv"] = max(errs["round_recv"], e)
        check(e == 0, f"round_recv [{p}, {m}, {u}] {dtype}: err {e}")
    cap = kr.MAX_BLOCKS
    try:
        kr.MAX_BLOCKS = 3
        for u in (32, 200):                    # a short row, a long row
            p, m = 4, 1_001
            d = rand_state(g, torch.int32, (p, m, u), dev)
            x = rand_state(g, torch.int32, (m, u), dev)
            act = torch.randint(0, 2, (m, p), generator=g, device=dev,
                                dtype=torch.int32)
            got = ops.round_recv(d, x, active=act, emit_stored=True,
                                 emit_cov=True)
            want = ops.round_recv(d.cpu(), x.cpu(), active=act.cpu(),
                                  emit_stored=True, emit_cov=True)
            e = max_abs_err(tuple(t.cpu() for t in got), want)
            errs["round_recv"] = max(errs["round_recv"], e)
            check(e == 0, f"round_recv [{p}, {m}, {u}] over 3 blocks: "
                          f"err {e}")
    finally:
        kr.MAX_BLOCKS = cap
    del d, x, act, got, want

    def step_case(n, u, nb, algo, dtype=torch.int32, off=0):
        """One ``round_step`` call on random operands against the plain
        version; its launches against the wrapper's rule."""
        topo = topology.partial_mesh(n, 4 if n > 4 else 2).on(dev)
        p = topo.max_degree
        k = {"state": 0, "classic": 1, "rr": 1}.get(algo, p + 1)
        kind = "bitor" if dtype == "words" else "max"
        args = (offset_view(rand_state(g, dtype, (nb, n, u), dev), off),
                rand_state(g, dtype, (nb, n, u), dev),
                rand_state(g, dtype, (k, nb, n, u), dev) if k else None,
                (torch.randint(0, 2, (nb, n, p), generator=g, device=dev,
                               dtype=torch.int32) * topo.mask).to(torch.int32),
                torch.randint(0, 2, (nb, n), generator=g, device=dev,
                              dtype=torch.int32) if k else None,
                topo.nbrs, topo.rev)
        kw = dict(kind=kind, per_origin=algo in ("bp", "bprr"),
                  extracts=algo in ("rr", "bprr"),
                  emit_inbox=algo not in ("rr", "bprr"))
        before = ks.launches
        got = ops.round_step(*args, **kw)
        launched = ks.launches - before
        views = [a.view(torch.uint8) if a is not None and a.dtype ==
                 torch.bool else a for a in args]
        want = ks.plain(*views, **kw)
        want = tuple(w.view(torch.bool) if w is not None and w.dtype ==
                     torch.uint8 else w for w in want)
        e = max_abs_err(got, want)
        errs["round_step"] = max(errs["round_step"], e)
        pl, blocks = ks.last_launch
        check(e == 0 and launched == ks.launches_for(nb, pl),
              f"round_step [{nb}, {n}, {u}] {dtype} {algo} offset {off}: "
              f"err {e}, {launched} launches under {pl}")
        return pl, blocks, launched

    for n, u, nb, algo in ((16, 32, 65_537, "bprr"), (16, 32, 65_537,
                                                      "classic"),
                           (16, 160, 65_537, "bprr"),
                           (16, 64, 3_001, "bprr"), (50, 64, 1_000, "bprr")):
        pl, blocks, launched = step_case(n, u, nb, algo)
        check(pl.short == (u != 160), f"round_step [{nb}, {n}, {u}]: took "
                                      f"{pl}")
        print(f"round_step [{nb}, {n}, {u}] {algo}: {launched} launch(es), "
              + (f"short rows: {pl.lanes} lanes a row, {pl.configs} "
                 f"configs a block, {blocks} blocks" if pl.short else
                 f"{'bulk copies' if pl.bulk else 'direct loads'} of "
                 f"{pl.vec_bytes or 'one element'} B a lane, {blocks} "
                 f"block(s) a config"), flush=True)
    # short rows about the 32-vector threshold and a warp, every flavour,
    # bool rows, words, a base off 16 bytes; B = g + 1 (a partial group)
    for n, u, dtype, algo, off in (
            (3, 1, torch.int32, "bprr", 0), (15, 7, torch.int32, "rr", 0),
            (17, 31, torch.int32, "bp", 1), (16, 33, torch.int32, "bprr", 0),
            (50, 100, torch.int32, "classic", 0),
            (64, 32, torch.int32, "state", 0), (17, 128, torch.bool, "bprr", 0),
            (15, 33, torch.bool, "classic", 1), (16, 64, "words", "rr", 0),
            (50, 7, "words", "bp", 0)):
        elem = 1 if dtype == torch.bool else 4
        topo_p = 4 if n > 4 else 2
        k = {"state": 0, "classic": 1, "rr": 1}.get(algo, topo_p + 1)
        pl = ks.plan(n, topo_p, k, algo in ("bp", "bprr"), elem, u, not off)
        step_case(n, u, pl.configs + 1, algo, dtype, off)
        check(ks.last_launch[0] == pl, f"round_step [{pl.configs + 1}, {n}, "
                                       f"{u}] launched {ks.last_launch[0]}, "
                                       f"not {pl}")
    cap = ks.MAX_BLOCKS
    try:
        ks.MAX_BLOCKS = 3                   # every block walks many groups
        for n, u in ((16, 32), (50, 64)):
            pl, blocks, _ = step_case(n, u, 301, "bprr")
            check(pl.short and blocks == 3, f"round_step [301, {n}, {u}] "
                                            f"over 3 blocks took {pl}, "
                                            f"{blocks} blocks")
    finally:
        ks.MAX_BLOCKS = cap
    b, n, u, p, be = 4096, 16, 64, 4, 8
    x = rand_state(g, torch.int32, (b, n, u), dev)
    buf = rand_state(g, torch.int32, (p + 1, b, n, u), dev)
    masks = torch.randint(0, 2, (p, b, n, u // be), generator=g, device=dev,
                          dtype=torch.int32).bool()
    for name, got, want in (
            ("buffer_fold", ops.buffer_fold(buf, kind="max"),
             ops.buffer_fold(buf.cpu(), kind="max")),
            ("digest_blocks", ops.digest_blocks(x, block_elems=be),
             ops.digest_blocks(x.cpu(), block_elems=be)),
            ("masked_extract", ops.masked_extract(x, masks, block_elems=be),
             ops.masked_extract(x.cpu(), masks.cpu(), block_elems=be))):
        e = max_abs_err(got.cpu(), want)
        errs[name] = max(errs[name], e)
        check(e == 0, f"{name} rows [{b}, {n}, {u}]: err {e}")
    del x, buf, masks
    torch.cuda.empty_cache()
    print(f"batch kernel grid: {errs} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    log["batch_kernel_grid"] = errs
    return errs


# the store shapes of phase 3's timings: (tag, configs, nodes, slots,
# flavours); the paper setting's store runs classic and bprr
STORE_SHAPES = (("paper 30,000 x mesh50 x 64", 30_000, 50, 64,
                 ("bprr", "classic")),
                ("1,048,576 x mesh16 x 32", 1 << 20, 16, 32, ("bprr",)))


def step_bound(b, n, u, p, k, inbox):
    """Bound of one ``round_step`` call of ``b`` configs: δ, x and the K
    slots read, x' and the K slots (and the P inbox planes) written, plus
    active, delivered and the 3P+2 counts; its integer operations."""
    rows = b * n
    nbytes = (2 * k + 3 + (p if inbox else 0)) * rows * u * 4 \
        + rows * 4 * (4 * p + 3)
    return bound(nbytes, (2 + 3 * k + 6 * p + 1) * rows * u)


def store_kernel_timings(check, dev, log):
    """``round_step``, ``round_recv`` and ``buffer_fold`` at the store's
    shapes, beside their byte bounds: the paper setting (30,000 objects of
    mesh50 d4, 64 int32 slots, bprr and classic) and a million objects
    (mesh16 d4, 32 slots, bprr). ``round_step`` as the ``mega`` round's
    launch under the default plan, which must be the short-row kernel,
    launched once; beside it the long-row kernel under its own default
    plan (the one-config-a-block design every shape took before the
    short-row kernel), equal bit for bit; ``round_recv`` as the ``fused``
    round's receive (P = 4 extractions out) and ``buffer_fold`` as its
    bprr fold of the [K, B·N, U] buffer. Returns ``{kernel: [row, ...]}``."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import round_recv as kr
    from repro_torch.kernels import round_step as ks
    from repro_torch.sync import topology

    g = torch.Generator(device=dev).manual_seed(9)
    out = {"round_step": [], "round_recv": [], "buffer_fold": []}
    for tag, b, n, u, flavours in STORE_SHAPES:
        topo = topology.partial_mesh(n, 4).on(dev)
        p = topo.max_degree
        plane = b * n * u * 4
        for flavour in flavours:
            k = p + 1 if flavour == "bprr" else 1
            bprr = flavour == "bprr"
            args = (rand_state(g, torch.int32, (b, n, u), dev),
                    rand_state(g, torch.int32, (b, n, u), dev),
                    rand_state(g, torch.int32, (k, b, n, u), dev),
                    topo.mask.to(torch.int32).expand(b, n, p).contiguous(),
                    torch.ones((b, n), dtype=torch.int32, device=dev),
                    topo.nbrs, topo.rev)
            kw = dict(kind="max", per_origin=bprr, extracts=bprr,
                      emit_inbox=not bprr)
            before = ks.launches
            got = ops.round_step(*args, **kw)
            launched = ks.launches - before
            pl, blocks = ks.last_launch
            old = ks.long_plans(n, p, k, bprr, 4, u, True)[0]
            same = same_outputs(got, ks._launch(*args, "max", bprr, bprr,
                                                not bprr, pl=old))
            del got
            check(pl.short and launched == 1 and same,
                  f"store shapes {tag} {flavour}: plan {pl}, {launched} "
                  f"launches, equal to the long-row kernel: {same}")
            ms = time_ms(lambda: ops.round_step(*args, **kw), reps=5)
            old_ms = time_ms(lambda: ks._launch(
                *args, "max", bprr, bprr, not bprr, pl=old), reps=5)
            b_ms, b_by = step_bound(b, n, u, p, k, not bprr)
            out["round_step"].append({
                "shape": f"[{b}, {n}, {u}] int32 {flavour} K={k}", "ms": ms,
                "bound_ms": b_ms, "bound_by": b_by, "launches_per_call":
                launched, "plan": dict(pl._asdict(), blocks=blocks),
                "long_row_kernel_ms": old_ms,
                "long_row_plan": old._asdict()})
            print(f"store shapes {tag} {flavour}: round_step {ms:.3f} ms "
                  f"(bound {b_ms:.3f} by {b_by}, {ms and b_ms / ms:.1%}), "
                  f"{launched} launch, short rows: {pl.lanes} lanes a row, "
                  f"g = {pl.configs} configs a block, {pl.threads} threads, "
                  f"{'a bulk-copied stage' if pl.bulk else 'direct loads'}, "
                  f"{pl.smem} B shared, {blocks} blocks; the long-row "
                  f"kernel {old_ms:.3f} ms (tile {old.tile}, vec "
                  f"{old.vec_bytes}, stages {old.stages})", flush=True)
            if bprr:
                buf = args[2].view(k, b * n, u)
                fb_ms = time_ms(lambda: ops.buffer_fold(buf, kind="max"),
                                reps=5)
                f_ms, f_by = bound((2 * k - 1) * plane, 2 * k * b * n * u)
                out["buffer_fold"].append({
                    "shape": f"[{k}, {b * n}, {u}] int32", "ms": fb_ms,
                    "bound_ms": f_ms, "bound_by": f_by})
                print(f"store shapes {tag}: buffer_fold {fb_ms:.3f} ms "
                      f"(bound {f_ms:.3f} by {f_by})", flush=True)
                del buf
            del args
            torch.cuda.empty_cache()
        d = rand_state(g, torch.int32, (p, b * n, u), dev)
        x = rand_state(g, torch.int32, (b * n, u), dev)
        act = topo.mask.to(torch.int32).repeat(b, 1)
        rkw = dict(kind="max", active=act, emit_stored=True)
        ms_r = time_ms(lambda: ops.round_recv(d, x, **rkw), reps=5)
        rb_ms, rb_by = bound((2 * p + 2) * plane, 5 * p * b * n * u)
        out["round_recv"].append({"shape": f"[{p}, {b * n}, {u}] int32",
                                  "ms": ms_r, "bound_ms": rb_ms,
                                  "bound_by": rb_by, "launches_per_call": 1,
                                  "short_rows": kr.short_rows(u, 4, True)})
        del d, x, act
        torch.cuda.empty_cache()
        print(f"store shapes {tag}: round_recv {ms_r:.3f} ms (bound "
              f"{rb_ms:.3f})", flush=True)
    log["store_kernel_timings"] = out
    return out


def elementwise_state(g, tname, shape, dev):
    """States of the elementwise kernels: 0/1 flags, small uint8 / int32,
    signed int8 over its whole range, full 32-bit words."""
    import torch

    if tname == "bool":
        return torch.randint(0, 2, shape, generator=g, device=dev).bool()
    if tname == "int8":
        return torch.randint(-128, 128, shape, generator=g, device=dev,
                             dtype=torch.int8)
    if tname == "uint8":
        return torch.randint(0, 9, shape, generator=g, device=dev,
                             dtype=torch.uint8)
    return rand_state(g, "words" if tname == "words" else torch.int32,
                      shape, dev)


def offset_view(t, offset):
    """``t`` as a view starting ``offset`` elements into a larger buffer
    (offset 1: not 16-byte aligned, the kernels' scalar path)."""
    import torch

    if not offset:
        return t
    flat = torch.zeros(t.numel() + offset, dtype=t.dtype, device=t.device)
    flat[offset:] = t.reshape(-1)
    return flat[offset:].view(t.shape)


def kview(t):
    import torch

    return t.view(torch.uint8) if t.dtype == torch.bool else t


def elementwise_grid(check, dev, log):
    """join, delta_extract and lex_join_delta against their plain versions
    at small shapes (sizes off multiples of 4 and 16) and at a view that is
    not 16-byte aligned."""
    import torch

    from repro_torch.kernels import delta_extract as kd
    from repro_torch.kernels import join as kj
    from repro_torch.kernels import lex_join as kl

    g = torch.Generator(device=dev).manual_seed(3)
    errs = {name: 0.0 for name in ELEMENTWISE}
    cases = {name: 0 for name in ELEMENTWISE}

    def record(name, e, what):
        errs[name] = max(errs[name], e)
        cases[name] += 1
        check(e == 0, f"{name} {what}: err {e}")

    for shape in ((64,), (1000,), (1001,), (7, 333), (3, 5, 129), (4099,)):
        for offset in (0, 1):
            for kind, tname in (("max", "uint8"), ("max", "int8"),
                                ("max", "int32"), ("max", "bool"),
                                ("bitor", "words")):
                a, b = (offset_view(elementwise_state(g, tname, shape, dev),
                                    offset) for _ in "ab")
                what = f"{kind}/{tname} {shape} offset {offset}"
                got = kj.join(a, b, kind=kind)
                want = kj.plain(kview(a), kview(b), kind)
                record("join", max_abs_err(kview(got), want), what)
                got = kd.delta_extract(a, b, kind=kind)
                want = kd.plain(kview(a), kview(b), kind)
                record("delta_extract", max_abs_err(
                    tuple(kview(t) for t in got), want), what)
            ta, va, tb, vb = (offset_view(torch.randint(
                -2, 4, shape, generator=g, device=dev, dtype=torch.int32),
                offset) for _ in range(4))
            (t, v), (dt, dv), cnt = kl.lex_join_delta((ta, va), (tb, vb))
            record("lex_join_delta", max_abs_err(
                (t, v, dt, dv, cnt), kl.plain(ta, va, tb, vb)),
                f"{shape} offset {offset}")
    torch.cuda.synchronize()
    log["elementwise_grid"] = {"cases": cases, "max_abs_err": errs}
    print(f"elementwise grid: {cases} cases, max_abs_err {errs}", flush=True)
    return errs


def elementwise_timings(check, dev, log):
    """join, delta_extract and lex_join_delta at [15, 4,194,304] int32:
    exact against the plain version, then kernel / plain / library time
    and the byte bound. Returns ``{name: (err, ms, plain_ms, bound_ms,
    bound_by, library_ms)}``."""
    import torch

    from repro_torch.kernels import delta_extract as kd
    from repro_torch.kernels import join as kj
    from repro_torch.kernels import lex_join as kl

    g = torch.Generator(device=dev).manual_seed(4)
    shape = (15, SCALE_KEYS)
    n = 15 * SCALE_KEYS
    plane = n * 4
    out, extra = {}, {}

    a, b = (rand_state(g, torch.int32, shape, dev) for _ in "ab")
    wa, wb = (rand_state(g, "words", shape, dev) for _ in "ab")
    e = max(max_abs_err(kj.join(a, b), kj.plain(a, b)),
            max_abs_err(kj.join(wa, wb, kind="bitor"),
                        kj.plain(wa, wb, "bitor")))
    ms = time_ms(lambda: kj.join(a, b))
    extra["join_bitor_ms"] = time_ms(lambda: kj.join(wa, wb, kind="bitor"))
    plain_ms = time_ms(lambda: kj.plain(a, b))
    lib_ms = time_ms(lambda: torch.maximum(a, b))
    extra["join_bitor_library_ms"] = time_ms(lambda: torch.bitwise_or(wa, wb))
    out["join"] = (e, ms, plain_ms, *bound(3 * plane, n), lib_ms)
    extra["join_over_torch_maximum"] = ms / lib_ms
    print(f"join {ms:.4f} ms beside torch.maximum {lib_ms:.4f} ms: ratio "
          f"{ms / lib_ms:.4f}", flush=True)

    e = max(max_abs_err(kd.delta_extract(a, b), kd.plain(a, b)),
            max_abs_err(kd.delta_extract(wa, wb, kind="bitor"),
                        kd.plain(wa, wb, "bitor")))
    ms = time_ms(lambda: kd.delta_extract(a, b))
    extra["delta_extract_bitor_ms"] = time_ms(
        lambda: kd.delta_extract(wa, wb, kind="bitor"))
    plain_ms = time_ms(lambda: kd.plain(a, b))
    out["delta_extract"] = (e, ms, plain_ms, *bound(4 * plane + 4, 4 * n),
                            None)
    del wa, wb

    # timestamps and values from a small range: ties are frequent
    ta, va, tb, vb = (torch.randint(0, 4, shape, generator=g, device=dev,
                                    dtype=torch.int32) for _ in range(4))
    (t, v), (dt, dv), cnt = kl.lex_join_delta((ta, va), (tb, vb))
    e = max_abs_err((t, v, dt, dv, cnt), kl.plain(ta, va, tb, vb))
    del t, v, dt, dv
    ms = time_ms(lambda: kl.lex_join_delta((ta, va), (tb, vb)))
    plain_ms = time_ms(lambda: kl.plain(ta, va, tb, vb))
    out["lex_join_delta"] = (e, ms, plain_ms, *bound(8 * plane + 4, 12 * n),
                             None)
    del a, b, ta, va, tb, vb
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    for name, (e, ms, plain_ms, b_ms, b_by, lib) in out.items():
        check(e == 0, f"{name} at scale shapes: err {e}")
        print(f"kernel {name}: {ms:.4f} ms (plain {plain_ms:.4f} ms, "
              f"library {lib if lib is None else round(lib, 4)} ms, bound "
              f"{b_ms:.4f} ms by {b_by}), max_abs_err {e}", flush=True)
    print(f"kernel join bitor {extra['join_bitor_ms']:.4f} ms (library "
          f"torch.bitwise_or {extra['join_bitor_library_ms']:.4f} ms); "
          f"delta_extract bitor {extra['delta_extract_bitor_ms']:.4f} ms",
          flush=True)
    log["elementwise_timings"] = {n_: dict(zip(
        ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
         "library_ms"), v)) for n_, v in out.items()}
    log["elementwise_timings"]["bitor"] = extra
    return out


# -- phases 4 and 5: the main path ---------------------------------------------

def same_run(a, b) -> bool:
    """Equal metrics, convergence flags and final states (a tensor or a
    tuple of them, on any device)."""
    import numpy as np
    import torch

    from repro_torch.core import tree_leaves

    return all(np.array_equal(x, y) for x, y in zip(
        (a.tx, a.mem, a.cpu, a.max_mem_node),
        (b.tx, b.mem, b.cpu, b.max_mem_node))) and all(
        torch.equal(x.cpu(), y.cpu()) for x, y in zip(
            tree_leaves(a.final_x), tree_leaves(b.final_x))) and (
        (a.uniform is None and b.uniform is None)
        or np.array_equal(a.uniform, b.uniform))


def expected_launches(engine, algo, rounds, configs=1, row=None):
    """Launches of one run: ``mega`` one ``round_step`` call per δ-family
    round, launching as often as the wrapper's own rule gives for its
    default plan (``round_step.launches_for``: once on the short-row
    kernel, once per 65,535 configs on the long-row one) at ``configs``
    configs of ``row`` = (nodes, degree, columns) int32 rows (None: at
    most 65,535 configs, one launch either way);
    ``fused`` one ``round_recv`` (+ ``buffer_fold`` for bp/bprr); the resync
    modes one ``round_recv`` per round on either kernel engine, and
    ``digest_driven`` one ``digest_blocks`` + one ``masked_extract``;
    ``reference`` none."""
    from repro_torch.kernels import round_step as ks

    kern = engine in ("fused", "mega")
    resync = algo in ("state_driven", "digest_driven")
    digest = kern and algo == "digest_driven"
    if row is None:
        if configs > ks.MAX_CONFIGS:
            raise ValueError(f"{configs} configs: name their row")
        per_round = 1
    else:
        n, p, u = row
        k = {"state": 0, "classic": 1, "rr": 1}.get(algo, p + 1)
        per_round = ks.launches_for(configs, ks.plan(
            n, p, k, algo in ("bp", "bprr"), 4, u, True))
    return {"round_step": rounds * per_round
            if engine == "mega" and not resync else 0,
            "round_recv": rounds if kern and (resync or engine == "fused")
            else 0,
            "buffer_fold": rounds if engine == "fused"
            and algo in ("bp", "bprr") else 0,
            "digest_blocks": rounds if digest else 0,
            "masked_extract": rounds if digest else 0,
            # no engine launches the elementwise kernels
            **{name: 0 for name in ELEMENTWISE}}


class Launches:
    """Each run's launches against :func:`expected_launches`, and their sum
    over the main path."""

    def __init__(self, check):
        self.check = check
        self.total = {name: 0 for name in SOURCES}

    def run(self, tag, engine, algo, rounds, fn, configs=1, blocks=1,
            row=None):
        """``fn()``, whose run has ``blocks`` device blocks of ``configs``
        configs each (a sharded store: each block's rounds launch on
        their own) of ``row`` rows (:func:`expected_launches`)."""
        from repro_torch import kernels

        before = kernels.launch_counts()
        r = fn()
        after = kernels.launch_counts()
        used = {k: after[k] - before[k] for k in after}
        want = expected_launches(engine, algo, rounds * blocks, configs, row)
        self.check(used == want, f"{tag}: launches {used}, expected {want}")
        for k, v in want.items():
            self.total[k] += v
        return r


def all_engines(check, launches, tag, algo, rounds, fn, times=None):
    """``fn(engine)`` on the three engines; launch-checked, and the kernel
    engines bit-identical to the reference. Returns the reference run.
    ``times``, a dict, receives each engine's ``(ms per round, peak
    bytes)`` of its one run (host clock around a synchronised device)."""
    import torch

    from repro_torch.sync import ENGINES

    runs = {}
    for e in ENGINES:
        if times is not None:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        runs[e] = launches.run(f"{tag} {e}", e, algo, rounds,
                               lambda e=e: fn(e))
        if times is not None:
            torch.cuda.synchronize()
            times[e] = ((time.perf_counter() - t0) * 1e3 / rounds,
                        torch.cuda.max_memory_allocated())
    for e in ("fused", "mega"):
        check(same_run(runs["reference"], runs[e]),
              f"{tag}: {e} differs from reference")
    return runs["reference"]


def paper_phase(check, launches, log):
    from repro_torch.core import GCounter, GMap, GSet
    from repro_torch.sync import (ALGORITHMS, RESYNC_ALGORITHMS, simulate,
                                  topology)
    from repro_torch.sync import workloads as W

    results = REPO / "benchmarks" / "results"
    fig7 = json.loads((results / "fig7_transmission.json").read_text())
    fig8 = json.loads((results / "fig8_gmap.json").read_text())
    benches = {
        "gset": (fig7, lambda: (GSet(1500).lattice, W.gset_unique_op(15, 100))),
        "gcounter": (fig7, lambda: (GCounter(15).lattice, W.gcounter_op(15))),
        "gmap10": (fig8, lambda: (GMap(1000).lattice,
                                  W.gmap_block_op(15, 1000, 10))),
        "gmap100": (fig8, lambda: (GMap(1000).lattice,
                                   W.gmap_block_op(15, 1000, 100))),
    }
    t0 = time.perf_counter()
    cells = peak_checked = peak_lacking = 0
    for topo_name in ("tree", "mesh"):
        topo = topology.by_name(topo_name, 15, 4)
        for bench, (fig, make) in benches.items():
            lat, op = make()
            for algo in ALGORITHMS:
                if algo in RESYNC_ALGORITHMS:
                    continue
                row = fig[f"{bench}_{topo_name}"]["raw"][algo]
                tag = f"paper {bench}_{topo_name} {algo}"
                r = all_engines(check, launches, tag, algo, 120,
                                lambda e: simulate(algo, lat, topo, op, 100,
                                                   20, engine=e))
                peak_ok = True
                if "mem_max_node" in row:
                    peak_ok = int(r.max_mem_node.max()) == row["mem_max_node"]
                    peak_checked += 1
                else:
                    peak_lacking += 1
                check(r.total_tx == row["tx"] and r.total_cpu == row["cpu"]
                      and r.avg_mem == row["mem_avg"] and peak_ok,
                      f"{tag}: tx {r.total_tx} vs {row['tx']}, cpu "
                      f"{r.total_cpu} vs {row['cpu']}, peak node "
                      f"{int(r.max_mem_node.max())} vs "
                      f"{row.get('mem_max_node')}")
                cells += 3
    wall = time.perf_counter() - t0
    print(f"paper size: {cells} runs against fig7/fig8, engines bit-identical "
          f"({wall:.1f} s); mem_max_node checked in {peak_checked} cells, "
          f"{peak_lacking} cells' rows lack it", flush=True)
    log["paper"] = {"runs": cells, "wall_s": wall,
                    "mem_max_node_checked": peak_checked,
                    "mem_max_node_lacking": peak_lacking}


def no_op(x, t):
    """The join scenarios' op stream: sync only (any state)."""
    import torch

    from repro_torch.core import tree_map

    return tree_map(torch.zeros_like, x)


def join_x0(nodes, universe, ratio, tile=None, value=1, dtype=None):
    """The fig_digest join start: every node but the joiner (node 0) holds
    the first ``ratio`` of the universe — or of every ``tile``-wide tile —
    at ``value`` (bool states by default)."""
    import torch

    dtype = dtype or torch.bool
    tile = tile or universe
    held = (torch.arange(universe) % tile) < int(round(ratio * tile))
    x0 = torch.zeros((nodes, universe), dtype=dtype)
    x0[1:] = held if dtype == torch.bool else held.to(dtype) * value
    return x0


def digest_phase(check, launches, log, singles):
    """fig_digest.json's join and heal tables on all three engines; the
    reference runs go into ``singles`` for the sweep phase."""
    import numpy as np

    from repro_torch.core import GSet
    from repro_torch.sync import DigestSpec, FaultSchedule, simulate, topology
    from repro_torch.sync import workloads as W

    fig = json.loads((REPO / "benchmarks" / "results" /
                      "fig_digest.json").read_text())
    topo = topology.partial_mesh(fig["nodes"], 4)
    n, u, spec = topo.num_nodes, fig["universe"], DigestSpec(fig["block_elems"])
    t0 = time.perf_counter()
    runs, join_r25 = 0, {}
    for algo, rows in fig["join"].items():
        for key, row in rows.items():
            x0 = join_x0(n, u, row["divergence"])
            r = all_engines(
                check, launches, f"join {algo} {key}", algo, fig["rounds"],
                lambda e: simulate(algo, GSet(u).lattice, topo, no_op, 0,
                                   fig["rounds"], x0=x0, engine=e,
                                   track_convergence=True, digest=spec))
            conv = r.convergence_round()
            tx_conv = int(r.tx[: conv + 1].sum()) if conv >= 0 else None
            got = (r.total_tx, conv >= 0, conv, tx_conv)
            want = (row["tx_window"], row["converged"], row["conv_round"],
                    row["tx_to_conv"])
            check(got == want, f"join {algo} {key}: (tx_window, converged, "
                               f"conv_round, tx_to_conv) {got} vs {want}")
            if key == "r25":
                join_r25[algo] = r
            singles["join", algo, key] = r
            runs += 3
    events = fig["events"]
    groups = (np.arange(n) >= n // 2).astype(np.int32)
    for algo, rows in fig["heal"].items():
        for key, row in rows.items():
            w = row["partition_rounds"]
            sched = FaultSchedule.partition(topo, events, 0, w, groups) \
                .compose(FaultSchedule.bernoulli(topo, events, 0.02, seed=11))
            r = all_engines(
                check, launches, f"heal {algo} {key}", algo, 3 * events,
                lambda e: simulate(algo, GSet(n * events).lattice, topo,
                                   W.gset_unique_op(n, events), events,
                                   2 * events, faults=sched, engine=e,
                                   digest=spec))
            conv = r.convergence_round()
            got = (r.total_tx, int(r.tx[w:].sum()), conv - events + 1,
                   conv >= 0)
            want = (row["tx_total"], row["tx_post_heal"], row["ttc_rounds"],
                    row["converged"])
            check(got == want, f"heal {algo} {key}: (tx_total, tx_post_heal, "
                               f"ttc_rounds, converged) {got} vs {want}")
            singles["heal", algo, key] = r
            runs += 3
    wall = time.perf_counter() - t0
    print(f"fig_digest: {runs} runs (join + heal) reproduced, engines "
          f"bit-identical ({wall:.1f} s)", flush=True)
    log["fig_digest"] = {"runs": runs, "wall_s": wall}
    return join_r25


def fault_scenarios(topo, events, quiet):
    """BENCH_fault.json's schedules, as ``benchmarks/fig_fault.py`` builds
    them."""
    import numpy as np

    from repro_torch.sync import FaultSchedule

    n = topo.num_nodes
    lossy = events + quiet // 4
    groups = (np.arange(n) >= n // 2).astype(np.int32)
    return {
        "loss0": FaultSchedule.none(topo, events),
        "loss1": FaultSchedule.bernoulli(topo, lossy, 0.01, seed=7),
        "loss10": FaultSchedule.bernoulli(topo, lossy, 0.10, seed=7),
        "partition": FaultSchedule.partition(
            topo, events, events // 4, (3 * events) // 4, groups),
        "churn": FaultSchedule.churn(
            topo, events, [(1, events // 4, (3 * events) // 4),
                           (n - 2, events // 2, events - 1)]),
    }


def fault_phase(check, launches, log, singles):
    """BENCH_fault.json: the δ-family under loss, a partition and churn;
    the reference runs go into ``singles`` for the sweep phase."""
    from repro_torch.core import GSet
    from repro_torch.sync import simulate, topology
    from repro_torch.sync import workloads as W

    bench = json.loads((REPO / "benchmarks" / "results" /
                        "BENCH_fault.json").read_text())
    events, quiet = bench["events"], bench["quiet"]
    topo = topology.partial_mesh(bench["nodes"], 4)
    n = topo.num_nodes
    scheds = fault_scenarios(topo, events, quiet)
    lat, op = GSet(n * events).lattice, W.gset_unique_op(n, events)
    t0 = time.perf_counter()
    runs = 0
    for scenario, cell in bench["cells"].items():
        for algo, row in cell["raw"].items():
            r = all_engines(
                check, launches, f"fault {scenario} {algo}", algo,
                events + quiet,
                lambda e: simulate(algo, lat, topo, op, events, quiet,
                                   faults=scheds[scenario], engine=e))
            conv = r.convergence_round()
            got = (r.total_tx, r.avg_mem, conv, conv - events + 1, conv >= 0)
            want = (row["tx"], row["mem_avg"], row["conv_round"],
                    row["ttc_rounds"], row["converged"])
            check(got == want, f"fault {scenario} {algo}: (tx, mem_avg, "
                               f"conv_round, ttc_rounds, converged) {got} vs "
                               f"{want}")
            singles["fault", scenario, algo] = r
            runs += 3
    wall = time.perf_counter() - t0
    print(f"BENCH_fault: {runs} runs reproduced, engines bit-identical "
          f"({wall:.1f} s)", flush=True)
    log["bench_fault"] = {"runs": runs, "wall_s": wall}


def scale_run(launches, tag, engine, algo, rounds, simulate_fn, configs=1,
              runs=SCALE_RUNS, blocks=1, row=None):
    """``runs`` runs, each timed on the host clock around a synchronised
    device, after a one-round run of the same configuration (which builds
    the op's tables and grows the allocator's pool); every run's launches
    are checked. Returns the last result, ms per round as (median, min,
    max) over the runs and the peak device memory."""
    import torch

    launches.run(f"{tag} warm-up", engine, algo, 1, lambda: simulate_fn(1, 0),
                 configs, blocks, row)
    gc.collect()                 # what earlier phases left in cycles goes
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, r = [], None
    for _ in range(runs):
        r = None                           # one result alive at a time
        t0 = time.perf_counter()
        r = launches.run(tag, engine, algo, rounds, simulate_fn, configs,
                         blocks, row)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / rounds)
    return (r, (statistics.median(times), min(times), max(times)),
            torch.cuda.max_memory_allocated())


def scale_row(workload, topo, algo, engine, ms, b_ms, peak, r,
              runs=SCALE_RUNS):
    med, lo, hi = ms
    return {"workload": workload, "topo": topo, "algo": algo,
            "engine": engine, "ms_per_round": med, "ms_per_round_min": lo,
            "ms_per_round_max": hi, "runs": runs,
            "bound_ms_per_round": b_ms, "max_memory_allocated": peak,
            "total_tx": int(r.sim.tx.sum()) if hasattr(r, "sim")
            else r.total_tx}


def print_scale(tag, ms, b_ms, peak, r, runs=SCALE_RUNS):
    med, lo, hi = ms
    tx = int(r.sim.tx.sum()) if hasattr(r, "sim") else r.total_tx
    print(f"{tag}: {med:.3f} ms/round (median of {runs}, {lo:.3f}-"
          f"{hi:.3f}; bound {b_ms:.3f}), peak {peak / 2**30:.2f} GiB, tx "
          f"{tx}", flush=True)


def ms_bound(nbytes):
    return nbytes / HBM_BYTES_PER_S * 1e3


def scale_phase(check, launches, log, join_r25):
    import numpy as np
    import torch

    from repro_torch.core import BitGSet, GCounter, GMap, GSet
    from repro_torch.sync import DigestSpec, FaultSchedule, simulate, topology
    from repro_torch.sync import workloads as W

    active, quiet = 12, 8
    rounds = active + quiet
    rows = []
    blocks = W.gmap_key_blocks(15, SCALE_KEYS, 10)
    per_node = int(blocks.sum(1)[0])
    check(per_node == 27_962, f"GMap per_node {per_node}")
    want_x = torch.where(torch.as_tensor(blocks.any(0), device="cuda"), 12, 0) \
        .to(torch.int32).expand(15, SCALE_KEYS)
    plane = 15 * SCALE_KEYS * 4
    for topo_name in ("mesh", "tree"):
        topo = topology.by_name(topo_name, 15, 4)
        op = W.gmap_block_op(15, SCALE_KEYS, 10)
        for algo in ("bprr", "classic"):
            oracle = simulate(algo, GCounter(15).lattice, topo,
                              W.gcounter_op(15), active, quiet)
            k = topo.max_degree + 1 if algo == "bprr" else 1
            b_ms = ms_bound((2 * k + 3) * plane)
            runs = {}
            for engine in ("mega", "fused"):
                tag = f"scale gmap{SCALE_KEYS} {topo_name} {algo} {engine}"
                r, ms, peak = scale_run(
                    launches, tag, engine, algo, rounds,
                    lambda a=active, q=quiet: simulate(
                        algo, GMap(SCALE_KEYS).lattice, topo, op, a, q,
                        engine=engine))
                for nm in ("tx", "mem", "cpu", "max_mem_node"):
                    check(np.array_equal(getattr(r, nm),
                                         per_node * getattr(oracle, nm)),
                          f"{tag}: {nm} != {per_node} x GCounter(15)")
                check(torch.equal(r.final_x, want_x), f"{tag}: final state")
                rows.append(scale_row(f"gmap{SCALE_KEYS}_k10", topo.name,
                                      algo, engine, ms, b_ms, peak, r))
                runs[engine] = r
                print_scale(tag, ms, b_ms, peak, r)
            check(same_run(runs["mega"], runs["fused"]),
                  f"scale gmap {topo_name} {algo}: engines differ")
            del runs, r
            torch.cuda.empty_cache()

    stride = BIT_UNIVERSE // (15 * 12)
    topo = topology.partial_mesh(15, 4)
    oracle = simulate("bprr", GSet(180).lattice, topo,
                      W.gset_unique_op(15, 12), active, quiet)
    op = W.bitgset_unique_op(15, 12, stride)
    words = BIT_UNIVERSE // 32
    b_ms = ms_bound(13 * 15 * words * 4)
    runs = {}
    for engine in ("mega", "fused"):
        tag = f"scale bitgset2^27 mesh bprr {engine}"
        r, ms, peak = scale_run(launches, tag, engine, "bprr", rounds,
                                lambda a=active, q=quiet: simulate(
                                    "bprr", BitGSet(BIT_UNIVERSE).lattice,
                                    topo, op, a, q, engine=engine))
        for nm in ("tx", "mem", "cpu", "max_mem_node"):
            check(np.array_equal(getattr(r, nm), getattr(oracle, nm)),
                  f"{tag}: {nm} != GSet(180)")
        rows.append(scale_row("bitgset2^27", topo.name, "bprr", engine, ms,
                              b_ms, peak, r))
        runs[engine] = r
        print_scale(tag, ms, b_ms, peak, r)
    check(same_run(runs["mega"], runs["fused"]), "scale bitgset: engines differ")
    del runs, r
    torch.cuda.empty_cache()

    # (a) GMap join: in every 1,024-key tile the donors hold keys [0, 256)
    # at version 1 and the joiner (node 0) holds nothing; 12 sync rounds.
    # Per round, per kernel: digest 12 B/block + a read of x, extraction
    # (1 + P) planes + masks, the receive fold (P + 2) planes; state's
    # receive (P + 2) planes (mega: δ, x in, x' out).
    p, jr, tiles = topo.max_degree, 12, SCALE_KEYS // 1024
    spec = DigestSpec(DIGEST_BLOCK)
    nb = SCALE_KEYS // DIGEST_BLOCK
    recv_b = (p + 2) * plane
    dig_b = plane + 12 * 15 * nb + (1 + p) * plane + 4 * p * 15 * nb + recv_b
    tile_x = torch.where((torch.arange(SCALE_KEYS, device="cuda") % 1024)
                         < 256, 1, 0).to(torch.int32).expand(15, SCALE_KEYS)
    x0 = join_x0(15, SCALE_KEYS, 0.25, tile=1024, value=1, dtype=torch.int32)
    lat = GMap(SCALE_KEYS).lattice
    plan = (("state", ("mega", "fused"), {"mega": 3 * plane,
                                          "fused": recv_b}),
            ("state_driven", ("mega", "fused"), {"mega": recv_b,
                                                 "fused": recv_b}),
            ("digest_driven", ("mega", "fused", "reference"),
             {"mega": dig_b, "fused": dig_b, "reference": dig_b}))
    for algo, engines, bounds in plan:
        runs = {}
        for engine in engines:
            tag = f"scale join gmap{SCALE_KEYS} {algo} {engine}"
            r, ms, peak = scale_run(
                launches, tag, engine, algo, jr,
                lambda a=0, q=jr: simulate(algo, lat, topo, no_op, a, q,
                                           x0=x0, engine=engine,
                                           track_convergence=True,
                                           digest=spec))
            check(torch.equal(r.final_x, tile_x), f"{tag}: final state")
            if algo != "digest_driven":     # the tiles of the GSet join (a
                o = join_r25[algo]          # digest's Merkle descent is not
                for nm in ("tx", "mem", "cpu", "max_mem_node"):  # additive)
                    check(np.array_equal(getattr(r, nm),
                                         tiles * getattr(o, nm)[:jr]),
                          f"{tag}: {nm} != {tiles} x GSet(1,024) r25 join")
                check(np.array_equal(r.uniform, o.uniform[:jr]),
                      f"{tag}: convergence differs from the GSet join")
            rows.append(scale_row(f"join_gmap{SCALE_KEYS}_r25", topo.name,
                                  algo, engine, ms, ms_bound(bounds[engine]),
                                  peak, r))
            runs[engine] = r
            print_scale(tag, ms, ms_bound(bounds[engine]), peak, r)
        for engine in engines[1:]:
            check(same_run(runs[engines[0]], runs[engine]),
                  f"scale join gmap {algo}: {engine} differs from "
                  f"{engines[0]}")
        del runs, r
        torch.cuda.empty_cache()
    del x0, tile_x

    # (b) BitGSet join, 2^27 bits: the donors hold words [0, 256) of every
    # 1,024-word tile with all 32 bits set (bit 31 included)
    bit_x = torch.where((torch.arange(words, device="cuda") % 1024) < 256,
                        -1, 0).to(torch.int32).expand(15, words)
    x0 = join_x0(15, words, 0.25, tile=1024, value=-1, dtype=torch.int32)
    plane_w = 15 * words * 4
    b_ms = ms_bound(plane_w + 12 * 15 * (words // DIGEST_BLOCK)
                    + (1 + p) * plane_w + 4 * p * 15 * (words // DIGEST_BLOCK)
                    + (p + 2) * plane_w)
    runs = {}
    for engine in ("mega", "fused", "reference"):
        tag = f"scale join bitgset2^27 digest_driven {engine}"
        r, ms, peak = scale_run(
            launches, tag, engine, "digest_driven", jr,
            lambda a=0, q=jr: simulate(
                "digest_driven", BitGSet(BIT_UNIVERSE).lattice, topo,
                no_op, a, q, x0=x0, engine=engine, track_convergence=True,
                digest=spec))
        check(torch.equal(r.final_x, bit_x), f"{tag}: final state")
        check(r.convergence_round() >= 0, f"{tag}: did not converge")
        rows.append(scale_row("join_bitgset2^27_r25", topo.name,
                              "digest_driven", engine, ms, b_ms, peak, r))
        runs[engine] = r
        print_scale(tag, ms, b_ms, peak, r)
    for engine in ("fused", "reference"):
        check(same_run(runs["mega"], runs[engine]),
              f"scale join bitgset: {engine} differs from mega")
    del runs, r, x0, bit_x
    torch.cuda.empty_cache()

    # (c) GMap bprr under 10% loss in the active rounds (seed 7): the kernel
    # engines against the reference engine, and the fault-free final state
    sched = FaultSchedule.bernoulli(topo, active, 0.10, seed=7)
    op = W.gmap_block_op(15, SCALE_KEYS, 10)
    b_ms = ms_bound(13 * plane)
    runs = {}
    for engine in ("mega", "fused", "reference"):
        tag = f"scale gmap{SCALE_KEYS} mesh bprr loss10 {engine}"
        r, ms, peak = scale_run(
            launches, tag, engine, "bprr", rounds,
            lambda a=active, q=quiet: simulate(
                "bprr", GMap(SCALE_KEYS).lattice, topo, op, a, q,
                faults=sched, engine=engine))
        check(torch.equal(r.final_x, want_x), f"{tag}: final state")
        rows.append(scale_row(f"gmap{SCALE_KEYS}_k10_loss10", topo.name,
                              "bprr", engine, ms, b_ms, peak, r))
        runs[engine] = r
        print_scale(tag, ms, b_ms, peak, r)
    for engine in ("mega", "fused"):
        check(same_run(runs["reference"], runs[engine]),
              f"scale gmap bprr loss10: {engine} differs from reference")
    log["scale"] = rows


# -- phase 6: sweeps and the keyed object store (Retwis) ------------------------

def sweep_phase(check, launches, log, singles):
    """BENCH_fault.json's scenarios and fig_digest.json's join and heal
    grids as one ``simulate_sweep`` per algorithm, as
    ``benchmarks/fig_fault.py`` and ``fig_digest.py`` batch them, on all
    three engines: every cell equal to the committed value and to its
    single ``simulate`` run of phase 4."""
    import numpy as np
    import torch

    from repro_torch.core import GSet
    from repro_torch.sync import (DigestSpec, FaultSchedule, SweepSpec,
                                  simulate_sweep, topology)
    from repro_torch.sync import workloads as W

    results = REPO / "benchmarks" / "results"
    t0 = time.perf_counter()
    cells, timing = 0, {}

    def timed_sweep(tag, algo, rounds, fn):
        times = {}
        r = all_engines(check, launches, tag, algo, rounds, fn, times)
        timing[tag] = {e: {"ms_per_round": ms, "max_memory_allocated": pk}
                       for e, (ms, pk) in times.items()}
        return r

    def cell_ok(tag, r, b, single):
        c = r.cell(b)
        check(same_run(c, single), f"{tag}: cell {b} differs from its "
                                   f"single simulate run")
        return c

    bench = json.loads((results / "BENCH_fault.json").read_text())
    events, quiet = bench["events"], bench["quiet"]
    topo = topology.partial_mesh(bench["nodes"], 4)
    n = topo.num_nodes
    scheds = fault_scenarios(topo, events, quiet)
    names = list(bench["cells"])
    spec = SweepSpec(batch=len(names),
                     op_fn=W.gset_unique_sweep_op(n, events, (0,)),
                     faults=[scheds[s] for s in names])
    lat = GSet(n * events).lattice
    for algo in bench["cells"][names[0]]["raw"]:
        tag = f"sweep fault {algo}"
        r = timed_sweep(tag, algo, events + quiet,
                        lambda e: simulate_sweep(algo, lat, topo, spec,
                                                 events, quiet, engine=e))
        for b, scenario in enumerate(names):
            c = cell_ok(tag, r, b, singles["fault", scenario, algo])
            row = bench["cells"][scenario]["raw"][algo]
            conv = c.convergence_round()
            got = (c.total_tx, c.avg_mem, conv, conv - events + 1, conv >= 0)
            want = (row["tx"], row["mem_avg"], row["conv_round"],
                    row["ttc_rounds"], row["converged"])
            check(got == want, f"{tag} {scenario}: {got} vs {want}")
            cells += 1

    fig = json.loads((results / "fig_digest.json").read_text())
    topo = topology.partial_mesh(fig["nodes"], 4)
    n, u, dspec = topo.num_nodes, fig["universe"], DigestSpec(
        fig["block_elems"])
    for algo, rows in fig["join"].items():
        keys = list(rows)
        x0 = torch.stack([join_x0(n, u, rows[k]["divergence"]) for k in keys])
        spec = SweepSpec(batch=len(keys), op_fn=no_op, x0=x0)
        tag = f"sweep join {algo}"
        r = timed_sweep(tag, algo, fig["rounds"],
                        lambda e: simulate_sweep(
                            algo, GSet(u).lattice, topo, spec, 0,
                            fig["rounds"], engine=e, track_convergence=True,
                            digest=dspec))
        for b, key in enumerate(keys):
            c = cell_ok(tag, r, b, singles["join", algo, key])
            conv = c.convergence_round()
            row = rows[key]
            got = (c.total_tx, conv >= 0, conv,
                   int(c.tx[: conv + 1].sum()) if conv >= 0 else None)
            want = (row["tx_window"], row["converged"], row["conv_round"],
                    row["tx_to_conv"])
            check(got == want, f"{tag} {key}: {got} vs {want}")
            cells += 1
    events = fig["events"]
    groups = (np.arange(n) >= n // 2).astype(np.int32)
    for algo, rows in fig["heal"].items():
        keys = list(rows)
        widths = [rows[k]["partition_rounds"] for k in keys]
        faults = [FaultSchedule.partition(topo, events, 0, w, groups).compose(
            FaultSchedule.bernoulli(topo, events, 0.02, seed=11))
            for w in widths]
        spec = SweepSpec(batch=len(keys),
                         op_fn=W.gset_unique_sweep_op(n, events, (0,)),
                         faults=faults)
        tag = f"sweep heal {algo}"
        r = timed_sweep(tag, algo, 3 * events,
                        lambda e: simulate_sweep(
                            algo, GSet(n * events).lattice, topo, spec,
                            events, 2 * events, engine=e, digest=dspec))
        for b, key in enumerate(keys):
            c = cell_ok(tag, r, b, singles["heal", algo, key])
            conv, w, row = c.convergence_round(), widths[b], rows[key]
            got = (c.total_tx, int(c.tx[w:].sum()), conv - events + 1,
                   conv >= 0)
            want = (row["tx_total"], row["tx_post_heal"], row["ttc_rounds"],
                    row["converged"])
            check(got == want, f"{tag} {key}: {got} vs {want}")
            cells += 1
    wall = time.perf_counter() - t0
    print(f"sweeps: {cells} cells (BENCH_fault, fig_digest join + heal) on "
          f"3 engines equal to the committed values and their single runs "
          f"({wall:.1f} s)", flush=True)
    for tag, per in timing.items():
        print(f"  {tag}: " + ", ".join(
            f"{e} {v['ms_per_round']:.3f} ms/round "
            f"({v['max_memory_allocated'] / 2**20:.1f} MiB peak)"
            for e, v in per.items()), flush=True)
    log["sweeps"] = {"cells": cells, "wall_s": wall, "timing": timing}


RETWIS_ZIPFS = (0.5, 0.75, 1.0, 1.25, 1.5)
# (nodes, objects, slots, active rounds, quiet rounds, ops per node): the
# drain is mesh50 d4's diameter, 13 rounds — a δ of the last active round
# needs them all to reach every node (in 10 no object converges)
RETWIS_PAPER = (50, 30_000, 64, 100, 13, 10)
# (nodes, objects, slots, rounds, ops per node, chunk rounds)
STORE_1M = (16, 1 << 20, 32, 20, 6, 5)
MILLION_RUNS = 3      # timed runs of the million-object store per engine


def retwis_store(zipf, nodes, objects, slots, rounds, ops, seed=0):
    """One Retwis store as ``benchmarks/fig11_retwis.py`` builds it: the
    versioned-slot lattice, the seeded op stream (and its count table) and
    the per-object byte weights."""
    from repro_torch.core import MapLattice
    from repro_torch.core import value_lattices as vl
    from repro_torch.sync import StoreSpec
    from repro_torch.sync import workloads as W

    counts = W.retwis(objects, nodes, rounds, ops, zipf, seed=seed) \
        .update_counts()
    lat = MapLattice(slots, vl.max_int(), "retwis").build()
    spec = StoreSpec(objects=objects,
                     op_fn=W.versioned_slot_op(counts, slots),
                     weights=W.retwis_weights(objects))
    return lat, spec, counts


def retwis_row(res, nodes):
    """A fig11 row's numbers from a store result, as fig11_retwis.py
    computes them (float64 from the engine's integers)."""
    tx, mem = res.store_tx_bytes, res.store_mem_bytes
    half = len(tx) // 2
    return {"tx_mb_node_h1": float(tx[:half].sum() / nodes / 1e6),
            "tx_mb_node_h2": float(tx[half:].sum() / nodes / 1e6),
            "mem_mb_node_h1": float(mem[:half].mean() / nodes / 1e6),
            "mem_mb_node_h2": float(mem[half:].mean() / nodes / 1e6),
            "cpu": float(res.store_cpu.sum())}


def retwis_phase(check, launches, log):
    """``benchmarks/results/fig11_retwis.json`` at its committed default
    shape (mesh16 d4, 96 objects, 32 slots, 40 rounds, 6 ops per node),
    value for value: every zipf row on ``reference``, ``fused`` and
    ``mega`` bit-identical to it at zipf 1.0, and the resync block."""
    from repro_torch.sync import simulate_store, topology

    fig = json.loads((REPO / "benchmarks" / "results" /
                      "fig11_retwis.json").read_text())
    nodes, objects, slots, rounds, ops = 16, 96, 32, 40, 6
    topo = topology.partial_mesh(nodes, 4)
    t0 = time.perf_counter()
    at_1 = {}
    for zipf in RETWIS_ZIPFS:
        lat, spec, _ = retwis_store(zipf, nodes, objects, slots, rounds, ops)
        row = {}
        for algo in ("classic", "bprr"):
            res = launches.run(
                f"retwis zipf {zipf} {algo}", "reference", algo, rounds,
                lambda: simulate_store(algo, lat, topo, spec, rounds))
            if zipf == 1.0:
                at_1[algo] = (res, lat, spec)
            row[algo] = retwis_row(res, nodes)
        row["tx_ratio_h2"] = row["classic"]["tx_mb_node_h2"] / max(
            row["bprr"]["tx_mb_node_h2"], 1e-9)
        row["cpu_overhead"] = row["classic"]["cpu"] / max(
            row["bprr"]["cpu"], 1e-9) - 1.0
        want = fig[f"zipf_{zipf}"]
        check(row == want, f"retwis zipf {zipf}: {row} vs {want}")
    identical = True
    for algo, (ref, lat, spec) in at_1.items():
        for engine in ("fused", "mega"):
            res = launches.run(
                f"retwis zipf 1.0 {algo} {engine}", engine, algo, rounds,
                lambda: simulate_store(algo, lat, topo, spec, rounds,
                                       engine=engine), objects)
            identical &= same_run(ref, res)
    check(identical == fig["engines_bit_identical"],
          f"retwis engines_bit_identical {identical}")
    resync = {}
    lat, spec, _ = retwis_store(1.0, nodes, objects, slots, rounds, ops)
    for algo in ("state_driven", "digest_driven"):
        res = launches.run(
            f"retwis resync {algo}", "reference", algo, rounds + 10,
            lambda: simulate_store(algo, lat, topo, spec, rounds, 10,
                                   track_convergence=True))
        conv = res.convergence_round()
        resync[algo] = {
            "tx_mb_node": float(res.total_tx_bytes / nodes / 1e6),
            "all_objects_converged": bool((conv >= 0).all()),
            "last_convergence_round": int(conv.max())}
    check(resync == fig["resync"], f"retwis resync {resync} vs "
                                   f"{fig['resync']}")
    wall = time.perf_counter() - t0
    print(f"fig11_retwis: {len(RETWIS_ZIPFS)} zipf rows, "
          f"engines_bit_identical and the resync block reproduced "
          f"({wall:.1f} s)", flush=True)
    log["fig11_retwis"] = {"wall_s": wall}


def sampled_objects(objects, seed=0):
    """The first, the last and 6 seeded draws between them."""
    import numpy as np

    mid = np.random.default_rng(seed).choice(
        np.arange(1, objects - 1), 6, replace=False)
    return [0, objects - 1] + sorted(int(o) for o in mid)


def retwis_paper_phase(check, launches, log):
    """Retwis at the repo's 50-node / 30K-object setting
    (``benchmarks/fig11_retwis.py`` docstring and ``--full``): mesh50 d4,
    30,000 objects (follower / wall / timeline), 64 slots, 100 active + 13
    quiet rounds (the mesh's diameter), 10 ops per node, zipf 1.0; classic
    and bprr on mega,
    fused and reference. All engines equal, 8 sampled objects equal to
    their own ``simulate``, every object converged after the drain; ms per
    round, peak memory and the round's byte bound. Returns the bprr
    ``mega`` run's per-object metrics (host arrays) and its median ms per
    round."""
    import numpy as np
    import torch

    from repro_torch.sync import (cluster_uniform, simulate, simulate_store,
                                  topology)
    from repro_torch.sync import workloads as W

    nodes, objects, slots, active, quiet, ops = RETWIS_PAPER
    topo = topology.partial_mesh(nodes, 4)
    lat, spec, counts = retwis_store(1.0, nodes, objects, slots, active, ops)
    plane = objects * nodes * slots * 4
    rows, t0, kept = [], time.perf_counter(), {}
    for algo in ("classic", "bprr"):
        k = 5 if algo == "bprr" else 1
        b_ms = ms_bound((2 * k + 3) * plane)
        runs = {}
        for engine in ("mega", "fused", "reference"):
            tag = f"retwis paper {algo} {engine}"
            r, ms, peak = scale_run(
                launches, tag, engine, algo, active + quiet,
                lambda a=active, q=quiet: simulate_store(
                    algo, lat, topo, spec, a, q, engine=engine), objects)
            rows.append(scale_row("retwis_mesh50_30k_s64", topo.name, algo,
                                  engine, ms, b_ms, peak, r))
            print_scale(tag, ms, b_ms, peak, r)
            runs[engine] = r
            if algo == "bprr" and engine == "mega":
                # phase 9 holds its four-block run to these
                kept = {"ms": ms[0], "metrics": {
                    f: np.asarray(getattr(r.sim, f)) for f in
                    ("tx", "mem", "cpu", "max_mem_node")}}
        for engine in ("fused", "reference"):
            check(same_run(runs["mega"], runs[engine]),
                  f"retwis paper {algo}: {engine} differs from mega")
        r = runs["mega"]
        check(bool(cluster_uniform(lat, r.final_x, batched=True).all()),
              f"retwis paper {algo}: an object did not converge")
        for o in sampled_objects(objects):
            single = launches.run(
                f"retwis paper {algo} object {o}", "mega", algo,
                active + quiet, lambda o=o: simulate(
                    algo, lat, topo,
                    W.versioned_slot_cell_op(counts, o, slots), active,
                    quiet, engine="mega"))
            check(same_run(r.object_result(o), single),
                  f"retwis paper {algo}: object {o} differs from its "
                  f"simulate run")
        del runs, r
        torch.cuda.empty_cache()
    prof = {}
    for engine in ("mega", "fused"):
        prof[engine] = profile_rounds(
            check, f"retwis paper bprr {engine}",
            lambda e=engine: launches.run(
                f"retwis paper bprr {e} profile", e, "bprr", 3,
                lambda: simulate_store("bprr", lat, topo, spec, 3, 0,
                                       engine=e), objects))
    wall = time.perf_counter() - t0
    log["retwis_paper"] = {"rows": rows, "profile": prof, "wall_s": wall}
    return kept


def million_phase(check, launches, log):
    """A million objects, chunked and resumed: 1,048,576 objects of the
    committed Retwis shape (mesh16 d4, 32 slots, 6 ops per node, zipf 1.0),
    bprr, 20 rounds in chunks of 5, ``object_metrics=False``: 16,777,216
    kernel rows and 1,048,576 ``round_step`` configs, timed as
    :func:`scale_run` times (a one-round warm-up, then the median, min and
    max of ``MILLION_RUNS`` runs). ``mega`` and ``fused`` agree; a run
    checkpointing at every boundary (under
    ``build/``) resumed from round 10 equals the uninterrupted run; the
    reduced aggregates equal the sums of an ``object_metrics=True`` run;
    8 sampled objects equal their own ``simulate``."""
    import shutil

    import numpy as np
    import torch

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.sync import (resume_store, simulate, simulate_store,
                                  topology)
    from repro_torch.sync import workloads as W

    nodes, objects, slots, rounds, ops, chunk = STORE_1M
    topo = topology.partial_mesh(nodes, 4)
    row = (nodes, topo.max_degree, slots)     # the launch rule's rows
    lat, spec, counts = retwis_store(1.0, nodes, objects, slots, rounds, ops)
    ckdir = REPO / "build" / "store_ckpt"
    shutil.rmtree(ckdir, ignore_errors=True)
    plane = objects * nodes * slots * 4
    b_ms = ms_bound(13 * plane)

    class KeepTen(Checkpointer):
        """Saves every boundary; keeps only round 10's bundle on disk (the
        one the resume reads): a bundle is 12 GiB."""

        def save(self, step, state, extra=None):
            out = super().save(step, state, extra)
            for s in self.available_steps():
                if s not in (10, step):
                    shutil.rmtree(self._path(s))
            return out

    def store(engine, active=rounds, **kw):
        return simulate_store("bprr", lat, topo, spec, active, engine=engine,
                              chunk_rounds=chunk, **kw)

    def aggregates(r):
        return [getattr(r, v) for v in ("store_tx", "store_mem", "store_cpu",
                                        "store_max_mem_node")]

    def same_store(a, b):
        return all(np.array_equal(x, y) for x, y in zip(
            aggregates(a), aggregates(b))) and torch.equal(a.final_x,
                                                           b.final_x)

    rows, runs, t0 = [], {}, time.perf_counter()
    for engine in ("mega", "fused"):
        tag = f"store 1M bprr {engine}"
        r, ms, peak = scale_run(
            launches, tag, engine, "bprr", rounds,
            lambda a=rounds, q=0: store(engine, a, object_metrics=False),
            objects, runs=MILLION_RUNS, row=row)
        rows.append(scale_row("retwis_mesh16_1M_s32", topo.name, "bprr",
                              engine, ms, b_ms, peak, r, runs=MILLION_RUNS))
        print_scale(tag, ms, b_ms, peak, r, runs=MILLION_RUNS)
        runs[engine] = r
        torch.cuda.empty_cache()
    base = runs["mega"]
    check(same_store(base, runs["fused"]), "store 1M: fused differs from mega")
    del runs
    torch.cuda.empty_cache()

    t = time.perf_counter()
    full = launches.run("store 1M bprr mega checkpointed", "mega", "bprr",
                        rounds, lambda: store("mega", object_metrics=False,
                                              checkpoint=KeepTen(ckdir)),
                        objects, row=row)
    save_s = time.perf_counter() - t
    check(same_store(base, full), "store 1M: the checkpointed run differs")
    del full
    torch.cuda.empty_cache()
    class ReadOnly(Checkpointer):
        """Restores; writes nothing (the resumed run's own boundaries are
        not needed here)."""

        def save(self, step, state, extra=None):
            return ""

    t = time.perf_counter()
    res = launches.run("store 1M bprr mega resumed", "mega", "bprr",
                       rounds - 10, lambda: resume_store(
                           "bprr", lat, topo, spec, rounds, engine="mega",
                           checkpoint=ReadOnly(ckdir), step=10,
                           object_metrics=False), objects, row=row)
    resume_s = time.perf_counter() - t
    check(same_store(base, res), "store 1M: resume from round 10 differs "
                                 "from the uninterrupted run")
    del res
    shutil.rmtree(ckdir, ignore_errors=True)
    torch.cuda.empty_cache()

    per = launches.run("store 1M bprr mega object_metrics", "mega", "bprr",
                       rounds, lambda: store("mega", object_metrics=True),
                       objects, row=row)
    check(same_store(base, per), "store 1M: the reduced aggregates differ "
                                 "from the per-object sums")
    for o in sampled_objects(objects):
        single = launches.run(
            f"store 1M object {o}", "mega", "bprr", rounds,
            lambda o=o: simulate("bprr", lat, topo,
                                 W.versioned_slot_cell_op(counts, o, slots),
                                 rounds, engine="mega"))
        check(same_run(per.object_result(o), single),
              f"store 1M: object {o} differs from its simulate run")
    del per
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    print(f"store 1M: checkpointed run {save_s:.1f} s (4 bundles of "
          f"{(6 * plane + 4 * objects * nodes) / 2**30:.1f} GiB), resume "
          f"from round 10 {resume_s:.1f} s; phase {wall:.1f} s", flush=True)
    log["store_1m"] = {"rows": rows, "checkpointed_s": save_s,
                       "resume_s": resume_s, "wall_s": wall}


# -- phase 7: LWWMap through simulate, the merge entry points, quickstart -----

def lww_write_op(blocks):
    """The LWWMap op of the scale runs: every node writes (its current
    timestamp + 1, its id + 1) at its keys (``blocks``, bool [N, U] on the
    device) — the GMap 10% stream as last-writer-wins puts."""
    import torch

    ids = torch.arange(1, blocks.shape[0] + 1, dtype=torch.int32,
                       device=blocks.device)[:, None]

    def op(x, t):
        ts, _ = x
        return (torch.where(blocks, ts + 1, 0), torch.where(blocks, ids, 0))

    return op


def lww_phase(check, launches, log):
    """LWWMap with 4,194,304 keys, bprr and classic on mesh15d4, 12 active
    + 8 quiet rounds on the reference engine (the lex-pair states have no
    dense kernel kind): per-round metrics equal 27,962 × the GCounter(15)
    run, the final timestamps 12 and values owner id + 1 on covered keys;
    ``engine="mega"`` resolves to the reference and launches nothing.
    Then replicas merge through the public entry points: a fresh replica
    takes the converged state by ``lex_join_delta``, the two runs' states
    merge to themselves, and their timestamp planes (a GMap of versions)
    go through ``join`` and ``delta_extract``. Returns the bprr result."""
    import numpy as np
    import torch

    from repro_torch.core import GCounter, LWWMap
    from repro_torch.kernels import ops
    from repro_torch.sync import simulate, topology
    from repro_torch.sync import workloads as W
    from repro_torch.sync.engine import resolve

    active, quiet = 12, 8
    rounds = active + quiet
    topo = topology.partial_mesh(15, 4)
    blocks = W.gmap_key_blocks(15, SCALE_KEYS, 10)
    per_node = int(blocks.sum(1)[0])
    covered = torch.as_tensor(blocks.any(0), device="cuda")
    owner = torch.as_tensor(blocks.argmax(0), device="cuda").to(torch.int32)
    want_t = torch.where(covered, 12, 0).to(torch.int32).expand(15, SCALE_KEYS)
    want_v = torch.where(covered, owner + 1, 0).to(torch.int32) \
        .expand(15, SCALE_KEYS)
    op = lww_write_op(torch.as_tensor(blocks, device="cuda"))
    lat = LWWMap(SCALE_KEYS).lattice
    check(resolve("mega", lat) == "reference",
          "LWWMap does not resolve to the reference engine")
    plane = 15 * SCALE_KEYS * 4
    rows, finals = [], {}
    for algo in ("bprr", "classic"):
        oracle = simulate(algo, GCounter(15).lattice, topo,
                          W.gcounter_op(15), active, quiet)
        k = topo.max_degree + 1 if algo == "bprr" else 1
        # the bytes of the round's state passes, each leaf once (as the
        # GMap bound, for two leaves)
        b_ms = ms_bound(2 * (2 * k + 3) * plane)
        tag = f"lww{SCALE_KEYS} mesh {algo} reference"
        r, ms, peak = scale_run(
            launches, tag, "reference", algo, rounds,
            lambda a=active, q=quiet: simulate(algo, lat, topo, op, a, q,
                                               engine="reference"))
        for nm in ("tx", "mem", "cpu", "max_mem_node"):
            check(np.array_equal(getattr(r, nm),
                                 per_node * getattr(oracle, nm)),
                  f"{tag}: {nm} != {per_node} x GCounter(15)")
        check(torch.equal(r.final_x[0], want_t)
              and torch.equal(r.final_x[1], want_v), f"{tag}: final state")
        rows.append(scale_row(f"lww{SCALE_KEYS}_k10", topo.name, algo,
                              "reference", ms, b_ms, peak, r))
        print_scale(tag, ms, b_ms, peak, r)
        finals[algo] = r
        torch.cuda.empty_cache()
    mega = launches.run("lww mesh bprr mega", "reference", "bprr", rounds,
                        lambda: simulate("bprr", lat, topo, op, active, quiet,
                                         engine="mega"))
    check(same_run(mega, finals["bprr"]),
          "lww bprr: engine='mega' differs from the reference run")
    del mega
    torch.cuda.empty_cache()

    # replicas merge through the public entry points
    fresh = lat.bottom("cuda")
    fresh = tuple(a.expand(15, SCALE_KEYS).contiguous() for a in fresh)
    held = finals["bprr"].final_x
    merged, delta, cnt = ops.lex_join_delta(fresh, held)
    n_cov = 15 * int(covered.sum())
    check(int(cnt) == n_cov and all(torch.equal(m, h) for m, h in
                                    zip(merged, held))
          and all(torch.equal(d, h) for d, h in zip(delta, held)),
          f"lex_join_delta(fresh, state): count {int(cnt)} vs {n_cov}")
    merged, delta, cnt = ops.lex_join_delta(held, finals["classic"].final_x)
    check(int(cnt) == 0 and all(torch.equal(m, h)
                                for m, h in zip(merged, held)),
          f"lex_join_delta(bprr, classic): count {int(cnt)}")
    check(torch.equal(ops.join(held[0], finals["classic"].final_x[0]),
                      want_t), "join of the timestamp planes")
    s, xj, cnt = ops.delta_extract(held[0], fresh[0])
    check(int(cnt) == n_cov and torch.equal(s, want_t)
          and torch.equal(xj, want_t),
          f"delta_extract(timestamps, fresh): count {int(cnt)} vs {n_cov}")
    log["lww_scale"] = rows
    return finals["bprr"]


def lww_small_phase(check, launches, log):
    """LWWMap at 65,536 keys through faults and resync on the card, each
    run identical to the same run on the CPU: bprr under 10% loss (seed 7)
    with the write stream, and a digest_driven join (donors hold every
    tile's first quarter at (1, 7), the joiner ⊥) on all three engine
    names."""
    import torch

    from repro_torch.core import LWWMap
    from repro_torch.sync import DigestSpec, FaultSchedule, simulate, topology
    from repro_torch.sync import workloads as W

    u, active, quiet = 65_536, 12, 8
    topo = topology.partial_mesh(15, 4)
    lat = LWWMap(u).lattice
    blocks = W.gmap_key_blocks(15, u, 10)
    sched = FaultSchedule.bernoulli(topo, active, 0.10, seed=7)
    t0 = time.perf_counter()
    runs = 0
    want = simulate("bprr", lat, topo,
                    lww_write_op(torch.as_tensor(blocks)), active, quiet,
                    faults=sched, device="cpu")
    got = launches.run("lww loss10 bprr", "reference", "bprr",
                       active + quiet, lambda: simulate(
                           "bprr", lat, topo,
                           lww_write_op(torch.as_tensor(blocks,
                                                        device="cuda")),
                           active, quiet, faults=sched))
    check(same_run(got, want) and got.convergence_round() >= 0,
          "lww bprr under 10% loss: cuda differs from cpu or did not "
          "converge")
    runs += 1
    x0 = tuple(join_x0(15, u, 0.25, tile=1024, value=v, dtype=torch.int32)
               for v in (1, 7))
    spec = DigestSpec(DIGEST_BLOCK)
    want = simulate("digest_driven", lat, topo, no_op, 0, 12, x0=x0,
                    track_convergence=True, digest=spec, device="cpu")
    for engine in ("reference", "fused", "mega"):
        got = launches.run(
            f"lww join digest_driven {engine}", "reference", "digest_driven",
            12, lambda e=engine: simulate(
                "digest_driven", lat, topo, no_op, 0, 12, x0=x0,
                track_convergence=True, digest=spec, engine=e))
        check(same_run(got, want) and got.convergence_round() >= 0,
              f"lww digest_driven join {engine}: cuda differs from cpu or "
              f"did not converge")
        runs += 1
    wall = time.perf_counter() - t0
    print(f"lww faults and resync: {runs} runs equal to the CPU "
          f"({wall:.1f} s)", flush=True)
    log["lww_small"] = {"runs": runs, "wall_s": wall}


def quickstart_phase(check, log):
    """``repro_torch.quickstart`` on the card and on the CPU: the same
    numbers, and ``delta_extract`` launched on the card."""
    from repro_torch import kernels, quickstart

    before = kernels.launch_counts()["delta_extract"]
    t0 = time.perf_counter()
    card = quickstart.run("cuda")
    cpu = quickstart.run("cpu")
    wall = time.perf_counter() - t0
    launched = kernels.launch_counts()["delta_extract"] - before
    check(card == cpu, f"quickstart: card {card} vs cpu {cpu}")
    check(launched == 1, f"quickstart: delta_extract launched {launched} "
                         f"times")
    log["quickstart"] = {"card": card, "wall_s": wall}


# the JAX example's numbers (examples/retwis_app.py: simulate_store with
# wide_metrics=False, the example's spec); tests/test_torch_retwis_app.py
# holds them equal to the JAX package
RETWIS_APP_EXPECT = {
    "total_tx_bytes": 678836.0, "converged_by": 30,
    "hottest": [{"class": "followers", "object": 0, "tx_bytes": 23520.0,
                 "elements": 1176, "converged": 28},
                {"class": "wall", "object": 1, "tx_bytes": 245014.0,
                 "elements": 814, "converged": 27},
                {"class": "timeline", "object": 2, "tx_bytes": 23439.0,
                 "elements": 601, "converged": 26}],
    "footprint_bytes": 87840.0}


def retwis_app_phase(check, log):
    """``repro_torch.retwis_app`` on the card and on the CPU: the same
    numbers and lines, equal to the JAX example's; no kernel launched (the
    store's default engine is the reference)."""
    from repro_torch import kernels, retwis_app

    before = kernels.launch_counts()
    t0 = time.perf_counter()
    card = retwis_app.run("cuda")
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = retwis_app.run("cpu")
    cpu_s = time.perf_counter() - t0
    check(kernels.launch_counts() == before,
          f"retwis_app launched {kernels.launch_counts()} (before {before})")
    check(card == cpu, f"retwis_app: card {card} vs cpu {cpu}")
    got = {k: card[k] for k in RETWIS_APP_EXPECT}
    check(got == RETWIS_APP_EXPECT,
          f"retwis_app: {got} vs the JAX example's {RETWIS_APP_EXPECT}")
    print(f"retwis_app: {card_s:.2f} s on the card, {cpu_s:.2f} s on the CPU",
          flush=True)
    log["retwis_app"] = {"card_s": card_s, "cpu_s": cpu_s}


def profile_rounds(check, tag, run):
    """``torch.profiler`` over one call of ``run`` (after a warm-up call):
    device time by kernel, and the device's busy share of the wall time.
    A profiler failure, or a window with no device time, fails a check."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    try:
        run()                                              # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # kernels only: an aten op also reports its kernels' time
        rows = [(e.key, e.self_device_time_total / 1e3, e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0]
    except Exception as exc:  # noqa: BLE001 - becomes a failed check
        check(False, f"profile {tag}: {exc!r}")
        return {"error": repr(exc)}
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    check(device_ms > 0, f"profile {tag}: no device time was recorded")
    print(f"profile {tag}: 3 rounds {wall_ms:.2f} ms wall, {device_ms:.2f} "
          f"ms on the device (busy {device_ms / wall_ms:.1%})", flush=True)
    for k, t, c in rows[:6]:
        print(f"    {t:9.3f} ms  x{c:<4d} {k[:80]}", flush=True)
    return {"wall_ms_3_rounds": wall_ms, "device_ms_3_rounds": device_ms,
            "busy_share": device_ms / wall_ms if wall_ms else None,
            "top": [{"kernel": k[:90], "ms": t, "calls": c}
                    for k, t, c in rows[:10]]}


def profile_phase(check, log):
    """Where a round's time goes: 3 active GMap rounds (4,194,304 keys,
    mesh, bprr) per kernel engine and on ``mega`` with telemetry and
    provenance, 3 LWWMap rounds of phase 7 (reference),
    and 3 digest_driven rounds of the GMap join (a) on ``fused``. Informs
    PERF.md."""
    import torch

    from repro_torch.core import GMap, LWWMap
    from repro_torch.obs import ProvenanceSpec, TelemetrySpec
    from repro_torch.sync import DigestSpec, simulate, topology
    from repro_torch.sync import workloads as W

    topo = topology.partial_mesh(15, 4)
    op = W.gmap_block_op(15, SCALE_KEYS, 10)
    lat = GMap(SCALE_KEYS).lattice
    out = {}
    for engine in ("mega", "fused"):
        out[engine] = profile_rounds(
            check, f"gmap mesh bprr {engine}",
            lambda e=engine: simulate("bprr", lat, topo, op, 3, 0, engine=e))
    out["mega_observability"] = profile_rounds(
        check, "gmap mesh bprr mega telemetry + provenance",
        lambda: simulate("bprr", lat, topo, op, 3, 0, engine="mega",
                         telemetry=TelemetrySpec(),
                         provenance=ProvenanceSpec()))
    blocks = torch.as_tensor(W.gmap_key_blocks(15, SCALE_KEYS, 10),
                             device="cuda")
    out["lww_reference"] = profile_rounds(
        check, "lww mesh bprr reference",
        lambda: simulate("bprr", LWWMap(SCALE_KEYS).lattice, topo,
                         lww_write_op(blocks), 3, 0))
    del blocks
    x0 = join_x0(15, SCALE_KEYS, 0.25, tile=1024, value=1,
                 dtype=torch.int32).cuda()
    out["digest_driven_fused"] = profile_rounds(
        check, "gmap join digest_driven fused",
        lambda: simulate("digest_driven", lat, topo, no_op, 0, 3, x0=x0,
                         engine="fused", digest=DigestSpec(DIGEST_BLOCK)))
    log["profile"] = out


# -- phase 8: observability and the Scuttlebutt baseline ------------------------

OBS_JOIN_U, OBS_JOIN_ROUNDS = 1024, 14      # fig_telemetry / fig_provenance
OBS_TIMED_RUNS = 5                          # timed runs at 4,194,304 keys


def obs_fields(r):
    """A run's telemetry channels (host arrays) and provenance channels
    and matrices (the matrices on the run's device)."""
    out = {}
    if r.telemetry is not None:
        out.update({f"tele.{f}": getattr(r.telemetry, f)
                    for f in r.telemetry._fields[:6]})
    if r.provenance is not None:
        out.update({f"prov.{f}": getattr(r.provenance, f)
                    for f in r.provenance._fields[:10]})
    return out


def equal_values(x, y) -> bool:
    """Two host arrays, or two tensors (compared on the first one's
    device), equal in shape and value."""
    import numpy as np
    import torch

    if isinstance(x, torch.Tensor):
        return torch.equal(x, y.to(x.device))
    return np.array_equal(x, y)


def same_obs(a, b) -> bool:
    """Equal runs (metrics, convergence, final states) with equal
    observability channels and matrices (tensors compared on the first
    run's device)."""
    fa, fb = obs_fields(a), obs_fields(b)
    return same_run(a, b) and fa.keys() == fb.keys() and all(
        equal_values(fa[k], fb[k]) for k in fa)


class Oracles:
    """The observability oracles (``repro_torch.obs.oracle``: replays that
    share no code with the engines' channels) on the card, held against
    runs; every oracle call launches no kernel, and their seconds add up
    in ``seconds``."""

    def __init__(self, check):
        self.check, self.seconds, self.calls = check, 0.0, 0

    def hold(self, tag, runs, call, prov=False):
        """``call(oracle_fn)`` runs an oracle with the runs' arguments on
        the card: ``oracle_channels`` must equal every run's telemetry
        and, with ``prov``, ``oracle_provenance`` its provenance (the
        matrices compared on the card), field for field. Returns the two
        oracles' seconds (the second 0.0 without ``prov``)."""
        import torch

        from repro_torch import kernels
        from repro_torch.obs import oracle

        before = kernels.launch_counts()
        t0 = time.perf_counter()
        ch = call(oracle.oracle_channels)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pv = call(oracle.oracle_provenance) if prov else None
        torch.cuda.synchronize()
        secs = (t1 - t0, time.perf_counter() - t1 if prov else 0.0)
        self.seconds += sum(secs)
        self.calls += 1 + prov
        self.check(kernels.launch_counts() == before,
                   f"{tag}: an oracle launched a kernel")
        for e, r in runs.items():
            for f, want in zip(ch._fields[:6], ch[:6]):
                self.check(equal_values(getattr(r.telemetry, f), want),
                           f"{tag}: {e} telemetry {f} differs from "
                           f"oracle_channels")
            if prov:
                for f, want in zip(pv._fields[:11], pv[:11]):
                    self.check(equal_values(want, getattr(r.provenance, f)),
                               f"{tag}: {e} provenance {f} differs from "
                               f"oracle_provenance")
        return secs


def fig_telemetry_row(r):
    """One row of ``benchmarks/fig_telemetry.py``'s table from a port run
    (its ``_row`` without the wall time)."""
    import numpy as np

    t = r.telemetry
    return {"tx": r.total_tx,
            "recv_elems": int(t.recv_elems.sum()),
            "novel_elems": int(t.novel_elems.sum()),
            "redundancy": round(t.total_redundancy(), 4),
            "redundancy_over_time": [
                None if np.isnan(v) else round(float(v), 4)
                for v in t.redundancy_over_time()],
            "peak_buf_elems": int(t.buf_elems.sum(axis=-1).max()),
            "max_stale_rounds": int(t.stale_rounds.max()),
            "max_ack_lag": int(t.ack_lag.max()),
            "final_div_gap": int(t.div_gap[-1].sum())}


def obs_engines(check, launches, tag, algo, rounds, fn, cpu=False):
    """``fn(engine, device)`` on the three engines on the card (launches
    checked), all equal with their observability; with ``cpu`` also the
    reference engine on the CPU, equal to them. Returns the card runs by
    engine."""
    from repro_torch.sync import ENGINES

    runs = {e: launches.run(f"{tag} {e}", e, algo, rounds,
                            lambda e=e: fn(e, "cuda")) for e in ENGINES}
    for e in ("fused", "mega"):
        check(same_obs(runs["reference"], runs[e]),
              f"{tag}: {e} differs from reference")
    if cpu:
        check(same_obs(runs["reference"], fn("reference", "cpu")),
              f"{tag}: the card differs from the CPU")
    return runs


def obs_fig_telemetry(check, launches, trace, oracles):
    """(a) ``benchmarks/results/fig_telemetry.json``'s 18 cells, value for
    value, on the three engines: the fig7 GSet workload on tree and mesh,
    the mesh at 10% loss, and the 25% join of state / state_driven /
    digest_driven, rebuilt here as ``benchmarks/fig_telemetry.py`` builds
    them; every cell's channels equal ``oracle_channels`` on the card."""
    import torch

    from repro_torch.core import GSet
    from repro_torch.obs import TelemetrySpec
    from repro_torch.sync import DigestSpec, FaultSchedule, simulate, topology
    from repro_torch.sync import workloads as W

    fig = json.loads((REPO / "benchmarks" / "results" /
                      "fig_telemetry.json").read_text())
    n, events, quiet = fig["nodes"], fig["events"], fig["quiet"]
    lat, op = GSet(n * events).lattice, W.gset_unique_op(n, events)
    mesh = topology.partial_mesh(n, 4)
    scen = [("tree", topology.tree(n), None, fig["transmission"]["tree"]),
            ("mesh", mesh, None, fig["transmission"]["mesh"]),
            ("loss", mesh, FaultSchedule.bernoulli(
                mesh, events + quiet // 4, fig["loss_rate"], seed=7),
             fig["loss"])]
    cells = 0
    for name, topo, faults, rows in scen:
        for algo, row in rows.items():
            want = {k: v for k, v in row.items() if k != "wall_s"}
            tag = f"fig_telemetry {name} {algo}"
            args = (algo, lat, topo, op, events, quiet)
            runs = obs_engines(
                check, launches, tag, algo, events + quiet,
                lambda e, d: simulate(*args, faults=faults, engine=e,
                                      telemetry=TelemetrySpec(), device=d))
            oracles.hold(tag, runs, lambda f: f(*args, faults=faults,
                                                device="cuda"))
            for e, r in runs.items():
                got = fig_telemetry_row(r)
                check(got == want, f"fig_telemetry {name} {algo} {e}: "
                                   f"{got} vs {want}")
            if name == "loss" and algo in ("classic", "bprr"):
                trace.add_round_counters(runs["mega"].telemetry,
                                         prefix=f"loss/{algo}/")
            cells += 1
    x0 = join_x0(n, OBS_JOIN_U, fig["join_ratio"])
    for algo, row in fig["join"].items():
        want = {k: v for k, v in row.items() if k != "wall_s"}
        tag = f"fig_telemetry join {algo}"
        args = (algo, GSet(OBS_JOIN_U).lattice, mesh, no_op, 0,
                OBS_JOIN_ROUNDS)
        runs = obs_engines(
            check, launches, tag, algo, OBS_JOIN_ROUNDS,
            lambda e, d: simulate(*args, x0=x0, digest=DigestSpec(64),
                                  track_convergence=True, engine=e,
                                  telemetry=TelemetrySpec(), device=d))
        oracles.hold(tag, runs, lambda f: f(*args, x0=x0,
                                            digest=DigestSpec(64),
                                            device="cuda"))
        for e, r in runs.items():
            got = fig_telemetry_row(r)
            check(got == want, f"fig_telemetry join {algo} {e}: {got} vs "
                               f"{want}")
        cells += 1
    torch.cuda.synchronize()
    return {"cells": cells}


def obs_fig_provenance(check, launches, trace, oracles):
    """(b) ``benchmarks/fig_provenance.py``'s scenarios (no committed
    result): the fig7 GSet workload on tree and mesh and the mesh at 10%
    loss with telemetry and provenance, and the two anomaly runs, each on
    three engines and on the CPU, all equal, and equal to
    ``oracle_channels`` (and ``oracle_provenance``) on the card; waste_bp
    + waste_cp == recv − novel for every (round, node); bprr
    back-propagates nothing; the joining replica under bprr is
    non-convergence, the partition under state fault stalls, and
    state_driven's join is not flagged."""
    import numpy as np

    from repro_torch.core import GSet
    from repro_torch.obs import (FAULT_STALL, NON_CONVERGENCE,
                                 ProvenanceSpec, TelemetrySpec,
                                 detect_stalls)
    from repro_torch.sync import FaultSchedule, simulate, topology
    from repro_torch.sync import workloads as W

    n, events, quiet = 15, 40, 40
    lat, op = GSet(n * events).lattice, W.gset_unique_op(n, events)
    mesh = topology.partial_mesh(n, 4)
    scen = [("tree", topology.tree(n), None), ("mesh", mesh, None),
            ("loss", mesh, FaultSchedule.bernoulli(mesh, events + quiet,
                                                   0.10, seed=7))]
    shares = {}
    for name, topo, faults in scen:
        for algo in ("state", "classic", "bp", "rr", "bprr"):
            tag = f"fig_provenance {name} {algo}"
            args = (algo, lat, topo, op, events, quiet)
            runs = obs_engines(
                check, launches, tag, algo, events + quiet,
                lambda e, d: simulate(*args, faults=faults, engine=e,
                                      telemetry=TelemetrySpec(),
                                      provenance=ProvenanceSpec(), device=d),
                cpu=True)
            oracles.hold(tag, runs, lambda f: f(*args, faults=faults,
                                                device="cuda"), prov=True)
            r = runs["mega"]
            p, t = r.provenance, r.telemetry
            check(np.array_equal(p.waste_bp.astype(np.int64) + p.waste_cp,
                                 t.redundant_elems)
                  and p.attributed_fraction(t) == 1.0,
                  f"{tag}: attribution is not exhaustive")
            w = p.waste_by_cause()
            if algo == "bprr":
                check(w["backprop"] == 0, f"{tag}: bprr back-propagated "
                                          f"{w['backprop']}")
            shares[f"{name}/{algo}"] = w
            if name == "tree" and algo == "classic":
                trace.add_propagation_spans(p, elems=range(128),
                                            prefix="classic/tree/")
    x0 = join_x0(n, OBS_JOIN_U, 0.25)
    stalls = {}
    for algo in ("bprr", "state_driven"):
        args = (algo, GSet(OBS_JOIN_U).lattice, mesh, no_op, 0,
                OBS_JOIN_ROUNDS)
        runs = obs_engines(
            check, launches, f"anomaly join {algo}", algo, OBS_JOIN_ROUNDS,
            lambda e, d: simulate(*args, x0=x0, track_convergence=True,
                                  engine=e, telemetry=TelemetrySpec(),
                                  device=d),
            cpu=True)
        oracles.hold(f"anomaly join {algo}", runs,
                     lambda f: f(*args, x0=x0, device="cuda"))
        stalls[algo] = detect_stalls(runs["mega"].telemetry,
                                     tx=runs["mega"].tx, k=3)
    check(bool(stalls["bprr"]) and all(
        ev.cause == NON_CONVERGENCE for ev in stalls["bprr"]),
        f"anomaly join bprr: {stalls['bprr']}")
    check(stalls["state_driven"] == [],
          f"anomaly join state_driven: {stalls['state_driven']}")
    total = events + quiet
    cut = FaultSchedule.partition(mesh, total, 1, total - 2,
                                  [0] * (n // 2) + [1] * (n - n // 2))
    args = ("state", lat, mesh, op, 2, total - 2)
    runs = obs_engines(
        check, launches, "anomaly partition state", "state", total,
        lambda e, d: simulate(*args, faults=cut, engine=e,
                              telemetry=TelemetrySpec(), device=d),
        cpu=True)
    oracles.hold("anomaly partition state", runs,
                 lambda f: f(*args, faults=cut, device="cuda"))
    evs = detect_stalls(runs["mega"].telemetry, tx=runs["mega"].tx, k=3)
    check(bool(evs) and all(ev.cause == FAULT_STALL for ev in evs),
          f"anomaly partition state: {evs}")
    stalls["partition"] = evs
    return {"waste_by_cause": {k: {c: int(v) for c, v in w.items()}
                               for k, w in shares.items()},
            "stalls": {k: [vars(ev) for ev in v] for k, v in stalls.items()}}


def obs_scale(check, launches, oracles):
    """(c) GMap 4,194,304 keys, K = 10%, mesh15d4, 12 + 8 rounds, bprr and
    classic, with ``telemetry=`` and ``provenance=`` on mega, fused and
    reference: tx / mem / cpu and the final states equal the run without
    observability; every channel and matrix equal across the engines and
    to ``oracle_channels`` and ``oracle_provenance`` on the card (the
    [15, 4,194,304] cov / birth / src / hop and the [15, 4, 4,194,304]
    edge_first included); recv / novel / buf / div_gap and waste_bp /
    waste_cp / covered equal 27,962 × the GCounter(15) run's,
    stale_rounds and ack_lag equal. mega timed off, with telemetry and
    with both (median, min, max of 5 runs after a warm-up); peak
    memory."""
    import numpy as np
    import torch

    from repro_torch.core import GCounter, GMap
    from repro_torch.obs import ProvenanceSpec, TelemetrySpec
    from repro_torch.sync import simulate, topology
    from repro_torch.sync import workloads as W

    active, quiet = 12, 8
    rounds = active + quiet
    topo = topology.partial_mesh(15, 4)
    op = W.gmap_block_op(15, SCALE_KEYS, 10)
    lat = GMap(SCALE_KEYS).lattice
    per_node = int(W.gmap_key_blocks(15, SCALE_KEYS, 10).sum(1)[0])
    plane = 15 * SCALE_KEYS * 4
    modes = {"off": {}, "telemetry": {"telemetry": TelemetrySpec()},
             "both": {"telemetry": TelemetrySpec(),
                      "provenance": ProvenanceSpec()}}
    rows, finals = [], {}
    for algo in ("bprr", "classic"):
        k = topo.max_degree + 1 if algo == "bprr" else 1
        b_ms = ms_bound((2 * k + 3) * plane)
        oracle = simulate(algo, GCounter(15).lattice, topo,
                          W.gcounter_op(15), active, quiet,
                          **modes["both"])
        runs = {}
        for mode, kw in modes.items():
            tag = f"obs gmap{SCALE_KEYS} {algo} mega {mode}"
            r, ms, peak = scale_run(
                launches, tag, "mega", algo, rounds,
                lambda a=active, q=quiet, kw=kw: simulate(
                    algo, lat, topo, op, a, q, engine="mega", **kw),
                runs=OBS_TIMED_RUNS)
            rows.append(scale_row(f"gmap{SCALE_KEYS}_k10_obs_{mode}",
                                  topo.name, algo, "mega", ms, b_ms, peak, r,
                                  runs=OBS_TIMED_RUNS))
            print_scale(tag, ms, b_ms, peak, r, runs=OBS_TIMED_RUNS)
            runs[mode] = r
            r = None
        for mode in ("telemetry", "both"):
            check(same_run(runs["off"], runs[mode]),
                  f"obs gmap {algo}: {mode} changed the run")
        both = runs.pop("both")
        del runs
        for engine in ("fused", "reference"):
            t0 = time.perf_counter()
            r = launches.run(f"obs gmap{SCALE_KEYS} {algo} {engine} both",
                             engine, algo, rounds,
                             lambda e=engine: simulate(
                                 algo, lat, topo, op, active, quiet,
                                 engine=e, **modes["both"]))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / rounds
            print(f"obs gmap{SCALE_KEYS} {algo} {engine} both: {ms:.3f} "
                  f"ms/round (one run, no warm-up)", flush=True)
            rows.append({"workload": f"gmap{SCALE_KEYS}_k10_obs_both",
                         "topo": topo.name, "algo": algo, "engine": engine,
                         "ms_per_round_one_run": ms, "runs": 1})
            check(same_obs(both, r), f"obs gmap {algo}: {engine} differs "
                                     f"from mega")
            del r
        secs = oracles.hold(f"obs gmap{SCALE_KEYS} {algo}", {"mega": both},
                            lambda f: f(algo, lat, topo, op, active, quiet,
                                        device="cuda"), prov=True)
        print(f"obs gmap{SCALE_KEYS} {algo} oracles: channels "
              f"{secs[0] * 1e3 / rounds:.3f} ms/round, provenance "
              f"{secs[1] * 1e3 / rounds:.3f} ms/round (one run each)",
              flush=True)
        rows.append({"workload": f"gmap{SCALE_KEYS}_k10_oracles",
                     "topo": topo.name, "algo": algo, "engine": None,
                     "channels_ms_per_round": secs[0] * 1e3 / rounds,
                     "provenance_ms_per_round": secs[1] * 1e3 / rounds,
                     "runs": 1})
        torch.cuda.empty_cache()
        t, p = both.telemetry, both.provenance
        for f in ("recv_elems", "novel_elems", "buf_elems", "div_gap"):
            check(np.array_equal(getattr(t, f),
                                 per_node * getattr(oracle.telemetry, f)),
                  f"obs gmap {algo}: {f} != {per_node} x GCounter(15)")
        for f in ("stale_rounds", "ack_lag"):
            check(np.array_equal(getattr(t, f),
                                 getattr(oracle.telemetry, f)),
                  f"obs gmap {algo}: {f} != GCounter(15)")
        for f in ("waste_bp", "waste_cp", "covered"):
            check(np.array_equal(getattr(p, f),
                                 per_node * getattr(oracle.provenance, f)),
                  f"obs gmap {algo}: {f} != {per_node} x GCounter(15)")
        finals[algo] = both.final_x
        del both, t, p
        torch.cuda.empty_cache()
    return rows, finals["bprr"]


def obs_scuttlebutt(check, bprr_final):
    """(d) Scuttlebutt: fig7's four rows, fig10's column and fig9's
    measured entries, value for value, on the card; then the GMap codec
    at 4,194,304 keys (K = 10%, mesh15d4, 12 + 8 rounds): tx / mem /
    max_mem_node equal 27,962 × the GCounter codec's and 27,962 / 7 × the
    1,000-key codec's, and the final states equal (c)'s bprr run's."""
    import numpy as np
    import torch

    from repro_torch.sync import scuttlebutt as sb
    from repro_torch.sync import topology
    from repro_torch.sync import workloads as W

    results = REPO / "benchmarks" / "results"
    fig7 = json.loads((results / "fig7_transmission.json").read_text())
    fig9 = json.loads((results / "fig9_metadata.json").read_text())
    fig10 = json.loads((results / "fig10_memory.json").read_text())
    n, events, quiet = 15, 100, 20
    codecs = {"gset": W.scuttlebutt_gset_codec(n, events),
              "gcounter": W.scuttlebutt_gcounter_codec(n),
              "gmap10": W.scuttlebutt_gmap_codec(10, n, 1000),
              "gmap100": W.scuttlebutt_gmap_codec(100, n, 1000)}
    for bench in ("gset", "gcounter"):
        for tn in ("tree", "mesh"):
            topo = topology.by_name(tn, n, 4)
            r = sb.simulate(codecs[bench], topo, events, quiet)
            got = {"tx": r.total_tx + sb.summary_vector_elems(
                       topo.num_edges, n, events),
                   "tx_data_only": r.total_tx,
                   "mem_avg": float(r.mem.mean()),
                   "mem_max_node": int(r.max_mem_node.max()),
                   "cpu": int(r.cpu.sum())}
            want = fig7[f"{bench}_{tn}"]["raw"]["scuttlebutt"]
            check(got == want, f"scuttlebutt fig7 {bench}_{tn}: {got} vs "
                               f"{want}")
    mesh = topology.partial_mesh(n, 4)
    for bench, codec in codecs.items():
        r = sb.simulate(codec, mesh, events, quiet)
        got, want = float(r.mem.mean()), fig10[bench]["raw"]["scuttlebutt"]
        check(got == want, f"scuttlebutt fig10 {bench}: {got} vs {want}")
    m16 = topology.partial_mesh(16, 4)
    r = sb.simulate(W.scuttlebutt_gcounter_codec(16), m16, 10, 2)
    want = fig9["measured_entries"]["16"]["per_round"]
    check(int(r.meta_tx[0]) == want, f"scuttlebutt fig9: {r.meta_tx[0]} vs "
                                     f"{want}")

    active, quiet = 12, 8
    per = int(W.gmap_key_blocks(n, SCALE_KEYS, 10).sum(1)[0])
    per_small = int(W.gmap_key_blocks(n, 1000, 10).sum(1)[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    big = sb.simulate(W.scuttlebutt_gmap_codec(10, n, SCALE_KEYS), mesh,
                      active, quiet)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    small = sb.simulate(codecs["gmap10"], mesh, active, quiet)
    gc = sb.simulate(codecs["gcounter"], mesh, active, quiet)
    for f in ("tx", "mem", "max_mem_node"):
        a = getattr(big, f)
        check(np.array_equal(a, per * getattr(gc, f))
              and np.array_equal(a * per_small, getattr(small, f) * per),
              f"scuttlebutt gmap{SCALE_KEYS}: {f} does not scale by "
              f"{per} / {per_small}")
    check(torch.equal(big.final_x, bprr_final),
          f"scuttlebutt gmap{SCALE_KEYS}: final states differ from bprr's")
    print(f"scuttlebutt gmap{SCALE_KEYS}: {active + quiet} rounds and the "
          f"final states in {wall:.2f} s; tx {big.total_tx}", flush=True)
    return {"gmap_4m_wall_s": wall, "gmap_4m_tx": big.total_tx}


def obs_batched(check, launches):
    """(e) Sweeps and the store with observability: phase 6's BENCH_fault
    sweep (B = 5 scenarios) and fig_digest join grid with ``telemetry=``
    and ``provenance=`` on three engines, every cell's channels equal to
    its single run's; the committed Retwis store (mesh16, 96 objects, 32
    slots, 40 rounds) with both on three engines, every object equal to
    its single run; Retwis at the paper setting (mesh50, 30,000 objects,
    64 slots, 113 rounds, bprr, mega) with ``telemetry=`` and
    ``object_metrics=False``, timed against the run without, chunked and
    checkpointed under ``build/``, its resumed partials equal to the
    uninterrupted run's."""
    import shutil

    import numpy as np
    import torch

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.core import GSet
    from repro_torch.obs import ProvenanceSpec, TelemetrySpec
    from repro_torch.sync import (DigestSpec, SweepSpec, resume_store,
                                  simulate, simulate_store, simulate_sweep,
                                  topology)
    from repro_torch.sync import workloads as W

    results = REPO / "benchmarks" / "results"
    both = {"telemetry": TelemetrySpec(), "provenance": ProvenanceSpec()}
    out = {"cells": 0}

    def cells_ok(tag, runs, singles):
        for e, r in runs.items():
            for b, single in enumerate(singles):
                check(same_obs(r.cell(b), single),
                      f"{tag} {e}: cell {b} differs from its single run")
                out["cells"] += 1

    bench = json.loads((results / "BENCH_fault.json").read_text())
    events, quiet = bench["events"], bench["quiet"]
    topo = topology.partial_mesh(bench["nodes"], 4)
    n = topo.num_nodes
    scheds = fault_scenarios(topo, events, quiet)
    names = list(bench["cells"])
    spec = SweepSpec(batch=len(names),
                     op_fn=W.gset_unique_sweep_op(n, events, (0,)),
                     faults=[scheds[s] for s in names])
    lat, op = GSet(n * events).lattice, W.gset_unique_op(n, events)
    for algo in bench["cells"][names[0]]["raw"]:
        tag = f"obs sweep fault {algo}"
        runs = obs_engines(check, launches, tag, algo, events + quiet,
                           lambda e, d: simulate_sweep(
                               algo, lat, topo, spec, events, quiet,
                               engine=e, device=d, **both))
        singles = [launches.run(f"{tag} single {s}", "mega", algo,
                                events + quiet, lambda s=s: simulate(
                                    algo, lat, topo, op, events, quiet,
                                    faults=scheds[s], engine="mega", **both))
                   for s in names]
        cells_ok(tag, runs, singles)

    fig = json.loads((results / "fig_digest.json").read_text())
    topo = topology.partial_mesh(fig["nodes"], 4)
    n, u, dspec = topo.num_nodes, fig["universe"], DigestSpec(
        fig["block_elems"])
    jlat = GSet(u).lattice
    for algo, rows in fig["join"].items():
        x0s = [join_x0(n, u, rows[k]["divergence"]) for k in rows]
        spec = SweepSpec(batch=len(x0s), op_fn=no_op, x0=torch.stack(x0s))
        tag = f"obs sweep join {algo}"
        runs = obs_engines(check, launches, tag, algo, fig["rounds"],
                           lambda e, d: simulate_sweep(
                               algo, jlat, topo, spec, 0, fig["rounds"],
                               engine=e, track_convergence=True,
                               digest=dspec, device=d, **both))
        singles = [launches.run(f"{tag} single {b}", "mega", algo,
                                fig["rounds"], lambda x0=x0: simulate(
                                    algo, jlat, topo, no_op, 0,
                                    fig["rounds"], x0=x0, engine="mega",
                                    track_convergence=True, digest=dspec,
                                    **both))
                   for b, x0 in enumerate(x0s)]
        cells_ok(tag, runs, singles)

    nodes, objects, slots, rounds, ops = 16, 96, 32, 40, 6
    topo = topology.partial_mesh(nodes, 4)
    lat, spec, counts = retwis_store(1.0, nodes, objects, slots, rounds, ops)
    for algo in ("classic", "bprr"):
        tag = f"obs retwis {algo}"
        runs = {e: launches.run(f"{tag} {e}", e, algo, rounds,
                                lambda e=e: simulate_store(
                                    algo, lat, topo, spec, rounds, engine=e,
                                    **both), objects)
                for e in ("reference", "fused", "mega")}
        for o in range(objects):
            single = launches.run(
                f"{tag} object {o}", "mega", algo, rounds,
                lambda o=o: simulate(
                    algo, lat, topo, W.versioned_slot_cell_op(counts, o,
                                                              slots),
                    rounds, engine="mega", **both))
            for e, r in runs.items():
                check(same_obs(r.object_result(o), single),
                      f"{tag} {e}: object {o} differs from its single run")
        out["cells"] += 3 * objects
        del runs

    nodes, objects, slots, active, quiet, ops = RETWIS_PAPER
    total = active + quiet
    topo = topology.partial_mesh(nodes, 4)
    lat, spec, _ = retwis_store(1.0, nodes, objects, slots, active, ops)
    plane = objects * nodes * slots * 4
    b_ms = ms_bound(13 * plane)
    rows, res = [], {}
    for mode, kw in (("off", {}), ("telemetry",
                                   {"telemetry": TelemetrySpec()})):
        tag = f"obs retwis paper bprr mega {mode}"
        r, ms, peak = scale_run(
            launches, tag, "mega", "bprr", total,
            lambda a=active, q=quiet, kw=kw: simulate_store(
                "bprr", lat, topo, spec, a, q, engine="mega",
                object_metrics=False, **kw), objects, runs=3)
        rows.append(scale_row("retwis_mesh50_30k_s64_obs_" + mode, topo.name,
                              "bprr", "mega", ms, b_ms, peak, r, runs=3))
        print_scale(tag, ms, b_ms, peak, r, runs=3)
        res[mode] = r
    ckdir = REPO / "build" / "obs_ckpt"
    shutil.rmtree(ckdir, ignore_errors=True)
    half = total // 2

    class KeepHalf(Checkpointer):
        """Writes only the bundle the resume reads."""

        def save(self, step, state, extra=None):
            return super().save(step, state, extra) if step == half else ""

    tele = {"telemetry": TelemetrySpec()}
    t0 = time.perf_counter()
    chunked = launches.run(
        "obs retwis paper checkpointed", "mega", "bprr", total,
        lambda: simulate_store("bprr", lat, topo, spec, active, quiet,
                               engine="mega", object_metrics=False,
                               chunk_rounds=half, checkpoint=KeepHalf(ckdir),
                               **tele), objects)
    ck_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    resumed = launches.run(
        "obs retwis paper resumed", "mega", "bprr", total - half,
        lambda: resume_store("bprr", lat, topo, spec, active, quiet,
                             checkpoint=KeepHalf(ckdir), step=half,
                             engine="mega", object_metrics=False, **tele),
        objects)
    resume_s = time.perf_counter() - t0
    shutil.rmtree(ckdir, ignore_errors=True)
    base = res["telemetry"]
    for tag, r in (("chunked", chunked), ("resumed", resumed)):
        check(same_obs(base.sim, r.sim), f"obs retwis paper: the {tag} "
                                         f"run differs")
    check(same_run(res["off"].sim, base.sim),
          "obs retwis paper: telemetry changed the run")
    check(base.telemetry.recv_elems.shape == (1, total, nodes)
          and base.telemetry.recv_elems.dtype == np.int64,
          "obs retwis paper: the partials are not [1, T, N] int64")
    print(f"obs retwis paper: checkpointed run {ck_s:.1f} s, resume from "
          f"round {half} {resume_s:.1f} s", flush=True)
    out.update(rows=rows, checkpointed_s=ck_s, resume_s=resume_s)
    return out


def obs_phase(check, launches, log):
    """Phase 8, observability and the Scuttlebutt baseline: parts (a)-(e)
    above, each part's seconds printed. Returns the phase's trace: a span
    a part, the counter tracks of classic and bprr under loss and 128
    element lineages of classic on the tree."""
    from repro_torch.obs import TraceLog

    trace = TraceLog()
    oracles = Oracles(check)
    part_s, oracle_s, out = {}, {}, {}

    def part(name, fn, *args):
        t0, o0 = time.perf_counter(), oracles.seconds
        with trace.span(name):
            r = fn(*args)
        part_s[name] = time.perf_counter() - t0
        oracle_s[name] = oracles.seconds - o0
        print(f"  obs part {name}: {part_s[name]:.1f} s (oracles "
              f"{oracle_s[name]:.1f} s)", flush=True)
        return r

    out["fig_telemetry"] = part("a_fig_telemetry", obs_fig_telemetry, check,
                                launches, trace, oracles)
    out["fig_provenance"] = part("b_fig_provenance", obs_fig_provenance,
                                 check, launches, trace, oracles)
    rows, bprr_final = part("c_scale", obs_scale, check, launches, oracles)
    out["scuttlebutt"] = part("d_scuttlebutt", obs_scuttlebutt, check,
                              bprr_final)
    del bprr_final
    out["batched"] = part("e_batched", obs_batched, check, launches)
    check(len(trace.events) > 128, f"obs trace: {len(trace.events)} events")
    check(oracles.calls == 55, f"obs oracles: {oracles.calls} calls, "
                                 f"expected 55")
    out.update(scale=rows, part_s=part_s, oracle_s=oracle_s,
               oracle_calls=oracles.calls, trace_events=len(trace.events))
    log["obs"] = out
    return trace


# -- phase 9: the gossip runtime, padding and shards ---------------------------

# The 256-node control plane: the 16 x 16 production mesh
# (src/repro/launch/mesh.py:23), node slots for its two-pod mesh (512), and
# DataConfig.num_shards (1,024) ledger shards and registry buckets; 8 nodes
# (ids 7 + 32k) down in rounds 6-16 under 3% loss (seed 11)
FLEET_256 = dict(nodes=256, max_nodes=512,
                 dead=tuple(7 + 32 * k for k in range(8)), registry=1024,
                 ledger=1024, drain=None)
# the JAX example's numbers (examples/elastic_churn.py)
CHURN_EXPECT = {"detected": {7: 10}, "plans": [(10, (7,), 11)],
                "bootstrap": [78], "latest_step": 19, "progress": 142_336,
                "rx_novel": 5_815, "rx_redundant": 13_316}
FLEET_KEYS = ("detected", "plans", "bootstrap", "latest_step", "progress",
              "rx_novel", "rx_redundant", "sent_elements", "converged",
              "drain_rounds", "up_node_rounds")


def same_fleet(a, b) -> bool:
    """Two fleet runs agree in every count and every final state."""
    import numpy as np

    return all(a[k] == b[k] for k in FLEET_KEYS) and \
        a["final"].keys() == b["final"].keys() and all(
            np.array_equal(a["final"][s], b["final"][s]) for s in a["final"])


def runtime_churn(check, log):
    """(a) The elastic-churn example on the card, equal to its CPU run in
    this process and to the JAX example's numbers."""
    from repro_torch.elastic_churn import Fleet, run

    card = run(Fleet(), "cuda", verbose=False)
    cpu = run(Fleet(), "cpu", verbose=False)
    check(same_fleet(card, cpu), "elastic churn: the card differs from the "
                                 "CPU")
    got = {k: card[k] for k in CHURN_EXPECT}
    check(got == CHURN_EXPECT, f"elastic churn: {got} vs {CHURN_EXPECT}")
    print(f"elastic churn: suspected at round {card['detected']}, plan "
          f"{card['plans']}, bootstrap {card['bootstrap']}, checkpoint "
          f"{card['latest_step']}, progress {card['progress']:,}, "
          f"{card['rx_novel']:,} novel / {card['rx_redundant']:,} redundant; "
          f"{card['s_per_round']:.4f} s/round on the card, "
          f"{cpu['s_per_round']:.4f} on the CPU", flush=True)
    log["churn"] = {k: card[k] for k in ("s_per_round", "seconds")} | {
        "cpu_s_per_round": cpu["s_per_round"]}


def runtime_fleet(check, log):
    """(b) The 256-node control plane (membership, heartbeats, a progress
    GCounter, the checkpoint registry and a shard ledger) for 24 rounds of
    churn and loss, then a fault-free drain until every store converged;
    on the card, and on the CPU at the same time in a worker process.
    Equal value for value; 256 members, progress 512 x the up node-rounds,
    the newest checkpoint 19."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    from repro_torch.elastic_churn import ROUNDS, TOKENS, Fleet, run

    fleet = Fleet(**FLEET_256)
    with ProcessPoolExecutor(1, mp_context=mp.get_context("spawn")) as ex:
        fut = ex.submit(run, fleet, "cpu", False)
        card = run(fleet, "cuda", verbose=False)
        cpu = fut.result()
    check(same_fleet(card, cpu), "fleet 256: the card differs from the CPU")
    members = card["final"]["members"].sum(axis=1)
    check(bool((members == fleet.nodes).all()),
          f"fleet 256: member counts {sorted(set(members.tolist()))}")
    check(card["progress"] == TOKENS * card["up_node_rounds"],
          f"fleet 256: progress {card['progress']} vs "
          f"{TOKENS} x {card['up_node_rounds']} up node-rounds")
    check(card["latest_step"] == 19, f"fleet 256: newest checkpoint "
                                     f"{card['latest_step']}")
    check(all(card["converged"].values()), f"fleet 256: {card['converged']}")
    claimed = int((card["final"]["ledger"][0] > 0).sum())
    drained = card["drain_rounds"]
    print(f"fleet 256: {ROUNDS + drained} rounds ({drained} to "
          f"drain), detections {card['detected']}, plans "
          f"{card['plans']}, bootstraps {card['bootstrap']}, progress "
          f"{card['progress']:,}, {claimed} shards claimed, "
          f"{card['rx_novel']:,} novel / {card['rx_redundant']:,} redundant, "
          f"{card['sent_elements']:,} sent; {card['s_per_round']:.4f} s/round "
          f"on the card, {cpu['s_per_round']:.4f} on the CPU", flush=True)
    log["fleet_256"] = {
        k: card[k] for k in ("s_per_round", "seconds", "drain_rounds",
                             "rx_novel", "rx_redundant", "sent_elements",
                             "progress")} | {
        "cpu_s_per_round": cpu["s_per_round"], "cpu_seconds": cpu["seconds"],
        "detected": {str(k): v for k, v in card["detected"].items()},
        "plans": card["plans"], "claimed": claimed}


def shard_committed(check, launches, log):
    """(c) The committed Retwis store (mesh16 d4, 96 objects, 32 slots, 40
    rounds, bprr) on each engine: ``pad_to=5`` (100 objects), five blocks
    on the card (``["cuda:0"] * 5``: 100 objects in blocks of 20) and
    ``shard=True`` over the card (one block, the unsharded run's launches)
    all equal to the unpadded run."""
    from repro_torch import kernels
    from repro_torch.sync import ENGINES, simulate_store, topology

    nodes, objects, slots, rounds, ops = 16, 96, 32, 40, 6
    topo = topology.partial_mesh(nodes, 4)
    lat, spec, _ = retwis_store(1.0, nodes, objects, slots, rounds, ops)

    def store(**kw):
        return simulate_store("bprr", lat, topo, spec, rounds, **kw)

    for engine in ENGINES:
        tag = f"retwis committed {engine}"
        before = kernels.launch_counts()
        base = launches.run(tag, engine, "bprr", rounds,
                            lambda: store(engine=engine), objects)
        mid = kernels.launch_counts()
        one = launches.run(f"{tag} shard=True", engine, "bprr", rounds,
                           lambda: store(engine=engine, shard=True,
                                         device="cuda"), objects)
        after = kernels.launch_counts()
        check({k: mid[k] - before[k] for k in mid}
              == {k: after[k] - mid[k] for k in mid},
              f"{tag}: shard=True on one card launched other kernels")
        check(same_run(base, one), f"{tag}: shard=True differs")
        padded = launches.run(f"{tag} pad_to=5", engine, "bprr", rounds,
                              lambda: store(engine=engine, pad_to=5), 100)
        check(same_run(base, padded), f"{tag}: pad_to=5 differs")
        five = launches.run(f"{tag} 5 blocks", engine, "bprr", rounds,
                            lambda: store(engine=engine, shard=True,
                                          device=["cuda:0"] * 5), 20, 5)
        check(same_run(base, five), f"{tag}: five blocks differ")
        check(five.final_x.shape[0] == objects and
              five.final_x.device.type == "cuda",
              f"{tag}: five blocks' final states {tuple(five.final_x.shape)}"
              f" on {five.final_x.device}")
    print("retwis committed: pad_to=5, 5 blocks and shard=True equal the "
          "unpadded run on 3 engines", flush=True)


def shard_paper(check, launches, log, kept):
    """(c) The paper-setting Retwis store (mesh50, 30,000 objects, 64
    slots, bprr, ``mega``) in four blocks of 7,500 on the card with
    ``object_metrics=False``: its [4, T] partials equal phase 6's
    per-object run reduced over each block; ms per round beside phase 6's
    unsharded run (3 runs after a one-round warm-up) and a profile of 3
    rounds."""
    import numpy as np

    from repro_torch.sync import simulate_store, topology

    nodes, objects, slots, active, quiet, ops = RETWIS_PAPER
    topo = topology.partial_mesh(nodes, 4)
    lat, spec, _ = retwis_store(1.0, nodes, objects, slots, active, ops)
    tag = "retwis paper bprr mega 4 blocks"
    r, ms, peak = scale_run(
        launches, tag, "mega", "bprr", active + quiet,
        lambda a=active, q=quiet: simulate_store(
            "bprr", lat, topo, spec, a, q, engine="mega", shard=True,
            device=["cuda:0"] * 4, object_metrics=False),
        objects // 4, runs=3, blocks=4)
    if not check(bool(kept), f"{tag}: phase 6 kept no per-object run"):
        return
    ok = r.sim.tx.shape == (4, active + quiet)
    for f, a in kept["metrics"].items():
        blocks = a.reshape(4, objects // 4, -1)
        want = blocks.max(1) if f == "max_mem_node" else blocks.sum(1)
        ok &= np.array_equal(getattr(r.sim, f), want)
    check(ok, f"{tag}: the [4, T] partials differ from phase 6's per-object "
              f"run summed by block")
    med, lo, hi = ms
    print(f"{tag}: {med:.3f} ms/round (median of 3, {lo:.3f}-{hi:.3f}) "
          f"against {kept['ms']:.3f} unsharded (phase 6); peak "
          f"{peak / 2**30:.2f} GiB", flush=True)
    del r
    prof = profile_rounds(check, tag, lambda: launches.run(
        f"{tag} profile", "mega", "bprr", 3, lambda: simulate_store(
            "bprr", lat, topo, spec, 3, 0, engine="mega", shard=True,
            device=["cuda:0"] * 4, object_metrics=False), objects // 4, 4))
    log["retwis_paper_4_blocks"] = {"ms_per_round": med, "min": lo,
                                    "max": hi, "unsharded_ms": kept["ms"],
                                    "max_memory_allocated": peak,
                                    "profile": prof}


def sync_cards():
    """Wait for every card (``torch.cuda.synchronize()`` waits for the
    current one only)."""
    import torch

    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def shard_cards(check, launches, log):
    """(c) With several cards (skipped on one): the committed Retwis store
    with ``shard=True, device="cuda"`` (one block a card) on each engine
    equal to the unpadded run, its final states gathered on card 0; the
    paper-setting store (``mega``, ``object_metrics=False``) in one block
    a card against the same blocks all on card 0: equal [k, T] partials,
    every card used, and ms per round of both (median of 3 runs after a
    one-round warm-up, every card synchronised)."""
    import numpy as np
    import torch

    from repro_torch.launch import mesh
    from repro_torch.sync import ENGINES, simulate_store, topology

    k = torch.cuda.device_count()
    if k < 2:
        print("several cards: one card visible, part skipped", flush=True)
        return
    nodes, objects, slots, rounds, ops = 16, 96, 32, 40, 6
    topo = topology.partial_mesh(nodes, 4)
    lat, spec, _ = retwis_store(1.0, nodes, objects, slots, rounds, ops)
    per = mesh.padded_size(objects, k) // k
    for engine in ENGINES:
        tag = f"retwis committed {engine} {k} cards"
        base = launches.run(f"{tag} unsharded", engine, "bprr", rounds,
                            lambda: simulate_store("bprr", lat, topo, spec,
                                                   rounds, engine=engine),
                            objects)
        got = launches.run(tag, engine, "bprr", rounds,
                           lambda: simulate_store(
                               "bprr", lat, topo, spec, rounds,
                               engine=engine, shard=True, device="cuda"),
                           per, k)
        check(same_run(base, got), f"{tag}: differs from the unsharded run")
        check(got.final_x.device == torch.device("cuda", 0),
              f"{tag}: final states on {got.final_x.device}")

    nodes, objects, slots, active, quiet, ops = RETWIS_PAPER
    topo = topology.partial_mesh(nodes, 4)
    lat, spec, _ = retwis_store(1.0, nodes, objects, slots, active, ops)
    per = mesh.padded_size(objects, k) // k
    total = active + quiet
    out = {"cards": k}
    runs = {}
    for name, devs in (("card 0", ["cuda:0"] * k), ("cards", "cuda")):
        tag = f"retwis paper bprr mega {k} blocks on {name}"

        def run(a=active, q=quiet, devs=devs):
            return simulate_store("bprr", lat, topo, spec, a, q,
                                  engine="mega", shard=True, device=devs,
                                  object_metrics=False)

        launches.run(f"{tag} warm-up", "mega", "bprr", 1,
                     lambda: run(1, 0), per, k)
        gc.collect()
        sync_cards()
        for i in range(k):
            torch.cuda.reset_peak_memory_stats(i)
        times, r = [], None
        for _ in range(3):
            r = None
            t0 = time.perf_counter()
            r = launches.run(tag, "mega", "bprr", total, run, per, k)
            sync_cards()
            times.append((time.perf_counter() - t0) * 1e3 / total)
        peaks = [torch.cuda.max_memory_allocated(i) for i in range(k)]
        runs[name] = r.sim
        med = statistics.median(times)
        out[name] = {"ms_per_round": med, "min": min(times),
                     "max": max(times), "max_memory_allocated": peaks}
        print(f"{tag}: {med:.3f} ms/round (median of 3, {min(times):.3f}-"
              f"{max(times):.3f}); peak GiB by card "
              f"{[round(b / 2**30, 2) for b in peaks]}", flush=True)
        if name == "cards":
            check(all(b > 0 for b in peaks),
                  f"{tag}: a card held nothing: {peaks}")
        del r
    check(runs["cards"].tx.shape == (k, total) and all(
        np.array_equal(getattr(runs["cards"], f), getattr(runs["card 0"], f))
        for f in ("tx", "mem", "cpu", "max_mem_node")),
        f"retwis paper {k} cards: the [k, T] partials differ from the "
        f"same blocks on card 0")
    out["speedup"] = out["card 0"]["ms_per_round"] / \
        out["cards"]["ms_per_round"]
    print(f"retwis paper {k} blocks: {out['speedup']:.3f}x faster on {k} "
          f"cards than on card 0", flush=True)
    log["retwis_several_cards"] = out


def timed_parts(log, parts):
    """Run ``(name, fn, args)`` parts, each one's seconds printed and kept
    under ``log["phase9_s"]``."""
    secs = log.setdefault("phase9_s", {})
    for name, fn, args in parts:
        t = time.perf_counter()
        fn(*args)
        secs[name] = time.perf_counter() - t
        print(f"phase 9 {name}: {secs[name]:.1f} s", flush=True)


def runtime_phase(check, log):
    """Phase 9 (a) elastic churn and (b) the 256-node control plane. The
    runtime is host-bound and launches no kernel; the smoke runs it before
    any ``torch.profiler`` window, so that no profiler state stays behind
    in the launches it times (:func:`launch_probe`)."""
    from repro_torch import kernels

    before = kernels.launch_counts()
    timed_parts(log, (("a_churn", runtime_churn, (check, log)),
                      ("b_fleet_256", runtime_fleet, (check, log))))
    check(kernels.launch_counts() == before,
          "phase 9: the runtime launched a kernel")


def shard_phase(check, launches, log, kept):
    """Phase 9 (c): padding and shards on the card."""
    timed_parts(log, (("c_committed", shard_committed,
                       (check, launches, log)),
                      ("c_paper", shard_paper,
                       (check, launches, log, kept)),
                      ("c_cards", shard_cards, (check, launches, log))))


def launch_probe(tag, log):
    """The host's cost of one small PyTorch launch, and of a launch
    followed by a device read (µs, mean of 20,000 and 5,000): what bounds
    the runtime's rounds. Probed before any profiler window and after the
    last one."""
    import torch

    x = torch.zeros(512, dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20000):
        y = torch.maximum(x, x)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(5000):
        int(y.sum())
    t2 = time.perf_counter()
    out = {"launch_us": (t1 - t0) / 20000 * 1e6,
           "launch_read_us": (t2 - t1) / 5000 * 1e6}
    log.setdefault("launch_probe", {})[tag] = out
    print(f"launch probe {tag}: {out['launch_us']:.2f} µs a launch, "
          f"{out['launch_read_us']:.2f} µs a reduction read back",
          flush=True)


# -- phase 11: the model side's server (plain PyTorch, no sync kernel) ----------

BF16_FLOPS_PER_S = 989e12        # H100 SXM dense bf16 (NVIDIA data sheet)
# The oracles hold two evaluations of the same logits: (i) the last step
# of a decode teacher-forced with the generated tokens against a re-prefill
# of prompt + generated tokens; (ii) the card against the card machine's
# CPU (same weights, copied, and inputs). Each is held twice, in the form
# of the JAX package's tests/test_model_correctness.py::
# test_decode_matches_prefill (allclose, rtol = atol = 0.15):
# - with the weights upcast to float32 on both sides (caches keep the JAX
#   layout's bf16 fields), at 0.15: the sharp check;
# - as served, in bf16, at rtol 0.15 and atol 0.15 or, where the
#   reference's own bf16 rounding noise is larger, twice that noise: the
#   largest distance between the reference's bf16 logits and its float32
#   twin's on the same inputs — for (i) the re-prefill's, for (ii) the
#   CPU's, never the output under test. Two bf16 evaluations that sum in
#   other orders (cuBLAS against oneDNN, one token against 2,080) each lie
#   about that far from the float32 value, so they can lie twice as far
#   apart (the triangle inequality). A deep random-weight stack amplifies
#   rounding: rwkv6-1.6b's 24 layers carry ~1 logit of bf16 noise against
#   their float32 twin, and the JAX package's own bf16 gap between decode
#   and re-prefill grows with depth as the port's does
#   (tests/test_torch_serve_gap.py, PERF.md §6).
# Every comparison must also reject planted faults of the output under
# test (zeroed, negated, shifted by one along the vocabulary): a tolerance
# that would pass them fails the run.
ORACLE_TOL = 0.15
# an MoE token may take other experts in two runs only where its k-th and
# (k+1)-th router probabilities lie within 8 bf16 epsilons of each other
ROUTE_GAP = 8 * 2.0 ** -7
# each thread's active PinnedRouting
ROUTERS = threading.local()
# request mixes: (batch, prompt, new tokens)
MIXES = {"R1": (4, 32, 16), "R2": (8, 2048, 32), "cut": (4, 512, 16)}
# (arch, cut to one pattern group, mixes)
SERVE_PLAN = (
    ("qwen3-0.6b", False, ("R1", "R2")),
    ("recurrentgemma-2b", False, ("R2",)),
    ("rwkv6-1.6b", False, ("R2",)),
    ("gemma2-27b", True, ("cut",)),
    ("qwen2.5-14b", True, ("cut",)),
    ("deepseek-coder-33b", True, ("cut",)),
    ("mixtral-8x22b", True, ("cut",)),
    ("qwen3-moe-30b-a3b", True, ("cut",)),
    ("musicgen-large", True, ("cut",)),
    ("internvl2-26b", True, ("cut",)),
)


class PinnedRouting:
    """Records each MoE call's top-k experts (``record``) and pins a later
    run to them (``replay``, in the same call order), so that two runs
    that differ only by bf16 noise route alike. A replayed token may have
    chosen other experts itself only at a near-tie (``ROUTE_GAP``);
    anything else fails ``check``. While entered it routes the calls of
    its own thread: ``repro_torch.models.moe.top_k`` is replaced, once, by
    a dispatcher to the calling thread's router (the plain ``top_k`` where
    the thread has none), so that phase 12's CPU worker and the card's
    runs can pin routes at the same time."""

    def __init__(self, check, tag):
        self.check, self.tag = check, tag
        self.calls, self.pinned, self.flips = [], None, 0

    def __enter__(self):
        from repro_torch.models import moe

        if not hasattr(moe.top_k, "plain"):
            plain = moe.top_k

            def dispatch(probs, k):
                router = getattr(ROUTERS, "active", None)
                return (plain(probs, k) if router is None
                        else router._top_k(probs, k))

            dispatch.plain = plain
            moe.top_k = dispatch
        self._real = moe.top_k.plain
        self._outer = getattr(ROUTERS, "active", None)
        ROUTERS.active = self
        return self

    def __exit__(self, *exc):
        ROUTERS.active = self._outer

    def replay(self, calls):
        self.pinned = list(calls)

    def _top_k(self, probs, k):
        import torch

        vals, idx = self._real(probs, k)
        if self.pinned is None:
            self.calls.append(idx)
            return vals, idx
        want = self.pinned.pop(0).to(idx.device)
        top = torch.sort(probs, dim=-1, descending=True).values
        gap = (top[..., k - 1] - top[..., k]) / top[..., k - 1]
        moved = (idx.sort(-1).values != want.sort(-1).values).any(-1)
        self.flips += int(moved.sum())
        self.check(not bool((moved & (gap > ROUTE_GAP)).any()),
                   f"{self.tag}: an MoE token changed experts with its "
                   f"router's top-k gap above {ROUTE_GAP}")
        return torch.gather(probs, -1, want), want


def drop_free(cfg):
    """An MoE config whose capacity holds every token (cap = t), so that
    no token's experts depend on the others' (oracle (i))."""
    import dataclasses

    if cfg.moe is None:
        return cfg
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=e / k))


def serve_inputs(cfg, b, total, seed, dev):
    """Seeded inputs of ``total`` positions: tokens, or frame embeddings
    (audio), or patch embeddings and tokens (vision)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    f = cfg.frontend_len if cfg.frontend == "vision" else 0
    out = {}
    if cfg.frontend is not None:
        n = total if cfg.frontend == "audio" else f
        out["embeds"] = torch.tensor(rng.normal(size=(b, n, cfg.d_model)),
                                     dtype=torch.bfloat16, device=dev)
    if cfg.frontend != "audio":
        out["tokens"] = torch.tensor(
            rng.integers(0, cfg.vocab_size, (b, total - f)),
            dtype=torch.int32, device=dev)
    return out


def prompt_and_steps(cfg, batch, p, n):
    """(the first ``p`` positions, the next ``n`` step inputs)."""
    if cfg.frontend == "audio":
        e = batch["embeds"]
        return {"embeds": e[:, :p]}, [{"embeds": e[:, p + i:p + i + 1]}
                                      for i in range(n)]
    tok = batch["tokens"]
    f = tok.shape[1] - n                    # prompt tokens (vision: p - F)
    prompt = dict(batch, tokens=tok[:, :f])
    return prompt, [{"tokens": tok[:, f + i:f + i + 1]} for i in range(n)]


def sync(dev):
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def serve_loop(cfg, model, prompt, steps, n, profiled=None):
    """Prefill ``prompt`` into a cache for ``n`` more positions, then ``n``
    decode steps fed ``steps[i]`` (or, with ``steps`` None, the greedy
    token), on the model's device. Returns (logits of every step [B,
    n + 1, V] — prefill's last position first, generated tokens [B, n],
    prefill s, decode s; host clock around a synchronised device). With
    ``profiled`` (a dict), the last 4 steps run under ``torch.profiler``
    and it receives their device-busy share and kernels a step."""
    import contextlib

    import torch

    from repro_torch.models import transformer as TT
    from repro_torch.train import steps as TS

    dev = model.embed.device
    decode = TS.make_decode(cfg)
    b = next(iter(prompt.values())).shape[0]
    p = TS._total_len(cfg, prompt)
    sync(dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        cache = TT.init_cache(cfg, b, p + n, device=dev)
        feats, cache, _ = TT.forward(cfg, model, prompt, mode="prefill",
                                     cache=cache)
        logits = [TT.lm_head(cfg, model, feats[:, -1:])]
    sync(dev)
    t1 = time.perf_counter()
    gen = []
    window = contextlib.nullcontext()
    for i in range(n):
        if profiled is not None and i == n - 4:
            sync(dev)
            window = decode_profile(profiled)
            window.__enter__()
        tok = torch.argmax(logits[-1][:, -1], dim=-1).to(torch.int32)[:, None]
        gen.append(tok)
        step = steps[i] if steps is not None else {"tokens": tok}
        lg, cache = decode(model, cache, step, p + i)
        logits.append(lg)
    sync(dev)
    window.__exit__(None, None, None)
    return (torch.cat(logits, dim=1), torch.cat(gen, dim=1), t1 - t0,
            time.perf_counter() - t1)


class decode_profile:
    """``torch.profiler`` over a window of ``steps`` steps (4 decode steps;
    the window ends after a synchronise): fills ``out`` with the wall and
    device ms, the device's busy share and the kernels launched a step, or
    ``error``."""

    def __init__(self, out, steps=4):
        self.out, self.steps = out, steps

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        # kernels only: host-side op events would multiply the trace (and
        # its processing) by the ~3,000 launches a step
        self.prof = None
        try:
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.__enter__()
        except Exception as err:  # noqa: BLE001 - becomes a failed check
            self.out["error"] = repr(err)
            return
        self.prof = prof
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        from torch.autograd import DeviceType

        if self.prof is None:
            return
        wall_ms = (time.perf_counter() - self.t0) * 1e3
        self.prof.__exit__(*exc)
        try:
            rows = [(e.self_device_time_total / 1e3, e.count)
                    for e in self.prof.key_averages()
                    if e.device_type == DeviceType.CUDA
                    and e.self_device_time_total > 0]
        except Exception as err:  # noqa: BLE001 - becomes a failed check
            self.out["error"] = repr(err)
            return
        device_ms = sum(r[0] for r in rows)
        n = self.steps
        self.out.update({f"wall_ms_{n}_steps": wall_ms,
                         f"device_ms_{n}_steps": device_ms,
                         "busy_share": device_ms / wall_ms,
                         "launches_per_step": sum(r[1] for r in rows) / n})


def float32_twin(model):
    """The model with its weights upcast to float32 (a copy)."""
    from repro_torch.models import transformer as TT
    from repro_torch.models.params import tree_map

    return TT.Decoder(model.cfg, tree_map(lambda _, t: t.float(),
                                          model.tensors()))


def held(check, tag, got, want, atol):
    """``got`` within ``allclose(rtol=ORACLE_TOL, atol=atol)`` of ``want``,
    and planted faults of ``got`` outside it (zeroed, negated, shifted by
    one along the vocabulary); returns the largest |got - want|."""
    import torch

    err = float((got - want).abs().max())
    check(torch.allclose(got, want, rtol=ORACLE_TOL, atol=atol),
          f"{tag}: differ by {err:.4f} (atol {atol:.4f}, rtol {ORACLE_TOL})")
    for name, bad in (("zeroed", torch.zeros_like(got)), ("negated", -got),
                      ("shifted", got.roll(1, -1))):
        check(not torch.allclose(bad, want, rtol=ORACLE_TOL, atol=atol),
              f"{tag}: a {name} output would pass (atol {atol:.4f})")
    return err


def hold_pair(check, tag, bf16, f32):
    """Oracle (i)'s two precisions: each ``(got, want)`` logits, ``got``
    the decode's, ``want`` the re-prefill's. float32 at ``ORACLE_TOL``;
    bf16 at atol ``ORACLE_TOL`` or twice the re-prefill's bf16 noise (its
    bf16 ``want`` against its float32 ``want``). Returns (errors, bf16
    atol)."""
    err = {"noise": float((bf16[1] - f32[1]).abs().max())}
    tol = max(ORACLE_TOL, 2 * err["noise"])
    err["f32"] = held(check, f"{tag} float32 decode vs re-prefill", *f32,
                      ORACLE_TOL)
    err["bf16"] = held(check, f"{tag} bf16 decode vs re-prefill", *bf16, tol)
    return err, tol


def active_params(cfg, model, tokens):
    """Non-embedding parameters a token uses (MoE: its top_k experts), and
    the bytes of the weights that ``tokens`` tokens can reach: every weight
    but the experts, of each MoE layer's experts min(E, tokens x top_k)
    (the most that distinct routes can touch), the head's matrix whole."""
    n_active, nbytes = 0, 0
    for layer in model.layers:
        for name, t in layer.named_parameters():
            share = 1.0
            if name.startswith("moe_"):
                e, k = cfg.moe.num_experts, cfg.moe.top_k
                share = k / e
                nbytes += t.numel() * t.element_size() \
                    * min(e, tokens * k) / e
            else:
                nbytes += t.numel() * t.element_size()
            n_active += t.numel() * share
    head = model.embed if cfg.tie_embeddings else model.lm_head
    nbytes += head.numel() * head.element_size() \
        + model.final_norm.numel() * model.final_norm.element_size()
    return n_active, nbytes


def serve_bounds(cfg, model, b, p, cache):
    """(prefill bound ms, what bounds it), decode bound ms per step, the
    prefill's FLOPs, a decode step's weight bytes, the cache bytes: the
    prefill's FLOPs — 2 x active non-embedding params x tokens, the causal
    (windowed) attention pairs' QK and PV products, the head on the last
    position — at the dense bf16 rate, or the bytes of the weights its b x
    p tokens reach at 3.35 TB/s if larger; a decode step's bytes — the
    weights its b tokens reach (``active_params``) and the whole cache,
    read once — at 3.35 TB/s."""
    n_active, pre_bytes = active_params(cfg, model, b * p)
    _, wbytes = active_params(cfg, model, b)
    flops = 2.0 * n_active * b * p + 2.0 * cfg.d_model * cfg.vocab_size * b
    for kind in cfg.layer_kinds:
        if kind in ("global", "local"):
            w = cfg.window if kind == "local" else p
            pairs = sum(min(i + 1, w) for i in range(p))
            flops += 2 * 2.0 * b * cfg.num_heads * cfg.head_dim * pairs
    cbytes = sum(t.numel() * t.element_size() for c in cache
                 for t in c.values())
    f_ms = flops / BF16_FLOPS_PER_S * 1e3
    b_ms = pre_bytes / HBM_BYTES_PER_S * 1e3
    pre = (f_ms, "operations") if f_ms >= b_ms else (b_ms, "bytes")
    return pre, (wbytes + cbytes) / HBM_BYTES_PER_S * 1e3, flops, wbytes, \
        cbytes


def serve_mix(check, smi, arch, cfg, model, mix, dev):
    """One request mix: the timed run (``generate`` for text, the same
    greedy loop through ``forward`` for the frontends, audio fed the next
    frames), after a warm-up run; its bounds and decode profile; oracles
    (i) and (iii). The float32 twin of (i) is made after the timed run,
    so that the peak is the server's alone."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.launch import serve
    from repro_torch.models import transformer as TT

    tag = f"{arch} {mix}"
    b, p, n = MIXES[mix]
    cuda = torch.device(dev).type == "cuda"
    t_run = time.perf_counter()
    if cfg.frontend is None:
        sr = serve.ServeRun(cfg, batch=b, prompt_len=p, max_new_tokens=n)
        serve.generate(sr, params=model, device=dev)       # warm-up
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        gen, stats = serve.generate(sr, params=model, device=dev)
        prompt = {"tokens": torch.as_tensor(np.random.default_rng(
            sr.seed).integers(0, cfg.vocab_size, (b, p)), dtype=torch.int32,
            device=dev)}
        steps = [{"tokens": gen[:, i:i + 1]} for i in range(n)]
        full = {"tokens": torch.cat([prompt["tokens"], gen], dim=1)}
    else:
        batch = serve_inputs(cfg, b, p + n, 0, dev)
        prompt, steps = prompt_and_steps(cfg, batch, p, n)
        fed = steps if cfg.frontend == "audio" else None
        serve_loop(cfg, model, prompt, fed, n)             # warm-up
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        _, gen, pre_s, dec_s = serve_loop(cfg, model, prompt, fed, n)
        stats = {"prefill_s": pre_s, "decode_s": dec_s,
                 "tokens_per_s": b * n / dec_s}
        if cfg.frontend == "vision":
            steps = [{"tokens": gen[:, i:i + 1]} for i in range(n)]
            full = dict(prompt, tokens=torch.cat([prompt["tokens"], gen], 1))
        else:
            full = batch
    peak = torch.cuda.max_memory_allocated() if cuda else float("nan")
    t_run = time.perf_counter() - t_run
    check(bool(((gen >= 0) & (gen < cfg.vocab_size)).all()),
          f"{tag}: a token outside [0, {cfg.vocab_size})")

    # (i) teacher-forced decode == re-prefill of prompt + generated tokens,
    # MoE at a drop-free capacity with the re-prefill pinned to the
    # decode's routing; in bf16 and float32
    t_i = time.perf_counter()
    cfg_o = drop_free(cfg)
    total = p + n
    chunk = max(c for c in range(1, cfg.attn_q_chunk + 1) if total % c == 0)
    cfg_r = dataclasses.replace(cfg_o, attn_q_chunk=chunk,
                                attn_kv_chunk=chunk)
    m = sum(1 for k in cfg.layer_kinds if k != "rwkv")
    res, prof = {}, {}
    twin = float32_twin(model)
    with PinnedRouting(check, f"{tag} (i)") as route:
        for prec, mod in (("bf16", model), ("f32", twin)):
            if prec == "f32":          # route as the bf16 run did
                route.replay(decode_routes + prefill_routes)
            logits, _, _, _ = serve_loop(
                cfg_o, mod, prompt, steps, n,
                profiled=prof if prec == "bf16" else None)
            if prec == "bf16":
                decode_routes = list(route.calls)
                prefill_routes = [torch.cat(
                    [decode_routes[l]] + [decode_routes[m * (1 + j) + l]
                                          for j in range(n)], 1)
                    for l in range(m)] if cfg.moe is not None else []
                route.replay(prefill_routes)
            with torch.no_grad():
                feats, _ = TT.forward(cfg_r, mod, full, mode="train")
                want = TT.lm_head(cfg_r, mod, feats[:, -1:])
            check(bool(torch.isfinite(logits.float()).all())
                  and bool(torch.isfinite(want.float()).all()),
                  f"{tag} (i) {prec}: a logit is not finite")
            res[prec] = (logits[:, -1:].float(), want.float())
    del twin
    check("error" not in prof and prof.get("device_ms_4_steps", 0) > 0,
          f"serve profile {tag}: {prof.get('error', 'no device time')}")
    err, tol = hold_pair(check, f"{tag} (i)", res["bf16"], res["f32"])
    t_i = time.perf_counter() - t_i

    (pre_b, pre_by), dec_b, flops, wbytes, cbytes = serve_bounds(
        cfg, model, b, p, TT.init_cache(cfg, b, p + n, device="meta"))
    out = {"batch": b, "prompt": p, "new_tokens": n, **stats,
           "prefill_ms": stats["prefill_s"] * 1e3,
           "decode_ms_per_step": stats["decode_s"] / n * 1e3,
           "prefill_bound_ms": pre_b, "prefill_bound_by": pre_by,
           "prefill_flops": flops, "decode_weight_bytes": wbytes,
           "cache_bytes": cbytes, "decode_bound_ms_per_step": dec_b,
           "peak_gib": peak / 2 ** 30, "decode_vs_prefill": err,
           "bf16_tolerance_i": tol,
           "moe_route_flips_i": route.flips, "profile": prof,
           "seconds": {"run": t_run, "oracle_i": t_i},
           "nvidia_smi": smi}
    print(f"serve {tag}: B={b} prompt {p} +{n}: prefill "
          f"{out['prefill_ms']:.2f} ms (bound {pre_b:.3f} ms, {pre_by}); "
          f"decode {out['decode_ms_per_step']:.3f} ms/step (byte bound "
          f"{dec_b:.3f}); {stats['tokens_per_s']:.1f} tok/s; peak "
          f"{out['peak_gib']:.2f} GiB; 4 decode steps busy "
          f"{prof.get('busy_share', float('nan')):.1%}, "
          f"{prof.get('launches_per_step', float('nan')):.0f} launches a "
          f"step; (i) decode vs re-prefill bf16 {err['bf16']:.4f} "
          f"(atol {tol:.4f}: the re-prefill's bf16 noise "
          f"{err['noise']:.4f}), float32 "
          f"{err['f32']:.4f}; s: run {t_run:.1f}, (i) {t_i:.1f} [{smi}]",
          flush=True)
    return out


def serve_card_cpu(check, smi, arch, cfg, model, dev):
    """(ii) the card against the card machine's CPU: batch 2, prompt 32
    (after the patch positions of a vision config), 4 teacher-forced steps,
    the weights copied to the CPU, in bf16 and as float32 twins on both
    sides, MoE routing pinned to the card's bf16 run (near-ties
    excepted)."""
    import torch

    f = cfg.frontend_len if cfg.frontend == "vision" else 0
    batch = serve_inputs(cfg, 2, f + 36, 1, "cpu")
    prompt, steps = prompt_and_steps(cfg, batch, f + 32, 4)

    def on(d, x):
        return {k: v.to(d) for k, v in x.items()}

    with PinnedRouting(check, f"{arch} (ii)") as route:
        card, _, _, _ = serve_loop(cfg, model, on(dev, prompt),
                                   [on(dev, s) for s in steps], 4)
        route.replay(route.calls)
        twin = float32_twin(model)
        card32, _, _, _ = serve_loop(cfg, twin, on(dev, prompt),
                                     [on(dev, s) for s in steps], 4)
        del twin
        route.replay(route.calls)
        cpu_model = model.copy_to("cpu")
        t0 = time.perf_counter()
        cpu, _, _, _ = serve_loop(cfg, cpu_model, prompt, steps, 4)
        route.replay(route.calls)
        cpu32, _, _, _ = serve_loop(cfg, float32_twin(cpu_model), prompt,
                                    steps, 4)
        cpu_s = time.perf_counter() - t0
        del cpu_model
    card, card32 = card.float().cpu(), card32.float().cpu()
    cpu, cpu32 = cpu.float(), cpu32.float()
    check(bool(torch.isfinite(card).all())
          and bool(torch.isfinite(card32).all()),
          f"{arch} (ii): a card logit is not finite")
    noise = float((cpu - cpu32).abs().max())
    tol = max(ORACLE_TOL, 2 * noise)
    err32 = held(check, f"{arch} (ii) float32 card vs CPU", card32, cpu32,
                 ORACLE_TOL)
    err = held(check, f"{arch} (ii) bf16 card vs CPU", card, cpu, tol)
    card_noise = float((card - card32).abs().max())
    print(f"serve {arch} (ii): card = CPU within {err32:.4f} in float32 "
          f"(tolerance {ORACLE_TOL}), {err:.4f} in bf16 (atol {tol:.4f}: "
          f"the CPU's bf16 noise {noise:.4f}; the card's {card_noise:.4f}); "
          f"{route.flips} MoE near-tie routes pinned; CPU {cpu_s:.1f} s "
          f"[{smi}]", flush=True)
    return {"card_cpu": err, "card_cpu_f32": err32, "cpu_bf16_noise": noise,
            "card_bf16_noise": card_noise, "bf16_tolerance_ii": tol,
            "moe_route_flips_ii": route.flips, "cpu_s": cpu_s}


def serve_phase(check, log, smi, dev):
    """Phase 11: every architecture through the server at its full width
    (``SERVE_PLAN``: whole, or one pattern group deep), each request mix
    timed against its bounds and held to oracles (i)–(iii); weights from
    seed 0 drawn on the card. Launches no sync kernel (oracle (iv), read by
    ``main``)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as TT

    out = {}
    for arch, cut, mixes in SERVE_PLAN:
        t0 = time.perf_counter()
        full = get_config(arch)
        cfg = dataclasses.replace(full, num_layers=full.pattern_len) \
            if cut else full
        model = TT.init_params(cfg, seed=0, device=dev)
        row = {"layers": cfg.num_layers, "of_layers": full.num_layers}
        for mix in mixes:
            row[mix] = serve_mix(check, smi, arch, cfg, model, mix, dev)
        row.update(serve_card_cpu(check, smi, arch, cfg, model, dev))
        del model
        gc.collect()
        if torch.device(dev).type == "cuda":
            torch.cuda.empty_cache()
        row["seconds"] = time.perf_counter() - t0
        print(f"serve {arch}: {cfg.num_layers} of {full.num_layers} layers, "
              f"{row['seconds']:.1f} s", flush=True)
        out[arch] = row
    log["serve"] = out


# -- phase 12: the model side's trainer (plain PyTorch, no sync kernel) ---------

# (a) qwen3-0.6b whole at the registry's train_4k length; the global batch
# cut from 256 to what one card holds in the phase's time
TRAIN_WHOLE = ("qwen3-0.6b", 4, 4096)
TRAIN_TIMED = 3                  # timed steps after the warm-up step
# (b) every architecture one pattern group deep: batch 2, 32 positions
# (phase 11 (ii)'s short prompt; a vision config's 256 patches come first)
TRAIN_SHORT = (2, 32)
# float32, card against CPU: reduction order only. Each leaf is held at
# rtol 1e-3 and atol 1e-3 of its largest entry; params after one AdamW
# step at atol = rtol = 1e-4 except where the clipped gradient is below
# 1e-6 (Adam's first step ĝ/(|ĝ| + ε) turns on ε there; held within 2·lr)
TRAIN_F32_TOL = 1e-3
TRAIN_LR = 1e-3
# the float32 AdamW part of (b) runs where its 7 float32 copies on the CPU
# (the twin, its gradients, zero moments, the new master and moments) fit
# in 12 GiB: the CPU's elementwise passes over them take ~4.5 s a GiB of
# float32 weights on the H100 machine's 8 cores (deepseek-coder-33b's 3.7
# GiB: 17.6 s), beyond the phase's time. It runs for qwen3-0.6b, rwkv6-1.6b and musicgen-large;
# AdamW itself is held to the JAX package on the CPU
# (tests/test_torch_train_optim.py) and runs on the card in (a) and (c).
ADAMW_CPU_BYTES = 12 * 2 ** 30
# the CPU results of (b) that the card's halves have not used yet, at most
# (the worker thread waits beyond it; it runs ahead during (a))
TRAIN_HELD_BYTES = 32 * 2 ** 30
# the bf16 loss where twice its noise is less (one scalar is one sample
# of the rounding): 2^-10 of it. A bf16 gradient leaf is held in L2 norm:
# |card - CPU| within twice |CPU bf16 - CPU float32|, or one bf16 epsilon
# of |CPU| where that is more. Two evaluations' rounding errors are
# independent draws, so a norm over the leaf's entries estimates their
# size steadily where its largest entry does not (on an H100 80GB HBM3,
# the card's largest entry lay 2.7 times the CPU's noise away on
# recurrentgemma-2b's gate leaves).
LOSS_FLOOR = 2.0 ** -10
BF16_EPS = 2.0 ** -7


def train_flops(cfg, model, b, s):
    """A training step's FLOPs: 6 × active non-embedding params × tokens
    (forward and backward products), 3 × the causal (windowed) attention
    pairs' QK and PV FLOPs, 3 × the head's 2·d·V per token."""
    n_active, _ = active_params(cfg, model, b * s)
    flops = 6.0 * n_active * b * s + 3 * 2.0 * cfg.d_model \
        * cfg.vocab_size * b * s
    for kind in cfg.layer_kinds:
        if kind in ("global", "local"):
            w = cfg.window if kind == "local" else s
            pairs = sum(min(i + 1, w) for i in range(s))
            flops += 3 * 2 * 2.0 * b * cfg.num_heads * cfg.head_dim * pairs
    return flops


def leaves_of(tree):
    from repro_torch.optim.adamw import tree_leaves

    return tree_leaves(tree)


def train_whole(check, smi, dev):
    """(a) qwen3-0.6b whole at full width, seq 4,096, batch 4, remat
    ``"nothing"``: ``make_train_step`` at microbatches 1 and 2, each a
    warm-up step (the oracle step: ``AdamW(lr=0, weight_decay=0)``, so its
    moments hold the clipped gradients as in the JAX package's
    ``test_microbatched_grads_match``) and 3 timed steps (AdamW at lr 3e-4),
    then one profiled step at microbatches 1."""
    import math
    import statistics

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, batch_for_step
    from repro_torch.models import transformer as TT
    from repro_torch.optim import AdamW, constant
    from repro_torch.train import steps as TS

    arch, b, s = TRAIN_WHOLE
    cfg = get_config(arch)
    model = TT.init_params(cfg, seed=0, device=dev)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=s, global_batch=b,
                      seed=0)
    batches = [batch_for_step(dcfg, 0, i, device=dev)
               for i in range(TRAIN_TIMED + 2)]
    oracle = AdamW(lr=constant(0.0), weight_decay=0.0)
    optim = AdamW(lr=constant(3e-4))
    flops = train_flops(cfg, model, b, s)
    bound_ms = flops / BF16_FLOPS_PER_S * 1e3
    out = {"arch": arch, "layers": cfg.num_layers, "batch": b, "seq": s,
           "remat": cfg.remat, "flops": flops, "flop_bound_ms": bound_ms,
           "nvidia_smi": smi}
    mu1 = None
    for mb in (1, 2):
        row = {}
        torch.cuda.reset_peak_memory_stats()
        sync(dev)
        t0 = time.perf_counter()
        state, m = TS.make_train_step(cfg, oracle, microbatches=mb)(
            TS.init_train_state(cfg, oracle, model), batches[0])
        row["loss_step1"] = loss1 = float(m["loss"])
        row["warmup_s"] = time.perf_counter() - t0
        dtypes = {t.dtype for t in leaves_of(state.params.tensors())}
        want = torch.bfloat16 if mb == 1 else torch.float32
        check(dtypes == {want}, f"train {arch} mb={mb}: params {dtypes} "
                                f"after a step, the reference gives {want}")
        check(math.isfinite(loss1)
              and abs(loss1 - math.log(cfg.vocab_size)) < 1.0,
              f"train {arch} mb={mb}: step-1 loss {loss1} not within 1 of "
              f"ln V = {math.log(cfg.vocab_size):.3f}")
        if mb == 1:
            mu1, loss_mb1 = leaves_of(state.opt.mu), loss1
        else:
            err = max(float((a - c).abs().max())
                      for a, c in zip(leaves_of(state.opt.mu), mu1))
            scale = max(float(t.abs().max()) for t in mu1)
            row["mu_vs_mb1"] = err
            row["loss_vs_mb1"] = abs(loss1 - loss_mb1) / abs(loss_mb1)
            check(row["loss_vs_mb1"] <= 5e-3,
                  f"train {arch}: microbatched loss {loss1} vs {loss_mb1}")
            check(err < 5e-2, f"train {arch}: microbatched first moments "
                              f"differ by {err} (largest {scale})")
            row["mu_largest"] = scale
            del mu1
        step = TS.make_train_step(cfg, optim, microbatches=mb)
        times, losses = [], []
        for i in range(TRAIN_TIMED):
            sync(dev)
            t0 = time.perf_counter()
            state, m = step(state, batches[1 + i])
            losses.append(float(m["loss"]))
            sync(dev)
            times.append(time.perf_counter() - t0)
        check(all(math.isfinite(x) for x in losses),
              f"train {arch} mb={mb}: a loss is not finite: {losses}")
        row["ms_per_step"] = statistics.median(times) * 1e3
        row["ms_all"] = [t * 1e3 for t in times]
        row["tokens_per_s"] = b * s / statistics.median(times)
        row["losses"] = [loss1] + losses
        if mb == 1:
            prof = {}
            sync(dev)
            t0 = time.perf_counter()
            with decode_profile(prof, steps=1):
                state, m = step(state, batches[-1])
                float(m["loss"])
                sync(dev)
            prof["seconds"] = time.perf_counter() - t0
            check("error" not in prof and prof.get("device_ms_1_steps", 0) > 0,
                  f"train profile {arch}: {prof.get('error', 'no device time')}")
            row["profile"] = prof
        row["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        del state, m
        gc.collect()
        torch.cuda.empty_cache()
        out[f"mb{mb}"] = row
        p = row.get("profile", {})
        print(f"train {arch} B={b} S={s} microbatches {mb}: "
              f"{row['ms_per_step']:.1f} ms/step (median of {TRAIN_TIMED}: "
              f"{', '.join(f'{t:.1f}' for t in row['ms_all'])}; FLOP bound "
              f"{bound_ms:.1f} ms), {row['tokens_per_s']:.0f} tok/s, peak "
              f"{row['peak_gib']:.2f} GiB, step-1 loss {loss1:.4f} (ln V "
              f"{math.log(cfg.vocab_size):.4f}), losses "
              f"{', '.join(f'{x:.4f}' for x in row['losses'])}"
              + (f"; 1 step profiled: busy {p.get('busy_share', 0):.1%}, "
                 f"{p.get('launches_per_step', 0):.0f} kernels a step"
                 if mb == 1 else
                 f"; vs microbatches 1: loss {row['loss_vs_mb1']:.2e} "
                 f"relative, first moments {row['mu_vs_mb1']:.3e} (largest "
                 f"{row['mu_largest']:.3e})") + f" [{smi}]", flush=True)
    del model
    return out


def held_tree(check, tag, got, want, tol_of, dev):
    """Every leaf of ``got`` within ``tol_of(i, want_leaf)`` (an elementwise
    allowance) of ``want``; planted faults of the largest-norm leaf
    (zeroed, negated, shifted by one) outside it. Leaves are compared one
    at a time on ``dev`` (the card: the CPU's passes over gigabyte leaves
    took most of the phase). Returns the largest error as a share of its
    allowance."""
    import torch

    def leaf(i):
        g = got[i].detach().to(dev).float()
        w = want[i].detach().to(dev).float()
        return g, w, tol_of(i, w).clamp(min=1e-30)

    worst, big, big_norm = 0.0, 0, -1.0
    for i in range(len(want)):
        g, w, allowed = leaf(i)
        share = float(((g - w).abs() / allowed).max()) if g.numel() else 0.0
        ok = bool(torch.isfinite(g).all()) and share <= 1.0
        check(ok, f"{tag}: leaf {i} {tuple(w.shape)} off by {share:.3f} of "
                  f"its allowance")
        worst = max(worst, share)
        n = float(w.norm())
        if n > big_norm:
            big, big_norm = i, n
        del g, w, allowed
    g, w, allowed = leaf(big)
    for name, bad in (("zeroed", torch.zeros_like(g)), ("negated", -g),
                      ("shifted", g.reshape(-1).roll(1).reshape(g.shape))):
        check(not bool(((bad - w).abs() <= allowed).all()),
              f"{tag}: a {name} leaf {big} would pass")
    return worst


def held_norms(check, tag, got, want, ref32, dev):
    """bf16 leaves in L2 norm: ``|got - want|`` within ``max(2 |want -
    ref32|, BF16_EPS |want|)`` (``want`` the CPU's bf16 leaf, ``ref32`` its
    float32 one); planted faults of the largest-norm leaf (zeroed,
    negated, shifted by one) outside it. Returns the largest error as a
    share of its allowance."""
    import torch

    def leaf(i):
        g = got[i].detach().to(dev).float()
        w = want[i].detach().to(dev).float()
        noise = float((w - ref32[i].detach().to(dev)).norm())
        return g, w, max(2 * noise, BF16_EPS * float(w.norm()), 1e-30)

    worst, big, big_norm = 0.0, 0, -1.0
    for i in range(len(want)):
        g, w, allowed = leaf(i)
        share = float((g - w).norm()) / allowed
        check(bool(torch.isfinite(g).all()) and share <= 1.0,
              f"{tag}: leaf {i} {tuple(w.shape)} off by {share:.3f} of its "
              f"allowance")
        worst = max(worst, share)
        if float(w.norm()) > big_norm:
            big, big_norm = i, float(w.norm())
    g, w, allowed = leaf(big)
    for name, bad in (("zeroed", torch.zeros_like(g)), ("negated", -g),
                      ("shifted", g.reshape(-1).roll(1).reshape(g.shape))):
        check(float((bad - w).norm()) > allowed,
              f"{tag}: a {name} leaf {big} would pass")
    return worst


def train_weights(arch, dev):
    """(b)'s model: one pattern group of ``arch`` at full width, remat
    ``"none"`` (recomputation would call the router again; remat changes
    no value: ``tests/test_torch_train_step.py``), weights drawn from seed
    0 on the card and copied to the CPU. Returns (config, the full model's
    layers, the CPU model)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as TT

    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=full.pattern_len,
                              remat="none")
    return cfg, full.num_layers, TT.init_params(cfg, seed=0,
                                                device=dev).copy_to("cpu")


def train_held_bytes(nbytes, adamw):
    """What (b)'s CPU results hold until the card's half has used them:
    the bf16 model and gradients, the float32 gradients (and params)."""
    return 2 * nbytes + (nbytes if adamw else 0)


def train_cpu_half(check, arch, drawn):
    """(b), the CPU's half, on phase 12's worker thread: one step of the
    drawn model (``train_weights``) in bf16 (recording the MoE routes) and
    in float32 (pinned to them), and for small models the float32 AdamW
    update."""
    import numpy as np
    import torch

    from repro_torch.optim import AdamW, constant
    from repro_torch.train import steps as TS

    cfg, of_layers, model = drawn
    b, n = TRAIN_SHORT
    f = cfg.frontend_len if cfg.frontend == "vision" else 0
    batch = serve_inputs(cfg, b, f + n, 2, "cpu")
    rng = np.random.default_rng(3)
    batch["labels"] = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                   (b, f + n)),
                                      dtype=torch.int32)
    batch["loss_mask"] = torch.ones((b, f + n), dtype=torch.bfloat16)
    nbytes = 4 * sum(t.numel() for t in model.parameters())
    grad_fn = TS.make_grad_fn(cfg)
    t0 = time.perf_counter()
    with PinnedRouting(check, f"train {arch}") as route:
        l16, _, g16 = grad_fn(model, batch)
        route.replay(route.calls)
        with torch.no_grad():
            cpu32 = float32_twin(model)
        l32, _, g32 = grad_fn(cpu32, batch)
    out = {"cfg": cfg, "of_layers": of_layers, "batch": batch,
           "model": model, "routes": route.calls, "flips": route.flips,
           "losses": (l16.item(), l32.item()), "g16": leaves_of(g16),
           "g32": leaves_of(g32), "nbytes": nbytes, "p32": None,
           "adamw": 7 * nbytes <= ADAMW_CPU_BYTES}
    out["grads_s"] = time.perf_counter() - t0
    if out["adamw"]:
        t1 = time.perf_counter()
        optim = AdamW(lr=constant(TRAIN_LR))
        p32, _, met = optim.update(
            dict(enumerate(out["g32"])), optim.init(dict(enumerate(
                leaves_of(cpu32.tensors())))))
        out["p32"] = [p32[i] for i in range(len(out["g32"]))]
        out["scale"] = min(1.0, 1.0 / max(float(met["grad_norm"]), 1e-9))
        out["adamw_s"] = time.perf_counter() - t1
    out["cpu_s"] = time.perf_counter() - t0
    # what the result holds until the card's half has used it
    out["held_bytes"] = train_held_bytes(nbytes, out["adamw"])
    return out


def train_card_half(check, smi, arch, dev, cpu):
    """(b), the card's half: the same weights (the CPU's copy) and inputs
    on the card, the MoE routes pinned to the CPU's bf16 run (near-ties
    excepted), then every comparison, each on the card."""
    import math

    import torch

    from repro_torch.optim import AdamW, constant
    from repro_torch.train import steps as TS

    cfg = cpu["cfg"]
    t0 = time.perf_counter()
    model = cpu["model"].copy_to(dev)
    on_card = {k: v.to(dev) for k, v in cpu["batch"].items()}
    grad_fn = TS.make_grad_fn(cfg)
    optim = AdamW(lr=constant(TRAIN_LR))
    with PinnedRouting(check, f"train {arch} (card)") as route:
        route.replay(cpu["routes"])
        l16c, _, g16c = grad_fn(model, on_card)
        route.replay(cpu["routes"])
        with torch.no_grad():
            twin = float32_twin(model)
        del model
        l32c, _, g32c = grad_fn(twin, on_card)
    p32c = None
    if cpu["adamw"]:
        p32c, _, _ = optim.update(g32c, optim.init(twin.tensors()))
        p32c = leaves_of(p32c)
    del twin
    g16c, g32c = leaves_of(g16c), leaves_of(g32c)
    sync(dev)
    card_s = time.perf_counter() - t0
    g16, g32 = cpu["g16"], cpu["g32"]
    losses = (l16c.item(), l32c.item()) + cpu["losses"]
    check(all(map(math.isfinite, losses)),
          f"train {arch}: a loss is not finite {losses}")
    row = {"layers": cfg.num_layers, "of_layers": cpu["of_layers"],
           "loss_card_bf16_f32_cpu_bf16_f32": losses,
           "moe_route_flips": cpu["flips"] + route.flips}
    row["loss_f32"] = abs(losses[1] - losses[3])
    check(row["loss_f32"] <= TRAIN_F32_TOL * abs(losses[3]),
          f"train {arch}: float32 loss card {losses[1]} vs CPU {losses[3]}")
    loss_noise = abs(losses[2] - losses[3])
    loss_tol = max(2 * loss_noise, LOSS_FLOOR * abs(losses[2]))
    row["loss_bf16"], row["loss_bf16_tol"] = abs(losses[0] - losses[2]), \
        loss_tol
    check(row["loss_bf16"] <= loss_tol,
          f"train {arch}: bf16 loss card {losses[0]} vs CPU {losses[2]} "
          f"(tolerance {loss_tol})")

    def f32_tol(i, w):
        return TRAIN_F32_TOL * (w.abs() + w.abs().max())

    row["grads_f32"] = held_tree(check, f"train {arch} float32 gradients",
                                 g32c, g32, f32_tol, dev)
    card_noise = max(
        float((g16c[i].float() - g32c[i]).norm())
        / max(float((g16[i].to(dev).float() - g32[i].to(dev)).norm()), 1e-30)
        for i in range(len(g16)))
    row["grads_bf16"] = held_norms(check, f"train {arch} bf16 gradients",
                                   g16c, g16, g32, dev)
    row["card_noise_vs_cpu"] = card_noise
    if cpu["adamw"]:
        scale = cpu["scale"]

        def step_tol(i, w):
            return 1e-4 + 1e-4 * w.abs() + torch.where(
                (g32[i].to(dev) * scale).abs() < 1e-6, 2 * TRAIN_LR, 0.0)

        row["params_f32"] = held_tree(
            check, f"train {arch} float32 params after one AdamW step",
            p32c, cpu["p32"], step_tol, dev)
    del g16c, g32c, p32c
    gc.collect()
    torch.cuda.empty_cache()
    row.update(adamw=cpu["adamw"], card_s=card_s, cpu_s=cpu["cpu_s"],
               cpu_grads_s=cpu["grads_s"], adamw_cpu_s=cpu.get("adamw_s"))
    nbytes = cpu["nbytes"]
    print(f"train {arch} (b): {cfg.num_layers} of {cpu['of_layers']} layers; "
          f"card = CPU in float32: loss {row['loss_f32']:.2e}, gradients "
          f"{row['grads_f32']:.3f} of their allowance"
          + (f", params after AdamW {row['params_f32']:.3f}" if cpu["adamw"]
             else f", AdamW not run ({7 * nbytes / 2 ** 30:.0f} GiB of "
                  f"float32 copies > {ADAMW_CPU_BYTES / 2 ** 30:.0f})")
          + f"; bf16: loss {row['loss_bf16']:.2e} (tolerance "
          f"{loss_tol:.2e}), gradients {row['grads_bf16']:.3f} of twice the "
          f"CPU's bf16 noise (L2; the card's noise up to {card_noise:.2f}× "
          f"the CPU's); {row['moe_route_flips']} MoE near-tie routes pinned; "
          f"card {card_s:.1f} s, CPU {cpu['cpu_s']:.1f} s (its gradients "
          f"{cpu['grads_s']:.1f}, AdamW {cpu.get('adamw_s', 0):.1f}) [{smi}]",
          flush=True)
    return row


def train_cpu_worker(check, dev, results, budget, drawn, a_done):
    """Phase 12's worker thread: every architecture's CPU half of (b), in
    ``SERVE_PLAN`` order, each put on ``results``; it starts the next only
    while the results the card has not used yet hold at most
    ``TRAIN_HELD_BYTES`` (``budget``: a condition over a one-item list).
    Models not in ``drawn`` (those drawn before (a)) are drawn once
    ``a_done`` is set, so that no draw or copy shares the card with (a)."""
    try:
        for arch, _, _ in SERVE_PLAN:
            with budget:
                budget.wait_for(lambda: budget.held[0] <= TRAIN_HELD_BYTES)
            if arch not in drawn:
                a_done.wait()
            out = train_cpu_half(check, arch, drawn.pop(arch, None)
                                 or train_weights(arch, dev))
            with budget:
                budget.held[0] += out["held_bytes"]
            results.put((arch, out))
    except BaseException as err:  # noqa: BLE001 - re-raised by the caller
        results.put((None, err))


def train_example(check, smi):
    """(c) ``repro_torch.train_100m``'s default run on the card (qwen3-100m,
    200 steps, batch 8, seq 256, a checkpoint every 50 under
    ``build/train_100m``), then the restart check: its step-100 bundle
    alone in another directory, resumed to 200, against the uninterrupted
    run within 2e-2 (the JAX package's test; not bit for bit: the
    embedding's backward accumulates with atomics on the card)."""
    import shutil

    import numpy as np
    import torch

    from repro_torch import train_100m
    from repro_torch.launch.train import TrainRun, run

    sync("cuda")
    t0 = time.perf_counter()
    state, hist, prog = train_100m.main([])
    sync("cuda")
    wall = time.perf_counter() - t0
    check(hist[-1] < hist[0], f"train_100m: loss {hist[0]} -> {hist[-1]}")
    ck = train_100m.DEFAULT_CKPT
    again = ck.parent / "train_100m_restart"
    shutil.rmtree(again, ignore_errors=True)
    again.mkdir(parents=True)
    t1 = time.perf_counter()
    shutil.copytree(ck / "step_00000100", again / "step_00000100")
    copy_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    resumed, hist2, _ = run(TrainRun(
        cfg=train_100m.model_100m(), steps=200, global_batch=8, seq_len=256,
        lr=3e-4, warmup=20, checkpoint_dir=str(again), checkpoint_every=50,
        log_every=0), device="cuda")
    resume_s = time.perf_counter() - t1
    err = max(float((a.detach().float() - c.detach().float()).abs().max())
              for a, c in zip(
        leaves_of(resumed.params.tensors()), leaves_of(state.params.tensors())))
    hist_err = float(np.abs(np.array(hist2) - np.array(hist[100:])).max())
    check(len(hist2) == 100 and err <= 2e-2,
          f"train_100m restart: {len(hist2)} steps resumed, params differ by "
          f"{err} from the uninterrupted run (tolerance 2e-2)")
    out = {"steps": len(hist), "first_loss": hist[0], "final_loss": hist[-1],
           "tokens": prog.total, "seconds": wall,
           "tokens_per_s": prog.total / wall, "resume_s": resume_s,
           "restart_params_err": err, "restart_loss_err": hist_err,
           "copy_s": copy_s, "nvidia_smi": smi}
    print(f"train_100m: 200 steps in {wall:.1f} s ({out['tokens_per_s']:.0f} "
          f"tok/s, {wall / 200 * 1e3:.1f} ms/step with logging and "
          f"checkpoints), loss {hist[0]:.4f} -> {hist[-1]:.4f}; resumed at "
          f"100 -> 200 in {resume_s:.1f} s: params within {err:.2e}, losses "
          f"within {hist_err:.2e} of the uninterrupted run [{smi}]",
          flush=True)
    del state, resumed
    t2 = time.perf_counter()
    shutil.rmtree(again, ignore_errors=True)
    shutil.rmtree(ck, ignore_errors=True)
    torch.cuda.empty_cache()
    out["cleanup_s"] = time.perf_counter() - t2
    return out


def train_phase(check, log, smi, dev):
    """Phase 12: (a) qwen3-0.6b trains whole at full width; (b) every
    architecture one pattern group deep, card against CPU; (c) the
    ``train_100m`` example with a restart. Launches no sync kernel (read
    by ``main``)."""
    import queue

    import torch

    secs = {}
    t0 = time.perf_counter()
    # the models the worker can take during (a), drawn before it
    drawn, held = {}, 0
    for arch, _, _ in SERVE_PLAN:
        if held > TRAIN_HELD_BYTES:
            break
        drawn[arch] = train_weights(arch, dev)
        nbytes = 4 * sum(t.numel() for t in drawn[arch][2].parameters())
        held += train_held_bytes(nbytes, 7 * nbytes <= ADAMW_CPU_BYTES)
    torch.cuda.empty_cache()
    secs["draw"], n_drawn = time.perf_counter() - t0, len(drawn)
    results, budget, a_done = queue.Queue(), threading.Condition(), \
        threading.Event()
    budget.held = [0]
    worker = threading.Thread(
        target=train_cpu_worker,
        args=(check, dev, results, budget, drawn, a_done), daemon=True)
    # the worker's CPU operations leave two cores to the thread that
    # launches (a)'s ~64,000 kernels a step (with every core taken, a
    # step's launches fell behind an H100 80GB HBM3: 82% busy, one step
    # 1.3× the others)
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, min(threads, (os.cpu_count() or 1) - 2)))
    t0 = time.perf_counter()
    worker.start()
    out = {"whole": train_whole(check, smi, dev)}
    gc.collect()
    a_done.set()
    secs["a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["card_cpu"] = {}
    for _ in SERVE_PLAN:
        arch, cpu = results.get()
        if arch is None:
            worker.join()
            raise cpu
        out["card_cpu"][arch] = train_card_half(check, smi, arch, dev, cpu)
        with budget:
            budget.held[0] -= cpu["held_bytes"]
            budget.notify()
        del cpu
    worker.join()
    worker_threads = torch.get_num_threads()
    torch.set_num_threads(threads)
    secs["b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["train_100m"] = train_example(check, smi)
    secs["c"] = time.perf_counter() - t0
    out["seconds"] = secs
    print(f"phase 12: (b)'s first {n_drawn} models drawn in "
          f"{secs['draw']:.1f} s; (a) "
          f"{secs['a']:.1f} s (with (b)'s CPU half beside it on a worker "
          f"thread), (b) {secs['b']:.1f} s more, (c) "
          f"{secs['c']:.1f} s; the worker's CPU threads {worker_threads} of "
          f"{os.cpu_count()} cores", flush=True)
    log["train"] = out


# -- phase 13: the autotuner, the model side's meshes, the dry-run ------------

# The smoke's own autotune cache (empty: every phase keeps the default
# plans), never a user's under ~/.cache; phase 13 (a) tunes into files of
# its own beside it.
TUNE_DIR = REPO / "build" / "chip_smoke_autotune"
# (a) round_step's plans at the scale phase's GMap 4M bprr round (mesh15d4,
# K = P + 1, per-origin) and at the store's shapes: the Retwis paper
# setting (mesh50 d4) and a million objects (mesh16 d4; tuned only: no
# mega run)
TUNE_SHAPES = (("GMap 4,194,304 bprr mesh15d4", 1, 15, SCALE_KEYS),
               ("Retwis [30,000, 50, 64] bprr", 30_000, 50, 64),
               ("Retwis [1,048,576, 16, 32] bprr", 1 << 20, 16, 32))
# (b) qwen3-0.6b whole on a one-rank NCCL group's (1, 1) mesh, float32
SHARDED_TRAIN = ("qwen3-0.6b", 2, 512)
SHARDED_PROMPT, SHARDED_STEPS = 32, 4
# (c) the dry-run cells, each a subprocess on the CPU (fake process group,
# no card, one thread), started before phase 11 — beside the host-bound
# server and the trainer, which use a few of the card machine's 8 cores —
# and awaited in phase 13: traced alone in phase 13 they would take its
# ~110 s, beyond its 90 s
DRYRUN_LIMIT_S = 600
DRYRUN_1X1 = """
import json
from repro_torch.configs.registry import ShapeSpec
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_process_group, make_mesh
with fake_process_group(1):
    mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
    r = dryrun.run_cell("qwen3-0.6b", ShapeSpec("train_4k", 4096, 4, "train"),
                        mesh, "mesh1,1", save=False)
print(json.dumps({k: r.get(k) for k in ("status", "error", "memory",
                                         "op_cost", "roofline", "trace_s")}))
"""
DRYRUN_CELLS = (
    ("qwen3-0.6b train_4k pod16x16", ["-m", "repro_torch.launch.dryrun",
                                      "--arch", "qwen3-0.6b", "--shape",
                                      "train_4k", "--mesh", "single",
                                      "--no-save"]),
    ("mixtral-8x22b decode_32k mesh4,4", ["-m", "repro_torch.launch.dryrun",
                                          "--arch", "mixtral-8x22b",
                                          "--shape", "decode_32k",
                                          "--mesh-shape", "4,4",
                                          "--no-save"]),
    ("qwen3-0.6b 4x4096 mesh1,1", ["-c", DRYRUN_1X1]),
)


def own_tune_cache():
    """Point the autotuner at an empty cache file of the smoke's own, in
    cache mode (``REPRO_AUTOTUNE`` cleared)."""
    TUNE_DIR.mkdir(parents=True, exist_ok=True)
    path = TUNE_DIR / "smoke.json"
    path.write_text("{}")
    os.environ["REPRO_AUTOTUNE_CACHE"] = str(path)
    os.environ["REPRO_AUTOTUNE"] = ""
    return path


def round_operands(g, b, n, u, dev):
    """One bprr round's operands of ``b`` configs on partial_mesh(n, 4)."""
    import torch

    from repro_torch.sync import topology

    topo = topology.partial_mesh(n, 4).on(dev)
    p = topo.max_degree
    k = p + 1
    return (rand_state(g, torch.int32, (b, n, u), dev),
            rand_state(g, torch.int32, (b, n, u), dev),
            rand_state(g, torch.int32, (k, b, n, u), dev),
            topo.mask.to(torch.int32).expand(b, n, p).contiguous(),
            torch.ones((b, n), dtype=torch.int32, device=dev),
            topo.nbrs, topo.rev), p, k


def same_outputs(got, want) -> bool:
    import torch

    return all((a is None and c is None) or (
        a is not None and c is not None and torch.equal(a, c))
        for a, c in zip(got, want))


def plan_name(pl) -> str:
    """A ``round_step`` plan in a few words."""
    if pl.short:
        return (f"short rows {pl.lanes} lanes g {pl.configs} "
                f"{'staged' if pl.bulk else 'direct'}")
    return f"tile {pl.tile} vec {pl.vec_bytes} stages {pl.stages}"


def tune_phase(check, log, smi, dev, smoke_cache):
    """(a) every plan of ``round_step.plans`` at the three shapes launched
    and held to the plain version exactly (at the store shapes the
    short-row kernel's: configs a block, direct or staged loads);
    ``ops.sync_round_block`` tuning into a fresh file (each candidate's ms
    by CUDA events), then resolving from it ("cache"); a mega GMap 4M bprr
    run under the tuned plan against the default plan's, bit for bit. The
    memo is cleared and the smoke's empty cache restored after; the same
    for the Retwis paper store's mega run at the store shape's winner.
    Returns the mega runs' launches."""
    import torch

    from repro_torch import kernels
    from repro_torch.core import GMap
    from repro_torch.kernels import common, ops
    from repro_torch.kernels import round_step as ks
    from repro_torch.sync import simulate, simulate_store, topology
    from repro_torch.sync import workloads as W

    g = torch.Generator(device=dev).manual_seed(13)
    kw = ("max", True, True, False)         # kind, per_origin, extracts, inbox
    out, winners = [], {}
    for i, (tag, b, n, u) in enumerate(TUNE_SHAPES):
        args, p, k = round_operands(g, b, n, u, dev)
        want = ks.plain(*args, *kw)
        cands = ks.plans(n, p, k, True, 4, u, True)
        for pl in cands:
            check(same_outputs(ks._launch(*args, *kw, pl=pl), want),
                  f"tune {tag}: plan {pl} differs from the plain version")
        del want
        path = TUNE_DIR / f"tune{i}.json"
        path.unlink(missing_ok=True)
        os.environ.update(REPRO_AUTOTUNE_CACHE=str(path), REPRO_AUTOTUNE="1")
        common._TUNE_MEM.clear()

        def bench(pl, args=args):
            for _ in range(ks.BENCH_LAUNCHES):
                ks._kernel(*args, *kw, pl)

        blk = dict(p=p, k=k, per_origin=True, kind="max", elem_size=4,
                   aligned=True, device=dev)
        win, src = ops.sync_round_block(b, n, u, tune_bench=bench, **blk)
        check(src == "tuned", f"tune {tag}: resolved {src}, not tuned")
        (entry,) = json.loads(path.read_text()).values()
        ms = {tuple(json.loads(c)): t / ks.BENCH_LAUNCHES * 1e3
              for c, t in entry["timings_s"].items()}
        check(len(ms) == len(cands), f"tune {tag}: {len(ms)} of "
                                     f"{len(cands)} candidates timed")
        os.environ["REPRO_AUTOTUNE"] = ""
        common._TUNE_MEM.clear()
        again = ops.sync_round_block(b, n, u, **blk)
        check(again == (win, "cache"), f"tune {tag}: the second resolution "
                                       f"gave {again}, not ({win}, cache)")
        default = cands[0]
        check(ms[tuple(win)] <= ms[tuple(default)],
              f"tune {tag}: the winner is slower than the default")
        plane = b * n * u * 4
        b_ms, b_by = bound((2 * k + 3) * plane,
                           (2 + 3 * k + 6 * p + 1) * b * n * u)
        row = {"shape": tag, "configs": b, "nodes": n, "columns": u,
               "candidates": [dict(pl._asdict(), ms=ms[tuple(pl)])
                              for pl in cands],
               "winner": dict(win._asdict(), ms=ms[tuple(win)]),
               "default_ms": ms[tuple(default)], "bound_ms": b_ms,
               "bound_by": b_by, "nvidia_smi": smi}
        out.append(row)
        winners[tag] = (win, path)
        print(f"tune {tag}: " + "; ".join(
            f"{plan_name(pl)}: {ms[tuple(pl)]:.3f} ms" for pl in cands),
            flush=True)
        print(f"tune {tag}: winner {plan_name(win)} {ms[tuple(win)]:.3f} "
              f"ms, default "
              f"{ms[tuple(default)]:.3f} ms, bound {b_ms:.3f} ms ({b_by}); "
              f"resolved again from the cache [{smi}]", flush=True)
        del args
        torch.cuda.empty_cache()

    # the mega GMap 4M bprr run, and the Retwis paper store's bprr mega
    # run, under the tuned plan and under the default
    nodes, objects, slots, active, quiet, ops_n = RETWIS_PAPER
    lat, spec, _ = retwis_store(1.0, nodes, objects, slots, active, ops_n)
    gmap = W.gmap_block_op(15, SCALE_KEYS, 10)
    workloads = (
        (TUNE_SHAPES[0][0], 20, 1, lambda: simulate(
            "bprr", GMap(SCALE_KEYS).lattice, topology.partial_mesh(15, 4),
            gmap, 12, 8, engine="mega")),
        (TUNE_SHAPES[1][0], active + quiet, objects, lambda: simulate_store(
            "bprr", lat, topology.partial_mesh(nodes, 4), spec, active,
            quiet, engine="mega")))
    kernels.reset_launches()
    want = {k: 0 for k in SOURCES}
    for (tag, _, n, u), (_, rounds, configs, run) in zip(TUNE_SHAPES,
                                                           workloads):
        win, path = winners[tag]
        default = ks.plans(n, 4, 5, True, 4, u, True)[0]
        kept, ms = {}, {"tuned": [], "default": []}
        # a warm-up, then default, tuned, tuned, default: each plan timed
        # twice, in turns; one result of each kept for the equality check
        order = ("default", "default", "tuned", "tuned", "default")
        for i, name in enumerate(order):
            cache, want_plan = (path, win) if name == "tuned" \
                else (smoke_cache, default)
            os.environ["REPRO_AUTOTUNE_CACHE"] = str(cache)
            common._TUNE_MEM.clear()
            gc.collect()
            sync(dev)
            t0 = time.perf_counter()
            r = run()
            sync(dev)
            if i:                          # the first is the warm-up
                ms[name].append((time.perf_counter() - t0) * 1e3 / rounds)
            kept.setdefault(name, r)
            del r
            check(ks.last_launch[0] == want_plan,
                  f"tune {tag}: the {name} mega run launched "
                  f"{ks.last_launch[0]}")
            for k, v in expected_launches("mega", "bprr", rounds,
                                          configs).items():
                want[k] += v
        check(same_run(kept["tuned"], kept["default"]),
              f"tune {tag}: the tuned plan's mega run differs from the "
              f"default plan's")
        row = next(r for r in out if r["shape"] == tag)
        row["mega_ms_per_round"] = dict(ms, rounds=rounds)
        print(f"tune {tag}: mega run ({rounds} rounds) under "
              f"{plan_name(win)} equal to the default plan's; ms/round tuned "
              f"{', '.join(f'{t:.3f}' for t in ms['tuned'])}, default "
              f"{', '.join(f'{t:.3f}' for t in ms['default'])} (after a "
              f"warm-up run, in turns) [{smi}]", flush=True)
        del kept
        gc.collect()
        torch.cuda.empty_cache()
    launched = kernels.launch_counts()
    check(launched == want, f"tune: mega runs launched {launched}, expected "
                            f"{want}")
    os.environ["REPRO_AUTOTUNE_CACHE"] = str(smoke_cache)
    common._TUNE_MEM.clear()
    log["autotune"] = out
    return launched


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def sharded_phase(check, log, smi, dev):
    """(b) a one-rank NCCL process group and a (1, 1) mesh on the card:
    qwen3-0.6b whole in float32, weights from seed 0 placed by
    ``param_specs`` / ``to_named``, a train step with hints and
    ``grad_specs`` against the plain ``make_train_step`` (loss, every
    gradient leaf, the params after AdamW, at phase 12's float32
    allowances, each rejecting planted faults), then a prefill and four
    decode steps through ``make_prefill`` / ``make_decode(hints=)`` against
    the plain ones. The group is destroyed after."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, batch_for_step
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as TT
    from repro_torch.optim import AdamW, constant
    from repro_torch.train import sharding as SH
    from repro_torch.train import steps as TS

    arch, b, s = SHARDED_TRAIN
    on_card = torch.device(dev).type == "cuda"
    dist.init_process_group(
        "nccl" if on_card else "gloo",
        init_method=f"tcp://localhost:{free_port()}", rank=0, world_size=1,
        device_id=torch.device("cuda", torch.cuda.current_device())
        if on_card else None)
    try:
        mesh = make_mesh((1, 1), ("data", "model"),
                         device_type=torch.device(dev).type)
        cfg = get_config(arch)
        model = float32_twin(TT.init_params(cfg, seed=0, device=dev))
        hints = TT.ShardingHints(data_axes=SH.data_axes_of(mesh),
                                 model_axis="model")
        p_sp = SH.param_specs(cfg, mesh, "train")
        smodel = TT.Decoder(cfg, SH.to_named(model.tensors(), p_sp, mesh))
        batch = batch_for_step(DataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=s, global_batch=b, seed=0),
                               0, 0, device=dev)
        sbatch = SH.to_named(batch, SH.batch_specs(cfg, mesh, batch), mesh)
        out = {"arch": arch, "layers": cfg.num_layers, "batch": b, "seq": s,
               "nvidia_smi": smi}
        loss, _, grads = TS.make_grad_fn(cfg)(model, batch)
        sloss, _, sgrads = TS.make_grad_fn(cfg, hints=hints,
                                           grad_specs=p_sp)(smodel, sbatch)
        loss, sloss = float(loss), float(sloss.full_tensor())
        out["loss"], out["sharded_loss"] = loss, sloss
        check(abs(sloss - loss) <= TRAIN_F32_TOL * abs(loss),
              f"sharded {arch}: loss {sloss} vs {loss}")
        grads = leaves_of(grads)
        out["grads"] = held_tree(
            check, f"sharded {arch} gradients",
            leaves_of(SH.full_tree(sgrads)), grads,
            lambda i, w: TRAIN_F32_TOL * (w.abs() + w.abs().max()), dev)
        del sgrads
        scale = min(1.0, 1.0 / max(float(torch.sqrt(sum(
            (g.float() ** 2).sum() for g in grads))), 1e-9))
        optim = AdamW(lr=constant(TRAIN_LR))
        steps = {"plain": (TS.make_train_step(cfg, optim), model, batch),
                 "sharded": (TS.make_train_step(cfg, optim, hints=hints,
                                                grad_specs=p_sp),
                             smodel, sbatch)}
        new = {}
        for name, (step, m, bt) in steps.items():
            sync(dev)
            t0 = time.perf_counter()
            new[name], _ = step(TS.init_train_state(cfg, optim, m), bt)
            sync(dev)
            out[f"{name}_step_ms"] = (time.perf_counter() - t0) * 1e3

        def step_tol(i, w):
            return 1e-4 + 1e-4 * w.abs() + torch.where(
                (grads[i] * scale).abs() < 1e-6, 2 * TRAIN_LR, 0.0)

        out["params"] = held_tree(
            check, f"sharded {arch} params after one AdamW step",
            leaves_of(SH.full_tree(new["sharded"].params.tensors())),
            leaves_of(new["plain"].params.tensors()), step_tol, dev)
        del new, grads
        gc.collect()
        torch.cuda.empty_cache()

        # serving: a prefill of 36 positions, then 4 decode steps over the
        # last 4, each attending the cache up to its own position
        total = SHARDED_PROMPT + SHARDED_STEPS
        tokens = serve_inputs(cfg, b, total, 5, dev)["tokens"]
        prompt = {"tokens": tokens}
        sprompt = SH.to_named(prompt, SH.batch_specs(cfg, mesh, prompt),
                              mesh)
        s_sp = SH.param_specs(cfg, mesh, "serve")
        smodel = TT.Decoder(cfg, SH.to_named(model.tensors(), s_sp, mesh))
        logits, cache = TS.make_prefill(cfg)(model, prompt)
        slogits, scache = TS.make_prefill(cfg, hints=hints)(smodel, sprompt)
        got, want = [slogits.full_tensor()], [logits]
        decode = TS.make_decode(cfg)
        sdecode = TS.make_decode(cfg, hints=hints)
        for i in range(SHARDED_STEPS):
            pos = SHARDED_PROMPT + i
            tok = {"tokens": tokens[:, pos:pos + 1].contiguous()}
            stok = SH.to_named(tok, SH.batch_specs(cfg, mesh, tok), mesh)
            logits, cache = decode(model, cache, tok, pos)
            slogits, scache = sdecode(smodel, scache, stok, pos)
            got.append(slogits.full_tensor())
            want.append(logits)
        out["serve_logits"] = held_tree(
            check, f"sharded {arch} prefill and decode logits", got, want,
            lambda i, w: TRAIN_F32_TOL * (w.abs() + w.abs().max()), dev)
        out["cache_placements"] = str(scache[0]["k"].placements)
        del model, smodel, cache, scache
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"sharded {arch} ({cfg.num_layers} layers, float32, mesh (1, 1), "
          f"B {b} x S {s}): loss {out['sharded_loss']:.6f} vs "
          f"{out['loss']:.6f}, gradients {out['grads']:.3f} and params after "
          f"AdamW {out['params']:.3f} of their allowances; step "
          f"{out['sharded_step_ms']:.1f} ms sharded vs "
          f"{out['plain_step_ms']:.1f} plain; prefill + {SHARDED_STEPS} decode steps' logits "
          f"{out['serve_logits']:.3f} of theirs, cache "
          f"{out['cache_placements']} [{smi}]", flush=True)
    log["sharded"] = out


def start_dryruns():
    """The dry-run cells as subprocesses on the CPU (no card visible, one
    thread each, at the lowest priority: phases 11 and 12 run beside them
    and time their host's work)."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    procs = {}
    for tag, args in DRYRUN_CELLS:
        proc = subprocess.Popen([sys.executable, *args], cwd=REPO, env=env,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        os.setpriority(os.PRIO_PROCESS, proc.pid, 19)
        procs[tag] = (time.perf_counter(), proc)
    return procs


def finish_dryruns(check, log, procs):
    """(c) each cell exits 0 with an ``OK`` line within its time limit; the
    1×1 cell's predicted peak memory and FLOPs beside phase 12 (a)'s
    measured peak and FLOP count."""
    out = {}
    for tag, (t0, proc) in procs.items():
        left = max(1.0, DRYRUN_LIMIT_S - (time.perf_counter() - t0))
        try:
            stdout, stderr = proc.communicate(timeout=left)
        except subprocess.TimeoutExpired:
            proc.kill()
            stdout, stderr = proc.communicate()
            check(False, f"dry-run {tag}: not done in {DRYRUN_LIMIT_S} s")
            continue
        secs = time.perf_counter() - t0
        lines = stdout.strip().splitlines() or [""]
        if tag.endswith("mesh1,1"):
            ok = proc.returncode == 0 and lines[-1].startswith("{") \
                and json.loads(lines[-1]).get("status") == "ok"
        else:
            ok = proc.returncode == 0 and " OK " in stdout \
                and "0 failed" in stdout
        check(ok, f"dry-run {tag}: exit {proc.returncode}: "
                  f"{(stdout + stderr)[-2000:]}")
        out[tag] = {"seconds": secs, "stdout": stdout[-4000:]}
        for line in lines:
            if line.startswith("[") or line.startswith("dry-run"):
                print(f"dry-run {tag}: {line} ({secs:.1f} s)", flush=True)
        if ok and tag.endswith("mesh1,1"):
            r = json.loads(lines[-1])
            out[tag]["result"] = r
            a = log.get("train", {}).get("whole", {})    # phase 12 (a)
            peak = r["memory"]["Total"] / 2 ** 30
            flops = r["op_cost"]["flops"]
            row = {"predicted_peak_gib": peak,
                   "measured_peak_gib": a.get("mb1", {}).get("peak_gib"),
                   "predicted_flops": flops,
                   "phase12_flop_bound": a.get("flops"),
                   "predicted_hbm_bytes": r["op_cost"]["hbm_bytes"],
                   "roofline": r["roofline"]}
            out["vs_phase12"] = row
            mp, fb = row["measured_peak_gib"], row["phase12_flop_bound"]
            print(f"dry-run qwen3-0.6b B 4 x 4,096 on (1, 1): predicted peak "
                  f"{peak:.2f} GiB vs phase 12 (a)'s measured "
                  + (f"{mp:.2f} GiB ({peak / mp:.3f}x)" if mp else "n/a")
                  + f"; FLOPs {flops:.4e} vs phase 12's FLOP count "
                  + (f"{fb:.4e} ({flops / fb:.3f}x)" if fb else "n/a")
                  + f"; HBM bytes {row['predicted_hbm_bytes']:.4e}",
                  flush=True)
    log["dryrun"] = out


def stop_dryruns(procs):
    for _, proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def mesh_phase(check, log, smi, dev, smoke_cache, dryruns):
    """Phase 13: (a) and (b) on the card, then (c)'s dry-runs (started
    before phase 11) awaited. Returns (a)'s mega runs' launches."""
    launched = tune_phase(check, log, smi, dev, smoke_cache)
    sharded_phase(check, log, smi, dev)
    finish_dryruns(check, log, dryruns)
    return launched


# -- driver ----------------------------------------------------------------------

SOURCES = {
    "round_step": ("src/repro_torch/csrc/round_step.cu",
                   "src/repro/kernels/round_step.py:148"),
    "round_recv": ("src/repro_torch/csrc/round_recv.cu",
                   "src/repro/kernels/round_recv.py:126"),
    "buffer_fold": ("src/repro_torch/csrc/buffer_fold.cu",
                    "src/repro/kernels/buffer_fold.py:59"),
    "digest_blocks": ("src/repro_torch/csrc/digest_blocks.cu",
                      "src/repro/kernels/digest.py:73"),
    "masked_extract": ("src/repro_torch/csrc/masked_extract.cu",
                       "src/repro/kernels/digest.py:125"),
    "join": ("src/repro_torch/csrc/join.cu", "src/repro/kernels/join.py:37"),
    "delta_extract": ("src/repro_torch/csrc/delta_extract.cu",
                      "src/repro/kernels/delta_extract.py:50"),
    "lex_join_delta": ("src/repro_torch/csrc/lex_join.cu",
                       "src/repro/kernels/lex_join.py:43"),
}
# the kernels of the sync engines' main path (phases 4-6) and of the
# lex-pair one (phase 7: the public elementwise entry points)
SYNC_KERNELS = ("round_step", "round_recv", "buffer_fold", "digest_blocks",
                "masked_extract")
ELEMENTWISE = ("join", "delta_extract", "lex_join_delta")


def cards_main() -> int:
    """``--cards``: the build and phase 9 (c)'s several-card part alone,
    on every visible card, with the launch counters checked; exits
    non-zero if a check fails or fewer than two cards are visible."""
    import torch

    from repro_torch import kernels
    from repro_torch.kernels import _build

    check = Checks()
    own_tune_cache()
    smi = nvidia_smi()
    print(f"cards: {torch.cuda.device_count()}\n{smi}", flush=True)
    if torch.cuda.device_count() < 2:
        print("chip_smoke --cards: needs two cards or more", file=sys.stderr)
        return 1
    _build.build_all()
    kernels.reset_launches()
    expect = Launches(check)
    log = {"nvidia_smi": smi}
    t0 = time.perf_counter()
    shard_cards(check, expect, log)
    check(kernels.launch_counts() == expect.total,
          f"several-card launches {kernels.launch_counts()}, expected "
          f"{expect.total}")
    print(f"several cards: {time.perf_counter() - t0:.1f} s", flush=True)
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke_cards.json").write_text(json.dumps(log, indent=1))
    if check.failed:
        print(f"chip_smoke --cards: {len(check.failed)} checks failed",
              file=sys.stderr)
        return 1
    print(json.dumps(log["retwis_several_cards"]))
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:] == ["--cards"]:
        return cards_main()
    if sys.argv[1:]:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]} (takes none or "
              f"--cards)", file=sys.stderr)
        return 2
    from repro_torch import kernels
    from repro_torch.kernels import _build

    global INT_OPS_PER_S
    check = Checks()
    dev = torch.device("cuda")
    smoke_cache = own_tune_cache()
    smi = nvidia_smi()
    log = {"torch": torch.__version__, "cuda": torch.version.cuda,
           "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    # 1. environment
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} capability "
          f"{torch.cuda.get_device_capability(0)}", flush=True)
    print(f"card: {smi}", flush=True)
    check(torch.cuda.get_device_capability(0) == (9, 0), "not an sm_90 card")
    INT_OPS_PER_S = log["int_ops_per_s"] = int_ops_per_s(check)

    # 2. build
    t0 = time.perf_counter()
    _build.build_all()
    log["build_s"] = time.perf_counter() - t0
    print(f"build: {log['build_s']:.1f} s", flush=True)
    for name in _build.SOURCES:
        text = _build.build_log(name)
        regs = [int(w) for w in re.findall(r"Used (\d+) registers", text)]
        spills = re.findall(r"(\d+) bytes spill stores", text)
        log[f"{name}_registers"] = regs
        print(f"  {name}: {len(regs)} instantiations, {min(regs, default=0)}-"
              f"{max(regs, default=0)} registers, spill stores "
              f"{max(map(int, spills), default=0)} bytes", flush=True)

    phase_s = log["phase_s"] = {"build": log["build_s"]}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t
        print(f"phase {name}: {phase_s[name]:.1f} s", flush=True)
        return out

    # 3. kernels against their plain versions
    grid_errs = timed("kernel_grid", kernel_grid, check, dev, log)
    for name, e in timed("batch_kernel_grid", batch_kernel_grid, check, dev,
                         log).items():
        grid_errs[name] = max(grid_errs[name], e)
    grid_errs.update(timed("elementwise_grid", elementwise_grid, check, dev,
                           log))
    timings = {name: t + (None,) for name, t in timed(
        "kernel_timings", kernel_timings, check, dev, log).items()}
    timings.update(timed("elementwise_timings", elementwise_timings, check,
                         dev, log))
    store_shapes = timed("store_kernel_timings", store_kernel_timings, check,
                         dev, log)

    # 9 (a, b). the gossip runtime (host-bound, no kernel), before any
    # profiler window
    launch_probe("before any profiler", log)
    timed("runtime", runtime_phase, check, log)

    # 4 + 5. the sync engines' main path, with the launch counters zeroed
    # around it
    kernels.reset_launches()
    expect = Launches(check)
    singles = {}
    timed("paper", paper_phase, check, expect, log)
    join_r25 = timed("fig_digest", digest_phase, check, expect, log, singles)
    timed("bench_fault", fault_phase, check, expect, log, singles)
    timed("scale", scale_phase, check, expect, log, join_r25)
    launches = kernels.launch_counts()
    check(launches == expect.total, f"main-path launches {launches}, the "
                                    f"runs' rounds give {expect.total}")
    for name in SYNC_KERNELS:
        check(launches[name] > 0, f"{name} was never launched on the main "
                                  f"path")

    # 6. the batched main path (sweeps and the keyed store), with the
    # counters zeroed around it
    kernels.reset_launches()
    expect6 = Launches(check)
    timed("sweeps", sweep_phase, check, expect6, log, singles)
    del singles
    timed("fig11_retwis", retwis_phase, check, expect6, log)
    kept = timed("retwis_paper", retwis_paper_phase, check, expect6, log)
    timed("store_1m", million_phase, check, expect6, log)
    launches6 = kernels.launch_counts()
    check(launches6 == expect6.total, f"batched main-path launches "
                                      f"{launches6}, expected {expect6.total}")
    for name in SYNC_KERNELS:
        check(launches6[name] > 0, f"{name} was never launched on the "
                                   f"batched main path")

    # 7. the lex-pair main path (LWWMap, the merge entry points, the
    # quickstart) and the Retwis example, with the counters zeroed around
    # it: the simulations launch nothing, the merges one join, one
    # delta_extract and two lex_join_delta, the quickstart one
    # delta_extract, the Retwis example nothing
    kernels.reset_launches()
    expect3 = Launches(check)
    timed("lww", lww_phase, check, expect3, log)
    timed("lww_small", lww_small_phase, check, expect3, log)
    timed("quickstart", quickstart_phase, check, log)
    timed("retwis_app", retwis_app_phase, check, log)
    launches3 = kernels.launch_counts()
    want3 = dict(expect3.total, join=1, delta_extract=2, lex_join_delta=2)
    check(launches3 == want3, f"lex-pair main-path launches {launches3}, "
                              f"expected {want3}")
    for name in ELEMENTWISE:
        check(launches3[name] > 0, f"{name} was never launched on the "
                                   f"lex-pair main path")
        launches[name] = launches3[name]

    # 8. observability and the Scuttlebutt baseline (simulate, sweeps and
    # the store with telemetry= / provenance= / trace=), with the counters
    # zeroed around it
    kernels.reset_launches()
    expect8 = Launches(check)
    obs_trace = timed("obs", obs_phase, check, expect8, log)
    launches8 = kernels.launch_counts()
    check(launches8 == expect8.total, f"observability-path launches "
                                      f"{launches8}, expected {expect8.total}")
    for name in SYNC_KERNELS:
        check(launches8[name] > 0, f"{name} was never launched on the "
                                   f"observability path")
    # 9 (c). padding and shards, with the counters zeroed around it
    kernels.reset_launches()
    expect9 = Launches(check)
    timed("shards", shard_phase, check, expect9, log, kept)
    del kept
    print(f"phase 9: {phase_s['runtime'] + phase_s['shards']:.1f} s "
          f"(runtime {phase_s['runtime']:.1f}, shards "
          f"{phase_s['shards']:.1f})", flush=True)
    launches9 = kernels.launch_counts()
    check(launches9 == expect9.total, f"sharded-path launches {launches9}, "
                                      f"expected {expect9.total}")
    for name in ("round_step", "round_recv", "buffer_fold"):
        check(launches9[name] > 0, f"{name} was never launched on the "
                                   f"sharded path")
    timed("profile", profile_phase, check, log)
    launch_probe("after the profiles", log)
    # 13 (c): the dry-runs start on the CPU now, beside phases 11 and 12
    dryruns = start_dryruns()
    try:
        # 11. the model side's server (plain PyTorch): no kernel of the
        # eight is launched there (oracle iv)
        kernels.reset_launches()
        timed("serve", serve_phase, check, log, smi, dev)
        served = kernels.launch_counts()
        check(not any(served.values()), f"the serving path launched "
                                        f"{served}")
        # 12. the model side's trainer (plain PyTorch): no kernel of the
        # eight is launched there either
        kernels.reset_launches()
        timed("train", train_phase, check, log, smi, dev)
        trained = kernels.launch_counts()
        check(not any(trained.values()), f"the training path launched "
                                         f"{trained}")
        # 13. the autotuner (its mega runs' launches: the tuned path), the
        # model side's meshes and the dry-run
        launches13 = timed("mesh", mesh_phase, check, log, smi, dev,
                           smoke_cache, dryruns)
    finally:
        stop_dryruns(dryruns)

    rows = []
    for name, (src, replaces) in SOURCES.items():
        e, ms, plain_ms, b_ms, b_by, lib_ms = timings[name]
        err = max(e, grid_errs[name])
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": replaces,
               "launches": launches[name] + launches6[name]
               + launches8[name] + launches9[name] + launches13[name],
               "max_abs_err": err, "equal": err == 0, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": lib_ms,
               "launches_by_path": {"unbatched": launches[name],
                                    "batched": launches6[name],
                                    "observability": launches8[name],
                                    "sharded": launches9[name],
                                    "tuned": launches13[name]}}
        if name in store_shapes:
            row["store_shapes"] = store_shapes[name]
        rows.append(row)
    log["kernels"] = rows
    log["failed"] = check.failed
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(log, indent=1))
    obs_trace.export_chrome(out / "obs_trace.json")
    obs_trace.export_jsonl(out / "obs_trace.jsonl")
    if check.failed:
        print(f"chip_smoke: {len(check.failed)} checks failed", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
