#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

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
   rows, ``round_step`` over 65,537 configs at U = 32 and at U = 64 on
   mesh16 and mesh50, the five path kernels on [B, N, U] rows) and
   ``round_step`` / ``round_recv`` timed at the store's shapes (30,000 ×
   mesh50 × 64 slots, 1,048,576 × mesh16 × 32) beside their bounds;
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
   equal to the CPU;
8. observability and the Scuttlebutt baseline, launch counters zeroed
   again (each part's seconds printed):
   (a) ``fig_telemetry.json``'s 18 cells value for value on three engines;
   (b) ``benchmarks/fig_provenance.py``'s scenarios on three engines and
   the CPU, all equal, attribution exhaustive, bprr back-propagating
   nothing, the two anomalies classified; (c) GMap 4,194,304 keys bprr /
   classic with telemetry and provenance on three engines: the run
   unchanged, the channels 27,962 × the GCounter(15) run's, mega timed
   off / telemetry / both; (d) Scuttlebutt's fig7 rows, fig10 column and
   fig9 entries, and its GMap codec at 4,194,304 keys; (e) phase 6's
   sweeps and the committed Retwis store with telemetry and provenance,
   every cell and object equal to its single run, and Retwis at the paper
   setting with telemetry and ``object_metrics=False``, timed against the
   run without, checkpointed and resumed; its trace is written beside the
   JSON log (``obs_trace.json``, ``obs_trace.jsonl``);
9. profile: ``torch.profiler`` over three GMap rounds per kernel engine
   (bprr; on ``mega`` also with telemetry and provenance), three LWWMap
   rounds (reference) and three digest_driven rounds
   on ``fused`` — device time by kernel and the device's busy share; a
   profiler failure fails the run.

Phases 4–5 are the sync engines' main path, phase 6 its batched form,
phase 7 the lex-pair one (the elementwise kernels' users) and phase 8 the
observability path: the launch counters are zeroed before and read after
each. Prints
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
    more than 65,535 configs (mesh16, U = 32) and at U = 64 (mesh16; mesh50,
    whose plan falls back to direct loads), ``round_recv`` with its grid
    capped at 3 blocks (every grid-stride loop walks), and the five path
    kernels on a batch's [B, N, U] operands as rows. Returns the largest
    error per kernel."""
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
    for n, u, nb, algo in ((16, 32, 65_537, "bprr"), (16, 32, 65_537,
                                                      "classic"),
                           (16, 64, 3_001, "bprr"), (50, 64, 1_000, "bprr")):
        topo = topology.partial_mesh(n, 4).on(dev)
        p = topo.max_degree
        k = p + 1 if algo == "bprr" else 1
        args = (rand_state(g, torch.int32, (nb, n, u), dev),
                rand_state(g, torch.int32, (nb, n, u), dev),
                rand_state(g, torch.int32, (k, nb, n, u), dev),
                (torch.randint(0, 2, (nb, n, p), generator=g, device=dev,
                               dtype=torch.int32) * topo.mask).to(torch.int32),
                torch.randint(0, 2, (nb, n), generator=g, device=dev,
                              dtype=torch.int32), topo.nbrs, topo.rev)
        kw = dict(kind="max", per_origin=algo == "bprr",
                  extracts=algo == "bprr", emit_inbox=algo != "bprr")
        before = ks.launches
        got = ops.round_step(*args, **kw)
        chunks = ks.launches - before
        e = max_abs_err(got, ks.plain(*args, **kw))
        errs["round_step"] = max(errs["round_step"], e)
        pl, blocks = ks.last_launch
        check(e == 0 and chunks == -(-nb // ks.MAX_CONFIGS),
              f"round_step [{nb}, {n}, {u}] {algo}: err {e}, {chunks} "
              f"launches")
        print(f"round_step [{nb}, {n}, {u}] {algo}: {chunks} launch(es), "
              f"{'bulk copies' if pl.bulk else 'direct loads'} of "
              f"{pl.vec_bytes or 'one element'} B a lane, {blocks} block(s) "
              f"a config", flush=True)
        del args, got
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


def store_kernel_timings(check, dev, log):
    """``round_step`` and ``round_recv`` at the store's shapes, beside their
    byte bounds: the paper setting (30,000 objects of mesh50 d4, 64 int32
    slots, bprr) and a million objects (mesh16 d4, 32 slots, bprr), each
    as the ``mega`` round's one launch and the ``fused`` round's receive
    (P = 4 extractions out). Returns ``{kernel: [row, ...]}``."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import round_recv as kr
    from repro_torch.kernels import round_step as ks
    from repro_torch.sync import topology

    g = torch.Generator(device=dev).manual_seed(9)
    out = {"round_step": [], "round_recv": []}
    for tag, b, n, u in (("paper 30,000 x mesh50 x 64", 30_000, 50, 64),
                         ("1,048,576 x mesh16 x 32", 1 << 20, 16, 32)):
        topo = topology.partial_mesh(n, 4).on(dev)
        p, k = topo.max_degree, topo.max_degree + 1
        plane = b * n * u * 4
        args = (rand_state(g, torch.int32, (b, n, u), dev),
                rand_state(g, torch.int32, (b, n, u), dev),
                rand_state(g, torch.int32, (k, b, n, u), dev),
                topo.mask.to(torch.int32).expand(b, n, p).contiguous(),
                torch.ones((b, n), dtype=torch.int32, device=dev),
                topo.nbrs, topo.rev)
        kw = dict(kind="max", per_origin=True, extracts=True,
                  emit_inbox=False)
        ms = time_ms(lambda: ops.round_step(*args, **kw), reps=5)
        pl, blocks = ks.last_launch
        b_ms, b_by = bound((2 * k + 3) * plane,
                           (2 + 3 * k + 6 * p + 1) * b * n * u)
        out["round_step"].append({"shape": f"[{b}, {n}, {u}] int32 K={k}",
                                  "ms": ms, "bound_ms": b_ms,
                                  "bound_by": b_by,
                                  "launches_per_call": -(-b // 65535),
                                  "plan": dict(pl._asdict(), blocks=blocks)})
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
        print(f"store shapes {tag}: round_step {ms:.3f} ms (bound "
              f"{b_ms:.3f}, {-(-b // 65535)} launch(es), "
              f"{'bulk' if pl.bulk else 'direct'} {pl.vec_bytes} B lanes); "
              f"round_recv {ms_r:.3f} ms (bound {rb_ms:.3f})", flush=True)
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


def expected_launches(engine, algo, rounds, configs=1):
    """Launches of one run: ``mega`` one ``round_step`` per δ-family round
    (one per 65,535 configs of a batch: the kernel's chunks);
    ``fused`` one ``round_recv`` (+ ``buffer_fold`` for bp/bprr); the resync
    modes one ``round_recv`` per round on either kernel engine, and
    ``digest_driven`` one ``digest_blocks`` + one ``masked_extract``;
    ``reference`` none."""
    kern = engine in ("fused", "mega")
    resync = algo in ("state_driven", "digest_driven")
    digest = kern and algo == "digest_driven"
    chunks = -(-configs // 65535)
    return {"round_step": rounds * chunks if engine == "mega" and not resync
            else 0,
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

    def run(self, tag, engine, algo, rounds, fn, configs=1):
        from repro_torch import kernels

        before = kernels.launch_counts()
        r = fn()
        after = kernels.launch_counts()
        used = {k: after[k] - before[k] for k in after}
        want = expected_launches(engine, algo, rounds, configs)
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
              runs=SCALE_RUNS):
    """``runs`` runs, each timed on the host clock around a synchronised
    device, after a one-round run of the same configuration (which builds
    the op's tables and grows the allocator's pool); every run's launches
    are checked. Returns the last result, ms per round as (median, min,
    max) over the runs and the peak device memory."""
    import torch

    launches.run(f"{tag} warm-up", engine, algo, 1, lambda: simulate_fn(1, 0),
                 configs)
    gc.collect()                 # what earlier phases left in cycles goes
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, r = [], None
    for _ in range(runs):
        r = None                           # one result alive at a time
        t0 = time.perf_counter()
        r = launches.run(tag, engine, algo, rounds, simulate_fn, configs)
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
    round, peak memory and the round's byte bound."""
    import torch

    from repro_torch.sync import (cluster_uniform, simulate, simulate_store,
                                  topology)
    from repro_torch.sync import workloads as W

    nodes, objects, slots, active, quiet, ops = RETWIS_PAPER
    topo = topology.partial_mesh(nodes, 4)
    lat, spec, counts = retwis_store(1.0, nodes, objects, slots, active, ops)
    plane = objects * nodes * slots * 4
    rows, t0 = [], time.perf_counter()
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
            objects, runs=MILLION_RUNS)
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
                        objects)
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
                           object_metrics=False), objects)
    resume_s = time.perf_counter() - t
    check(same_store(base, res), "store 1M: resume from round 10 differs "
                                 "from the uninterrupted run")
    del res
    shutil.rmtree(ckdir, ignore_errors=True)
    torch.cuda.empty_cache()

    per = launches.run("store 1M bprr mega object_metrics", "mega", "bprr",
                       rounds, lambda: store("mega", object_metrics=True),
                       objects)
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


def same_obs(a, b) -> bool:
    """Equal runs (metrics, convergence, final states) with equal
    observability channels and matrices (tensors compared on the first
    run's device)."""
    import numpy as np
    import torch

    def equal(x, y):
        if isinstance(x, torch.Tensor):
            return torch.equal(x, y.to(x.device))
        return np.array_equal(x, y)

    fa, fb = obs_fields(a), obs_fields(b)
    return same_run(a, b) and fa.keys() == fb.keys() and all(
        equal(fa[k], fb[k]) for k in fa)


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


def obs_fig_telemetry(check, launches, trace):
    """(a) ``benchmarks/results/fig_telemetry.json``'s 18 cells, value for
    value, on the three engines: the fig7 GSet workload on tree and mesh,
    the mesh at 10% loss, and the 25% join of state / state_driven /
    digest_driven, rebuilt here as ``benchmarks/fig_telemetry.py`` builds
    them."""
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
            runs = obs_engines(
                check, launches, f"fig_telemetry {name} {algo}", algo,
                events + quiet,
                lambda e, d: simulate(algo, lat, topo, op, events, quiet,
                                      faults=faults, engine=e,
                                      telemetry=TelemetrySpec(), device=d))
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
        runs = obs_engines(
            check, launches, f"fig_telemetry join {algo}", algo,
            OBS_JOIN_ROUNDS,
            lambda e, d: simulate(algo, GSet(OBS_JOIN_U).lattice, mesh,
                                  no_op, 0, OBS_JOIN_ROUNDS,
                                  x0=x0, digest=DigestSpec(64),
                                  track_convergence=True, engine=e,
                                  telemetry=TelemetrySpec(), device=d))
        for e, r in runs.items():
            got = fig_telemetry_row(r)
            check(got == want, f"fig_telemetry join {algo} {e}: {got} vs "
                               f"{want}")
        cells += 1
    torch.cuda.synchronize()
    return {"cells": cells}


def obs_fig_provenance(check, launches, trace):
    """(b) ``benchmarks/fig_provenance.py``'s scenarios (no committed
    result): the fig7 GSet workload on tree and mesh and the mesh at 10%
    loss with telemetry and provenance, and the two anomaly runs, each on
    three engines and on the CPU, all equal; waste_bp + waste_cp == recv
    − novel for every (round, node); bprr back-propagates nothing; the
    joining replica under bprr is non-convergence, the partition under
    state fault stalls, and state_driven's join is not flagged."""
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
            runs = obs_engines(
                check, launches, tag, algo, events + quiet,
                lambda e, d: simulate(algo, lat, topo, op, events, quiet,
                                      faults=faults, engine=e,
                                      telemetry=TelemetrySpec(),
                                      provenance=ProvenanceSpec(), device=d),
                cpu=True)
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
        runs = obs_engines(
            check, launches, f"anomaly join {algo}", algo, OBS_JOIN_ROUNDS,
            lambda e, d: simulate(algo, GSet(OBS_JOIN_U).lattice, mesh,
                                  no_op, 0, OBS_JOIN_ROUNDS, x0=x0,
                                  track_convergence=True, engine=e,
                                  telemetry=TelemetrySpec(), device=d),
            cpu=True)
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
    runs = obs_engines(
        check, launches, "anomaly partition state", "state", total,
        lambda e, d: simulate("state", lat, mesh, op, 2, total - 2,
                              faults=cut, engine=e,
                              telemetry=TelemetrySpec(), device=d),
        cpu=True)
    evs = detect_stalls(runs["mega"].telemetry, tx=runs["mega"].tx, k=3)
    check(bool(evs) and all(ev.cause == FAULT_STALL for ev in evs),
          f"anomaly partition state: {evs}")
    stalls["partition"] = evs
    return {"waste_by_cause": {k: {c: int(v) for c, v in w.items()}
                               for k, w in shares.items()},
            "stalls": {k: [vars(ev) for ev in v] for k, v in stalls.items()}}


def obs_scale(check, launches):
    """(c) GMap 4,194,304 keys, K = 10%, mesh15d4, 12 + 8 rounds, bprr and
    classic, with ``telemetry=`` and ``provenance=`` on mega, fused and
    reference: tx / mem / cpu and the final states equal the run without
    observability; every channel and matrix equal across the engines;
    recv / novel / buf / div_gap and waste_bp / waste_cp / covered equal
    27,962 × the GCounter(15) run's, stale_rounds and ack_lag equal. mega
    timed off, with telemetry and with both (median, min, max of 5 runs
    after a warm-up); peak memory."""
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
    part_s, out = {}, {}

    def part(name, fn, *args):
        t0 = time.perf_counter()
        with trace.span(name):
            r = fn(*args)
        part_s[name] = time.perf_counter() - t0
        print(f"  obs part {name}: {part_s[name]:.1f} s", flush=True)
        return r

    out["fig_telemetry"] = part("a_fig_telemetry", obs_fig_telemetry, check,
                                launches, trace)
    out["fig_provenance"] = part("b_fig_provenance", obs_fig_provenance,
                                 check, launches, trace)
    rows, bprr_final = part("c_scale", obs_scale, check, launches)
    out["scuttlebutt"] = part("d_scuttlebutt", obs_scuttlebutt, check,
                              bprr_final)
    del bprr_final
    out["batched"] = part("e_batched", obs_batched, check, launches)
    check(len(trace.events) > 128, f"obs trace: {len(trace.events)} events")
    out.update(scale=rows, part_s=part_s, trace_events=len(trace.events))
    log["obs"] = out
    return trace


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import kernels
    from repro_torch.kernels import _build

    global INT_OPS_PER_S
    check = Checks()
    dev = torch.device("cuda")
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
    timed("retwis_paper", retwis_paper_phase, check, expect6, log)
    timed("store_1m", million_phase, check, expect6, log)
    launches6 = kernels.launch_counts()
    check(launches6 == expect6.total, f"batched main-path launches "
                                      f"{launches6}, expected {expect6.total}")
    for name in SYNC_KERNELS:
        check(launches6[name] > 0, f"{name} was never launched on the "
                                   f"batched main path")

    # 7. the lex-pair main path (LWWMap, the merge entry points, the
    # quickstart), with the counters zeroed around it: the simulations
    # launch nothing, the merges one join, one delta_extract and two
    # lex_join_delta, the quickstart one delta_extract
    kernels.reset_launches()
    expect3 = Launches(check)
    timed("lww", lww_phase, check, expect3, log)
    timed("lww_small", lww_small_phase, check, expect3, log)
    timed("quickstart", quickstart_phase, check, log)
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
    timed("profile", profile_phase, check, log)

    rows = []
    for name, (src, replaces) in SOURCES.items():
        e, ms, plain_ms, b_ms, b_by, lib_ms = timings[name]
        err = max(e, grid_errs[name])
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": replaces,
               "launches": launches[name] + launches6[name]
               + launches8[name],
               "max_abs_err": err, "equal": err == 0, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": lib_ms,
               "launches_by_path": {"unbatched": launches[name],
                                    "batched": launches6[name],
                                    "observability": launches8[name]}}
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
