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
   call where one exists (torch.maximum, torch.bitwise_or) and their byte
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
6. the lex-pair main path: LWWMap with 4,194,304 keys (the GMap 10% key
   blocks written as (timestamp + 1, node id + 1)), bprr and classic on the
   mesh, 12 + 8 rounds on the reference engine (ms per round, peak memory;
   27,962 × the GCounter(15) run; ``engine="mega"`` resolves to the
   reference and launches nothing); replicas merging the results through
   ``ops.lex_join_delta``, ``ops.join`` and ``ops.delta_extract``; LWWMap
   at 65,536 keys under 10% loss and in a digest_driven join, each run on
   the card equal to the CPU run; ``repro_torch.quickstart`` on the card
   equal to the CPU;
7. profile: ``torch.profiler`` over three GMap rounds per kernel engine
   (bprr), three LWWMap rounds (reference) and three digest_driven rounds
   on ``fused`` — device time by kernel and the device's busy share; a
   profiler failure fails the run.

Phases 4–5 are the sync engines' main path and phase 6 the lex-pair one
(the elementwise kernels' users): the launch counters are zeroed before
and read after each. Prints
per-phase seconds, one ``{"kernels": [...]}`` line, the card's
``nvidia-smi`` name and power limit, and last ``{"ok": true, "device":
{...}}``; exits non-zero, without that line, if anything fails or no card
is present. Details go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO / "src"))

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


def expected_launches(engine, algo, rounds):
    """Launches of one run: ``mega`` one ``round_step`` per δ-family round;
    ``fused`` one ``round_recv`` (+ ``buffer_fold`` for bp/bprr); the resync
    modes one ``round_recv`` per round on either kernel engine, and
    ``digest_driven`` one ``digest_blocks`` + one ``masked_extract``;
    ``reference`` none."""
    kern = engine in ("fused", "mega")
    resync = algo in ("state_driven", "digest_driven")
    digest = kern and algo == "digest_driven"
    return {"round_step": rounds if engine == "mega" and not resync else 0,
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

    def run(self, tag, engine, algo, rounds, fn):
        from repro_torch import kernels

        before = kernels.launch_counts()
        r = fn()
        after = kernels.launch_counts()
        used = {k: after[k] - before[k] for k in after}
        want = expected_launches(engine, algo, rounds)
        self.check(used == want, f"{tag}: launches {used}, expected {want}")
        for k, v in want.items():
            self.total[k] += v
        return r


def all_engines(check, launches, tag, algo, rounds, fn):
    """``fn(engine)`` on the three engines; launch-checked, and the kernel
    engines bit-identical to the reference. Returns the reference run."""
    from repro_torch.sync import ENGINES

    runs = {e: launches.run(f"{tag} {e}", e, algo, rounds,
                            lambda e=e: fn(e)) for e in ENGINES}
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


def digest_phase(check, launches, log):
    """fig_digest.json's join and heal tables on all three engines."""
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
            runs += 3
    wall = time.perf_counter() - t0
    print(f"fig_digest: {runs} runs (join + heal) reproduced, engines "
          f"bit-identical ({wall:.1f} s)", flush=True)
    log["fig_digest"] = {"runs": runs, "wall_s": wall}
    return join_r25


def fault_phase(check, launches, log):
    """BENCH_fault.json: the δ-family under loss, a partition and churn."""
    import numpy as np

    from repro_torch.core import GSet
    from repro_torch.sync import FaultSchedule, simulate, topology
    from repro_torch.sync import workloads as W

    bench = json.loads((REPO / "benchmarks" / "results" /
                        "BENCH_fault.json").read_text())
    events, quiet = bench["events"], bench["quiet"]
    topo = topology.partial_mesh(bench["nodes"], 4)
    n = topo.num_nodes
    lossy = events + quiet // 4
    groups = (np.arange(n) >= n // 2).astype(np.int32)
    scheds = {
        "loss0": FaultSchedule.none(topo, events),
        "loss1": FaultSchedule.bernoulli(topo, lossy, 0.01, seed=7),
        "loss10": FaultSchedule.bernoulli(topo, lossy, 0.10, seed=7),
        "partition": FaultSchedule.partition(
            topo, events, events // 4, (3 * events) // 4, groups),
        "churn": FaultSchedule.churn(
            topo, events, [(1, events // 4, (3 * events) // 4),
                           (n - 2, events // 2, events - 1)]),
    }
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
            runs += 3
    wall = time.perf_counter() - t0
    print(f"BENCH_fault: {runs} runs reproduced, engines bit-identical "
          f"({wall:.1f} s)", flush=True)
    log["bench_fault"] = {"runs": runs, "wall_s": wall}


def scale_run(launches, tag, engine, algo, rounds, simulate_fn):
    """SCALE_RUNS runs, each timed on the host clock around a synchronised
    device, after a one-round run of the same configuration (which builds
    the op's tables and grows the allocator's pool); every run's launches
    are checked. Returns the last result, ms per round as (median, min,
    max) over the runs and the peak device memory."""
    import torch

    launches.run(f"{tag} warm-up", engine, algo, 1, lambda: simulate_fn(1, 0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, r = [], None
    for _ in range(SCALE_RUNS):
        r = None                           # one result alive at a time
        t0 = time.perf_counter()
        r = launches.run(tag, engine, algo, rounds, simulate_fn)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / rounds)
    return (r, (statistics.median(times), min(times), max(times)),
            torch.cuda.max_memory_allocated())


def scale_row(workload, topo, algo, engine, ms, b_ms, peak, r):
    med, lo, hi = ms
    return {"workload": workload, "topo": topo, "algo": algo,
            "engine": engine, "ms_per_round": med, "ms_per_round_min": lo,
            "ms_per_round_max": hi, "runs": SCALE_RUNS,
            "bound_ms_per_round": b_ms, "max_memory_allocated": peak,
            "total_tx": r.total_tx}


def print_scale(tag, ms, b_ms, peak, r):
    med, lo, hi = ms
    print(f"{tag}: {med:.3f} ms/round (median of {SCALE_RUNS}, {lo:.3f}-"
          f"{hi:.3f}; bound {b_ms:.3f}), peak {peak / 2**30:.2f} GiB, tx "
          f"{r.total_tx}", flush=True)


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


# -- phase 6: LWWMap through simulate, the merge entry points, quickstart -----

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
    mesh, bprr) per kernel engine, 3 LWWMap rounds of phase 6 (reference),
    and 3 digest_driven rounds of the GMap join (a) on ``fused``. Informs
    PERF.md."""
    import torch

    from repro_torch.core import GMap, LWWMap
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
# the kernels of the sync engines' main path (phases 4-5) and of the
# lex-pair one (phase 6: the public elementwise entry points)
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
    grid_errs.update(timed("elementwise_grid", elementwise_grid, check, dev,
                           log))
    timings = {name: t + (None,) for name, t in timed(
        "kernel_timings", kernel_timings, check, dev, log).items()}
    timings.update(timed("elementwise_timings", elementwise_timings, check,
                         dev, log))

    # 4 + 5. the sync engines' main path, with the launch counters zeroed
    # around it
    kernels.reset_launches()
    expect = Launches(check)
    timed("paper", paper_phase, check, expect, log)
    join_r25 = timed("fig_digest", digest_phase, check, expect, log)
    timed("bench_fault", fault_phase, check, expect, log)
    timed("scale", scale_phase, check, expect, log, join_r25)
    launches = kernels.launch_counts()
    check(launches == expect.total, f"main-path launches {launches}, the "
                                    f"runs' rounds give {expect.total}")
    for name in SYNC_KERNELS:
        check(launches[name] > 0, f"{name} was never launched on the main "
                                  f"path")

    # 6. the lex-pair main path (LWWMap, the merge entry points, the
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
    timed("profile", profile_phase, check, log)

    rows = []
    for name, (src, replaces) in SOURCES.items():
        e, ms, plain_ms, b_ms, b_by, lib_ms = timings[name]
        err = max(e, grid_errs[name])
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": err, "equal": err == 0, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": lib_ms})
    log["kernels"] = rows
    log["failed"] = check.failed
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(log, indent=1))
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
