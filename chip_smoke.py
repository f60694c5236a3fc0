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
   be ∈ {8, 32, 64, 128}, P ∈ {1, 4, 8} extraction masks all-zero, all-one
   and random, N ∈ {9, 15, 40} and U off tile and block multiples; then
   each timed (CUDA events, median of 25) beside its plain version and its
   byte bound at the scale phase's shapes;
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
6. profile: ``torch.profiler`` over three GMap rounds per kernel engine
   (bprr) and three digest_driven rounds on ``fused`` — device time by
   kernel and the device's busy share; a profiler failure fails the run.

Phases 4 and 5 are the main path: the launch counters are zeroed before
and read after them. Prints per-phase seconds, one ``{"kernels": [...]}``
line, the card's ``nvidia-smi`` name and power limit, and last
``{"ok": true, "device": {...}}``; exits non-zero, without that line, if
anything fails or no card is present. Details go to
``chiprun_out/chip_smoke.json``.
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
INT_OPS_PER_S = 67e12            # H100 SXM non-tensor 32-bit peak
REPS = 25
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
    """Median CUDA-event time of ``fn`` over ``reps`` calls, after two
    warm-up calls."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
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


def nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi: not available"


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
    errs = {name: 0.0 for name in SOURCES}
    cases = {name: 0 for name in SOURCES}
    for kind, tname in KINDS:
        dtype = {"int32": torch.int32, "bool": torch.bool,
                 "words": "words"}[tname]
        # N = 40: more nodes than a round_step block has node-threads
        for topo in (topology.partial_mesh(9, 4), topology.tree(15),
                     topology.partial_mesh(40, 4)):
            t = topo.on(dev)
            n, p = topo.num_nodes, topo.max_degree
            for flavor, k, per_origin, extracts in (
                    ("state", 0, False, False), ("classic", 1, False, False),
                    ("bp", p + 1, True, False), ("rr", 1, False, True),
                    ("bprr", p + 1, True, True)):
                for emit_inbox in (False, True):
                    b, u = 2, 1001
                    delta = rand_state(g, dtype, (b, n, u), dev)
                    x = rand_state(g, dtype, (b, n, u), dev)
                    buf = rand_state(g, dtype, (k, b, n, u), dev) if k else None
                    act = torch.randint(0, 2, (b, n, p), generator=g,
                                        device=dev, dtype=torch.int32) \
                        * t.mask.to(torch.int32)
                    dlv = torch.randint(0, 2, (b, n), generator=g, device=dev,
                                        dtype=torch.int32) if k else None
                    args = (delta, x, buf, act, dlv, t.nbrs, t.rev)
                    kw = dict(kind=kind, per_origin=per_origin,
                              extracts=extracts, emit_inbox=emit_inbox)
                    got = ks.round_step(*args, **kw)
                    views = [None if a is None else
                             (a.view(torch.uint8) if a.dtype == torch.bool else a)
                             for a in args]
                    want = ks.plain(*views, **kw)
                    want = tuple(None if w is None else
                                 (w.view(torch.bool) if w.dtype == torch.uint8 else w)
                                 for w in want)
                    e = max_abs_err(got, want)
                    errs["round_step"] = max(errs["round_step"], e)
                    cases["round_step"] += 1
                    check(e == 0, f"round_step {kind}/{tname} {topo.name} "
                                  f"{flavor} inbox={emit_inbox}: err {e}")
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
        # (1001, 333, 70) and one 16-byte aligned row width (1024)
        for n, u in ((9, 1001), (15, 333), (40, 70), (15, 1024)):
            x = rand_state(g, dtype, (n, u), dev)
            xv = x.view(torch.uint8) if x.dtype == torch.bool else x
            for be in (8, 32, 64, 128):
                e = max_abs_err(kd.digest_blocks(x, block_elems=be, kind=kind),
                                kd.plain(xv, be, kind))
                errs["digest_blocks"] = max(errs["digest_blocks"], e)
                cases["digest_blocks"] += 1
                check(e == 0, f"digest_blocks {kind}/{tname} n={n} u={u} "
                              f"be={be}: err {e}")
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


# -- phases 4 and 5: the main path ---------------------------------------------

def same_run(a, b) -> bool:
    import numpy as np
    import torch

    return all(np.array_equal(x, y) for x, y in zip(
        (a.tx, a.mem, a.cpu, a.max_mem_node),
        (b.tx, b.mem, b.cpu, b.max_mem_node))) and torch.equal(
        a.final_x, b.final_x) and ((a.uniform is None and b.uniform is None)
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
            "masked_extract": rounds if digest else 0}


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
    """The join scenarios' op stream: sync only."""
    import torch

    return torch.zeros_like(x)


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
    mesh, bprr) per kernel engine, and 3 digest_driven rounds of the GMap
    join (a) on ``fused``. Informs PERF.md."""
    import torch

    from repro_torch.core import GMap
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
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import kernels
    from repro_torch.kernels import _build

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
    timings = timed("kernel_timings", kernel_timings, check, dev, log)

    # 4 + 5. the main path, with the launch counters zeroed around it
    kernels.reset_launches()
    expect = Launches(check)
    timed("paper", paper_phase, check, expect, log)
    join_r25 = timed("fig_digest", digest_phase, check, expect, log)
    timed("bench_fault", fault_phase, check, expect, log)
    timed("scale", scale_phase, check, expect, log, join_r25)
    launches = kernels.launch_counts()
    check(launches == expect.total, f"main-path launches {launches}, the "
                                    f"runs' rounds give {expect.total}")
    for name, n in launches.items():
        check(n > 0, f"{name} was never launched on the main path")
    timed("profile", profile_phase, check, log)

    rows = []
    for name, (src, replaces) in SOURCES.items():
        e, ms, plain_ms, b_ms, b_by = timings[name]
        err = max(e, grid_errs[name])
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": err, "equal": err == 0, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": None})
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
