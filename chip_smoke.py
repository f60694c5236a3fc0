#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Needs one sm_90 CUDA device (an H100) and ``nvcc``; builds the kernels from
``src/repro_torch/csrc`` on first use. Phases, each of which must pass:

1. environment: torch / CUDA versions and the card's name and power limit;
2. build: every kernel compiled by nvcc for sm_90a, and its time;
3. kernels: each CUDA kernel against its plain PyTorch version on the card,
   exactly (tolerance 0: integers and bit patterns), over kinds max
   (int32, bool) and bitor, buffers of K ∈ {0, 1, P+1}, extracts, the
   masked inbox, emit_stored/emit_cov, active/delivered masks with zeros,
   N ∈ {9, 15, 40} and U off tile multiples; then each timed (CUDA events, median of 25)
   beside its plain version and its byte bound at the scale phase's shapes;
4. paper size: ``simulate`` on the paper's 15-node tree and partial mesh,
   100 active + 20 quiet rounds, the five δ-family algorithms on all three
   engines, against every committed total of
   ``benchmarks/results/fig7_transmission.json`` (GSet, GCounter) and the
   GMap 10% / 100% rows of ``fig8_gmap.json``; engines bit-identical; each
   kernel engine's launches equal its rounds;
5. scale: GMap with 4,194,304 keys (K = 10%) and BitGSet with 2^27 bits,
   per-round metrics against closed-form oracles (27,962 × the GCounter(15)
   run; the GSet(180) run), ms per round (median, min and max of 5 timed
   runs), byte bound, peak device memory;
6. profile: ``torch.profiler`` over three GMap rounds per kernel engine —
   device time by kernel and the device's busy share (reported, not a gate).

Phases 4 and 5 are the main path: the launch counters are zeroed before
and read after them. Prints one ``{"kernels": [...]}`` line, the card's
``nvidia-smi`` name and power limit, and last
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
    from repro_torch.kernels import round_recv as kr
    from repro_torch.kernels import round_step as ks
    from repro_torch.sync import topology

    g = torch.Generator(device=dev).manual_seed(0)
    errs = {"round_step": 0.0, "round_recv": 0.0, "buffer_fold": 0.0}
    cases = {"round_step": 0, "round_recv": 0, "buffer_fold": 0}
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
    torch.cuda.synchronize()
    log["kernel_grid"] = {"cases": cases, "max_abs_err": errs}
    print(f"kernel grid: {cases} cases, max_abs_err {errs}", flush=True)
    return errs


def kernel_timings(check, dev, log):
    """Each kernel at the scale phase's shapes (GMap, 4,194,304 keys, the
    paper's mesh, bprr): exact check, then kernel / plain time and bound."""
    import torch

    from repro_torch.kernels import buffer_fold as kf
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
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    for name, (e, ms, plain_ms, b_ms, b_by) in out.items():
        check(e == 0, f"{name} at scale shapes: err {e}")
        print(f"kernel {name}: {ms:.4f} ms (plain {plain_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms by {b_by}), max_abs_err {e}", flush=True)
    log["kernel_timings"] = {n_: dict(zip(
        ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by"), v))
        for n_, v in out.items()}
    return out


# -- phases 4 and 5: the main path ---------------------------------------------

def same_run(a, b) -> bool:
    import numpy as np
    import torch

    return all(np.array_equal(x, y) for x, y in zip(
        (a.tx, a.mem, a.cpu, a.max_mem_node),
        (b.tx, b.mem, b.cpu, b.max_mem_node))) and torch.equal(a.final_x,
                                                                b.final_x)


def expected_launches(engine, algo, rounds):
    return {"round_step": rounds if engine == "mega" else 0,
            "round_recv": rounds if engine == "fused" else 0,
            "buffer_fold": rounds if engine == "fused"
            and algo in ("bp", "bprr") else 0}


def paper_phase(check, log):
    from repro_torch import kernels
    from repro_torch.core import GCounter, GMap, GSet
    from repro_torch.sync import ALGORITHMS, ENGINES, simulate, topology
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
                row = fig[f"{bench}_{topo_name}"]["raw"][algo]
                runs = {}
                for engine in ENGINES:
                    before = kernels.launch_counts()
                    r = simulate(algo, lat, topo, op, 100, 20, engine=engine)
                    after = kernels.launch_counts()
                    used = {k: after[k] - before[k] for k in after}
                    tag = f"paper {bench}_{topo_name} {algo} {engine}"
                    check(used == expected_launches(engine, algo, 120),
                          f"{tag}: launches {used}")
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
                    runs[engine] = r
                    cells += 1
                for engine in ("fused", "mega"):
                    check(same_run(runs["reference"], runs[engine]),
                          f"paper {bench}_{topo_name} {algo}: {engine} differs "
                          f"from reference")
    wall = time.perf_counter() - t0
    print(f"paper size: {cells} runs against fig7/fig8, engines bit-identical "
          f"({wall:.1f} s); mem_max_node checked in {peak_checked} runs, "
          f"{peak_lacking} runs' rows lack it", flush=True)
    log["paper"] = {"runs": cells, "wall_s": wall,
                    "mem_max_node_checked": peak_checked,
                    "mem_max_node_lacking": peak_lacking}


def scale_run(simulate_fn, rounds):
    """SCALE_RUNS runs, each timed on the host clock around a synchronised
    device, after a one-round run of the same configuration (which builds
    the op's tables and grows the allocator's pool). Returns the last
    result, ms per round as (median, min, max) over the runs, peak device
    memory and each timed run's kernel launches."""
    import torch

    from repro_torch import kernels

    simulate_fn(1, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, used, r = [], [], None
    for _ in range(SCALE_RUNS):
        r = None                           # one result alive at a time
        before = kernels.launch_counts()
        t0 = time.perf_counter()
        r = simulate_fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / rounds)
        after = kernels.launch_counts()
        used.append({n: after[n] - before[n] for n in after})
    return (r, (statistics.median(times), min(times), max(times)),
            torch.cuda.max_memory_allocated(), used)


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


def scale_phase(check, log):
    import numpy as np
    import torch

    from repro_torch.core import BitGSet, GCounter, GMap, GSet
    from repro_torch.sync import simulate, topology
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
            b_ms = (2 * k + 3) * plane / HBM_BYTES_PER_S * 1e3
            runs = {}
            for engine in ("mega", "fused"):
                r, ms, peak, used = scale_run(
                    lambda a=active, q=quiet: simulate(
                        algo, GMap(SCALE_KEYS).lattice, topo, op, a, q,
                        engine=engine), rounds)
                tag = f"scale gmap{SCALE_KEYS} {topo_name} {algo} {engine}"
                check(all(u == expected_launches(engine, algo, rounds)
                          for u in used), f"{tag}: launches {used}")
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
    b_ms = 13 * 15 * (BIT_UNIVERSE // 32) * 4 / HBM_BYTES_PER_S * 1e3
    runs = {}
    for engine in ("mega", "fused"):
        r, ms, peak, used = scale_run(lambda a=active, q=quiet: simulate(
            "bprr", BitGSet(BIT_UNIVERSE).lattice, topo, op, a, q,
            engine=engine), rounds)
        tag = f"scale bitgset2^27 mesh bprr {engine}"
        check(all(u == expected_launches(engine, "bprr", rounds)
                  for u in used), f"{tag}: launches {used}")
        for nm in ("tx", "mem", "cpu", "max_mem_node"):
            check(np.array_equal(getattr(r, nm), getattr(oracle, nm)),
                  f"{tag}: {nm} != GSet(180)")
        rows.append(scale_row("bitgset2^27", topo.name, "bprr", engine, ms,
                              b_ms, peak, r))
        runs[engine] = r
        print_scale(tag, ms, b_ms, peak, r)
    check(same_run(runs["mega"], runs["fused"]), "scale bitgset: engines differ")
    log["scale"] = rows


def profile_phase(log):
    """Where a round's time goes: ``torch.profiler`` over 3 active GMap
    rounds (4,194,304 keys, mesh, bprr) per kernel engine — device time by
    kernel, and the device's busy share of the profiled wall time. Informs
    PERF.md; a profiler failure is reported, not fatal."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import GMap
    from repro_torch.sync import simulate, topology
    from repro_torch.sync import workloads as W

    topo = topology.partial_mesh(15, 4)
    op = W.gmap_block_op(15, SCALE_KEYS, 10)
    lat = GMap(SCALE_KEYS).lattice
    out = {}
    for engine in ("mega", "fused"):
        try:
            simulate("bprr", lat, topo, op, 2, 0, engine=engine)   # warm-up
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                simulate("bprr", lat, topo, op, 3, 0, engine=engine)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            # kernels only: an aten op also reports its kernels' time
            rows = [(e.key, e.self_device_time_total / 1e3, e.count)
                    for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA
                    and e.self_device_time_total > 0]
        except Exception as exc:  # noqa: BLE001 - report, keep the smoke going
            print(f"profile {engine}: failed: {exc!r}", flush=True)
            out[engine] = {"error": repr(exc)}
            continue
        rows.sort(key=lambda r: -r[1])
        device_ms = sum(r[1] for r in rows)
        out[engine] = {"wall_ms_3_rounds": wall_ms,
                       "device_ms_3_rounds": device_ms,
                       "busy_share": device_ms / wall_ms if wall_ms else None,
                       "top": [{"kernel": k[:90], "ms": t, "calls": c}
                               for k, t, c in rows[:10]]}
        print(f"profile gmap mesh bprr {engine}: 3 rounds {wall_ms:.2f} ms "
              f"wall, {device_ms:.2f} ms on the device (busy "
              f"{device_ms / wall_ms:.1%})", flush=True)
        for k, t, c in rows[:6]:
            print(f"    {t:9.3f} ms  x{c:<4d} {k[:80]}", flush=True)
    log["profile"] = out


# -- driver ----------------------------------------------------------------------

SOURCES = {
    "round_step": ("src/repro_torch/csrc/round_step.cu",
                   "src/repro/kernels/round_step.py:148"),
    "round_recv": ("src/repro_torch/csrc/round_recv.cu",
                   "src/repro/kernels/round_recv.py:126"),
    "buffer_fold": ("src/repro_torch/csrc/buffer_fold.cu",
                    "src/repro/kernels/buffer_fold.py:59"),
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

    # 3. kernels against their plain versions
    grid_errs = kernel_grid(check, dev, log)
    timings = kernel_timings(check, dev, log)

    # 4 + 5. the main path, with the launch counters zeroed around it
    kernels.reset_launches()
    paper_phase(check, log)
    scale_phase(check, log)
    launches = kernels.launch_counts()
    for name, n in launches.items():
        check(n > 0, f"{name} was never launched on the main path")
    profile_phase(log)

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
