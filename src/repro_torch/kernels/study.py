"""Same-call timing study of ``round_step`` and ``digest_blocks`` on the card.

Two calls can land on two cards, so designs are compared inside one
process. Run from the root of a checkout, on a machine with an sm_90 card:

    python3 src/repro_torch/kernels/study.py kernels [--baseline DIR]
    python3 src/repro_torch/kernels/study.py rounds [--root CHECKOUT]

``kernels`` times, at the scale shapes of ``chip_smoke.py`` ([1, 15,
4,194,304] int32 on mesh15d4), ``round_step`` for bprr (K = 5, extracts)
under the plan :func:`round_step.plan` picks and under every other plan of
the kernel (lane bytes × ring stages, direct loads), classic (K = 1), and
``digest_blocks`` at be = 64; with ``--baseline`` also the sources
``DIR/round_step.cu`` and ``DIR/digest_blocks.cu`` of an earlier design
with the C interface of the first port (``git show
<commit>:src/repro_torch/csrc/round_step.cu``), built with the same flags.

``rounds`` times, for the port under ``CHECKOUT/src`` (default this
checkout, so an earlier commit unpacked by ``git archive`` can be run in
turn with this one), the paper-size runs (fig7's GSet and GCounter and
fig8's GMap 10% / 100% rows: 5 algorithms × tree and mesh × 3 engines, 100
+ 20 rounds) in seconds, GMap 4,194,304-key bprr and classic on ``mega``
and bprr on ``fused``, on the mesh (12 + 8 rounds), and the GMap join at
4,194,304 keys of ``chip_smoke.py``'s scale phase (donors hold keys
[0, 256) of every 1,024-key tile, the joiner nothing; 12 rounds, block 64)
for ``digest_driven`` on ``mega`` and ``fused`` and ``state_driven`` on
``mega``: ms/round as the median, min and max of 5 runs after a one-round
warm-up, with peak memory.

Kernel times are the median of 25 samples, each the CUDA-event time per
call of 5 back-to-back calls behind one more call, as in ``chip_smoke.py``.
Prints one JSON object per measurement and the card's ``nvidia-smi`` name
and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

KEYS = 4_194_304


def emit(**kw):
    print(json.dumps(kw), flush=True)


def time_ms(fn, reps=25, batch=5):
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
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip()


def equal(got, want) -> bool:
    import torch

    return all((g is None and w is None) or torch.equal(g, w)
               for g, w in zip(got, want))


def baseline_libs(src_dir: Path):
    """round_step and digest_blocks of the first port's design and C
    interface, built from ``src_dir`` with the port's flags into
    build/repro_torch/study/."""
    from repro_torch.kernels import _build as B

    out = B.BUILD_DIR / "study"
    out.mkdir(parents=True, exist_ok=True)
    procs = {n: subprocess.Popen(
        [B.nvcc_path(), *B.NVCC_FLAGS, "-I", str(B.CSRC), "-o",
         str(out / f"{n}.so"), str(src_dir / f"{n}.cu")])
        for n in ("round_step", "digest_blocks")}
    for n, p in procs.items():
        if p.wait() != 0:
            raise RuntimeError(f"nvcc failed for the baseline {n}")
    step = ctypes.CDLL(str(out / "round_step.so"))
    step.round_step_launch.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 14 \
        + [ctypes.c_int] * 6 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                ctypes.c_longlong, ctypes.c_void_p]
    dig = ctypes.CDLL(str(out / "digest_blocks.so"))
    dig.digest_blocks_launch.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    return step, dig


def kernels(baseline: Path | None):
    import torch

    from repro_torch.kernels import _build as B
    from repro_torch.kernels import digest_blocks as kd
    from repro_torch.kernels import round_step as ks
    from repro_torch.sync import topology

    B.build_all()
    base = baseline_libs(baseline) if baseline else None
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    topo = topology.partial_mesh(15, 4).on(dev)
    n, p = 15, 4

    def state(*shape):
        return torch.randint(0, 13, shape, generator=g, device=dev,
                             dtype=torch.int32)

    delta, x = state(1, n, KEYS), state(1, n, KEYS)
    act = topo.mask.to(torch.int32)[None].contiguous()
    dlv = torch.ones((1, n), dtype=torch.int32, device=dev)
    for flavor, k, per_origin, extracts in (("bprr", p + 1, True, True),
                                            ("classic", 1, False, False)):
        buf = state(k, 1, n, KEYS)
        args = (delta, x, buf, act, dlv, topo.nbrs, topo.rev)
        want = ks.plain(*args, per_origin=per_origin, extracts=extracts)
        chosen = ks.plan(n, p, k, per_origin, 4, KEYS, True)
        plans = {"chosen": chosen}
        if flavor == "bprr":
            s_rows, rows_in = 2 * p * n, (2 + k) * n
            for vb in ks.VEC_BYTES + (0,):
                for st in ((3, 2, 0) if vb else (0,)):
                    row = 32 * (vb or 4)
                    bars = -(-8 * st // 16) * 16
                    smem = chosen.table_bytes + bars + (s_rows + st * rows_in) \
                        * row
                    if smem <= ks.SMEM_LIMIT:
                        plans[f"vb{vb}_st{st}"] = chosen._replace(
                            tile=row // 4, vec_bytes=vb, stages=st,
                            bar_bytes=bars, smem=smem)
        for name, pl in plans.items():
            def run(pl=pl):
                return ks._launch(*args, "max", per_origin, extracts, False,
                                  pl=pl)
            ok = equal(run(), want)
            emit(kernel="round_step", flavor=flavor, plan=name,
                 **pl._asdict(), blocks=ks.last_launch[1], equal=ok,
                 ms=time_ms(run))
        if base is not None:
            outs = (torch.empty_like(x), torch.empty_like(buf),
                    torch.zeros((1, n, 2), dtype=torch.int32, device=dev),
                    *(torch.zeros((1, n, p), dtype=torch.int32, device=dev)
                      for _ in range(3)))
            s = p if per_origin else 1
            tb = ks.table_bytes(n, p)

            def old(outs=outs, args=args, k=k, per_origin=per_origin,
                    extracts=extracts, s=s, tb=tb):
                for o in outs[2:]:
                    o.zero_()
                with B.launching(dev) as stream:
                    err = base[0].round_step_launch(
                        1, *(B.ptr(a) for a in args), B.ptr(outs[0]),
                        B.ptr(outs[1]), None, *(B.ptr(o) for o in outs[2:]),
                        1, n, p, k, int(per_origin), int(extracts), KEYS,
                        min(n, 32), tb, tb + 4 * 32 * n * (1 + k + s),
                        stream)
                if err:
                    raise RuntimeError(f"baseline round_step: error {err}")
            old()
            xo, bo, nodecnt, ssend, cnt, dsz = outs
            ok = equal((xo, bo, None, nodecnt[..., 0], nodecnt[..., 1],
                        ssend, cnt, dsz), want)
            emit(kernel="round_step", flavor=flavor, plan="baseline",
                 equal=ok, ms=time_ms(old))
            del outs
        del buf, want
        torch.cuda.empty_cache()

    be = 64
    xd = state(n, KEYS)
    want = kd.plain(xd, be, "max")
    ok = torch.equal(kd.digest_blocks(xd, block_elems=be), want)
    emit(kernel="digest_blocks", plan="chosen", **kd.last_launch._asdict(),
         equal=ok, ms=time_ms(lambda: kd.digest_blocks(xd, block_elems=be)))
    if base is not None:
        out = torch.empty_like(want)

        def old_digest():
            with B.launching(dev) as stream:
                err = base[1].digest_blocks_launch(1, B.ptr(xd), B.ptr(out),
                                                   n, KEYS, be, stream)
            if err:
                raise RuntimeError(f"baseline digest_blocks: error {err}")
        old_digest()
        emit(kernel="digest_blocks", plan="baseline",
             equal=torch.equal(out, want), ms=time_ms(old_digest))


def rounds():
    import torch

    from repro_torch.core import GCounter, GMap, GSet
    from repro_torch.kernels import _build as B
    from repro_torch.sync import (ALGORITHMS, ENGINES, RESYNC_ALGORITHMS,
                                  DigestSpec, simulate, topology)
    from repro_torch.sync import workloads as W

    B.build_all()
    benches = (lambda: (GSet(1500).lattice, W.gset_unique_op(15, 100)),
               lambda: (GCounter(15).lattice, W.gcounter_op(15)),
               lambda: (GMap(1000).lattice, W.gmap_block_op(15, 1000, 10)),
               lambda: (GMap(1000).lattice, W.gmap_block_op(15, 1000, 100)))
    algos = [a for a in ALGORITHMS if a not in RESYNC_ALGORITHMS]
    t0 = time.perf_counter()
    runs = 0
    for topo_name in ("tree", "mesh"):
        topo = topology.by_name(topo_name, 15, 4)
        for make in benches:
            lat, op = make()
            for algo in algos:
                for engine in ENGINES:
                    simulate(algo, lat, topo, op, 100, 20, engine=engine)
                    runs += 1
    torch.cuda.synchronize()
    emit(what="paper", runs=runs, seconds=time.perf_counter() - t0)
    topo = topology.by_name("mesh", 15, 4)
    op = W.gmap_block_op(15, KEYS, 10)
    lat = GMap(KEYS).lattice

    def timed_runs(what, run, rounds):
        """``run(active, quiet)``: one round, then 5 timed runs of
        ``rounds``."""
        run(*((1, 0) if rounds == 20 else (0, 1)))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            r = run(*((12, 8) if rounds == 20 else (0, rounds)))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3 / rounds)
            del r
        emit(what=what, ms_per_round=statistics.median(times),
             min=min(times), max=max(times),
             peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        torch.cuda.empty_cache()

    for algo, engine in (("bprr", "mega"), ("classic", "mega"),
                         ("bprr", "fused")):
        timed_runs(f"gmap{KEYS} mesh {algo} {engine}",
                   lambda a, q: simulate(algo, lat, topo, op, a, q,
                                         engine=engine), 20)
    x0 = torch.zeros((15, KEYS), dtype=torch.int32)
    x0[1:] = ((torch.arange(KEYS) % 1024) < 256).to(torch.int32)
    for algo, engine in (("digest_driven", "mega"), ("digest_driven",
                                                     "fused"),
                         ("state_driven", "mega")):
        timed_runs(f"join gmap{KEYS} mesh {algo} {engine}",
                   lambda a, q: simulate(
                       algo, lat, topo, lambda x, t: torch.zeros_like(x), a,
                       q, x0=x0, engine=engine, track_convergence=True,
                       digest=DigestSpec(64)), 12)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("what", choices=("kernels", "rounds"))
    ap.add_argument("--baseline", type=Path, default=None,
                    help="directory of an earlier round_step.cu and "
                         "digest_blocks.cu (kernels)")
    ap.add_argument("--root", type=Path, default=None,
                    help="checkout whose src/ holds the port to time "
                         "(rounds; default this one)")
    a = ap.parse_args(argv)
    root = (a.root or Path(__file__).resolve().parents[3]).resolve()
    here = Path(__file__).resolve().parent     # not a top-level module dir
    sys.path[:] = [q for q in sys.path if Path(q or ".").resolve() != here]
    sys.path.insert(0, str(root / "src"))
    import torch

    if not torch.cuda.is_available():
        print("study: no CUDA device", file=sys.stderr)
        return 1
    emit(root=str(root), card=card())
    if a.what == "kernels":
        kernels(a.baseline.resolve() if a.baseline else None)
    else:
        rounds()
    return 0


if __name__ == "__main__":
    sys.exit(main())
