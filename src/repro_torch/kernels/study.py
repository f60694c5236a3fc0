"""Same-call timing study of the port's kernels on the card.

Two calls can land on two cards, so designs are compared inside one
process. Run from the root of a checkout, on a machine with an sm_90 card:

    python3 src/repro_torch/kernels/study.py kernels [--baseline DIR]
    python3 src/repro_torch/kernels/study.py rounds [--root CHECKOUT]
    python3 src/repro_torch/kernels/study.py slot_bump

``kernels`` times ``round_step`` under every plan of its ladder
(:func:`round_step.plans`, the default first): at the scale shapes of
``chip_smoke.py`` ([1, 15, 4,194,304] int32 on mesh15d4) for bprr (K = 5,
extracts) and classic (K = 1), and at the keyed store's shapes ([30,000,
50, 64] on mesh50 d4, bprr and classic; [1,048,576, 16, 32] on mesh16 d4,
bprr: the short-row kernel's plans), each checked equal to the plain
version; and ``digest_blocks`` at be = 64. With
``--baseline DIR`` also ``DIR/round_step.cu``, an earlier design with the
C interface the long-row kernel keeps (``round_step_launch``; ``git show
<commit>:src/repro_torch/csrc/round_step.cu``), built with the same flags
and launched under the long-row kernel's default plan, at every shape.

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

``slot_bump`` times the versioned-slot kernel and its plain version (the
seven PyTorch kernels it replaces) at the store's shapes, [30,000, 50, 64]
and a card's block of the 786,432-object store, [196,608, 50, 64], with
500 rows counted (1-3 bumps, a Retwis round's ops) and with every row
counted, each checked equal and set beside its byte bound (the delta
written, the counts read and the counted rows of x read, at 3.35 TB/s)
and beside PyTorch's ``zero_`` of a tensor of the delta's size, the rate
at which the card writes memory and nothing else. With 500 rows counted it
also times a sparse δ in PyTorch, checked equal: ``zeros_like``, then the
plain version on the counted rows alone, gathered and written back by
index. ``sparse_ms`` takes the counted rows' indices as made before the
call (as a table of them cut at set-up would give); ``sparse_nonzero_ms``
finds them in the call, by ``nonzero``, which waits for the card.

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


def baseline_lib(src_dir: Path):
    """``round_step`` of an earlier design with the long-row kernel's C
    interface, built from ``src_dir`` with the port's flags into
    build/repro_torch/study/."""
    from repro_torch.kernels import _build as B
    from repro_torch.kernels import round_step as ks

    out = B.BUILD_DIR / "study"
    out.mkdir(parents=True, exist_ok=True)
    so = out / "round_step.so"
    if subprocess.run([B.nvcc_path(), *B.NVCC_FLAGS, "-I", str(B.CSRC),
                       "-o", str(so), str(src_dir / "round_step.cu")]
                      ).returncode != 0:
        raise RuntimeError("nvcc failed for the baseline round_step")
    step = ctypes.CDLL(str(so))
    step.round_step_launch.argtypes = ks._SIGNATURE["round_step_launch"]
    return step


# (shape, configs, nodes, columns, flavours) of ``kernels``
SHAPES = (("gmap", 1, 15, KEYS, ("bprr", "classic")),
          ("retwis", 30_000, 50, 64, ("bprr", "classic")),
          ("million", 1 << 20, 16, 32, ("bprr",)))


def kernels(baseline: Path | None):
    import torch

    from repro_torch.kernels import _build as B
    from repro_torch.kernels import digest_blocks as kd
    from repro_torch.kernels import round_step as ks
    from repro_torch.sync import topology

    B.build_all()
    base = baseline_lib(baseline) if baseline else None
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)

    def state(*shape):
        return torch.randint(0, 13, shape, generator=g, device=dev,
                             dtype=torch.int32)

    for shape, b, n, u, flavours in SHAPES:
        topo = topology.partial_mesh(n, 4).on(dev)
        p = topo.max_degree
        delta, x = state(b, n, u), state(b, n, u)
        act = topo.mask.to(torch.int32).expand(b, n, p).contiguous()
        dlv = torch.ones((b, n), dtype=torch.int32, device=dev)
        for flavor in flavours:
            bprr = flavor == "bprr"
            k = p + 1 if bprr else 1
            buf = state(k, b, n, u)
            args = (delta, x, buf, act, dlv, topo.nbrs, topo.rev)
            flags = ("max", bprr, bprr, not bprr)
            want = ks.plain(*args, *flags)
            cands = ks.plans(n, p, k, bprr, 4, u, True)
            for i, pl in enumerate(cands):
                def run(pl=pl):
                    return ks._launch(*args, *flags, pl=pl)
                ok = equal(run(), want)
                emit(kernel="round_step", shape=f"[{b}, {n}, {u}]",
                     flavor=flavor, plan="default" if i == 0 else
                     ("short" if pl.short else "long"), **pl._asdict(),
                     blocks=ks.last_launch[1], equal=ok, ms=time_ms(run))
            if base is not None:
                old = ks.long_plans(n, p, k, bprr, 4, u, True)[0]
                outs = (torch.empty_like(x), torch.empty_like(buf),
                        torch.empty((p, b, n, u), dtype=torch.int32,
                                    device=dev) if not bprr else None,
                        torch.zeros((b, n, 2), dtype=torch.int32,
                                    device=dev),
                        *(torch.zeros((b, n, p), dtype=torch.int32,
                                      device=dev) for _ in range(3)))

                def parent(outs=outs, args=args, k=k, bprr=bprr, old=old):
                    for o in outs[3:]:
                        o.zero_()
                    blocks = ctypes.c_longlong(0)
                    with B.launching(dev) as stream:
                        err = base.round_step_launch(
                            1, *(B.ptr(a) for a in args),
                            *(B.ptr(o) for o in outs), b, n, p, k, int(bprr),
                            int(bprr), u, old.vec_bytes, old.reg_tally,
                            old.stages, old.threads, old.table_bytes,
                            old.bar_bytes, old.smem, ctypes.byref(blocks),
                            stream)
                    if err:
                        raise RuntimeError(f"baseline round_step: error "
                                           f"{err}")
                parent()
                xo, bo, ib, nodecnt, ssend, cnt, dsz = outs
                ok = equal((xo, bo, ib, nodecnt[..., 0], nodecnt[..., 1],
                            ssend, cnt, dsz), want)
                emit(kernel="round_step", shape=f"[{b}, {n}, {u}]",
                     flavor=flavor, plan="baseline", **old._asdict(),
                     equal=ok, ms=time_ms(parent))
                del outs
            del buf, want, args
            torch.cuda.empty_cache()
        del delta, x, act, dlv
        torch.cuda.empty_cache()

    be = 64
    xd = state(15, KEYS)
    want = kd.plain(xd, be, "max")
    ok = torch.equal(kd.digest_blocks(xd, block_elems=be), want)
    emit(kernel="digest_blocks", plan="chosen", **kd.last_launch._asdict(),
         equal=ok, ms=time_ms(lambda: kd.digest_blocks(xd, block_elems=be)))


HBM_BYTES_PER_S = 3.35e12


def sparse_slot_bump(x, cnt, u, idx=None):
    """The versioned-slot δ in PyTorch, written only where it is not ⊥:
    zeros, and the plain version on the rows ``idx`` (those with a count
    above 0; found by ``nonzero`` when None)."""
    import torch

    from repro_torch.kernels import slot_bump as ksb

    flat = cnt.reshape(-1)
    if idx is None:
        idx = (flat > 0).nonzero().squeeze(1)
    out = torch.zeros_like(x)
    out.view(-1, u)[idx] = ksb.plain(x.view(-1, u)[idx], flat[idx], u)
    return out


def slot_bump():
    import torch

    from repro_torch.kernels import slot_bump as ksb

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    for b in (30_000, 196_608):
        n, u = 50, 64
        x = torch.randint(0, 13, (b, n, u), generator=g, device=dev,
                          dtype=torch.int32)
        rows = b * n
        sparse = torch.zeros(rows, dtype=torch.int32, device=dev)
        at = torch.randperm(rows, generator=g, device=dev)[:500]
        sparse[at] = torch.randint(1, 4, (500,), generator=g, device=dev,
                                   dtype=torch.int32)
        for name, cnt in (("500 rows", sparse.view(b, n)),
                          ("every row", torch.ones((b, n), dtype=torch.int32,
                                                   device=dev))):
            counted = int((cnt > 0).sum())
            nbytes = (rows * u + rows + counted * u) * 4
            ok = torch.equal(ksb.slot_bump(x, cnt, u), ksb.plain(x, cnt, u))
            ms = time_ms(lambda: ksb.slot_bump(x, cnt, u))
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            sparse_ms = {}
            if name == "500 rows":
                idx = (cnt.reshape(-1) > 0).nonzero().squeeze(1)
                ok &= torch.equal(sparse_slot_bump(x, cnt, u, idx),
                                  ksb.slot_bump(x, cnt, u))
                sparse_ms = dict(
                    sparse_ms=time_ms(
                        lambda: sparse_slot_bump(x, cnt, u, idx)),
                    sparse_nonzero_ms=time_ms(
                        lambda: sparse_slot_bump(x, cnt, u)))
            emit(kernel="slot_bump", shape=f"[{b}, {n}, {u}]", counts=name,
                 equal=ok, ms=ms, bound_ms=bound,
                 pct_of_bound=100 * bound / ms,
                 plain_ms=time_ms(lambda: ksb.plain(x, cnt, u)), **sparse_ms)
        out = torch.empty_like(x)
        emit(kernel="zero_", shape=f"[{b}, {n}, {u}]",
             ms=time_ms(out.zero_),
             bound_ms=rows * u * 4 / HBM_BYTES_PER_S * 1e3)
        del x, sparse, out
        torch.cuda.empty_cache()


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
    ap.add_argument("what", choices=("kernels", "rounds", "slot_bump"))
    ap.add_argument("--baseline", type=Path, default=None,
                    help="directory of an earlier round_step.cu with the "
                         "long-row kernel's C interface (kernels)")
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
    elif a.what == "slot_bump":
        slot_bump()
    else:
        rounds()
    return 0


if __name__ == "__main__":
    sys.exit(main())
