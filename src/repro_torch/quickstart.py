"""Quickstart: the paper's core objects, on the port.

    PYTHONPATH=src python -m repro_torch.quickstart                # on the card
    PYTHONPATH=src python -m repro_torch.quickstart --device cpu   # on the CPU

The counterpart of the JAX package's ``examples/quickstart.py``: CRDT
states and mutators, optimal deltas Δ(a, b), Algorithm 2 (BP+RR) against
the classic algorithm on the paper's partial mesh, and the fused
``delta_extract`` kernel over a 65,536-entry map. It runs on the card
unless ``--device cpu`` is given, and raises without a card; it ends with
``quickstart OK``. :func:`main` also returns the numbers it prints.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import GCounter, GSet
from repro_torch.kernels import ops as kops
from repro_torch.sync import converged, simulate, topology
from repro_torch.sync.simulator import resolve_device


def run(device="cuda") -> dict:
    """The four sections on ``device``; returns their numbers."""
    dev = resolve_device(device)
    out = {}

    print("== 1. GCounter: states, mutators, optimal δ-mutators ==")
    gc = GCounter(num_replicas=3)
    p = gc.lattice.bottom(dev)
    for _ in range(5):
        p = gc.inc(p, 0)          # replica A increments 5 times
    p = gc.inc(p, 1)              # replica B once
    d = gc.inc_delta(p, 2)        # optimal delta: a single map entry
    out["gcounter"] = p.tolist()
    out["gcounter_value"] = int(gc.value(p))
    out["inc_delta"] = d.tolist()
    print(f"state={out['gcounter']}, value={out['gcounter_value']}")
    print(f"incᵟ by C -> delta={out['inc_delta']} (1 irreducible, not the "
          f"whole map)")

    print("\n== 2. Optimal deltas Δ(a, b) ==")
    gs = GSet(universe=8)
    lat = gs.lattice
    a = torch.tensor([1, 1, 1, 0, 0, 0, 0, 0], dtype=torch.bool, device=dev)
    b = torch.tensor([1, 0, 0, 1, 0, 0, 0, 0], dtype=torch.bool, device=dev)
    delta = lat.delta(a, b)
    assert bool(lat.leq(lat.join(delta, b), lat.join(a, b)))
    out["delta"] = delta.int().tolist()
    print(f"a={a.int().tolist()}  b={b.int().tolist()}")
    print(f"Δ(a,b)={out['delta']}  (exactly what b is missing from a)")

    print("\n== 3. Classic delta-based vs Algorithm 2 (BP+RR) on a mesh ==")
    n, rounds = 15, 30
    topo = topology.partial_mesh(n, 4)
    lat = GSet(universe=n * rounds).lattice
    rows = torch.arange(n, device=dev)

    def op_fn(x, t):
        ids = rows * rounds + min(t, rounds - 1)
        m = torch.zeros((n, n * rounds), dtype=torch.bool, device=dev)
        m[rows, ids] = True
        return m

    out["tx"], out["converged"] = {}, {}
    for algo in ("state", "classic", "bprr"):
        res = simulate(algo, lat, topo, op_fn, active_rounds=rounds,
                       quiet_rounds=10, device=dev)
        out["tx"][algo] = res.total_tx
        out["converged"][algo] = converged(lat, res.final_x)
        print(f"  {algo:8s}: {res.total_tx:>9,} elements transmitted "
              f"(converged={out['converged'][algo]})")

    print("\n== 4. The fused delta_extract kernel (RR hot path) ==")
    rng = np.random.default_rng(0)
    d = torch.from_numpy(rng.integers(0, 10, size=(1 << 16,))
                         .astype(np.int32)).to(dev)
    x = torch.from_numpy(rng.integers(0, 10, size=(1 << 16,))
                         .astype(np.int32)).to(dev)
    s, xj, cnt = kops.delta_extract(d, x)   # Δ + join + |⇓Δ| in one pass
    out["novel"] = int(cnt)
    print(f"  delta_extract over 65k-entry map: {out['novel']} novel "
          f"irreducibles")
    print("\nquickstart OK")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain versions on the CPU)")
    return run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
