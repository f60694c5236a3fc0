"""Retwis application demo on the keyed object store, on the port (paper
§V-D at example scale, DESIGN.md §15).

    PYTHONPATH=src python -m repro_torch.retwis_app                # on the card
    PYTHONPATH=src python -m repro_torch.retwis_app --device cpu   # on the CPU

The counterpart of the JAX package's ``examples/retwis_app.py``. A
Twitter-clone data model on a *store* of independent CRDT objects:
follower sets, walls and timelines cycle through the object axis, each
synchronized per object by BP+RR over an 8-node mesh while a Zipf workload
(paper Table II op mix: 15% follow / 35% post / 50% read) concentrates
contention on the popular objects. The whole store runs as one batched
round loop, and the paper's byte sizes (20 B user ids, 301 B wall entries,
39 B timeline entries) ride the engine as per-object element weights. It
runs on the card unless ``--device cpu`` is given, and raises without a
card; it ends with ``retwis_app OK``. :func:`run` also returns the numbers
it prints.
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import value_lattices as vl
from repro_torch.core.lattice import MapLattice
from repro_torch.sync import StoreSpec, simulate_store, topology
from repro_torch.sync import workloads as W
from repro_torch.sync.simulator import resolve_device

OBJECTS, NODES, SLOTS, ROUNDS, DRAIN = 24, 8, 16, 30, 8
CLASSES = ("followers", "wall", "timeline")


def run(device="cuda") -> dict:
    """The store run on ``device``; prints its lines and returns their
    numbers (``lines`` the printed text)."""
    dev = resolve_device(device)
    topo = topology.partial_mesh(NODES, 4)
    lat = MapLattice(SLOTS, vl.max_int(), "retwis").build()

    # Zipf-contended Retwis schedule (seed-deterministic), compiled to the
    # store's batched op stream; per-object byte weights by object class
    wl = W.retwis(OBJECTS, NODES, ROUNDS, ops_per_node=4, zipf=1.2, seed=7)
    spec = StoreSpec(objects=OBJECTS,
                     op_fn=W.versioned_slot_op(wl.update_counts(), SLOTS),
                     weights=W.retwis_weights(OBJECTS))
    res = simulate_store("bprr", lat, topo, spec, active_rounds=ROUNDS,
                         quiet_rounds=DRAIN, track_convergence=True,
                         device=dev)

    lines = []

    def say(s):
        lines.append(s)
        print(s)

    out = {"total_tx_bytes": res.total_tx_bytes}
    say(f"retwis store: {OBJECTS} objects × {NODES} nodes, "
        f"{ROUNDS} rounds (+{DRAIN} drain)")
    say(f"  transmitted {res.total_tx_bytes / 1e3:8.1f} KB total "
        f"({res.total_tx_bytes / NODES / 1e3:.1f} KB/node)")
    conv = res.convergence_round()
    if not (conv >= 0).all():
        raise RuntimeError(f"every object must converge after the drain: "
                           f"{conv.tolist()}")
    out["converged_by"] = int(conv.max())
    say(f"  all {OBJECTS} objects converged by round {out['converged_by']}")

    # per-object views: the hottest object of each class
    tx_totals = res.tx_bytes.sum(axis=1)                   # [B]
    out["hottest"] = []
    for cls in range(3):
        ids = np.arange(cls, OBJECTS, 3)
        hot = int(ids[np.argmax(tx_totals[ids])])
        obj = res.object_result(hot)
        row = {"class": CLASSES[cls], "object": hot,
               "tx_bytes": float(tx_totals[hot]),
               "elements": int(obj.tx.sum()), "converged": int(conv[hot])}
        out["hottest"].append(row)
        say(f"  hottest {CLASSES[cls]:9s} object #{hot:2d}: "
            f"{row['tx_bytes'] / 1e3:7.1f} KB sent, "
            f"{row['elements']} elements, "
            f"converged at round {row['converged']}")

    # the weighted footprint straight from the engine (Lattice.wsize)
    out["footprint_bytes"] = float(res.final_state_bytes.sum())
    say(f"  final store footprint {out['footprint_bytes'] / 1e3:.1f} KB "
        f"across the cluster")
    say("retwis_app OK")
    out["lines"] = lines
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card; 'cpu' runs on "
                         "the CPU)")
    return run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
