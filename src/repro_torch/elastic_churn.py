"""Elastic fleet simulation: membership, failure, restart, catch-up — the
port's counterpart of the JAX package's ``examples/elastic_churn.py``.

    PYTHONPATH=src python -m repro_torch.elastic_churn               # the card
    PYTHONPATH=src python -m repro_torch.elastic_churn --device cpu  # the CPU

A 12-node gossip fleet (partial mesh) runs BP+RR synchronization of its
control plane (membership GSet, heartbeat GMap, progress GCounter,
checkpoint registry). Faults are driven by a ``sync.faults.FaultSchedule``
wired into ``LocalTransport.drop_fn``: node 7 is down for a 10-round epoch
while every link also drops 3% of messages. Mid-run the failure detector
flags the dead node and the elastic planner reassigns DP ranks; later the
node restarts from nothing and catches up purely from gossip plus one
state-driven bootstrap. It prints what the JAX example prints and ends with
``elastic_churn OK``.

:func:`run` drives any :class:`Fleet` (more nodes, several dead ones, a
shard ledger, a drain until every store agrees) and returns its numbers and
final states.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointRegistry
from repro_torch.core import GCounter
from repro_torch.data import ShardLedger
from repro_torch.runtime import (FailureDetector, GossipNode, LocalTransport,
                                 beat, converged, join_cluster,
                                 plan_from_view, register_membership,
                                 sync_round)
from repro_torch.runtime.gossip import bootstrap
from repro_torch.sync import FaultSchedule, topology
from repro_torch.sync.simulator import resolve_device


DEGREE = 4              # partial-mesh degree
ROUNDS = 24             # rounds under the fault schedule, then the drain
DOWN_AT, BACK_AT = 6, 16  # the dead nodes are down in [DOWN_AT, BACK_AT)
LOSS, SEED = 0.03, 11   # Bernoulli message loss on every link, its seed
TOKENS = 512            # progress a node adds each round
CHECKPOINT_EVERY = 5    # a checkpoint is announced at rnd % 5 == 4


@dataclasses.dataclass(frozen=True)
class Fleet:
    """One control-plane scenario; the defaults are the JAX example's."""

    nodes: int = 12
    max_nodes: int = 32
    dead: Tuple[int, ...] = (7,)
    registry: int = 128              # checkpoint registry capacity
    ledger: Optional[int] = None     # shards of a shard-ledger store
    drain: Optional[int] = 6         # fault-free rounds; None: until every
                                     # store has converged


def _register(nd: GossipNode, fleet: Fleet, gc, registry, device):
    register_membership(nd, fleet.max_nodes)
    join_cluster(nd, fleet.max_nodes)
    nd.register("progress", gc.lattice)
    nd.register("ckpt", registry.gmap.lattice)
    if fleet.ledger is not None:
        nd.register("ledger", ShardLedger(fleet.ledger, device).gmap.lattice)


def run(fleet: Fleet = Fleet(), device="cuda", verbose: bool = True) -> dict:
    """The scenario on ``device``; returns its numbers and every node's
    final states (host arrays, per store [nodes, ...])."""
    dev = resolve_device(device)
    say = print if verbose else (lambda *a, **k: None)
    n, max_nodes, rounds = fleet.nodes, fleet.max_nodes, ROUNDS
    topo = topology.partial_mesh(n, DEGREE)

    # One declarative fault plan for the whole run: node-down epochs plus
    # background message loss on every link.
    sched = FaultSchedule.churn(
        topo, rounds, [(d, DOWN_AT, BACK_AT) for d in fleet.dead]) \
        .compose(FaultSchedule.bernoulli(topo, rounds, LOSS, seed=SEED))
    clock = {"t": 0}
    transport = LocalTransport()
    transport.drop_fn = sched.drop_fn(lambda: clock["t"])

    lists = topo.neighbor_lists()
    nodes = {i: GossipNode(i, lists[i], transport, dev) for i in range(n)}
    gc = GCounter(num_replicas=max_nodes)
    registry = CheckpointRegistry(fleet.registry, dev)
    for nd in nodes.values():
        _register(nd, fleet, gc, registry, dev)
    stores = list(nodes[0].stores)

    fd = FailureDetector(staleness_rounds=3)
    reg = {i: CheckpointRegistry(fleet.registry, dev) for i in range(n)}
    ledgers = {i: ShardLedger(fleet.ledger, dev) for i in range(n)} \
        if fleet.ledger is not None else None
    detected, plans, boot = {}, [], []

    t0 = time.perf_counter()
    for rnd in range(rounds):
        clock["t"] = rnd
        if rnd == BACK_AT:
            for dead in fleet.dead:
                say(f"  round {rnd}: node {dead} RESTARTS (empty state)")
                n2 = GossipNode(dead, lists[dead], transport, dev)
                _register(n2, fleet, gc, registry, dev)
                nodes[dead] = n2
                if ledgers is not None:
                    ledgers[dead] = ShardLedger(fleet.ledger, dev)
                # state-driven bootstrap from one neighbour (recovery after
                # the loss of all prior deltas — paper §VI, PMLDC'16)
                boot.append(bootstrap(n2, nodes[lists[dead][0]]))
                say(f"  bootstrap exchanged {boot[-1]} elements")
        # the schedule says who is up: down nodes run no ops and no sync
        alive = {i: nd for i, nd in nodes.items() if sched.up_at(rnd, i)}
        for i, nd in alive.items():
            beat(nd, max_nodes)
            st = nd.state("progress")
            delta = torch.zeros_like(st)
            delta[i] = st[i] + TOKENS
            nd.update("progress", delta)
            if rnd % CHECKPOINT_EVERY == CHECKPOINT_EVERY - 1:
                nd.update("ckpt", reg[i].announce(rnd))
            if ledgers is not None:
                led = ledgers[i]
                led.merge(nd.state("ledger"))
                shard = led.next_unclaimed(start=4 * i % fleet.ledger)
                if shard is not None:
                    nd.update("ledger", led.claim(shard))
        sync_round(alive)
        suspects = fd.suspects(nodes[0], rnd)
        new = [d for d in fleet.dead if d in suspects and d not in detected]
        if new:
            # heartbeat staleness fires once the last pre-crash beat has
            # gossiped over and aged out — a few rounds after DOWN_AT
            for d in new:
                detected[d] = rnd
            plan = plan_from_view(nodes[0], suspects)
            plans.append((rnd, tuple(suspects), plan.dp_size))
            say(f"  round {rnd}: suspects={suspects} -> elastic plan "
                f"dp_size={plan.dp_size} (was {n})")

    clock["t"] = rounds  # past the schedule: fault-free drain
    drained = 0
    while (drained < fleet.drain) if fleet.drain is not None else \
            not all(converged(nodes, s) for s in stores):
        if drained > 4 * n:
            raise RuntimeError(f"the fleet did not converge in {drained} "
                               f"fault-free rounds")
        sync_round(nodes)
        drained += 1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0

    first = nodes[fleet.dead[0]]
    out = {
        "detected": detected, "plans": plans, "bootstrap": boot,
        "latest_step": int(first.state("ckpt").max()) - 1,
        "progress": int(gc.value(first.state("progress"))),
        "rx_novel": sum(nd.rx_novel for nd in nodes.values()),
        "rx_redundant": sum(nd.rx_redundant for nd in nodes.values()),
        "sent_elements": transport.sent_elements,
        "converged": {s: converged(nodes, s) for s in stores},
        "drain_rounds": drained,
        "seconds": seconds,
        "s_per_round": seconds / (rounds + drained),
        "up_node_rounds": int(sched.up[:rounds].sum()),
        "final": {s: np.stack([nodes[i].state(s).cpu().numpy()
                               for i in range(n)]) for s in stores},
    }
    novel, red = out["rx_novel"], out["rx_redundant"]
    say(f"\nrestarted node caught up: newest checkpoint step="
        f"{out['latest_step']}, global progress={out['progress']:,} tokens")
    say(f"gossip efficiency (BP+RR): {novel:,} novel vs {red:,} redundant "
        f"elements received ({red / max(novel, 1):.2f}x)")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card; 'cpu' runs on "
                         "the CPU)")
    fleet = Fleet()
    out = run(fleet, ap.parse_args(argv).device)
    dead = fleet.dead[0]
    if not DOWN_AT < out["detected"].get(dead, -1) < BACK_AT:
        raise RuntimeError(f"node {dead} was not suspected while it was "
                           f"down: {out['detected']}")
    if not (out["converged"]["progress"] and out["converged"]["ckpt"]):
        raise RuntimeError(f"the fleet did not converge: {out['converged']}")
    print("elastic_churn OK")
    return out


if __name__ == "__main__":
    main()
