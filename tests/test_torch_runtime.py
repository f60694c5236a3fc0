"""The port's control-plane runtime (``repro_torch.runtime``, the checkpoint
registry, the shard ledger, the progress counter, ``Topology.
neighbor_lists`` and ``FaultSchedule.drop_fn``) against the JAX package's.

Every scenario of ``tests/test_runtime.py`` runs through both runtimes on
the same inputs (the chaos hooks draw from one numpy generator each, seeded
alike) and must agree exactly: every node's final store states and
δ-buffers, ``rx_novel``/``rx_redundant``, ``sent_elements``, suspects,
plans, bootstrap costs, ledger and registry reads. The JAX test's own
assertions are then checked on the port's run. Tolerance 0."""

import contextlib
import io
import runpy
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointRegistry as JRegistry
from repro.core import GCounter as JGCounter
from repro.core import GSet as JGSet
from repro.core import LWWMap as JLWWMap
from repro.core import PNCounter as JPNCounter
from repro.data import ProgressCounter as JProgress
from repro.data import ShardLedger as JLedger
from repro.runtime import gossip as jgossip
from repro.runtime import membership as jmember
from repro.sync import FaultSchedule as JFaults
from repro.sync import topology as jtopo
from repro_torch import elastic_churn
from repro_torch.checkpoint import CheckpointRegistry as TRegistry
from repro_torch.core import GCounter as TGCounter
from repro_torch.core import GSet as TGSet
from repro_torch.core import LWWMap as TLWWMap
from repro_torch.core import PNCounter as TPNCounter
from repro_torch.data import ProgressCounter as TProgress
from repro_torch.data import ShardLedger as TLedger
from repro_torch.runtime import gossip as tgossip
from repro_torch.runtime import membership as tmember
from repro_torch.sync import FaultSchedule as TFaults
from repro_torch.sync import topology as ttopo

REPO = Path(__file__).resolve().parents[1]


class Side:
    """One runtime's entry points behind the same names, so a scenario is
    written once and run through both."""

    def __init__(self, port: bool):
        self.port = port
        g, m = (tgossip, tmember) if port else (jgossip, jmember)
        self.g, self.m = g, m
        self.topology = ttopo if port else jtopo
        self.Faults = TFaults if port else JFaults
        self.GSet = TGSet if port else JGSet
        self.GCounter = TGCounter if port else JGCounter
        self.PNCounter = TPNCounter if port else JPNCounter
        self.LWWMap = TLWWMap if port else JLWWMap
        self.kw = {"device": "cpu"} if port else {}

    def node(self, i, nbrs, transport):
        return self.g.GossipNode(i, nbrs, transport, **self.kw)

    def ledger(self, shards):
        return (TLedger if self.port else JLedger)(shards, **self.kw)

    def registry(self, capacity):
        return (TRegistry if self.port else JRegistry)(capacity, **self.kw)

    def progress(self, nodes, i):
        return (TProgress if self.port else JProgress)(nodes, i, **self.kw)

    def onehot(self, u, k):
        if self.port:
            d = torch.zeros((u,), dtype=torch.bool)
            d[k] = True
            return d
        return jnp.zeros((u,), jnp.bool_).at[k].set(True)

    def bump(self, st, i, inc=1):
        if self.port:
            d = torch.zeros_like(st)
            d[i] = st[i] + inc
            return d
        return jnp.zeros_like(st).at[i].set(st[i] + inc)

    @staticmethod
    def np(x):
        if isinstance(x, tuple):                 # tuple states, leaf by leaf
            return tuple(Side.np(a) for a in x)
        return x.cpu().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x)

    def cluster(self, n=8, degree=4, max_nodes=16, topo=None):
        topo = self.topology.partial_mesh(n, degree) if topo is None \
            else topo
        transport = self.g.LocalTransport()
        lists = topo.neighbor_lists()
        nodes = {i: self.node(i, lists[i], transport)
                 for i in range(topo.num_nodes)}
        for nd in nodes.values():
            self.m.register_membership(nd, max_nodes)
            self.m.join_cluster(nd, max_nodes)
        return nodes, transport

    def snapshot(self, nodes, transport):
        """Everything a run leaves behind, as host values."""
        return {
            "sent": transport.sent_elements,
            "nodes": {i: {
                "rx": (nd.rx_novel, nd.rx_redundant),
                "neighbors": nd.neighbors,
                "stores": {name: (self.np(st.state),
                                  {o: self.np(d) for o, d in
                                   st.buffer.items()})
                           for name, st in nd.stores.items()}}
                for i, nd in nodes.items()},
        }


def same(a, b, path="") -> None:
    """Exact structural equality of two snapshots (numpy leaves by value
    and dtype kind)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), (path, a, b)
        for k in a:
            same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype.kind == b.dtype.kind, (path, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, (path, a, b)


def both(scenario, *args):
    """The scenario through the JAX runtime and the port; their outputs
    equal. Returns the port's."""
    want = scenario(Side(False), *args)
    got = scenario(Side(True), *args)
    same(want, got)
    return got


# -- the scenarios of tests/test_runtime.py -----------------------------------

def membership_converges(s):
    nodes, tr = s.cluster()
    for _ in range(6):
        for nd in nodes.values():
            s.m.beat(nd, 16)
        s.g.sync_round(nodes)
    return {"snap": s.snapshot(nodes, tr),
            "converged": s.g.converged(nodes, s.m.MEMBERS)}


def test_membership_converges():
    out = both(membership_converges)
    assert out["converged"]
    members = out["snap"]["nodes"][0]["stores"]["members"][0]
    assert list(np.nonzero(members)[0]) == list(range(8))


def rr_suppresses_redundant_traffic(s):
    nodes, tr = s.cluster()
    gs = s.GSet(universe=64)
    for nd in nodes.values():
        nd.register("set", gs.lattice)
    for r in range(8):
        for i, nd in nodes.items():
            nd.update("set", s.onehot(64, r * 8 + i))
        s.g.sync_round(nodes)
    for _ in range(6):
        s.g.sync_round(nodes)
    return {"snap": s.snapshot(nodes, tr),
            "converged": s.g.converged(nodes, "set")}


def test_rr_suppresses_redundant_traffic():
    out = both(rr_suppresses_redundant_traffic)
    assert out["converged"]
    rx = [v["rx"] for v in out["snap"]["nodes"].values()]
    novel, red = sum(a for a, _ in rx), sum(b for _, b in rx)
    assert novel >= 64 * 7 and red < novel * 3


def chaos_drops_and_duplicates(s):
    nodes, tr = s.cluster()
    rng = np.random.default_rng(0)
    tr.drop_fn = lambda a, b: rng.random() < 0.3
    tr.dup_fn = lambda a, b: rng.random() < 0.3
    gc = s.GCounter(num_replicas=8)
    for nd in nodes.values():
        nd.register("ctr", gc.lattice)
    for _ in range(10):
        for i, nd in nodes.items():
            nd.update("ctr", s.bump(nd.state("ctr"), i))
        s.g.sync_round(nodes)
    tr.drop_fn = None
    for _ in range(10):
        s.g.sync_round(nodes)
    return {"snap": s.snapshot(nodes, tr),
            "converged": s.g.converged(nodes, "ctr"),
            "value": int(gc.value(nodes[3].state("ctr"))),
            "draws": float(rng.random())}


def test_chaos_drops_and_duplicates_still_converge():
    out = both(chaos_drops_and_duplicates)
    assert out["converged"] and out["value"] == 80


def lossy_sparse(s, topo_name):
    n, rounds = 8, 10
    topo = s.topology.by_name(topo_name, n)
    nodes, tr = s.cluster(topo=topo)
    sched = s.Faults.bernoulli(topo, rounds, 0.3, seed=1)
    clock = {"t": 0}
    tr.drop_fn = sched.drop_fn(lambda: clock["t"])
    gs = s.GSet(universe=n * rounds)
    for nd in nodes.values():
        nd.register("set", gs.lattice)
    for r in range(rounds):
        clock["t"] = r
        for i, nd in nodes.items():
            nd.update("set", s.onehot(n * rounds, i * rounds + r))
        s.g.sync_round(nodes)
    clock["t"] = rounds
    for _ in range(2 * n):
        s.g.sync_round(nodes)
    return {"snap": s.snapshot(nodes, tr),
            "converged": (s.g.converged(nodes, "set"),
                          s.g.converged(nodes, s.m.MEMBERS))}


@pytest.mark.parametrize("topo_name", ["ring", "tree"])
def test_lossy_transport_converges_on_sparse_topologies(topo_name):
    out = both(lossy_sparse, topo_name)
    assert out["converged"] == (True, True)
    assert int(out["snap"]["nodes"][0]["stores"]["set"][0].sum()) == 80


def retained_buffers_drain(s):
    n, rounds = 6, 6
    topo = s.topology.ring(n)
    nodes, tr = s.cluster(topo=topo)
    sched = s.Faults.bernoulli(topo, rounds, 0.5, seed=3)
    clock = {"t": 0}
    tr.drop_fn = sched.drop_fn(lambda: clock["t"])
    mid = None
    for r in range(rounds):
        clock["t"] = r
        for nd in nodes.values():
            s.m.beat(nd, 16)
        s.g.sync_round(nodes)
        if r == rounds // 2:        # buffers retained mid-run
            mid = s.snapshot(nodes, tr)
    clock["t"] = rounds
    for _ in range(2 * n):
        s.g.sync_round(nodes)
    return {"mid": mid, "snap": s.snapshot(nodes, tr),
            "converged": s.g.converged(nodes, s.m.HEARTBEATS)}


def test_retained_buffers_drain_after_heal():
    out = both(retained_buffers_drain)
    assert out["converged"]
    for i, nd in out["snap"]["nodes"].items():
        for name, (_, buf) in nd["stores"].items():
            assert not buf, f"unflushed buffer on node {i}"


def failure_detection(s):
    nodes, tr = s.cluster()
    fd = s.m.FailureDetector(staleness_rounds=3)
    dead, seen = 5, []
    for rnd in range(10):
        for i, nd in nodes.items():
            if i != dead:
                s.m.beat(nd, 16)
        live = {i: nd for i, nd in nodes.items() if i != dead or rnd < 2}
        s.g.sync_round(live)
        seen.append(fd.suspects(nodes[0], rnd))
    plan = s.m.plan_from_view(nodes[0], seen[-1])
    return {"snap": s.snapshot(nodes, tr), "suspects": seen,
            "plan": (plan.alive, plan.dp_rank, plan.dp_size,
                     plan.world_size)}


def test_failure_detection_and_elastic_plan():
    out = both(failure_detection)
    assert 5 in out["suspects"][-1]
    alive, ranks, size, _ = out["plan"]
    assert 5 not in alive and size == 7
    assert sorted(ranks.values()) == list(range(7))


def node_rejoin(s):
    nodes, tr = s.cluster()
    for _ in range(4):
        s.g.sync_round(nodes)
    n2 = s.node(2, nodes[2].neighbors, tr)
    s.m.register_membership(n2, 16)
    s.m.join_cluster(n2, 16)
    cost = s.g.bootstrap(n2, nodes[n2.neighbors[0]])
    nodes[2] = n2
    for _ in range(6):
        for nd in nodes.values():
            s.m.beat(nd, 16)
        s.g.sync_round(nodes)
    return {"snap": s.snapshot(nodes, tr), "cost": cost,
            "converged": s.g.converged(nodes, s.m.MEMBERS)}


def test_node_rejoin_is_monotone():
    out = both(node_rejoin)
    assert out["converged"]
    assert int(out["snap"]["nodes"][2]["stores"]["members"][0].sum()) == 8


def shard_ledger(s):
    a, b = s.ledger(32), s.ledger(32)
    d1, d2 = a.claim(3), b.claim(7)
    a.merge(d2)
    b.merge(d1)
    again = a.claim(3)                      # a re-claim bumps the version
    return {"claimed": (a.claimed(), b.claimed()),
            "next": (b.next_unclaimed(), a.next_unclaimed(start=3),
                     a.next_unclaimed(start=31)),
            "deltas": [s.np(d) for d in (d1, d2, again)],
            "state": (s.np(a.state), s.np(b.state))}


def test_shard_ledger_claims_and_gossip():
    out = both(shard_ledger)
    ca, _ = out["claimed"]
    assert ca[3] and ca[7]
    assert out["next"][:2] == (0, 4)


def checkpoint_registry(s):
    r1, r2 = s.registry(64), s.registry(64)
    r2.merge(r1.announce(100))
    r1.merge(r2.announce(150))
    latest = (r1.latest_step(), r2.latest_step())
    r1.merge(r2.announce(120))              # a stale announce
    return {"latest": latest, "after": r1.latest_step(),
            "empty": s.registry(64).latest_step(),
            "state": (s.np(r1.state), s.np(r2.state))}


def test_checkpoint_registry_latest_step():
    out = both(checkpoint_registry)
    assert out["latest"] == (150, 150) and out["after"] == 150
    assert out["empty"] is None


def bootstrap_recovers(s):
    nodes, tr = s.cluster()
    gc = s.GCounter(num_replicas=8)
    for nd in nodes.values():
        nd.register("ctr", gc.lattice)
    for _ in range(6):
        for i, nd in nodes.items():
            nd.update("ctr", s.bump(nd.state("ctr"), i))
        s.g.sync_round(nodes)
    fresh = s.node(4, nodes[4].neighbors, tr)
    s.m.register_membership(fresh, 16)
    fresh.register("ctr", gc.lattice)
    for _ in range(6):
        s.g.sync_round({**nodes, 4: fresh})
    behind = int(s.np(fresh.state("ctr")).sum())
    cost = s.g.bootstrap(fresh, nodes[fresh.neighbors[0]])
    nodes[4] = fresh
    for _ in range(4):
        s.g.sync_round(nodes)
    return {"snap": s.snapshot(nodes, tr), "behind": behind, "cost": cost,
            "converged": s.g.converged(nodes, "ctr")}


def test_bootstrap_recovers_lost_history():
    out = both(bootstrap_recovers)
    assert out["behind"] < 48 and out["cost"] > 0 and out["converged"]


def progress_counters(s):
    ctr = [s.progress(4, i) for i in range(4)]
    deltas = [c.add(100 * (i + 1)) for i, c in enumerate(ctr)]
    for c in ctr:
        for d in deltas:
            c.merge(d)
    ctr[2].merge(ctr[2].add(7))
    return {"totals": [c.total for c in ctr],
            "states": [s.np(c.state) for c in ctr]}


def test_progress_counter_gossips_a_global_total():
    out = both(progress_counters)
    assert out["totals"] == [1000, 1000, 1007, 1000]


def tuple_state_stores(s):
    """Stores whose lattices are not dense maps (a product and a lex-pair
    map): the runtime's generic Δ path, under drops and duplicates."""
    nodes, tr = s.cluster()
    rng = np.random.default_rng(5)
    tr.drop_fn = lambda a, b: rng.random() < 0.25
    tr.dup_fn = lambda a, b: rng.random() < 0.25
    pn, lww = s.PNCounter(num_replicas=8), s.LWWMap(num_keys=16)
    for nd in nodes.values():
        nd.register("pn", pn.lattice)
        nd.register("lww", lww.lattice)
    for r in range(8):
        for i, nd in nodes.items():
            mut = pn.inc_delta if (r + i) % 2 else pn.dec_delta
            nd.update("pn", mut(nd.state("pn"), i))
            nd.update("lww", lww.put_delta(nd.state("lww"), (3 * r + i) % 16,
                                           r + 1, i + 1))
        s.g.sync_round(nodes)
    tr.drop_fn = None
    for _ in range(8):
        s.g.sync_round(nodes)
    return {"snap": s.snapshot(nodes, tr),
            "converged": (s.g.converged(nodes, "pn"),
                          s.g.converged(nodes, "lww")),
            "value": int(pn.value(nodes[0].state("pn")))}


def test_tuple_state_stores_gossip_alike():
    out = both(tuple_state_stores)
    assert out["converged"] == (True, True)
    assert out["value"] == 0            # 4 incs and 4 decs a node


# -- topology and fault hooks -------------------------------------------------

@pytest.mark.parametrize("name,n", [("tree", 15), ("tree", 2), ("mesh", 15),
                                    ("mesh", 256), ("ring", 7),
                                    ("full", 6)])
def test_neighbor_lists_match(name, n):
    want = jtopo.by_name(name, n).neighbor_lists()
    got = ttopo.by_name(name, n).neighbor_lists()
    assert got == want
    assert all(isinstance(j, int) for row in got for j in row)


@pytest.mark.parametrize("name", ["tree", "mesh", "ring"])
def test_drop_fn_matches_over_every_message(name):
    n, rounds = 9, 12

    def sched(side):
        topo = side.topology.by_name(name, n)
        return side.Faults.churn(topo, rounds, [(3, 2, 6), (7, 5, 9)]) \
            .compose(side.Faults.bernoulli(topo, rounds, 0.2, seed=4)) \
            .compose(side.Faults.partition(topo, rounds, 8, 10,
                                           [int(i >= 4) for i in range(n)]))

    clock = {"t": 0}
    want = sched(Side(False)).drop_fn(lambda: clock["t"])
    got = sched(Side(True)).drop_fn(lambda: clock["t"])
    drops = 0
    for t in range(rounds + 2):
        clock["t"] = t
        for src in range(n):
            for dst in range(n):
                w = want(src, dst)
                assert got(src, dst) == w, (t, src, dst)
                drops += w
    assert drops > 0


# -- the elastic-churn example ------------------------------------------------

def test_elastic_churn_matches_the_jax_example():
    """``python -m repro_torch.elastic_churn --device cpu`` prints what
    ``examples/elastic_churn.py`` prints, with the example's numbers."""
    jax_out = io.StringIO()
    with contextlib.redirect_stdout(jax_out):
        runpy.run_path(str(REPO / "examples" / "elastic_churn.py"),
                       run_name="__main__")
    port_out = io.StringIO()
    with contextlib.redirect_stdout(port_out):
        res = elastic_churn.main(["--device", "cpu"])
    assert port_out.getvalue() == jax_out.getvalue()
    assert res["detected"] == {7: 10}
    assert res["plans"] == [(10, (7,), 11)]
    assert res["bootstrap"] == [78]
    assert res["latest_step"] == 19
    assert res["progress"] == 142_336 == 512 * res["up_node_rounds"]
    assert (res["rx_novel"], res["rx_redundant"]) == (5_815, 13_316)
    assert port_out.getvalue().rstrip().endswith("elastic_churn OK")
