"""The benchmark's plain reference agrees with the port, value for value, at
sizes a CPU test holds: a 96-object Retwis store, a 4,096-key GMap (also
under message loss, where acknowledgements keep buffers), a 1,024-key
digest-driven join, and the digest arithmetic itself. The reference
imports nothing of the port."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from crdtbench import traffic
from crdtbench.reference import crdt
from crdtbench.reference import digest as dg

from repro_torch.core import GMap, MapLattice
from repro_torch.core import value_lattices as vl
from repro_torch.sync import (DigestSpec, FaultSchedule, StoreSpec, digest,
                              simulate, simulate_store, topology)
from repro_torch.sync import workloads as W

ROOT = Path(__file__).resolve().parents[2]
ALGOS = ("state", "classic", "bp", "rr", "bprr")


def metrics_of(sim) -> np.ndarray:
    """A SimResult's metrics as [4, T, B] (B = 1 for a single run)."""
    out = [np.asarray(getattr(sim, f)) for f in
           ("tx", "mem", "cpu", "max_mem_node")]
    return np.stack([a.T if a.ndim == 2 else a[:, None] for a in out])


@pytest.mark.parametrize("engine", ["reference", "mega"])
@pytest.mark.parametrize("algo", ALGOS)
def test_store_of_96_objects(algo, engine):
    objects, nodes, slots, active, quiet = 96, 16, 32, 8, 4
    counts = traffic.retwis_counts(objects, nodes, active, 6, 1.0, 5)
    lat = MapLattice(slots, vl.max_int(), "retwis").build()
    topo = topology.partial_mesh(nodes, 4)
    spec = StoreSpec(objects, W.versioned_slot_op(counts, slots))
    res = simulate_store(algo, lat, topo, spec, active, quiet, engine=engine,
                         track_convergence=True, device="cpu")
    cnt = torch.as_tensor(counts)
    m, x, uni = crdt.run_delta(
        algo, torch.zeros((objects, nodes, slots), dtype=torch.int32),
        lambda x, t: crdt.slot_bumps(x, cnt[t].T),
        crdt.mesh_routes(nodes, 4), active, quiet)
    np.testing.assert_array_equal(metrics_of(res.sim), m.numpy())
    assert torch.equal(res.final_x, x)
    np.testing.assert_array_equal(res.sim.uniform, uni.numpy().T)


@pytest.mark.parametrize("algo", ALGOS)
def test_gmap_of_4096_keys(algo):
    nodes, keys, active, quiet = 15, 4096, 6, 4
    blocks = traffic.key_blocks(nodes, keys, 10, 777)
    bt = torch.as_tensor(blocks)
    res = simulate(algo, GMap(keys).lattice, topology.partial_mesh(nodes, 4),
                   lambda x, t: torch.where(bt, x + 1, 0).to(x.dtype),
                   active, quiet, engine="mega", track_convergence=True,
                   device="cpu")
    m, x, uni = crdt.run_delta(
        algo, torch.zeros((1, nodes, keys), dtype=torch.int32),
        lambda x, t: crdt.block_bumps(x, bt), crdt.mesh_routes(nodes, 4),
        active, quiet)
    np.testing.assert_array_equal(metrics_of(res), m.numpy())
    assert torch.equal(res.final_x, x[0])
    np.testing.assert_array_equal(res.uniform, uni.numpy()[:, 0])


@pytest.mark.parametrize("engine", ["reference", "mega"])
@pytest.mark.parametrize("algo", ALGOS[1:])
def test_gmap_under_loss_keeps_unacknowledged_buffers(algo, engine):
    nodes, keys, active, quiet = 15, 512, 8, 10
    topo = topology.partial_mesh(nodes, 4)
    link_ok = np.random.default_rng(3).random((active, nodes, 4)) >= 0.2
    sched = FaultSchedule(topo, link_ok, np.ones((active, nodes), bool))
    bt = torch.as_tensor(traffic.key_blocks(nodes, keys, 10))
    res = simulate(algo, GMap(keys).lattice, topo,
                   lambda x, t: torch.where(bt, x + 1, 0).to(x.dtype),
                   active, quiet, engine=engine, faults=sched, device="cpu")
    m, x, uni = crdt.run_delta(
        algo, torch.zeros((1, nodes, keys), dtype=torch.int32),
        lambda x, t: crdt.block_bumps(x, bt), crdt.mesh_routes(nodes, 4),
        active, quiet, loss=~torch.as_tensor(link_ok))
    np.testing.assert_array_equal(metrics_of(res), m.numpy())
    assert torch.equal(res.final_x, x[0])
    np.testing.assert_array_equal(res.uniform, uni.numpy()[:, 0])


@pytest.mark.parametrize("engine", ["reference", "mega"])
def test_join_of_1024_keys(engine):
    nodes, keys, rounds = 15, 1024, 12
    x0 = torch.as_tensor(traffic.join_start(nodes, keys, 1024, 0.25, 64, 1,
                                            np.asarray([5])))
    res = simulate("digest_driven", GMap(keys).lattice,
                   topology.partial_mesh(nodes, 4),
                   lambda x, t: torch.zeros_like(x), 0, rounds, x0=x0,
                   engine=engine, digest=DigestSpec(64),
                   track_convergence=True, device="cpu")
    m, x, uni = crdt.run_digest(x0, crdt.mesh_routes(nodes, 4), rounds, 64)
    np.testing.assert_array_equal(metrics_of(res), m.numpy()[..., None])
    assert torch.equal(res.final_x, x)
    np.testing.assert_array_equal(res.uniform, uni.numpy())
    assert res.convergence_round() >= 0


@pytest.mark.parametrize("u,block", [(1000, 64), (4096, 64), (96, 8),
                                     (64, 64)])
def test_digest_words_equal_the_port(u, block):
    g = torch.Generator().manual_seed(u)
    x = torch.randint(0, 2 ** 31 - 1, (3, u), generator=g, dtype=torch.int32)
    x[:, ::3] = 0
    spec = DigestSpec(block)
    want = digest.digest_state(x, spec)
    assert torch.equal(dg.digest(x, block), want)
    other = want.clone()
    other[1:, :1, 0] += 1
    assert torch.equal(dg.descent_words(want[:, None], other[None]),
                       digest.descent_words(want[:, None], other[None]))


def test_routes_equal_the_port():
    for nodes in (15, 16, 50):
        topo = topology.partial_mesh(nodes, 4)
        r = crdt.mesh_routes(nodes, 4)
        assert torch.equal(r.nbrs, topo.nbrs.long())
        assert torch.equal(r.rev, topo.rev.long())
        assert torch.equal(r.mask, topo.mask)


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "crdtbench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = [a.name for a in node.names] \
                if isinstance(node, ast.Import) else \
                [node.module or ""] if isinstance(node, ast.ImportFrom) \
                else []
            for name in names:
                assert name.split(".")[0] not in ("repro_torch", "repro",
                                                  "jax"), (path, name)
    code = ("import sys; import crdtbench.reference.crdt; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('repro_torch', 'repro', 'jax')]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   env={"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin"})
