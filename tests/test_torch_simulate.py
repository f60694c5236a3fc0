"""Whole simulations, JAX against the port, and the port against the paper.

* Parity: for GSet, GCounter, GMap and BitGSet on the paper's 15-node tree
  and partial mesh, every δ-family algorithm runs a few active and quiet
  rounds through JAX ``simulate(..., wide_metrics=False)`` (int32 metrics:
  nothing can wrap at this size) and through each of the port's three
  engines; per-round tx / mem / cpu / max_mem_node and the final states
  must agree exactly.
* Paper size: the port alone reproduces every committed total of
  ``benchmarks/results/fig7_transmission.json`` (GSet and GCounter, tree
  and mesh, 100 active + 20 quiet rounds) and every GMap row (10%, 30%,
  60%, 100%) of ``fig8_gmap.json``.
"""

import functools
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import types as jtypes
from repro.sync import simulate as jax_simulate
from repro.sync import topology as jtopo
from repro.sync import workloads as jW

from repro_torch import convert
from repro_torch.core import types as ttypes
from repro_torch.sync import (ALGORITHMS, ENGINES, RESYNC_ALGORITHMS,
                              AlgoCarry, RoundMetrics, converged, simulate)
from repro_torch.sync.simulator import collect_result
from repro_torch.sync import topology as ttopo
from repro_torch.sync import workloads as tW

# The states here are small: one intra-op thread per test process keeps
# the suite's parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

RESULTS = Path(__file__).resolve().parents[1] / "benchmarks" / "results"
DELTA_ALGORITHMS = [a for a in ALGORITHMS if a not in RESYNC_ALGORITHMS]
N, EVENTS, ACTIVE, QUIET = 15, 6, 6, 4
STRIDE = 3                        # BitGSet ids spread over 3x the universe


def jax_bitgset_op(nodes, events, stride):
    bg = jtypes.BitGSet(universe=nodes * events * stride)

    def op_fn(x, t):
        ids = (jnp.arange(nodes) * events + jnp.minimum(t, events - 1)) * stride
        m = jnp.zeros((nodes, bg.num_words), jnp.uint32)
        m = m.at[jnp.arange(nodes), ids // 32].set(
            jnp.uint32(1) << (ids % 32).astype(jnp.uint32))
        return bg.add_mask_delta(x, m)

    return op_fn


WORKLOADS = {  # name -> (JAX lattice, JAX op, port lattice, port op)
    "gset": lambda: (jtypes.GSet(N * EVENTS).lattice,
                     jW.gset_unique_op(N, EVENTS),
                     ttypes.GSet(N * EVENTS).lattice,
                     tW.gset_unique_op(N, EVENTS)),
    "gcounter": lambda: (jtypes.GCounter(N).lattice, jW.gcounter_op(N),
                         ttypes.GCounter(N).lattice, tW.gcounter_op(N)),
    "gmap": lambda: (jtypes.GMap(150).lattice, jW.gmap_block_op(N, 150, 30),
                     ttypes.GMap(150).lattice, tW.gmap_block_op(N, 150, 30)),
    "bitgset": lambda: (
        jtypes.BitGSet(N * EVENTS * STRIDE).lattice,
        jax_bitgset_op(N, EVENTS, STRIDE),
        ttypes.BitGSet(N * EVENTS * STRIDE).lattice,
        tW.bitgset_unique_op(N, EVENTS, STRIDE)),
}
TOPOS = {"tree15": (lambda: jtopo.tree(15), lambda: ttopo.tree(15)),
         "mesh15d4": (lambda: jtopo.partial_mesh(15, 4),
                      lambda: ttopo.partial_mesh(15, 4))}


@functools.lru_cache(maxsize=None)
def jax_run(workload, topo_name, algo):
    jlat, jop, _, _ = WORKLOADS[workload]()
    r = jax_simulate(algo, jlat, TOPOS[topo_name][0](), jop, ACTIVE, QUIET,
                     wide_metrics=False)
    return r.tx, r.mem, r.cpu, r.max_mem_node, np.asarray(r.final_x)


@pytest.mark.parametrize("workload", sorted(WORKLOADS))
@pytest.mark.parametrize("topo_name", sorted(TOPOS))
@pytest.mark.parametrize("algo", DELTA_ALGORITHMS)
def test_simulate_matches_jax(workload, topo_name, algo):
    want = jax_run(workload, topo_name, algo)
    _, _, tlat, top = WORKLOADS[workload]()
    words = workload == "bitgset"
    for engine in ENGINES:
        r = simulate(algo, tlat, TOPOS[topo_name][1](), top, ACTIVE, QUIET,
                     engine=engine, wide_metrics=False, device="cpu")
        for nm, g, w in zip(("tx", "mem", "cpu", "max_mem_node"),
                            (r.tx, r.mem, r.cpu, r.max_mem_node), want):
            np.testing.assert_array_equal(g, w, err_msg=f"{engine} {nm}")
        np.testing.assert_array_equal(convert.to_numpy(r.final_x, words),
                                      want[4], err_msg=f"{engine} final_x")
        assert r.tx.dtype == np.int32


def paper_cells(fig, benches):
    data = json.loads((RESULTS / f"{fig}.json").read_text())
    return [(b, t, a, data[f"{b}_{t}"]["raw"][a])
            for b in benches for t in ("tree", "mesh")
            for a in DELTA_ALGORITHMS]


def paper_workload(bench):
    if bench == "gset":
        return ttypes.GSet(15 * 100).lattice, tW.gset_unique_op(15, 100)
    if bench == "gcounter":
        return ttypes.GCounter(15).lattice, tW.gcounter_op(15)
    k = int(bench.removeprefix("gmap"))
    return ttypes.GMap(1000).lattice, tW.gmap_block_op(15, 1000, k)


@pytest.mark.parametrize(
    "bench,topo_name,algo,row",
    paper_cells("fig7_transmission", ("gset", "gcounter"))
    + paper_cells("fig8_gmap", ("gmap10", "gmap30", "gmap60", "gmap100")))
def test_paper_results_reproduce(bench, topo_name, algo, row):
    lat, op = paper_workload(bench)
    r = simulate(algo, lat, ttopo.by_name(topo_name, 15, 4), op, 100, 20,
                 device="cpu")
    assert r.total_tx == row["tx"]
    assert r.total_cpu == row["cpu"]
    assert r.avg_mem == row["mem_avg"]
    if "mem_max_node" in row:
        assert int(r.max_mem_node.max()) == row["mem_max_node"]
    assert converged(lat, r.final_x)


def test_convergence_tracking_and_overflow_check():
    lat, op = ttypes.GCounter(15).lattice, tW.gcounter_op(15)
    r = simulate("bprr", lat, ttopo.tree(15), op, 5, 6,
                 track_convergence=True, device="cpu")
    assert r.uniform.shape == (11,)
    assert 5 <= r.convergence_round() <= 10
    assert r.uniform[-1] and not r.uniform[0]
    # int32 accumulators that wrapped show up negative and are refused
    wrapped = RoundMetrics(*(torch.tensor(v, dtype=torch.int32)
                             for v in (-5, 3, 2, 1)))
    with pytest.raises(OverflowError):
        collect_result(AlgoCarry(torch.zeros(2, 3), None, torch.zeros(2)),
                       [wrapped], [], False)


@pytest.mark.parametrize("engine", ENGINES)
def test_x0_as_numpy_or_a_strided_view(engine, monkeypatch):
    """``simulate(x0=)`` takes what the JAX package's takes: a numpy array
    runs (it raised AttributeError), and a strided view of a tensor (here
    a broadcast row) reaches the kernels contiguous — the CUDA kernels
    refuse anything else — with the JAX package's result."""
    from repro_torch.kernels import ops

    def guard(fn):
        def wrapped(*args, **kw):
            for a in args:
                if isinstance(a, torch.Tensor):
                    assert a.is_contiguous(), fn.__name__
            return fn(*args, **kw)
        return wrapped

    for name in ("round_recv", "round_step", "buffer_fold"):
        monkeypatch.setattr(ops, name, guard(getattr(ops, name)))
    n, events = 15, 4
    row = np.zeros(n * events, bool)
    row[::7] = True
    x0 = np.broadcast_to(row, (n, n * events)).copy()
    x0[0] = False                                  # a joiner at node 0
    want = jax_simulate("bprr", jtypes.GSet(n * events).lattice,
                        jtopo.partial_mesh(n, 4),
                        jW.gset_unique_op(n, events), events, 3,
                        x0=jnp.asarray(x0), wide_metrics=False)
    strided = torch.from_numpy(row).expand(n, n * events)
    for start in (x0, strided):
        got = simulate("bprr", ttypes.GSet(n * events).lattice,
                       ttopo.partial_mesh(n, 4), tW.gset_unique_op(n, events),
                       events, 3, x0=start, engine=engine, device="cpu")
        if start is x0:
            for nm in ("tx", "mem", "cpu", "max_mem_node"):
                np.testing.assert_array_equal(getattr(got, nm),
                                              np.asarray(getattr(want, nm)))
            np.testing.assert_array_equal(got.final_x.numpy(),
                                          np.asarray(want.final_x))
        else:
            assert converged(ttypes.GSet(n * events).lattice, got.final_x)
