"""Fault schedules and faulted simulations, JAX against the port.

* Schedules: every ``FaultSchedule`` constructor of the port builds the same
  ``link_ok``/``up`` tables as the JAX package's (the same numpy draws), and
  ``views()`` folds them into the same receiver/sender/liveness masks; the
  host-side queries agree.
* One round: a random carry under random fault masks (loss and a down node)
  goes through one ``round_step`` of the JAX reference engine and of each
  of the port's three engines; the new states, buffers (ack-gated
  retention), ``buf_elems`` and the round's metrics must agree exactly.
* Whole runs: the five δ-family algorithms on the paper's partial mesh under
  loss, a partition, churn and all three composed, through JAX
  ``simulate(..., wide_metrics=False)`` and the port's three engines:
  per-round tx / mem / cpu / max_mem_node, ``uniform`` and the final states
  agree exactly.
* Paper size: the port alone reproduces every committed cell of
  ``benchmarks/results/BENCH_fault.json`` on its reference engine.
"""

import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import types as jtypes
from repro.sync import FaultSchedule as JaxSchedule
from repro.sync import SyncAlgorithm as JaxAlgorithm
from repro.sync import simulate as jax_simulate
from repro.sync import topology as jtopo
from repro.sync import workloads as jW
from repro.sync.faults import RoundFaults as JaxRoundFaults

from repro_torch import convert
from repro_torch.core import types as ttypes
from repro_torch.sync import (ALGORITHMS, ENGINES, RESYNC_ALGORITHMS,
                              FaultSchedule, SyncAlgorithm, simulate)
from repro_torch.sync import topology as ttopo
from repro_torch.sync import workloads as tW
from repro_torch.sync.faults import RoundFaults

# The states here are small: one intra-op thread per test process keeps
# the suite's parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

RESULTS = Path(__file__).resolve().parents[1] / "benchmarks" / "results"
DELTA_ALGORITHMS = [a for a in ALGORITHMS if a not in RESYNC_ALGORITHMS]
N, ACTIVE, QUIET = 15, 6, 6
GROUPS = (np.arange(N) >= N // 2).astype(np.int32)


def schedules(F, topo, rounds):
    """The same named schedules built by either package's FaultSchedule."""
    return {
        "loss": F.bernoulli(topo, rounds, 0.2, seed=3),
        "partition": F.partition(topo, rounds, 1, 5, GROUPS),
        "churn": F.churn(topo, rounds, [(1, 1, 5), (N - 2, 2, 7)]),
        "composed": F.partition(topo, rounds, 0, 4, GROUPS)
        .compose(F.bernoulli(topo, rounds + 2, 0.1, seed=5))
        .compose(F.from_epochs(topo, rounds, [(2, [3]), (5, [])])),
    }


def both_topos():
    return jtopo.partial_mesh(N, 4), ttopo.partial_mesh(N, 4)


@pytest.mark.parametrize("topo_name", ["mesh15d4", "tree15"])
def test_schedules_and_views_match_jax(topo_name):
    jtp, ttp = ((jtopo.tree(15), ttopo.tree(15)) if topo_name == "tree15"
                else both_topos())
    want = schedules(JaxSchedule, jtp, ACTIVE)
    got = schedules(FaultSchedule, ttp, ACTIVE)
    want["none"] = JaxSchedule.none(jtp, ACTIVE)
    got["none"] = FaultSchedule.none(ttp, ACTIVE)
    for name in want:
        w, g = want[name], got[name]
        np.testing.assert_array_equal(g.link_ok, w.link_ok, err_msg=name)
        np.testing.assert_array_equal(g.up, w.up, err_msg=name)
        assert g.num_rounds == w.num_rounds
        assert g.is_trivial == w.is_trivial, name
        assert g.last_fault_round == w.last_fault_round, name
        total = ACTIVE + QUIET + 3
        wv, gv = w.views(total), g.views(total)
        for nm in ("recv_ok", "send_ok", "up"):
            np.testing.assert_array_equal(getattr(gv, nm).numpy(),
                                          np.asarray(getattr(wv, nm)),
                                          err_msg=f"{name} {nm}")
        for t in (0, 2, ACTIVE + 1):
            for src in range(0, N, 4):
                assert g.up_at(t, src) == w.up_at(t, src)
                for dst in range(N):
                    assert g.delivers(t, src, dst) == w.delivers(t, src, dst)
    assert got["loss"].same_topology(ttp)
    assert not got["loss"].same_topology(ttopo.ring(N))
    with pytest.raises(ValueError):
        got["loss"].compose(FaultSchedule.none(ttopo.ring(N), 2))


def test_simulate_refuses_a_schedule_of_another_topology():
    sched = FaultSchedule.none(ttopo.ring(N), 3)
    with pytest.raises(ValueError):
        simulate("bprr", ttypes.GCounter(N).lattice, ttopo.partial_mesh(N, 4),
                 tW.gcounter_op(N), 2, faults=sched, device="cpu")


# -- one faulted round ----------------------------------------------------------

@functools.lru_cache(maxsize=None)
def jax_faulted_round(algo):
    jtp, _ = both_topos()
    rng = np.random.default_rng(100 + ALGORITHMS.index(algo))
    n, p, u = N, jtp.max_degree, 6

    def state(*shape):
        return rng.integers(0, 2**32, size=shape + (u,), dtype=np.uint32) \
            & rng.integers(0, 2**32, size=shape + (u,), dtype=np.uint32)

    x, delta = state(n), state(n)
    buf = None if algo == "state" else (
        state(n, p + 1) if algo in ("bp", "bprr") else state(n))
    buf_elems = rng.integers(0, 50, size=n).astype(np.int32)
    link = rng.random((1, n, p)) > 0.3
    up = np.ones((1, n), bool)
    up[0, 4] = False
    views = JaxSchedule(jtp, link, up).views(1)
    lat = jtypes.BitGSet(32 * u).lattice
    alg = JaxAlgorithm(name=algo, lattice=lat, topo=jtp)
    carry = alg.init(jnp.asarray(x))._replace(
        buf=None if buf is None else jnp.asarray(buf),
        buf_elems=jnp.asarray(buf_elems))
    rf = JaxRoundFaults(views.recv_ok[0], views.send_ok[0], views.up[0])
    out, metrics = jax.jit(alg.round_step)(carry, jnp.asarray(delta), rf)
    got_views = tuple(np.asarray(v[0]) for v in views)
    return ((x, buf, buf_elems, delta, got_views),
            jax.device_get((out.x, out.buf, out.buf_elems)),
            jax.device_get(tuple(metrics)))


@pytest.mark.parametrize("algo", DELTA_ALGORITHMS)
@pytest.mark.parametrize("engine", ENGINES)
def test_one_faulted_round_matches_jax(algo, engine):
    """Ack-gated retention: a node with an undelivered send keeps its
    buffer and its buffered-entry count; a down node sends and receives
    nothing."""
    (x, buf, buf_elems, delta, views), want_carry, want_metrics = \
        jax_faulted_round(algo)
    jtp, ttp = both_topos()
    alg = SyncAlgorithm(name=algo, lattice=ttypes.BitGSet(32 * 6).lattice,
                        topo=ttp, engine=engine, metric_dtype=torch.int32)
    carry = convert.carry_to_torch(x, buf, buf_elems)
    rf = RoundFaults(*(convert.to_torch(v) for v in views))
    out, metrics = alg.round_step(carry, convert.to_torch(delta), rf)
    got = convert.carry_to_numpy(out, words=True)
    for nm, g, w in zip(("x", "buf", "buf_elems"), got, want_carry):
        if w is None:
            assert g is None, nm
        else:
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=nm)
    for nm, g, w in zip(("tx", "mem", "cpu", "max_mem_node"), metrics,
                        want_metrics):
        assert int(g) == int(w), nm


# -- whole faulted runs -------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def jax_faulted_run(algo, sched_name):
    jtp, _ = both_topos()
    r = jax_simulate(algo, jtypes.GSet(N * ACTIVE).lattice, jtp,
                     jW.gset_unique_op(N, ACTIVE), ACTIVE, QUIET,
                     faults=schedules(JaxSchedule, jtp, ACTIVE)[sched_name],
                     wide_metrics=False)
    return (r.tx, r.mem, r.cpu, r.max_mem_node, r.uniform,
            np.asarray(r.final_x))


@pytest.mark.parametrize("sched_name", ["loss", "partition", "churn",
                                        "composed"])
@pytest.mark.parametrize("algo", DELTA_ALGORITHMS)
def test_faulted_simulate_matches_jax(algo, sched_name):
    want = jax_faulted_run(algo, sched_name)
    _, ttp = both_topos()
    sched = schedules(FaultSchedule, ttp, ACTIVE)[sched_name]
    for engine in ENGINES:
        r = simulate(algo, ttypes.GSet(N * ACTIVE).lattice, ttp,
                     tW.gset_unique_op(N, ACTIVE), ACTIVE, QUIET,
                     faults=sched, engine=engine, wide_metrics=False,
                     device="cpu")
        for nm, g, w in zip(("tx", "mem", "cpu", "max_mem_node", "uniform"),
                            (r.tx, r.mem, r.cpu, r.max_mem_node, r.uniform),
                            want):
            np.testing.assert_array_equal(g, w, err_msg=f"{engine} {nm}")
        np.testing.assert_array_equal(r.final_x.numpy(), want[5],
                                      err_msg=f"{engine} final_x")


def test_all_ok_schedule_is_the_fault_free_run():
    _, ttp = both_topos()
    lat, op = ttypes.GCounter(N).lattice, tW.gcounter_op(N)
    for engine in ENGINES:
        a = simulate("bprr", lat, ttp, op, ACTIVE, QUIET, engine=engine,
                     device="cpu", track_convergence=True)
        b = simulate("bprr", lat, ttp, op, ACTIVE, QUIET, engine=engine,
                     device="cpu",
                     faults=FaultSchedule.none(ttp, ACTIVE + QUIET))
        for nm in ("tx", "mem", "cpu", "max_mem_node", "uniform"):
            np.testing.assert_array_equal(getattr(a, nm), getattr(b, nm))
        assert torch.equal(a.final_x, b.final_x)


# -- BENCH_fault.json from the port alone -----------------------------------------

def bench_fault_schedules(topo, events, quiet):
    """The five scenarios of ``benchmarks/fig_fault.py`` (seed 7)."""
    n = topo.num_nodes
    lossy = events + quiet // 4
    groups = (np.arange(n) >= n // 2).astype(np.int32)
    return {
        "loss0": FaultSchedule.none(topo, events),
        "loss1": FaultSchedule.bernoulli(topo, lossy, 0.01, seed=7),
        "loss10": FaultSchedule.bernoulli(topo, lossy, 0.10, seed=7),
        "partition": FaultSchedule.partition(
            topo, events, events // 4, (3 * events) // 4, groups),
        "churn": FaultSchedule.churn(
            topo, events, [(1, events // 4, (3 * events) // 4),
                           (n - 2, events // 2, events - 1)]),
    }


BENCH_FAULT = json.loads((RESULTS / "BENCH_fault.json").read_text())


@pytest.mark.parametrize("scenario", sorted(BENCH_FAULT["cells"]))
def test_bench_fault_cells_reproduce(scenario):
    events, quiet = BENCH_FAULT["events"], BENCH_FAULT["quiet"]
    topo = ttopo.partial_mesh(BENCH_FAULT["nodes"], 4)
    sched = bench_fault_schedules(topo, events, quiet)[scenario]
    lat = ttypes.GSet(topo.num_nodes * events).lattice
    op = tW.gset_unique_op(topo.num_nodes, events)
    for algo, row in BENCH_FAULT["cells"][scenario]["raw"].items():
        r = simulate(algo, lat, topo, op, events, quiet, faults=sched,
                     device="cpu")
        conv = r.convergence_round()
        assert (r.total_tx, r.avg_mem, conv, conv - events + 1, conv >= 0) \
            == (row["tx"], row["mem_avg"], row["conv_round"],
                row["ttc_rounds"], row["converged"]), algo
