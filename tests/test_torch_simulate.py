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
* The results path: ``to_host``'s one copy in the result's layout against
  a copy of the earlier host path (stack time-major, copy, concatenate,
  check and transpose on the host) kept here — values, dtypes and shapes —
  and its overflow check on the device.
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
from repro_torch.sync import simulator
from repro_torch.sync.simulator import Chunk, cat_chunks, collect_result
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


# -- the results path against the earlier host path --------------------------

def old_stack_host(rounds, k, shape, dtype):
    if rounds:
        return tuple(torch.stack([torch.stack(tuple(r)) for r in rounds],
                                 1).cpu().numpy())
    return tuple(np.zeros((0,) + tuple(shape),
                          torch.empty((), dtype=dtype).numpy().dtype)
                 for _ in range(k))


def old_to_host(metrics, uniform, track_convergence, lead=(),
                dtype=torch.int64):
    host = old_stack_host(metrics, 4, lead, dtype)
    uni = torch.stack(uniform).cpu().numpy() if uniform else (
        np.zeros(host[0].shape, bool) if track_convergence else None)
    return Chunk(metrics=host, uniform=uni)


def old_cat_chunks(chunks):
    def cat(arrays):
        return None if arrays[0] is None else tuple(
            np.concatenate([a[i] for a in arrays])
            for i in range(len(arrays[0])))

    uni = None if chunks[0].uniform is None \
        else np.concatenate([c.uniform for c in chunks])
    return Chunk(cat([c.metrics for c in chunks]), uni,
                 cat([c.tele for c in chunks]), cat([c.prov for c in chunks]))


def old_collect_result(carry, metrics, uniform=None, track_convergence=False,
                       batched=False, telemetry=None, provenance=None,
                       nbrs=None):
    ys = metrics if isinstance(metrics, Chunk) \
        else old_to_host(metrics, uniform, track_convergence)
    carry, _, prov = simulator.unwrap_carry(carry, telemetry, provenance)
    tx, mem, cpu, mmax = (a.T if batched else a for a in ys.metrics)
    if (tx < 0).any() or (mem < 0).any() or (cpu < 0).any():
        raise OverflowError(
            "round-metric accumulator overflow: rerun with wide_metrics=True")
    uni = ys.uniform
    if uni is not None and batched:
        uni = uni.T
    return simulator.SimResult(
        tx=np.ascontiguousarray(tx), mem=np.ascontiguousarray(mem),
        cpu=np.ascontiguousarray(cpu),
        max_mem_node=np.ascontiguousarray(mmax), final_x=carry.x,
        uniform=None if uni is None else np.ascontiguousarray(uni),
        telemetry=None if telemetry is None
        else simulator.tel.collect(telemetry, ys.tele, batched),
        provenance=None if provenance is None
        else simulator.prv.collect(provenance, prov, ys.prov, nbrs, batched))


def old_host_path(monkeypatch):
    """Route ``simulate``, ``simulate_sweep`` and ``simulate_store``
    through the earlier host path: every round's metrics stacked
    time-major on the device, copied with ``.cpu()``, concatenated,
    checked for overflow and transposed to [B, T] on the host."""
    from repro_torch.sync import store, sweep
    monkeypatch.setattr(simulator, "stack_host", old_stack_host)
    monkeypatch.setattr(simulator, "to_host", old_to_host)
    for mod in (simulator, store):
        monkeypatch.setattr(mod, "cat_chunks", old_cat_chunks)
    for mod in (simulator, store, sweep):
        monkeypatch.setattr(mod, "collect_result", old_collect_result)
    monkeypatch.setattr(store, "host_copy", lambda t: t.cpu())


def assert_same_host_result(new, old, ctx=""):
    """The results path's arrays against the earlier path's: values,
    dtypes and shapes of the four metrics, ``uniform`` and (a store's)
    ``final_state_bytes``; the new [B, T] arrays are C-contiguous."""
    sim_new, sim_old = getattr(new, "sim", new), getattr(old, "sim", old)
    pairs = [(f, getattr(sim_new, f), getattr(sim_old, f))
             for f in ("tx", "mem", "cpu", "max_mem_node", "uniform")]
    if hasattr(new, "final_state_bytes"):
        pairs.append(("final_state_bytes", new.final_state_bytes,
                      old.final_state_bytes))
    for f, a, b in pairs:
        if b is None:
            assert a is None, f"{ctx} {f}"
            continue
        assert isinstance(a, np.ndarray), f"{ctx} {f}"
        assert a.dtype == b.dtype and a.shape == b.shape, f"{ctx} {f}"
        np.testing.assert_array_equal(a, b, err_msg=f"{ctx} {f}")
        assert a.flags.c_contiguous, f"{ctx} {f}"
    assert torch.equal(sim_new.final_x, sim_old.final_x), ctx


@pytest.mark.parametrize("faulted", [False, True],
                         ids=["fault_free", "faulted"])
@pytest.mark.parametrize("wide", [True, False], ids=["int64", "int32"])
def test_simulate_results_path_equals_the_old_host_path(wide, faulted,
                                                        monkeypatch):
    from repro_torch.sync import FaultSchedule
    lat, op = ttypes.GCounter(N).lattice, tW.gcounter_op(N)
    topo = ttopo.partial_mesh(N, 4)
    faults = FaultSchedule.bernoulli(topo, ACTIVE, 0.2, seed=3) \
        if faulted else None

    def run():
        return simulate("bprr", lat, topo, op, ACTIVE, QUIET, faults=faults,
                        wide_metrics=wide, device="cpu")

    new = run()
    old_host_path(monkeypatch)
    assert_same_host_result(new, run(), f"wide={wide}")


def round_metrics(values, batch):
    """One round's RoundMetrics of int32 tensors, 0-d or [batch]."""
    return RoundMetrics(*(torch.full((batch,) if batch else (), v,
                                     dtype=torch.int32) for v in values))


@pytest.mark.parametrize("batch", [0, 3], ids=["unbatched", "batched"])
@pytest.mark.parametrize("negative", ["tx", "mem", "cpu", "max_mem_node"])
def test_overflow_is_checked_on_the_device(negative, batch):
    """A wrapped (negative) int32 tx, mem or cpu in any round raises the
    earlier path's OverflowError; max_mem_node is not a tally the check
    reads, as before."""
    ok = [round_metrics((5, 3, 2, 1), batch) for _ in range(3)]
    bad = round_metrics([-7 if f == negative else 4
                         for f in RoundMetrics._fields], batch)
    rounds = ok[:1] + [bad] + ok[1:]
    if negative == "max_mem_node":
        ys = simulator.to_host(rounds, [], False)
        assert ys.metrics[3][1].min() == -7
        return
    with pytest.raises(OverflowError, match="wide_metrics=True"):
        simulator.to_host(rounds, [], False)
    with pytest.raises(OverflowError, match="wide_metrics=True"):
        collect_result(AlgoCarry(torch.zeros(2, 3), None, torch.zeros(2)),
                       rounds, [], False, batched=bool(batch))


@pytest.mark.parametrize("batch", [0, 3], ids=["unbatched", "batched"])
def test_one_chunk_reaches_the_result_uncopied(batch):
    """``to_host`` stacks into the result's layout: the chunk holds
    time-major views of it, ``cat_chunks`` of one chunk returns them as
    they are, and a batched result's [B, T] arrays share their memory."""
    rounds = [round_metrics((t, 2 * t, 3 * t, t + 1), batch)
              for t in range(4)]
    uniform = [torch.full((batch,) if batch else (), t % 2 == 0)
               for t in range(4)]
    ys = simulator.to_host(rounds, uniform, True)
    one = cat_chunks([ys])
    assert one is ys
    want = old_to_host(rounds, uniform, True)
    for a, b in zip(ys.metrics + (ys.uniform,),
                    want.metrics + (want.uniform,)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    res = collect_result(AlgoCarry(torch.zeros(2, 3), None, torch.zeros(2)),
                         one, batched=bool(batch))
    for a, b in zip((res.tx, res.mem, res.cpu, res.max_mem_node,
                     res.uniform), ys.metrics + (ys.uniform,)):
        assert np.shares_memory(a, b)
        assert a.flags.c_contiguous
    two = cat_chunks([ys, ys])
    assert two.metrics[0].shape == (8,) + ys.metrics[0].shape[1:]
    assert not np.shares_memory(two.metrics[0], ys.metrics[0])
