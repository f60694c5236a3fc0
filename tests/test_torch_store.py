"""The keyed object store, JAX against the port.

* Every object of a port ``simulate_store`` equals the JAX package's
  ``simulate_store(..., wide_metrics=False)`` object exactly — final states,
  per-round metrics, ``uniform`` and convergence — for every algorithm on
  each of the port's three engines, fault-free and under one store-shared
  schedule; and equals the port's own single ``simulate`` of that object.
* The packed bitor kind and the digest over the objects' rows against the
  JAX fused engine (its Pallas kernels in interpret mode).
* Weighted accounting (``*_bytes``, ``final_state_bytes``) and ``wsize``:
  reduction to ``size``, per-slot and per-object (``BatchWeights``)
  weights, mixed-rank products.
* Chunked runs, resume at every chunk boundary and after a kill, a refused
  resume of another run, ``object_metrics=False`` aggregates, the eager
  validation, the options that wait for later slices (shard, pad_to) and
  the refusal of a malformed observability argument.
* The results path: every run kind's arrays against the earlier host path
  (``test_torch_simulate.old_host_path``), the same checkpoint bundles,
  and the ``results_to_host`` trace counter.
* The committed ``fig11_retwis.json`` zipf 1.0 row at its default shape.
"""

import functools
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BatchWeights as JBatchWeights
from repro.core import GSet as JGSet
from repro.core import product as jproduct
from repro.sync import FaultSchedule as JaxSchedule
from repro.sync import StoreSpec as JaxStoreSpec
from repro.sync import simulate_store as jax_simulate_store
from repro.sync import topology as jtopo
from repro.sync import workloads as jW
from test_store import _scalar_max_lattice as jax_scalar_max_lattice
from test_sweep import bitgset_sweep_ops as jax_bitgset_sweep_ops
from test_torch_simulate import assert_same_host_result, old_host_path
from test_torch_sweep import assert_same_run, bitgset_ops

from repro_torch.checkpoint import Checkpointer
from repro_torch.core import (BatchWeights, BitGSet, GCounter, GSet, Lattice,
                              MapLattice, align_weights, product)
from repro_torch.core import value_lattices as tvl
from repro_torch.sync import (ALGORITHMS, ENGINES, FaultSchedule, StoreSpec,
                              resume_store, simulate, simulate_store)
from repro_torch.sync import topology as ttopo
from repro_torch.sync import workloads as tW

torch.set_num_threads(1)

RESULTS = Path(__file__).resolve().parents[1] / "benchmarks" / "results"
N, T, Q, B = 7, 5, 8, 3
SEEDS = (0, 3, 11)
GROUPS = (np.arange(N) >= N // 2).astype(np.int32)


def store_schedule(F, topo):
    """One store-wide schedule of either package: loss ∘ partition ∘
    churn, with a fault-free drain tail."""
    return F.bernoulli(topo, T, 0.2, seed=2).compose(
        F.partition(topo, T, 1, T - 1, GROUPS)).compose(
        F.churn(topo, T, [(N // 2, 1, T - 1)]))


def topos():
    return jtopo.partial_mesh(N, 4), ttopo.partial_mesh(N, 4)


@functools.lru_cache(maxsize=None)
def jax_store(algo, faulted):
    jtp, _ = topos()
    spec = JaxStoreSpec(objects=B, op_fn=jW.gset_unique_sweep_op(N, T, SEEDS),
                        faults=store_schedule(JaxSchedule, jtp) if faulted
                        else None)
    return jax_simulate_store(algo, JGSet(N * T).lattice, jtp, spec,
                              active_rounds=T, quiet_rounds=Q,
                              wide_metrics=False)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("faulted", [False, True],
                         ids=["fault_free", "shared_faults"])
@pytest.mark.parametrize("algo", ALGORITHMS)
def test_store_objects_match_jax(algo, faulted, engine):
    want = jax_store(algo, faulted)
    _, ttp = topos()
    sched = store_schedule(FaultSchedule, ttp) if faulted else None
    spec = StoreSpec(objects=B, op_fn=tW.gset_unique_sweep_op(N, T, SEEDS),
                     faults=sched)
    got = simulate_store(algo, GSet(N * T).lattice, ttp, spec, T, Q,
                         engine=engine, device="cpu")
    assert got.objects == B
    for b, seed in enumerate(SEEDS):
        ctx = f"{algo}/{engine}/faulted={faulted}/obj{b}"
        assert_same_run(got.object_result(b), want.object_result(b), ctx)
        single = simulate(algo, GSet(N * T).lattice, ttp,
                          tW.gset_unique_op(N, T, seed), T, Q, engine=engine,
                          faults=sched, device="cpu")
        assert_same_run(got.object_result(b), single, ctx + "/single")
    if faulted:
        np.testing.assert_array_equal(got.convergence_round(),
                                      want.convergence_round())
        assert (got.convergence_round() >= 0).all()
        assert got.store_convergence_round() == \
            want.store_convergence_round()


@pytest.mark.parametrize("engine", ["fused", "mega"])
def test_store_bitor(engine):
    """The packed bitor kind over the objects' rows, against the JAX fused
    engine."""
    jlat, _, jsweep = jax_bitgset_sweep_ops()
    tlat, tcell, tsweep = bitgset_ops()
    want = jax_simulate_store("bprr", jlat, jtopo.tree(N),
                              JaxStoreSpec(objects=2, op_fn=jsweep),
                              active_rounds=T, quiet_rounds=Q,
                              engine="fused", wide_metrics=False)
    got = simulate_store("bprr", tlat, ttopo.tree(N),
                         StoreSpec(objects=2, op_fn=tsweep), T, Q,
                         engine=engine, device="cpu")
    single = simulate("bprr", tlat, ttopo.tree(N), tcell, T, Q,
                      engine=engine, device="cpu")
    for b in range(2):
        assert_same_run(got.object_result(b), want.object_result(b),
                        f"bitgset/{engine}/{b}", words=True)
        assert_same_run(got.object_result(b), single,
                        f"bitgset/{engine}/single{b}")


def test_store_digest_rows_layout():
    """digest_driven on the kernel engines against the JAX fused run in
    its rows layout: the digest and extract kernels take the objects'
    rows, the aux carries the object axis."""
    spec_j = JaxStoreSpec(objects=B, op_fn=jW.gset_unique_sweep_op(N, T,
                                                                    SEEDS))
    want = jax_simulate_store("digest_driven", JGSet(N * T).lattice,
                              jtopo.ring(N), spec_j, active_rounds=T,
                              quiet_rounds=Q, engine="fused", layout="rows",
                              wide_metrics=False)
    spec = StoreSpec(objects=B, op_fn=tW.gset_unique_sweep_op(N, T, SEEDS))
    for engine in ("fused", "mega"):
        got = simulate_store("digest_driven", GSet(N * T).lattice,
                             ttopo.ring(N), spec, T, Q, engine=engine,
                             device="cpu")
        for b in range(B):
            assert_same_run(got.object_result(b), want.object_result(b),
                            f"digest-rows/{engine}/{b}")


# -- weighted element accounting ---------------------------------------------

def test_weighted_accounting_matches_jax():
    jtp, ttp = topos()
    w = np.asarray([20.0, 301.0, 39.0])
    want = jax_simulate_store(
        "bprr", JGSet(N * T).lattice, jtp,
        JaxStoreSpec(objects=B, op_fn=jW.gset_unique_sweep_op(N, T, SEEDS),
                     weights=w),
        active_rounds=T, quiet_rounds=Q, wide_metrics=False)
    got = simulate_store(
        "bprr", GSet(N * T).lattice, ttp,
        StoreSpec(objects=B, op_fn=tW.gset_unique_sweep_op(N, T, SEEDS),
                  weights=w), T, Q, device="cpu")
    for view in ("tx_bytes", "mem_bytes", "store_tx_bytes",
                 "store_mem_bytes", "final_state_bytes"):
        g, x = getattr(got, view), np.asarray(getattr(want, view))
        assert g.dtype == np.float64, view
        np.testing.assert_array_equal(g, x, err_msg=view)
    assert got.total_tx_bytes == want.total_tx_bytes
    np.testing.assert_array_equal(got.final_state_bytes,
                                  np.broadcast_to(w[:, None] * (N * T),
                                                  (B, N)))


def test_wsize_reduces_to_size_and_prices_slots():
    for lat, x in [
        (GSet(universe=12).lattice, torch.arange(24).reshape(2, 12) % 3 == 0),
        (GCounter(6).lattice, torch.arange(12, dtype=torch.int32).reshape(2, 6)),
        (BitGSet(universe=40).lattice,
         torch.tensor([[0, 1], [-1, 6]], dtype=torch.int32)),
    ]:
        np.testing.assert_array_equal(lat.wsize(x, 1).numpy(),
                                      lat.size(x).numpy())
        np.testing.assert_array_equal(
            lat.wsize(x, BatchWeights(torch.ones(2))).numpy(),
            lat.size(x).numpy())
    x = torch.tensor([[True, False, True, True]])
    w = torch.tensor([1.0, 10.0, 100.0, 1000.0], dtype=torch.float64)
    np.testing.assert_array_equal(GSet(4).lattice.wsize(x, w).numpy(),
                                  [1101.0])


def scalar_max_lattice() -> Lattice:
    """A rank-0 max register (the port's copy of ``test_store``'s): its
    irreducible mask has no universe axis."""

    def wsize(a, w):
        m = a > 0
        return m * align_weights(w, m)

    return Lattice(
        name="reg", bottom=lambda device=None: torch.zeros(
            (), dtype=torch.int32, device=device),
        join=torch.maximum, leq=lambda a, b: a <= b,
        delta=lambda a, b: torch.where(a > b, a, 0),
        size=lambda a: (a > 0).to(torch.int32), is_bottom=lambda a: a == 0,
        irreducible_mask=lambda a: a > 0,
        novel_mask=lambda a, b: (a > 0) & (a > b), wsize=wsize)


def test_wsize_mixed_rank_against_jax():
    """BatchWeights on a product of a [U] map and a rank-0 register: each
    leaf aligns the [B] weights on its own rank; over rank raises."""
    jlat = jproduct("mixed", (JGSet(universe=4).lattice,
                              jax_scalar_max_lattice()))
    tlat = product("mixed", (GSet(universe=4).lattice, scalar_max_lattice()))
    s = np.asarray([[True, False, True, True], [False, False, True, False]])
    r = np.asarray([5, 0], np.int32)
    w = np.asarray([2.0, 7.0])
    want = np.asarray(jlat.wsize((jnp.asarray(s), jnp.asarray(r)),
                                 JBatchWeights(jnp.asarray(w))))
    got = tlat.wsize((torch.from_numpy(s), torch.from_numpy(r)),
                     BatchWeights(torch.from_numpy(w)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), [8.0, 7.0])
    with pytest.raises(ValueError, match="rank"):
        tlat.wsize((torch.from_numpy(s), torch.from_numpy(r)),
                   BatchWeights(torch.ones((2, 1, 1))))


def test_store_mixed_rank_weighted_accounting():
    """A store over the mixed-rank product prices its final states per
    object: 1 set element + 1 register on every node, at w[b] each."""
    topo = ttopo.ring(3)
    lat = product("mixed", (GSet(universe=6).lattice, scalar_max_lattice()))

    def op_fn(x, t):
        s, r = x
        b = s.shape[0]
        ds = torch.zeros_like(s)
        ds[:, 0, 2] = ~s[:, 0, 2]
        dr = (torch.arange(1, b + 1, dtype=r.dtype)[:, None]
              * torch.ones_like(r[:1])) if t == 0 else torch.zeros_like(r)
        return (ds, dr)

    w = np.asarray([10.0, 100.0])
    res = simulate_store("bprr", lat, topo, StoreSpec(objects=2, op_fn=op_fn,
                                                      weights=w), 2, 4,
                         device="cpu")
    np.testing.assert_array_equal(res.final_state_bytes,
                                  np.broadcast_to(w[:, None] * 2, (2, 3)))


# -- chunks, checkpoints, reduced metrics, padding -----------------------------

def scale_fixture():
    _, ttp = topos()
    spec = StoreSpec(objects=B, op_fn=tW.gset_unique_sweep_op(N, T, SEEDS),
                     weights=np.arange(1.0, B + 1),
                     faults=store_schedule(FaultSchedule, ttp))
    return ttp, GSet(N * T).lattice, spec


def run(spec_fixture=None, **kw):
    ttp, lat, spec = spec_fixture or scale_fixture()
    return simulate_store("bprr", lat, ttp, spec, T, Q, device="cpu", **kw)


def assert_store_identical(a, b):
    for f in ("tx", "mem", "cpu", "max_mem_node", "uniform"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
        assert getattr(a, f).dtype == getattr(b, f).dtype, f
    assert torch.equal(a.final_x, b.final_x)
    np.testing.assert_array_equal(a.final_state_bytes, b.final_state_bytes)


@pytest.mark.parametrize("chunk", [1, 4, 5, T + Q, T + Q + 9])
def test_store_chunked_equals_whole_run_and_jax(chunk):
    mono = run()
    assert_store_identical(mono, run(chunk_rounds=chunk))
    want = jax_store("bprr", True)
    for b in range(B):
        got = run(chunk_rounds=chunk).object_result(b)
        assert_same_run(got, want.object_result(b), f"chunk{chunk}/obj{b}")


def test_store_resume_every_boundary(tmp_path):
    full = run(chunk_rounds=4, checkpoint=tmp_path)
    ck = Checkpointer(tmp_path)
    assert ck.available_steps() == [4, 8, 12, T + Q]
    ttp, lat, spec = scale_fixture()
    for step in ck.available_steps():
        res = resume_store("bprr", lat, ttp, spec, T, Q, checkpoint=tmp_path,
                           step=step, device="cpu")
        assert_store_identical(full, res)


class KilledAfterSaves(Checkpointer):
    """A checkpointer that dies right after its n-th save: a job killed at
    a chunk boundary."""

    def __init__(self, directory, die_after: int):
        super().__init__(directory)
        self.die_after = die_after

    def save(self, step, state, extra=None):
        out = super().save(step, state, extra)
        self.die_after -= 1
        if self.die_after <= 0:
            raise KeyboardInterrupt("killed after checkpoint save")
        return out


def test_store_resume_after_kill(tmp_path):
    full = run(chunk_rounds=4)
    with pytest.raises(KeyboardInterrupt):
        run(chunk_rounds=4, checkpoint=KilledAfterSaves(tmp_path, 1))
    ck = Checkpointer(tmp_path)
    assert ck.available_steps() == [4]
    ttp, lat, spec = scale_fixture()
    res = resume_store("bprr", lat, ttp, spec, T, Q, checkpoint=ck,
                       device="cpu")
    assert_store_identical(full, res)
    assert ck.available_steps()[-1] == T + Q   # it went on checkpointing


def test_store_resume_refuses_another_run(tmp_path):
    run(chunk_rounds=4, checkpoint=tmp_path)
    ttp, lat, spec = scale_fixture()
    with pytest.raises(ValueError, match="different store run"):
        resume_store("state", lat, ttp, spec, T, Q, checkpoint=tmp_path,
                     device="cpu")
    with pytest.raises(ValueError, match="different store run"):
        resume_store("bprr", lat, ttp, spec, T + 1, Q, checkpoint=tmp_path,
                     device="cpu")
    with pytest.raises(ValueError, match="no checkpoint for round"):
        resume_store("bprr", lat, ttp, spec, T, Q, checkpoint=tmp_path,
                     step=3, device="cpu")
    with pytest.raises(ValueError, match="chunk_rounds"):
        run(checkpoint=tmp_path / "x")


def test_store_reduced_metrics_exact_aggregates():
    full = run()
    red = run(object_metrics=False, chunk_rounds=4)
    want = jax_store("bprr", True)
    assert red.objects == B and red.sim.tx.shape == (1, T + Q)
    for view in ("store_tx", "store_mem", "store_cpu", "store_max_mem_node",
                 "store_uniform"):
        np.testing.assert_array_equal(getattr(red, view),
                                      getattr(full, view), err_msg=view)
        np.testing.assert_array_equal(getattr(red, view),
                                      np.asarray(getattr(want, view)),
                                      err_msg=view)
    assert red.store_convergence_round() == full.store_convergence_round()
    assert torch.equal(red.final_x, full.final_x)
    np.testing.assert_array_equal(red.final_state_bytes,
                                  full.final_state_bytes)
    for view in ("tx", "mem", "cpu", "max_mem_node", "uniform", "tx_bytes"):
        with pytest.raises(ValueError, match="object_metrics"):
            getattr(red, view)
    with pytest.raises(ValueError, match="object_metrics"):
        red.object_result(0)


def results_path_run(kind, ckpt_dir):
    """One store run of ``kind`` on the CPU: a single chunk, chunks,
    checkpoints and a resume from round 8, a pad, reduced metrics or
    telemetry."""
    if kind == "resume":
        run(chunk_rounds=4, checkpoint=ckpt_dir)
        ttp, lat, spec = scale_fixture()
        return resume_store("bprr", lat, ttp, spec, T, Q,
                            checkpoint=ckpt_dir, step=8, device="cpu")
    from repro_torch.obs import TelemetrySpec
    return run(**{"single": {}, "chunked": {"chunk_rounds": 4},
                  "padded": {"pad_to": 4},
                  "reduced": {"object_metrics": False},
                  "telemetry": {"telemetry": TelemetrySpec()}}[kind])


@pytest.mark.parametrize("kind", ["single", "chunked", "resume", "padded",
                                  "reduced", "telemetry"])
def test_store_results_path_equals_the_old_host_path(kind, tmp_path,
                                                     monkeypatch):
    new = results_path_run(kind, tmp_path / "new")
    old_host_path(monkeypatch)
    old = results_path_run(kind, tmp_path / "old")
    assert_same_host_result(new, old, kind)
    if kind == "telemetry":
        for f in new.telemetry._fields[:6]:
            a, b = getattr(new.telemetry, f), getattr(old.telemetry, f)
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a, b, err_msg=f)
    if kind == "resume":
        # the bundles hold the same bytes: time-major views save as the
        # earlier path's time-major arrays did
        new_ck, old_ck = Checkpointer(tmp_path / "new"), \
            Checkpointer(tmp_path / "old")
        assert new_ck.available_steps() == old_ck.available_steps()
        for step in new_ck.available_steps():
            assert new_ck.manifest(step)["digest"] == \
                old_ck.manifest(step)["digest"], step


@pytest.mark.parametrize("chunk", [None, 4])
def test_store_results_to_host_counter(chunk, monkeypatch):
    """``trace=`` records one ``results_to_host`` counter a run: the bytes
    of its results on the host, and no pinned memory on the CPU. Without
    ``trace`` nothing is recorded and the allocator is not read."""
    from repro_torch.obs import TraceLog
    from repro_torch.sync import store

    log = TraceLog()
    res = run(chunk_rounds=chunk, trace=log)
    counters = [e for e in log.events if e["name"] == "results_to_host"]
    assert len(counters) == 1 and counters[0]["ph"] == "C"
    want = sum(a.nbytes for a in (res.tx, res.mem, res.cpu, res.max_mem_node,
                                  res.uniform, res.final_state_bytes))
    assert counters[0]["args"] == {"bytes": float(want),
                                   "pinned_bytes": 0.0}

    def unread(device):
        raise AssertionError("the allocator was read without trace=")

    monkeypatch.setattr(store, "pinned_bytes", unread)
    assert_store_identical(run(chunk_rounds=chunk), res)


def test_store_validation_and_unported_options():
    ttp, lat, _ = scale_fixture()
    op = tW.gset_unique_sweep_op(N, T, SEEDS)
    with pytest.raises(ValueError):
        StoreSpec(objects=0, op_fn=lambda x, t: x)
    with pytest.raises(ValueError):
        StoreSpec(objects=3, op_fn=op, weights=np.ones(2))
    with pytest.raises(ValueError, match="leading"):
        StoreSpec(objects=B, op_fn=op, x0=np.zeros((B + 1, N, N * T), bool))
    with pytest.raises(ValueError, match="universe"):
        simulate_store("bprr", lat, ttp,
                       StoreSpec(objects=B, op_fn=op,
                                 x0=np.zeros((B, N, N * T + 1), bool)),
                       T, device="cpu")
    with pytest.raises(ValueError, match="op_fn"):
        simulate_store("bprr", lat, ttp, StoreSpec(
            objects=B, op_fn=lambda x, t: x[:, :1]), T, device="cpu")
    with pytest.raises(ValueError):           # schedule bound to other topo
        simulate_store("bprr", lat, ttp, StoreSpec(
            objects=B, op_fn=op, faults=FaultSchedule.none(ttopo.tree(N), T)),
            T, device="cpu")
    ok = StoreSpec(objects=B, op_fn=op)
    with pytest.raises(ValueError, match="cannot split"):
        simulate_store("bprr", lat, ttp, ok, T, shard=True, pad_to=3,
                       device=["cpu"] * 2)
    with pytest.raises(ValueError, match="pad_to"):
        simulate_store("bprr", lat, ttp, ok, T, pad_to=0, device="cpu")
    with pytest.raises(ValueError, match="shard=True"):
        simulate_store("bprr", lat, ttp, ok, T, device=["cpu"] * 2)
    table = torch.zeros((B, N, N * T), dtype=torch.bool)
    closed = StoreSpec(objects=B, op_fn=lambda x, t: table | x)
    simulate_store("bprr", lat, ttp, closed, T, shard=True, device=["cpu"])
    with pytest.raises(ValueError, match="sharded object axis"):
        simulate_store("bprr", lat, ttp, closed, T, shard=True,
                       device=["cpu"] * 2)
    for kw in ({"telemetry": object()}, {"provenance": object()}):
        with pytest.raises(TypeError):
            simulate_store("bprr", lat, ttp, ok, T, device="cpu", **kw)


# -- the committed Retwis row ----------------------------------------------------

def retwis_row(zipf, algo, nodes=16, objects=96, slots=32, rounds=40, ops=6):
    """One fig11 cell through the port's store on the CPU, computed as
    ``benchmarks/fig11_retwis.py`` computes it."""
    wl = tW.retwis(objects, nodes, rounds, ops, zipf, seed=0)
    lat = MapLattice(slots, tvl.max_int(), "retwis").build()
    spec = StoreSpec(objects=objects,
                     op_fn=tW.versioned_slot_op(wl.update_counts(), slots),
                     weights=tW.retwis_weights(objects))
    res = simulate_store(algo, lat, ttopo.partial_mesh(nodes, 4), spec,
                         rounds, device="cpu")
    tx, mem = res.store_tx_bytes, res.store_mem_bytes
    half = len(tx) // 2
    return {"tx_mb_node_h1": float(tx[:half].sum() / nodes / 1e6),
            "tx_mb_node_h2": float(tx[half:].sum() / nodes / 1e6),
            "mem_mb_node_h1": float(mem[:half].mean() / nodes / 1e6),
            "mem_mb_node_h2": float(mem[half:].mean() / nodes / 1e6),
            "cpu": float(res.store_cpu.sum())}


def test_fig11_default_zipf1_row():
    fig = json.loads((RESULTS / "fig11_retwis.json").read_text())
    row = fig["zipf_1.0"]
    got = {algo: retwis_row(1.0, algo) for algo in ("classic", "bprr")}
    for algo in ("classic", "bprr"):
        assert got[algo] == row[algo], algo
    ratio = got["classic"]["tx_mb_node_h2"] / max(
        got["bprr"]["tx_mb_node_h2"], 1e-9)
    overhead = got["classic"]["cpu"] / max(got["bprr"]["cpu"], 1e-9) - 1.0
    assert ratio == row["tx_ratio_h2"]
    assert overhead == row["cpu_overhead"]
