"""Telemetry, JAX against the port.

* Every channel (recv / novel / stale / ack / buf / div_gap, per round and
  node) of a port ``simulate(..., telemetry=TelemetrySpec())`` equals the
  JAX package's (``wide_metrics=False``) exactly, for the five δ-family
  algorithms over GSet, GCounter and LWWMap, fault-free and under 10%
  loss, and for both resync modes from a joining replica, on each of the
  port's three engines; the derived views (redundancy over time and in
  total) too.
* Sweeps and stores: every cell's and object's channels equal the JAX
  package's and the single run's; the store's reduced partials under
  ``object_metrics=False``; chunked, checkpointed and resumed runs; a
  resume under another telemetry configuration is refused.
* Telemetry leaves every other result field bit-identical, and the
  disabled groups come back as zeros.
* The committed ``benchmarks/results/fig_telemetry.json``, value for value.
* ``repro_torch.sync`` exports every name ``repro.sync`` does.
"""

import functools
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sync as jsync
from repro.core import types as jtypes
from repro.obs import TelemetrySpec as JaxTelemetrySpec
from repro.sync import DigestSpec as JaxDigestSpec
from repro.sync import FaultSchedule as JaxSchedule
from repro.sync import StoreSpec as JaxStoreSpec
from repro.sync import SweepSpec as JaxSweepSpec
from repro.sync import simulate as jax_simulate
from repro.sync import simulate_store as jax_simulate_store
from repro.sync import simulate_sweep as jax_simulate_sweep
from repro.sync import topology as jtopo
from repro.sync import workloads as jW
from test_torch_lww import jax_op as jax_lww_op
from test_torch_lww import torch_op as torch_lww_op
from test_torch_sweep import assert_same_run

import repro_torch.sync as tsync
from repro_torch.checkpoint import Checkpointer
from repro_torch.core import types as ttypes
from repro_torch.obs import TelemetryResult, TelemetrySpec
from repro_torch.obs import telemetry as tel
from repro_torch.sync import (ENGINES, DigestSpec, FaultSchedule, StoreSpec,
                              SweepSpec, resume_store, simulate,
                              simulate_store, simulate_sweep)
from repro_torch.sync import topology as ttopo
from repro_torch.sync import workloads as tW

torch.set_num_threads(1)

RESULTS = Path(__file__).resolve().parents[1] / "benchmarks" / "results"
DELTA = ("state", "classic", "bp", "rr", "bprr")
N, EVENTS, ACTIVE, QUIET = 15, 6, 6, 6
JOIN_U, BE = 96, 8
CHANNELS = tel.TelemetryChannels._fields


def workload(name):
    """(JAX lattice, JAX op, port lattice, port op) at the tests' size."""
    if name == "gset":
        return (jtypes.GSet(N * EVENTS).lattice, jW.gset_unique_op(N, EVENTS),
                ttypes.GSet(N * EVENTS).lattice,
                tW.gset_unique_op(N, EVENTS))
    if name == "gcounter":
        return (jtypes.GCounter(N).lattice, jW.gcounter_op(N),
                ttypes.GCounter(N).lattice, tW.gcounter_op(N))
    return (jtypes.LWWMap(120).lattice, jax_lww_op,
            ttypes.LWWMap(120).lattice, torch_lww_op)


def topos(name="mesh"):
    return jtopo.by_name(name, N, 4), ttopo.by_name(name, N, 4)


def loss(F, topo):
    return F.bernoulli(topo, ACTIVE + QUIET, 0.10, seed=7)


def joiner_x0():
    """fig_digest's join start: every node but node 0 holds the first
    quarter of the universe."""
    x0 = np.zeros((N, JOIN_U), bool)
    x0[1:, : JOIN_U // 4] = True
    return x0


def assert_channels_equal(got, want, ctx):
    """Two telemetry results (port, JAX or port), channel for channel."""
    assert isinstance(got, TelemetryResult), ctx
    for f in CHANNELS:
        np.testing.assert_array_equal(getattr(got, f),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f"{ctx}: {f}")
    np.testing.assert_array_equal(got.redundancy_over_time(),
                                  want.redundancy_over_time(),
                                  err_msg=f"{ctx}: redundancy_over_time")
    np.testing.assert_array_equal(got.total_redundancy(),
                                  want.total_redundancy(),
                                  err_msg=f"{ctx}: total_redundancy")


# -- C1: the package's exports ----------------------------------------------------

def test_sync_exports_cover_the_jax_package():
    """``repro_torch.sync`` exports every name ``repro.sync`` does (the
    topology constructors, ``RoundFaults``, the submodules and the
    telemetry types were missing), each importable."""
    missing = set(jsync.__all__) - set(tsync.__all__)
    assert not missing, sorted(missing)
    for name in tsync.__all__:
        assert getattr(tsync, name) is not None, name
    from repro_torch.sync import (RoundFaults, TelemetryResult,  # noqa: F401
                                  TelemetrySpec, Topology, partial_mesh,
                                  scuttlebutt)
    assert partial_mesh(15, 4).num_edges == jtopo.partial_mesh(15, 4).num_edges


# -- single runs ------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def jax_run(algo, lat_name, faulted):
    jlat, jop, _, _ = workload(lat_name)
    jtp, _ = topos()
    r = jax_simulate(algo, jlat, jtp, jop, ACTIVE, QUIET,
                     faults=loss(JaxSchedule, jtp) if faulted else None,
                     wide_metrics=False, telemetry=JaxTelemetrySpec())
    return r


def port_run(algo, lat_name, faulted, engine, telemetry=TelemetrySpec()):
    _, _, tlat, top = workload(lat_name)
    _, ttp = topos()
    return simulate(algo, tlat, ttp, top, ACTIVE, QUIET, engine=engine,
                    faults=loss(FaultSchedule, ttp) if faulted else None,
                    wide_metrics=False, telemetry=telemetry, device="cpu")


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("faulted", [False, True],
                         ids=["fault_free", "loss10"])
@pytest.mark.parametrize("lat_name", ["gset", "gcounter", "lww"])
@pytest.mark.parametrize("algo", DELTA)
def test_channels_match_jax(algo, lat_name, faulted, engine):
    want = jax_run(algo, lat_name, faulted)
    got = port_run(algo, lat_name, faulted, engine)
    ctx = f"{algo}/{lat_name}/{engine}/faulted={faulted}"
    assert_same_run(got, want, ctx)
    assert got.telemetry.recv_elems.shape == (ACTIVE + QUIET, N)
    assert_channels_equal(got.telemetry, want.telemetry, ctx)


@functools.lru_cache(maxsize=None)
def jax_join(algo, faulted):
    jtp, _ = topos()
    return jax_simulate(
        algo, jtypes.GSet(JOIN_U).lattice, jtp,
        lambda x, t: jnp.zeros_like(x), 0, ACTIVE + QUIET,
        x0=jnp.asarray(joiner_x0()),
        faults=loss(JaxSchedule, jtp) if faulted else None,
        digest=JaxDigestSpec(BE), wide_metrics=False,
        telemetry=JaxTelemetrySpec())


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("faulted", [False, True],
                         ids=["fault_free", "loss10"])
@pytest.mark.parametrize("algo", ["state_driven", "digest_driven"])
def test_resync_channels_match_jax(algo, faulted, engine):
    """Both resync modes from a joining replica: the payload tallies
    exclude the digest words, on every engine."""
    want = jax_join(algo, faulted)
    _, ttp = topos()
    got = simulate(algo, ttypes.GSet(JOIN_U).lattice, ttp,
                   lambda x, t: torch.zeros_like(x), 0, ACTIVE + QUIET,
                   x0=torch.as_tensor(joiner_x0()),
                   faults=loss(FaultSchedule, ttp) if faulted else None,
                   digest=DigestSpec(BE), engine=engine, wide_metrics=False,
                   telemetry=TelemetrySpec(), device="cpu")
    ctx = f"{algo}/{engine}/faulted={faulted}"
    assert_same_run(got, want, ctx)
    assert_channels_equal(got.telemetry, want.telemetry, ctx)
    assert got.telemetry.recv_elems.sum() > 0


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("algo", ["classic", "bprr", "digest_driven"])
def test_telemetry_leaves_the_run_unchanged(algo, engine):
    """With telemetry on, every other field equals the run without it,
    and ``telemetry=None`` returns no result."""
    _, ttp = topos()
    kw = dict(faults=loss(FaultSchedule, ttp), engine=engine,
              digest=DigestSpec(BE), device="cpu")
    lat, op = ttypes.GSet(N * EVENTS).lattice, tW.gset_unique_op(N, EVENTS)
    off = simulate(algo, lat, ttp, op, ACTIVE, QUIET, **kw)
    on = simulate(algo, lat, ttp, op, ACTIVE, QUIET,
                  telemetry=TelemetrySpec(), **kw)
    assert off.telemetry is None and off.provenance is None
    assert on.telemetry is not None and on.provenance is None
    assert_same_run(on, off, f"{algo}/{engine}")


@pytest.mark.parametrize("group", ["redundancy", "staleness", "buffer",
                                   "divergence"])
def test_disabled_groups_come_back_as_zeros(group):
    """A disabled group's channels are zeros; the others are unchanged
    (the same as the JAX package's with the same spec)."""
    jtp, ttp = topos()
    off = {group: False}
    want = jax_simulate("bprr", jtypes.GSet(N * EVENTS).lattice, jtp,
                        jW.gset_unique_op(N, EVENTS), ACTIVE, QUIET,
                        faults=loss(JaxSchedule, jtp), wide_metrics=False,
                        telemetry=JaxTelemetrySpec(**off))
    full = port_run("bprr", "gset", True, "fused")
    got = port_run("bprr", "gset", True, "fused", TelemetrySpec(**off))
    assert_channels_equal(got.telemetry, want.telemetry, group)
    zeroed = {"redundancy": ("recv_elems", "novel_elems"),
              "staleness": ("stale_rounds",),
              "buffer": ("ack_lag", "buf_elems"),
              "divergence": ("div_gap",)}[group]
    for f in CHANNELS:
        a = getattr(got.telemetry, f)
        if f in zeroed:
            assert not a.any(), f
        else:
            np.testing.assert_array_equal(a, getattr(full.telemetry, f))


def test_result_views_and_overflow():
    """``cell`` / ``take_lead`` refuse a single run; a negative tally (a
    wrapped accumulator) is refused by ``collect``."""
    r = port_run("bprr", "gset", False, "reference")
    with pytest.raises(ValueError):
        r.telemetry.cell(0)
    with pytest.raises(ValueError):
        r.telemetry.take_lead(1)
    assert r.telemetry.batch is None
    bad = [np.zeros((3, N), np.int32) for _ in CHANNELS]
    bad[2][1, 4] = -1
    with pytest.raises(OverflowError, match="stale_rounds"):
        tel.collect(TelemetrySpec(), bad, batched=False)
    with pytest.raises(TypeError):
        simulate("bprr", ttypes.GSet(4).lattice, ttopo.ring(5),
                 lambda x, t: x, 1, telemetry={"redundancy": True},
                 device="cpu")


# -- sweeps -----------------------------------------------------------------------

SB, ST, SQ, SEEDS = 3, 5, 7, (0, 3, 11)


def sweep_faults(F, topo):
    return [None, F.bernoulli(topo, ST, 0.3, seed=7),
            F.partition(topo, ST, 1, ST - 1,
                        (np.arange(N) >= N // 2).astype(np.int32))]


@functools.lru_cache(maxsize=None)
def jax_sweep(algo):
    jtp, _ = topos()
    spec = JaxSweepSpec(batch=SB, op_fn=jW.gset_unique_sweep_op(N, ST, SEEDS),
                        faults=sweep_faults(JaxSchedule, jtp))
    return jax_simulate_sweep(algo, jtypes.GSet(N * ST).lattice, jtp, spec,
                              ST, SQ, wide_metrics=False,
                              digest=JaxDigestSpec(BE),
                              telemetry=JaxTelemetrySpec())


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("algo", ["classic", "bprr", "digest_driven"])
def test_sweep_cells_match_jax_and_single_runs(algo, engine):
    want = jax_sweep(algo)
    _, ttp = topos()
    scheds = sweep_faults(FaultSchedule, ttp)
    spec = SweepSpec(batch=SB, op_fn=tW.gset_unique_sweep_op(N, ST, SEEDS),
                     faults=scheds)
    lat = ttypes.GSet(N * ST).lattice
    got = simulate_sweep(algo, lat, ttp, spec, ST, SQ, engine=engine,
                         wide_metrics=False, telemetry=TelemetrySpec(),
                         digest=DigestSpec(BE), device="cpu")
    assert got.telemetry.batch == SB
    assert_channels_equal(got.telemetry, want.telemetry, f"{algo}/{engine}")
    for b, seed in enumerate(SEEDS):
        single = simulate(algo, lat, ttp, tW.gset_unique_op(N, ST, seed), ST,
                          SQ, faults=scheds[b], engine=engine,
                          track_convergence=True, digest=DigestSpec(BE),
                          wide_metrics=False, telemetry=TelemetrySpec(),
                          device="cpu")
        assert_channels_equal(got.telemetry.cell(b), single.telemetry,
                              f"{algo}/{engine}/cell{b}")
        assert_same_run(got.cell(b), single, f"{algo}/{engine}/cell{b}")


# -- stores -----------------------------------------------------------------------

def store_sched(F, topo):
    return F.bernoulli(topo, ST, 0.2, seed=2)


@functools.lru_cache(maxsize=None)
def jax_store(algo, object_metrics):
    jtp, _ = topos()
    spec = JaxStoreSpec(objects=SB,
                        op_fn=jW.gset_unique_sweep_op(N, ST, SEEDS),
                        faults=store_sched(JaxSchedule, jtp))
    return jax_simulate_store(algo, jtypes.GSet(N * ST).lattice, jtp, spec,
                              ST, SQ, wide_metrics=False,
                              object_metrics=object_metrics,
                              telemetry=JaxTelemetrySpec())


def port_store(algo, engine, **kw):
    _, ttp = topos()
    spec = StoreSpec(objects=SB, op_fn=tW.gset_unique_sweep_op(N, ST, SEEDS),
                     faults=store_sched(FaultSchedule, ttp))
    return simulate_store(algo, ttypes.GSet(N * ST).lattice, ttp, spec, ST,
                          SQ, engine=engine, wide_metrics=False,
                          device="cpu", **kw)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("algo", ["state", "bprr", "state_driven"])
def test_store_objects_match_jax(algo, engine):
    want = jax_store(algo, True)
    got = port_store(algo, engine, telemetry=TelemetrySpec())
    assert got.telemetry.batch == SB
    assert_channels_equal(got.telemetry, want.telemetry, f"{algo}/{engine}")
    _, ttp = topos()
    for b, seed in enumerate(SEEDS):
        single = simulate(algo, ttypes.GSet(N * ST).lattice, ttp,
                          tW.gset_unique_op(N, ST, seed), ST, SQ,
                          faults=store_sched(FaultSchedule, ttp),
                          engine=engine, wide_metrics=False,
                          telemetry=TelemetrySpec(), device="cpu")
        assert_channels_equal(got.object_result(b).telemetry,
                              single.telemetry, f"{algo}/{engine}/obj{b}")


@pytest.mark.parametrize("engine", ENGINES)
def test_store_reduced_partials_match_jax(engine):
    """``object_metrics=False``: one [1, T, N] partial (sums for the
    payload tallies, maxes for the lags and gaps), the JAX package's, and
    the reduction of the per-object channels."""
    want = jax_store("bprr", False)
    got = port_store("bprr", engine, telemetry=TelemetrySpec(),
                     object_metrics=False)
    per = port_store("bprr", engine, telemetry=TelemetrySpec())
    t = got.telemetry
    assert t.recv_elems.shape == (1, ST + SQ, N)
    for f in CHANNELS:
        np.testing.assert_array_equal(getattr(t, f),
                                      np.asarray(getattr(want.telemetry, f)),
                                      err_msg=f)
        red = np.max if f in ("stale_rounds", "ack_lag", "div_gap") \
            else np.sum
        np.testing.assert_array_equal(
            getattr(t, f)[0], red(getattr(per.telemetry, f), axis=0),
            err_msg=f)


def test_store_chunked_resume_and_refusal(tmp_path):
    """Chunked and checkpointed runs keep the channels; a resume from any
    boundary equals the uninterrupted run; a resume with another
    telemetry configuration (or none) is refused."""
    full = port_store("bprr", "mega", telemetry=TelemetrySpec())
    ck = Checkpointer(tmp_path / "ck")
    chunked = port_store("bprr", "mega", telemetry=TelemetrySpec(),
                         chunk_rounds=4, checkpoint=ck)
    assert_channels_equal(chunked.telemetry, full.telemetry, "chunked")
    assert ck.available_steps() == [4, 8, 12]
    _, ttp = topos()
    spec = StoreSpec(objects=SB, op_fn=tW.gset_unique_sweep_op(N, ST, SEEDS),
                     faults=store_sched(FaultSchedule, ttp))
    lat = ttypes.GSet(N * ST).lattice
    for step in (4, 8):
        res = resume_store("bprr", lat, ttp, spec, ST, SQ, checkpoint=ck,
                           step=step, engine="mega", wide_metrics=False,
                           telemetry=TelemetrySpec(), device="cpu")
        assert_channels_equal(res.telemetry, full.telemetry, f"from {step}")
        assert_same_run(res.sim, full.sim, f"from {step}")
    for other in (None, TelemetrySpec(divergence=False)):
        with pytest.raises(ValueError, match="telemetry"):
            resume_store("bprr", lat, ttp, spec, ST, SQ, checkpoint=ck,
                         step=4, engine="mega", wide_metrics=False,
                         telemetry=other, device="cpu")


# -- the committed fig_telemetry results --------------------------------------------

def fig_row(res):
    """A fig_telemetry row's numbers, as ``benchmarks/fig_telemetry.py``
    computes them."""
    t = res.telemetry
    return {"tx": res.total_tx,
            "recv_elems": int(t.recv_elems.sum()),
            "novel_elems": int(t.novel_elems.sum()),
            "redundancy": round(t.total_redundancy(), 4),
            "redundancy_over_time": [
                None if np.isnan(v) else round(float(v), 4)
                for v in t.redundancy_over_time()],
            "peak_buf_elems": int(t.buf_elems.sum(axis=-1).max()),
            "max_stale_rounds": int(t.stale_rounds.max()),
            "max_ack_lag": int(t.ack_lag.max()),
            "final_div_gap": int(t.div_gap[-1].sum())}


@pytest.mark.parametrize("scenario", ["tree", "mesh", "loss", "join"])
def test_fig_telemetry_reproduces(scenario):
    """The 18 committed cells of ``fig_telemetry.json`` (N = 15, 40 + 40
    rounds), value for value, on the port's reference engine (its
    engines' channels are equal, as the tests above hold)."""
    fig = json.loads((RESULTS / "fig_telemetry.json").read_text())
    nodes, events, quiet = fig["nodes"], fig["events"], fig["quiet"]
    topo = ttopo.by_name("tree" if scenario == "tree" else "mesh", nodes, 4)
    kw = dict(telemetry=TelemetrySpec(), device="cpu")
    if scenario == "join":
        u = 1024
        x0 = torch.zeros((nodes, u), dtype=torch.bool)
        x0[1:, : int(round(fig["join_ratio"] * u))] = True
        rows = fig["join"]
        runs = {a: simulate(a, ttypes.GSet(u).lattice, topo,
                            lambda x, t: torch.zeros_like(x), 0, 14, x0=x0,
                            digest=DigestSpec(64), track_convergence=True,
                            **kw) for a in rows}
    else:
        rows = fig["transmission"][scenario] if scenario != "loss" \
            else fig["loss"]
        faults = FaultSchedule.bernoulli(topo, events + quiet // 4,
                                         fig["loss_rate"], seed=7) \
            if scenario == "loss" else None
        lat, op = ttypes.GSet(nodes * events).lattice, \
            tW.gset_unique_op(nodes, events)
        runs = {a: simulate(a, lat, topo, op, events, quiet, faults=faults,
                            **kw) for a in rows}
    for algo, row in rows.items():
        want = {k: v for k, v in row.items() if k != "wall_s"}
        assert fig_row(runs[algo]) == want, f"{scenario}/{algo}"
