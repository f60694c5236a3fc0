"""Provenance, JAX against the port.

* Every end-of-run matrix (cov, birth, src, hop, edge_first, the per-cause
  waste) and every per-round channel (waste_bp, waste_cp, covered) of a
  port ``simulate(..., provenance=ProvenanceSpec())``, with telemetry
  riding the same run, equals the JAX package's (``wide_metrics=False``)
  exactly, for the five δ-family algorithms over GSet, GCounter and
  BitGSet, fault-free and under 10% loss, and for both resync modes from
  a joining replica, on each of the port's three engines; so do the
  derived views (waste by cause, lineage, time to full coverage) and
  ``attributed_fraction`` is 1.
* Sweeps and stores: every cell's and object's record equals the JAX
  package's and the single run's; ``provenance=`` needs
  ``object_metrics=True``.
* Provenance leaves every other result field bit-identical; tuple states
  and bad universes are refused as the JAX package refuses them.
* The scale oracle of ``chip_smoke.py``: a GMap whose nodes bump blocks
  of m keys gives m × the GCounter run's payload channels, stale_rounds
  and ack_lag equal.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import types as jtypes
from repro.obs import ProvenanceSpec as JaxProvenanceSpec
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
from test_torch_simulate import jax_bitgset_op
from test_torch_sweep import assert_same_run
from test_torch_telemetry import assert_channels_equal

from repro_torch.core import types as ttypes
from repro_torch.obs import ProvenanceResult, ProvenanceSpec, TelemetrySpec
from repro_torch.obs import provenance as prv
from repro_torch.sync import (ENGINES, DigestSpec, FaultSchedule, StoreSpec,
                              SweepSpec, simulate, simulate_store,
                              simulate_sweep)
from repro_torch.sync import topology as ttopo
from repro_torch.sync import workloads as tW

torch.set_num_threads(1)

DELTA = ("state", "classic", "bp", "rr", "bprr")
N, EVENTS, ACTIVE, QUIET, STRIDE = 15, 6, 6, 6, 3
JOIN_U, BE = 96, 8
MATRICES = ("cov", "birth", "src", "hop", "edge_first", "waste_bp_elems",
            "waste_cp_elems")
CHANNELS = ("waste_bp", "waste_cp", "covered")


def workload(name):
    """(JAX lattice, JAX op, port lattice, port op, universe=)."""
    if name == "gset":
        return (jtypes.GSet(N * EVENTS).lattice, jW.gset_unique_op(N, EVENTS),
                ttypes.GSet(N * EVENTS).lattice,
                tW.gset_unique_op(N, EVENTS), None)
    if name == "gcounter":
        return (jtypes.GCounter(N).lattice, jW.gcounter_op(N),
                ttypes.GCounter(N).lattice, tW.gcounter_op(N), None)
    u = N * EVENTS * STRIDE
    return (jtypes.BitGSet(u).lattice, jax_bitgset_op(N, EVENTS, STRIDE),
            ttypes.BitGSet(u).lattice,
            tW.bitgset_unique_op(N, EVENTS, STRIDE), u)


def topos(name="mesh"):
    return jtopo.by_name(name, N, 4), ttopo.by_name(name, N, 4)


def loss(F, topo):
    return F.bernoulli(topo, ACTIVE + QUIET, 0.10, seed=7)


def assert_provenance_equal(got, want, ctx):
    """Two provenance results (port, JAX or port), field for field."""
    assert isinstance(got, ProvenanceResult), ctx
    for f in MATRICES:
        g = getattr(got, f)
        g = g.cpu().numpy() if isinstance(g, torch.Tensor) else g
        np.testing.assert_array_equal(g, np.asarray(getattr(want, f)),
                                      err_msg=f"{ctx}: {f}")
    for f in CHANNELS:
        np.testing.assert_array_equal(getattr(got, f),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f"{ctx}: {f}")
    np.testing.assert_array_equal(got.nbrs, np.asarray(want.nbrs))
    assert got.waste_by_cause().keys() == want.waste_by_cause().keys()
    for k, v in want.waste_by_cause().items():
        np.testing.assert_array_equal(got.waste_by_cause()[k], v)


# -- single runs ------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def jax_run(algo, lat_name, faulted):
    jlat, jop, _, _, u = workload(lat_name)
    jtp, _ = topos()
    return jax_simulate(algo, jlat, jtp, jop, ACTIVE, QUIET,
                        faults=loss(JaxSchedule, jtp) if faulted else None,
                        wide_metrics=False, telemetry=JaxTelemetrySpec(),
                        provenance=JaxProvenanceSpec(universe=u))


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("faulted", [False, True],
                         ids=["fault_free", "loss10"])
@pytest.mark.parametrize("lat_name", ["gset", "gcounter", "bitgset"])
@pytest.mark.parametrize("algo", DELTA)
def test_provenance_matches_jax(algo, lat_name, faulted, engine):
    want = jax_run(algo, lat_name, faulted)
    _, _, tlat, top, u = workload(lat_name)
    _, ttp = topos()
    got = simulate(algo, tlat, ttp, top, ACTIVE, QUIET, engine=engine,
                   faults=loss(FaultSchedule, ttp) if faulted else None,
                   wide_metrics=False, telemetry=TelemetrySpec(),
                   provenance=ProvenanceSpec(universe=u), device="cpu")
    ctx = f"{algo}/{lat_name}/{engine}/faulted={faulted}"
    assert_same_run(got, want, ctx, words=lat_name == "bitgset")
    assert_channels_equal(got.telemetry, want.telemetry, ctx)
    assert_provenance_equal(got.provenance, want.provenance, ctx)
    # the attribution is exhaustive: waste_bp + waste_cp == recv − novel
    np.testing.assert_array_equal(
        got.provenance.waste_bp.astype(np.int64) + got.provenance.waste_cp,
        got.telemetry.redundant_elems)
    assert got.provenance.attributed_fraction(got.telemetry) == 1.0
    if algo == "bprr" and lat_name != "gcounter":
        # unique elements: bprr never ships one back (a GCounter entry
        # grows, and under loss a retained older value can travel back)
        assert got.provenance.waste_by_cause()["backprop"] == 0
    np.testing.assert_array_equal(got.provenance.time_to_full_coverage(),
                                  want.provenance.time_to_full_coverage())
    for e in (0, 7, got.provenance.cov.shape[-1] - 1):
        assert got.provenance.lineage(e) == want.provenance.lineage(e), e


def joiner_x0():
    x0 = np.zeros((N, JOIN_U), bool)
    x0[1:, : JOIN_U // 4] = True
    return x0


@functools.lru_cache(maxsize=None)
def jax_join(algo):
    jtp, _ = topos()
    return jax_simulate(
        algo, jtypes.GSet(JOIN_U).lattice, jtp,
        lambda x, t: jnp.zeros_like(x), 0, ACTIVE + QUIET,
        x0=jnp.asarray(joiner_x0()), faults=loss(JaxSchedule, jtp),
        digest=JaxDigestSpec(BE), wide_metrics=False,
        provenance=JaxProvenanceSpec())


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("algo", ["state_driven", "digest_driven", "bprr"])
def test_join_provenance_matches_jax(algo, engine):
    """A joining replica under 10% loss: the initial states count as
    native (birth −1, hop 0)."""
    want = jax_join(algo)
    _, ttp = topos()
    got = simulate(algo, ttypes.GSet(JOIN_U).lattice, ttp,
                   lambda x, t: torch.zeros_like(x), 0, ACTIVE + QUIET,
                   x0=torch.as_tensor(joiner_x0()),
                   faults=loss(FaultSchedule, ttp), digest=DigestSpec(BE),
                   engine=engine, wide_metrics=False,
                   provenance=ProvenanceSpec(), device="cpu")
    assert got.telemetry is None
    assert_provenance_equal(got.provenance, want.provenance, f"{algo}/{engine}")


@pytest.mark.parametrize("spec", [dict(edges=False), dict(waste=False)],
                         ids=["no_edges", "no_waste"])
def test_disabled_groups_match_jax(spec):
    jtp, ttp = topos("tree")
    want = jax_simulate("classic", jtypes.GSet(N * EVENTS).lattice, jtp,
                        jW.gset_unique_op(N, EVENTS), ACTIVE, QUIET,
                        wide_metrics=False,
                        provenance=JaxProvenanceSpec(**spec))
    got = simulate("classic", ttypes.GSet(N * EVENTS).lattice, ttp,
                   tW.gset_unique_op(N, EVENTS), ACTIVE, QUIET,
                   engine="mega", provenance=ProvenanceSpec(**spec),
                   device="cpu")
    assert_provenance_equal(got.provenance, want.provenance, str(spec))
    if "edges" in spec:
        assert (got.provenance.edge_first == -1).all()
    else:
        assert not got.provenance.waste_bp.any()


@pytest.mark.parametrize("engine", ENGINES)
def test_provenance_leaves_the_run_unchanged(engine):
    _, ttp = topos()
    kw = dict(faults=loss(FaultSchedule, ttp), engine=engine, device="cpu")
    lat, op = ttypes.GSet(N * EVENTS).lattice, tW.gset_unique_op(N, EVENTS)
    off = simulate("bp", lat, ttp, op, ACTIVE, QUIET, **kw)
    on = simulate("bp", lat, ttp, op, ACTIVE, QUIET,
                  provenance=ProvenanceSpec(), **kw)
    assert off.provenance is None and on.provenance is not None
    assert_same_run(on, off, engine)


def test_refusals():
    """Tuple states, a dense universe override and an out-of-range bit
    universe are refused, with the JAX package's messages."""
    lww = ttypes.LWWMap(8).lattice
    with pytest.raises(ValueError, match="tuple state"):
        prv.element_universe(lww)
    with pytest.raises(ValueError, match="tuple state"):
        simulate("bprr", lww, ttopo.ring(5), lambda x, t: x, 1,
                 provenance=ProvenanceSpec(), device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        prv.element_universe(ttypes.GSet(10).lattice, 11)
    with pytest.raises(ValueError, match="out of range"):
        prv.element_universe(ttypes.BitGSet(40).lattice, 65)
    assert prv.element_universe(ttypes.BitGSet(40).lattice) == 64
    assert prv.element_universe(ttypes.BitGSet(40).lattice, 40) == 40
    with pytest.raises(TypeError):
        simulate("bprr", ttypes.GSet(4).lattice, ttopo.ring(5),
                 lambda x, t: x, 1, provenance=object(), device="cpu")
    r = simulate("bprr", ttypes.GSet(N * EVENTS).lattice, ttopo.tree(N),
                 tW.gset_unique_op(N, EVENTS), 2, provenance=ProvenanceSpec(),
                 device="cpu")
    with pytest.raises(ValueError):
        r.provenance.cell(0)
    bad = [np.zeros((2, N), np.int32) for _ in CHANNELS]
    bad[0][1, 1] = -3
    carry = prv.ProvenanceCarry(*(torch.zeros((N, 8), dtype=torch.int32)
                                  for _ in range(7)))
    with pytest.raises(OverflowError, match="waste_bp"):
        prv.collect(ProvenanceSpec(), carry, bad, np.zeros((N, 4)), False)


# -- sweeps and stores ----------------------------------------------------------------

SB, ST, SQ, SEEDS = 3, 5, 7, (0, 3, 11)


@functools.lru_cache(maxsize=None)
def jax_sweep(algo):
    jtp, _ = topos()
    spec = JaxSweepSpec(batch=SB, op_fn=jW.gset_unique_sweep_op(N, ST, SEEDS),
                        faults=[None, JaxSchedule.bernoulli(jtp, ST, 0.3,
                                                            seed=7), None])
    return jax_simulate_sweep(algo, jtypes.GSet(N * ST).lattice, jtp, spec,
                              ST, SQ, wide_metrics=False,
                              telemetry=JaxTelemetrySpec(),
                              provenance=JaxProvenanceSpec())


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("algo", ["classic", "bprr"])
def test_sweep_cells_match_jax_and_single_runs(algo, engine):
    want = jax_sweep(algo)
    _, ttp = topos()
    scheds = [None, FaultSchedule.bernoulli(ttp, ST, 0.3, seed=7), None]
    spec = SweepSpec(batch=SB, op_fn=tW.gset_unique_sweep_op(N, ST, SEEDS),
                     faults=scheds)
    lat = ttypes.GSet(N * ST).lattice
    got = simulate_sweep(algo, lat, ttp, spec, ST, SQ, engine=engine,
                         wide_metrics=False, telemetry=TelemetrySpec(),
                         provenance=ProvenanceSpec(), device="cpu")
    assert got.provenance.batch == SB
    assert_provenance_equal(got.provenance, want.provenance,
                            f"{algo}/{engine}")
    for b, seed in enumerate(SEEDS):
        single = simulate(algo, lat, ttp, tW.gset_unique_op(N, ST, seed), ST,
                          SQ, faults=scheds[b], engine=engine,
                          track_convergence=True, wide_metrics=False,
                          telemetry=TelemetrySpec(),
                          provenance=ProvenanceSpec(), device="cpu")
        c = got.cell(b)
        assert_provenance_equal(c.provenance, single.provenance,
                                f"{algo}/{engine}/cell{b}")
        assert_channels_equal(c.telemetry, single.telemetry,
                              f"{algo}/{engine}/cell{b}")
        assert c.provenance.lineage(3) == single.provenance.lineage(3)


@functools.lru_cache(maxsize=None)
def jax_store():
    jtp, _ = topos()
    spec = JaxStoreSpec(objects=SB,
                        op_fn=jW.gset_unique_sweep_op(N, ST, SEEDS),
                        faults=JaxSchedule.bernoulli(jtp, ST, 0.2, seed=2))
    return jax_simulate_store("bp", jtypes.GSet(N * ST).lattice, jtp, spec,
                              ST, SQ, wide_metrics=False,
                              provenance=JaxProvenanceSpec())


@pytest.mark.parametrize("engine", ENGINES)
def test_store_objects_match_jax(engine):
    want = jax_store()
    _, ttp = topos()
    spec = StoreSpec(objects=SB, op_fn=tW.gset_unique_sweep_op(N, ST, SEEDS),
                     faults=FaultSchedule.bernoulli(ttp, ST, 0.2, seed=2))
    lat = ttypes.GSet(N * ST).lattice
    got = simulate_store("bp", lat, ttp, spec, ST, SQ, engine=engine,
                         wide_metrics=False, provenance=ProvenanceSpec(),
                         chunk_rounds=5, device="cpu")
    assert_provenance_equal(got.provenance, want.sim.provenance, engine)
    for b in range(SB):
        assert_provenance_equal(got.object_result(b).provenance,
                                want.object_result(b).provenance,
                                f"{engine}/obj{b}")
    with pytest.raises(ValueError, match="object_metrics"):
        simulate_store("bp", lat, ttp, spec, ST, SQ, engine=engine,
                       provenance=ProvenanceSpec(), object_metrics=False,
                       device="cpu")


# -- the scale oracle -------------------------------------------------------------------

@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("faulted", [False, True], ids=["fault_free",
                                                         "loss10"])
@pytest.mark.parametrize("algo", ["bprr", "classic"])
def test_gmap_blocks_scale_the_gcounter_channels(algo, faulted, engine):
    """``chip_smoke.py``'s oracle at a CPU size: node i bumps a block of m
    keys each round, so every key of its block is GCounter entry i, m
    times over. recv / novel / buf / div_gap and waste_bp / waste_cp /
    covered are m × the GCounter(15) run's; stale_rounds and ack_lag are
    equal (they count rounds, not elements)."""
    _, ttp = topos()
    keys, k_pct = 300, 20
    m = int(tW.gmap_key_blocks(N, keys, k_pct).sum(1)[0])
    assert m == 4
    kw = dict(faults=loss(FaultSchedule, ttp) if faulted else None,
              engine=engine, telemetry=TelemetrySpec(),
              provenance=ProvenanceSpec(), device="cpu")
    gmap = simulate(algo, ttypes.GMap(keys).lattice, ttp,
                    tW.gmap_block_op(N, keys, k_pct), ACTIVE, QUIET, **kw)
    gc = simulate(algo, ttypes.GCounter(N).lattice, ttp, tW.gcounter_op(N),
                  ACTIVE, QUIET, **kw)
    for f in ("recv_elems", "novel_elems", "buf_elems", "div_gap"):
        np.testing.assert_array_equal(getattr(gmap.telemetry, f),
                                      m * getattr(gc.telemetry, f), f)
    for f in ("stale_rounds", "ack_lag"):
        np.testing.assert_array_equal(getattr(gmap.telemetry, f),
                                      getattr(gc.telemetry, f), f)
    for f in CHANNELS:
        np.testing.assert_array_equal(getattr(gmap.provenance, f),
                                      m * getattr(gc.provenance, f), f)
    for f in ("tx", "mem", "cpu", "max_mem_node"):
        np.testing.assert_array_equal(getattr(gmap, f), m * getattr(gc, f))
