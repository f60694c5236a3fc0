"""Object- and config-axis sharding in the port (``simulate_store(shard=,
pad_to=)``, ``simulate_sweep(shard=)``, ``repro_torch.launch.mesh``)
against the JAX package.

* ``pad_to`` ∈ {2, 4, 5} on one device against the JAX package's
  ``pad_to`` (``wide_metrics=False``), per-object and reduced.
* ``shard=True`` on one device against the JAX package's ``shard=True``
  (one device: the unsharded program).
* ``device=["cpu"] * 4`` — four blocks, the port's counterpart of the JAX
  tests' four forced host devices — at B = 7 (padded to 8, as in
  ``tests/test_store.py``'s ``SHARD_SCRIPT``), under faults and weights,
  on every engine: equal to the JAX unsharded run, and with
  ``object_metrics=False`` its [4, T] partials (and [4, T, N] telemetry
  partials) equal to the JAX per-object metrics reduced over each block
  of objects; chunked, checkpointed and resumed alike. (The JAX package's
  own multi-device path does not run under the installed JAX, so its
  unsharded run is the oracle, as the invariant ``SHARD_SCRIPT`` asserts.)
* The Retwis op stream sharded through ``for_block``, a sharded sweep with
  per-cell seeds and faults, the mesh geometry, and the refusals.
Tolerance 0.
"""

import functools

import numpy as np
import pytest
import torch

from repro.core import GSet as JGSet
from repro.core import MapLattice as JMapLattice
from repro.core import value_lattices as jvl
from repro.launch import mesh as jmesh
from repro.obs import TelemetrySpec as JTelemetrySpec
from repro.sync import FaultSchedule as JFaults
from repro.sync import StoreSpec as JStoreSpec
from repro.sync import SweepSpec as JSweepSpec
from repro.sync import simulate_store as jax_simulate_store
from repro.sync import simulate_sweep as jax_simulate_sweep
from repro.sync import topology as jtopo
from repro.sync import workloads as jW
from test_torch_sweep import assert_same_run

from repro_torch.core import GSet, MapLattice
from repro_torch.core import value_lattices as tvl
from repro_torch.launch import mesh as tmesh
from repro_torch.obs import ProvenanceSpec, TelemetrySpec
from repro_torch.sync import (ENGINES, FaultSchedule, StoreSpec, SweepSpec,
                              resume_store, simulate_store, simulate_sweep)
from repro_torch.sync import topology as ttopo
from repro_torch.sync import workloads as tW

torch.set_num_threads(1)

N, T, Q, B = 7, 5, 8, 7          # B = 7 pads to 8 over four blocks
FOUR = ["cpu"] * 4
WEIGHTS = np.arange(1.0, B + 1)


def op_b(x, t):
    """Shard-agnostic op stream: the object extent comes from ``x``."""
    ids = torch.arange(N) * T + min(t, T - 1)
    d = torch.zeros((x.shape[0], N, N * T), dtype=torch.bool)
    d[:, torch.arange(N), ids] = True
    return d


def jax_op_b(x, t):
    import jax.numpy as jnp

    ids = jnp.arange(N) * T + jnp.minimum(t, T - 1)
    d = jnp.zeros((x.shape[0], N, N * T), jnp.bool_)
    return d.at[:, jnp.arange(N), ids].set(True)


def port_spec(op=op_b):
    topo = ttopo.partial_mesh(N, 4)
    return topo, StoreSpec(objects=B, op_fn=op, weights=WEIGHTS,
                           faults=FaultSchedule.bernoulli(topo, T, 0.3,
                                                          seed=5))


@functools.lru_cache(maxsize=None)
def jax_store(algo="bprr", telemetry=False, **kw):
    topo = jtopo.partial_mesh(N, 4)
    spec = JStoreSpec(objects=B, op_fn=jax_op_b, weights=WEIGHTS,
                      faults=JFaults.bernoulli(topo, T, 0.3, seed=5))
    return jax_simulate_store(
        algo, JGSet(N * T).lattice, topo, spec, active_rounds=T,
        quiet_rounds=Q, wide_metrics=False,
        telemetry=JTelemetrySpec() if telemetry else None, **kw)


def assert_store_equal(got, want, ctx):
    for f in ("tx", "mem", "cpu", "max_mem_node", "uniform"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f"{ctx}: {f}")
    np.testing.assert_array_equal(got.final_x.cpu().numpy(),
                                  np.asarray(want.final_x),
                                  err_msg=f"{ctx}: final_x")
    np.testing.assert_array_equal(got.final_state_bytes,
                                  want.final_state_bytes, err_msg=ctx)


def assert_aggregates_equal(got, want, ctx):
    for f in ("store_tx", "store_mem", "store_cpu", "store_max_mem_node",
              "store_uniform"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f"{ctx}: {f}")
    np.testing.assert_array_equal(got.final_x.cpu().numpy(),
                                  np.asarray(want.final_x),
                                  err_msg=f"{ctx}: final_x")


def block_partials(per_object, shards, b_pad):
    """JAX per-object [B, T] metrics reduced over each block of the padded
    object axis: [S, T] sums (maxes for max_mem_node, all for uniform)."""
    per = b_pad // shards
    out = {}
    for f, red in (("tx", np.sum), ("mem", np.sum), ("cpu", np.sum),
                   ("max_mem_node", np.max), ("uniform", np.all)):
        a = np.asarray(getattr(per_object, f))
        out[f] = np.stack([red(a[s * per:min((s + 1) * per, B)], axis=0)
                           for s in range(shards)])
    return out


# -- pad_to and shard=True on one device --------------------------------------

@pytest.mark.parametrize("object_metrics", [True, False],
                         ids=["per_object", "reduced"])
@pytest.mark.parametrize("pad_to", [2, 4, 5])
def test_pad_to_matches_jax(pad_to, object_metrics):
    want = jax_store(pad_to=pad_to, object_metrics=object_metrics)
    plain = jax_store()
    topo, spec = port_spec()
    got = simulate_store("bprr", GSet(N * T).lattice, topo, spec, T, Q,
                         pad_to=pad_to, object_metrics=object_metrics,
                         device="cpu")
    assert got.objects == B and got.final_x.shape[0] == B
    if object_metrics:
        assert_store_equal(got, want, f"pad_to={pad_to}")
        assert_store_equal(got, plain, f"pad_to={pad_to} vs unpadded")
    else:
        assert got.sim.tx.shape == want.sim.tx.shape == (1, T + Q)
        for f in ("tx", "mem", "cpu", "max_mem_node", "uniform"):
            np.testing.assert_array_equal(getattr(got.sim, f),
                                          getattr(want.sim, f), err_msg=f)
        assert_aggregates_equal(got, plain, f"pad_to={pad_to} reduced")


@pytest.mark.parametrize("engine", ENGINES)
def test_shard_on_one_device_is_the_unsharded_run(engine):
    want = jax_store(shard=True)
    topo, spec = port_spec()
    lat = GSet(N * T).lattice
    got = simulate_store("bprr", lat, topo, spec, T, Q, shard=True,
                         engine=engine, device="cpu")
    assert_store_equal(got, want, f"{engine} shard=True, one device")
    red = simulate_store("bprr", lat, topo, spec, T, Q, shard=True,
                         engine=engine, object_metrics=False,
                         device=["cpu"])
    assert red.sim.tx.shape == (1, T + Q)
    assert_aggregates_equal(red, want, f"{engine} one block, reduced")


# -- four blocks --------------------------------------------------------------

@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("algo", ["bprr", "classic", "digest_driven"])
def test_four_blocks_equal_the_jax_unsharded_run(algo, engine):
    want = jax_store(algo)
    topo, spec = port_spec()
    lat = GSet(N * T).lattice
    got = simulate_store(algo, lat, topo, spec, T, Q, shard=True,
                         engine=engine, device=FOUR)
    assert_store_equal(got, want, f"{algo}/{engine} four blocks")
    red = simulate_store(algo, lat, topo, spec, T, Q, shard=True,
                         engine=engine, object_metrics=False, device=FOUR)
    assert red.sim.tx.shape == (4, T + Q)          # per-shard partials
    for f, a in block_partials(want, 4, 8).items():
        np.testing.assert_array_equal(getattr(red.sim, f), a, err_msg=f)
    assert_aggregates_equal(red, want, f"{algo}/{engine} reduced")
    assert red.store_convergence_round() == want.store_convergence_round()


def test_four_blocks_telemetry_partials():
    want = jax_store(telemetry=True)
    topo, spec = port_spec()
    got = simulate_store("bprr", GSet(N * T).lattice, topo, spec, T, Q,
                         shard=True, object_metrics=False,
                         telemetry=TelemetrySpec(), device=FOUR)
    per = 2
    for f, red in (("recv_elems", np.sum), ("novel_elems", np.sum),
                   ("stale_rounds", np.max), ("ack_lag", np.max),
                   ("buf_elems", np.sum), ("div_gap", np.max)):
        a = np.asarray(getattr(want.telemetry, f), np.int64)   # [B, T, N]
        blocks = np.stack([red(a[s * per:min((s + 1) * per, B)], axis=0)
                           for s in range(4)])
        np.testing.assert_array_equal(getattr(got.telemetry, f), blocks,
                                      err_msg=f)


def test_four_blocks_observability_equals_one_block():
    """Per-object telemetry and provenance over four blocks equal the
    unsharded run's, field by field: the blocks' results concatenate in
    object order (matrices gathered on the first block's device)."""
    topo, spec = port_spec()
    lat = GSet(N * T).lattice
    obs = dict(telemetry=TelemetrySpec(), provenance=ProvenanceSpec())
    want = simulate_store("bprr", lat, topo, spec, T, Q, device="cpu", **obs)
    got = simulate_store("bprr", lat, topo, spec, T, Q, shard=True,
                         device=FOUR, **obs)
    for res in ("telemetry", "provenance"):
        w, g = getattr(want, res), getattr(got, res)
        assert g._fields == w._fields
        for f in w._fields:
            if f == "spec":
                assert g.spec == w.spec
                continue
            a, b = getattr(g, f), getattr(w, f)
            np.testing.assert_array_equal(
                a.cpu().numpy() if isinstance(a, torch.Tensor) else a,
                b.cpu().numpy() if isinstance(b, torch.Tensor) else b,
                err_msg=f"{res}.{f}")


def test_four_blocks_chunked_checkpointed_and_resumed(tmp_path):
    want = jax_store()
    topo, spec = port_spec()
    lat = GSet(N * T).lattice
    chunked = simulate_store("bprr", lat, topo, spec, T, Q, shard=True,
                             chunk_rounds=4, device=FOUR)
    assert_store_equal(chunked, want, "chunked")
    c = simulate_store("bprr", lat, topo, spec, T, Q, shard=True,
                       chunk_rounds=4, object_metrics=False,
                       checkpoint=tmp_path, device=FOUR)
    assert c.sim.tx.shape[0] == 4
    for f, a in block_partials(want, 4, 8).items():
        np.testing.assert_array_equal(getattr(c.sim, f), a, err_msg=f)
    for step in (4, 8, 12):
        r = resume_store("bprr", lat, topo, spec, T, Q, shard=True,
                         object_metrics=False, checkpoint=tmp_path,
                         step=step, device=FOUR)
        for f in ("tx", "mem", "cpu", "max_mem_node", "uniform"):
            np.testing.assert_array_equal(getattr(r.sim, f),
                                          getattr(c.sim, f), err_msg=f)
        assert torch.equal(r.final_x, c.final_x)
    # the bundle records the shard count: another geometry is refused
    with pytest.raises(ValueError, match="shards"):
        resume_store("bprr", lat, topo, spec, T, Q, shard=True,
                     object_metrics=False, checkpoint=tmp_path, step=4,
                     device=["cpu"] * 2)
    per_obj = tmp_path / "per_object"
    simulate_store("bprr", lat, topo, spec, T, Q, shard=True,
                   chunk_rounds=5, checkpoint=per_obj, device=FOUR)
    r = resume_store("bprr", lat, topo, spec, T, Q, shard=True,
                     checkpoint=per_obj, step=5, device=FOUR)
    assert_store_equal(r, want, "resumed per-object")


def test_retwis_store_sharded_through_for_block():
    """The Retwis op stream closes over its [T, N, B] count table; sharded,
    each block runs its own columns (the pad none)."""
    nodes, objects, slots, rounds = 8, 12, 8, 10
    counts = tW.retwis(objects, nodes, rounds, 3, 1.0, seed=0) \
        .update_counts()
    np.testing.assert_array_equal(
        counts, jW.retwis(objects, nodes, rounds, 3, 1.0, seed=0)
        .update_counts())
    jlat = JMapLattice(slots, jvl.max_int(), "retwis").build()
    want = jax_simulate_store(
        "bprr", jlat, jtopo.partial_mesh(nodes, 4),
        JStoreSpec(objects=objects, op_fn=jW.versioned_slot_op(counts, slots),
                   weights=jW.retwis_weights(objects)),
        active_rounds=rounds, quiet_rounds=4, wide_metrics=False)
    lat = MapLattice(slots, tvl.max_int(), "retwis").build()
    spec = StoreSpec(objects=objects,
                     op_fn=tW.versioned_slot_op(counts, slots),
                     weights=tW.retwis_weights(objects))
    topo = ttopo.partial_mesh(nodes, 4)
    for devs in (["cpu"] * 5, ["cpu"] * 3):
        got = simulate_store("bprr", lat, topo, spec, rounds, 4, shard=True,
                             device=devs)
        assert_store_equal(got, want, f"retwis over {len(devs)} blocks")


# -- sweeps -------------------------------------------------------------------

SWEEP_SEEDS = (0, 3, 11, 5)


@pytest.mark.parametrize("blocks", [2, 4])
@pytest.mark.parametrize("engine", ENGINES)
def test_sharded_sweep_matches_the_jax_sweep(engine, blocks):
    jtp, ttp = jtopo.partial_mesh(N, 4), ttopo.partial_mesh(N, 4)

    def faults(F, topo):
        return [None, F.bernoulli(topo, T, 0.3, seed=1), None,
                F.churn(topo, T, [(2, 1, 4)])]

    want = jax_simulate_sweep(
        "bprr", JGSet(N * T).lattice, jtp,
        JSweepSpec(batch=4, op_fn=jW.gset_unique_sweep_op(N, T, SWEEP_SEEDS),
                   faults=faults(JFaults, jtp)),
        active_rounds=T, quiet_rounds=Q, wide_metrics=False)
    got = simulate_sweep(
        "bprr", GSet(N * T).lattice, ttp,
        SweepSpec(batch=4, op_fn=tW.gset_unique_sweep_op(N, T, SWEEP_SEEDS),
                  faults=faults(FaultSchedule, ttp)),
        T, Q, engine=engine, shard=True, device=["cpu"] * blocks)
    assert_same_run(got, want, f"sweep over {blocks} blocks")


# -- the mesh and the refusals ------------------------------------------------

def test_mesh_geometry():
    assert tmesh.store_mesh(device=FOUR).shape == {"object": 4}
    assert tmesh.store_mesh(3, device=FOUR).shape == {"object": 3}
    assert tmesh.store_mesh(device="cpu").shape == {"object": 1}
    assert tmesh.sweep_mesh(device=FOUR).shape == {"config": 4}
    assert tmesh.sweep_mesh(2, device=FOUR).shape == {"config": 2}
    assert tmesh.axis_shards(tmesh.sweep_mesh(device=FOUR),
                             tmesh.STORE_AXIS) == 1
    assert (tmesh.SWEEP_AXIS, tmesh.STORE_AXIS) == \
        (jmesh.SWEEP_AXIS, jmesh.STORE_AXIS)
    for b in range(1, 12):
        for s in (1, 2, 3, 4, 5):
            assert tmesh.padded_size(b, s) == jmesh.padded_size(b, s)
    blocks = tmesh.shard_store_scan(8, tmesh.store_mesh(device=FOUR))
    assert [(b.lo, b.hi) for b in blocks] == [(0, 2), (2, 4), (4, 6), (6, 8)]
    assert all(b.device == torch.device("cpu") for b in blocks)
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.shard_store_scan(7, tmesh.store_mesh(device=FOUR))
    one = tmesh.batch_mesh(tmesh.STORE_AXIS, False, "cpu")
    assert one.shape == {"object": 1} and one.devices == [torch.device("cpu")]
    assert tmesh.batch_mesh(tmesh.SWEEP_AXIS, True, FOUR).shape == \
        {"config": 4}
    with pytest.raises(ValueError, match="shard=True"):
        tmesh.batch_mesh(tmesh.STORE_AXIS, False, FOUR)
    with pytest.raises(ValueError, match="num_devices"):
        tmesh.sweep_mesh(5, device=FOUR)


def test_refusals():
    topo, spec = port_spec()
    lat = GSet(N * T).lattice
    with pytest.raises(ValueError, match="cannot split"):   # 7 → 9, 4 ∤ 9
        simulate_store("bprr", lat, topo, spec, T, Q, shard=True, pad_to=3,
                       device=FOUR)
    table = torch.zeros((B, N, N * T), dtype=torch.bool)
    _, closed = port_spec(lambda x, t: x | table)
    with pytest.raises(ValueError, match="sharded object axis"):
        simulate_store("bprr", lat, topo, closed, T, Q, shard=True,
                       device=FOUR)
    # one block: the op stream sees the unpadded objects, so it may close
    # over [B] tables
    simulate_store("bprr", lat, topo, closed, T, Q, pad_to=4, device="cpu")
