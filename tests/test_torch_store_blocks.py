"""The sharded store checks its op stream block by block
(``simulate_store(shard=True)``): no device holds a whole-store state or op
table, and the results stay bit-identical to the unsharded run.

* A sharded run over ``versioned_slot_op`` never calls the whole-store op
  and never makes its [T, B, N] table; every call has a block's rows.
* Sharded over ``["cpu"] * 4`` it equals the unsharded run bit for bit, per
  object and in its per-block partials, at 96 objects and at 99 (padded to
  100).
* A mis-shaped op or one that closes over whole-store tables is refused
  before any round, with the messages of the unsharded check.
* One block still checks the whole-store op on the whole store, and makes
  its table once.
* The ``store.check`` / ``store.collect`` / ``store.gather`` labels show
  under ``torch.profiler``, and ``trace=`` records a ``store_blocks``
  counter for a sharded run alone.
* On four cards (``cuda`` marker; skips with fewer): the sharded store
  equals its CPU run, and the cards' peaks differ by no more than the final
  states gathered on the first.
Tolerance 0.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import MapLattice
from repro_torch.core import value_lattices as tvl
from repro_torch.obs import TraceLog
from repro_torch.sync import StoreSpec, simulate_store
from repro_torch.sync import algorithms
from repro_torch.sync import topology as ttopo
from repro_torch.sync import workloads as tW

torch.set_num_threads(1)

NODES, SLOTS, ACTIVE, QUIET = 8, 16, 6, 4
FOUR = ["cpu"] * 4


class Recorder:
    """A ``versioned_slot_op`` that records the object rows of every call,
    its own and its blocks'."""

    def __init__(self, op, calls):
        self.op, self.calls = op, calls

    def __call__(self, x, t):
        self.calls.append(x.shape[0])
        return self.op(x, t)

    def for_block(self, lo, hi):
        return Recorder(self.op.for_block(lo, hi), self.calls)


def store(objects, seed=3):
    counts = tW.retwis(objects, NODES, ACTIVE, 6, 1.0, seed=seed) \
        .update_counts()
    lat = MapLattice(SLOTS, tvl.max_int(), "retwis").build()
    return counts, lat, ttopo.partial_mesh(NODES, 4)


def spec_of(objects, op):
    return StoreSpec(objects=objects, op_fn=op,
                     weights=tW.retwis_weights(objects))


def run(lat, topo, spec, **kw):
    return simulate_store("bprr", lat, topo, spec, ACTIVE, QUIET,
                          engine="mega", **kw)


@pytest.fixture
def tables(monkeypatch):
    """The (lo, hi) object extents of every count table made."""
    made = []
    orig = tW._count_table

    def record(counts, lo, hi):
        made.append((lo, hi))
        return orig(counts, lo, hi)

    monkeypatch.setattr(tW, "_count_table", record)
    return made


def test_a_sharded_run_never_calls_or_builds_the_whole_store_op(tables):
    counts, lat, topo = store(96)
    calls = []
    spec = spec_of(96, Recorder(tW.versioned_slot_op(counts, SLOTS), calls))
    run(lat, topo, spec, shard=True, object_metrics=False, device=FOUR)
    assert calls and set(calls) == {24}
    assert len(calls) == 4 * (ACTIVE + 1)       # the check and each round
    assert sorted(tables) == [(0, 24), (24, 48), (48, 72), (72, 96)]


def test_one_block_checks_and_builds_the_whole_store_op_once(tables):
    counts, lat, topo = store(96)
    calls = []
    spec = spec_of(96, Recorder(tW.versioned_slot_op(counts, SLOTS), calls))
    run(lat, topo, spec, device="cpu")
    assert calls == [96] * (ACTIVE + 1)
    assert tables == [(0, 96)]
    run(lat, topo, spec, shard=True, device=["cpu"])
    assert calls == [96] * 2 * (ACTIVE + 1) and tables == [(0, 96)]


def block_sums(per_object, blocks, objects):
    """[B, T] per-object metrics as the [S, T] partials of ``blocks``
    equal blocks of the padded objects (the pad counts nothing)."""
    per = -(-objects // blocks)
    pad = np.concatenate([per_object, np.zeros(
        (per * blocks - objects,) + per_object.shape[1:], per_object.dtype)])
    return pad.reshape((blocks, per) + per_object.shape[1:]).sum(1)


@pytest.mark.parametrize("objects", [96, 99])
def test_sharded_equals_unsharded_bit_for_bit(objects):
    counts, lat, topo = store(objects, seed=objects)
    op = tW.versioned_slot_op(counts, SLOTS)
    want = run(lat, topo, spec_of(objects, op), device="cpu")
    got = run(lat, topo, spec_of(objects, op), shard=True, device=FOUR)
    for f in ("tx", "mem", "cpu", "max_mem_node"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), f)
    assert torch.equal(got.final_x, want.final_x)
    np.testing.assert_array_equal(got.final_state_bytes,
                                  want.final_state_bytes)
    parts = run(lat, topo, spec_of(objects, op), shard=True,
                object_metrics=False, device=FOUR)
    assert parts.sim.tx.shape == (4, ACTIVE + QUIET)
    for f in ("tx", "mem", "cpu"):
        np.testing.assert_array_equal(getattr(parts.sim, f), block_sums(
            getattr(want, f), 4, objects), f)
    per = -(-objects // 4)
    mmax = np.concatenate([want.max_mem_node, np.zeros(
        (4 * per - objects, ACTIVE + QUIET), want.max_mem_node.dtype)])
    np.testing.assert_array_equal(parts.sim.max_mem_node,
                                  mmax.reshape(4, per, -1).max(1))
    assert torch.equal(parts.final_x, want.final_x)
    np.testing.assert_array_equal(parts.final_state_bytes,
                                  want.final_state_bytes)


def test_a_sharded_x0_is_cut_block_by_block():
    counts, lat, topo = store(99, seed=5)
    op = tW.versioned_slot_op(counts, SLOTS)
    x0 = np.random.default_rng(0).integers(
        0, 3, (99, NODES, SLOTS)).astype(np.int32)
    spec = StoreSpec(objects=99, op_fn=op, x0=x0)
    want = run(lat, topo, spec, device="cpu")
    got = run(lat, topo, spec, shard=True, device=FOUR)
    np.testing.assert_array_equal(got.tx, want.tx)
    assert torch.equal(got.final_x, want.final_x)


def test_a_mis_shaped_op_is_refused_before_any_round(monkeypatch):
    def never(*a, **k):
        raise AssertionError("a round ran before the refusal")

    monkeypatch.setattr(algorithms.SyncAlgorithm, "round_step", never)
    counts, lat, topo = store(96)
    for devs in ("cpu", FOUR):
        with pytest.raises(ValueError, match="returned a delta leaf of "
                                             "shape"):
            run(lat, topo, spec_of(96, lambda x, t: x[:, :1]),
                shard=True, device=devs)
        with pytest.raises(ValueError, match="one delta leaf per state "
                                             "leaf"):
            run(lat, topo, spec_of(96, lambda x, t: (x, x)), shard=True,
                device=devs)
    whole = torch.zeros((96, NODES, SLOTS), dtype=torch.int32)
    with pytest.raises(ValueError, match="sharded object axis"):
        run(lat, topo, spec_of(96, lambda x, t: x + whole), shard=True,
            device=FOUR)
    with pytest.raises(ValueError, match="sharded object axis"):
        run(lat, topo, spec_of(96, lambda x, t: whole), shard=True,
            device=FOUR)
    with pytest.raises(ValueError, match="failed on the stacked state"):
        run(lat, topo, spec_of(96, lambda x, t: x + whole[:1, :1, :3]),
            device="cpu")


def labels(fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return {e.key for e in prof.key_averages()}


@pytest.mark.parametrize("devs", [FOUR, "cpu"])
def test_the_phases_are_labelled_and_the_blocks_counted(devs):
    counts, lat, topo = store(96)
    spec = spec_of(96, tW.versioned_slot_op(counts, SLOTS))
    seen = labels(lambda: run(lat, topo, spec, shard=True,
                              object_metrics=False, device=devs))
    assert {"store.check", "store.collect", "store.gather"} <= seen
    log = TraceLog()
    run(lat, topo, spec, shard=True, object_metrics=False, trace=log,
        device=devs)
    blocks = [e for e in log.events if e["name"] == "store_blocks"]
    if devs == "cpu":
        assert not blocks
    else:
        assert [e["args"] for e in blocks] == [
            {"blocks": 4.0, "objects_per_block": 24.0,
             "gathered_bytes": 0.0}]


@pytest.mark.cuda
def test_four_cards_equal_the_cpu_and_hold_even_shares():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4 or \
            torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs four sm_90 CUDA cards")
    objects = 4 * 6_000
    counts, lat, topo = store(objects, seed=11)
    op = tW.versioned_slot_op(counts, SLOTS)
    want = run(lat, topo, spec_of(objects, op), shard=True,
               object_metrics=False, device=FOUR)
    cards = [f"cuda:{i}" for i in range(4)]
    for c in cards:
        torch.cuda.reset_peak_memory_stats(c)
    log = TraceLog()
    got = run(lat, topo, spec_of(objects, op), shard=True,
              object_metrics=False, trace=log, device=cards)
    for f in ("tx", "mem", "cpu", "max_mem_node"):
        np.testing.assert_array_equal(getattr(got.sim, f),
                                      getattr(want.sim, f), f)
    assert got.final_x.device == torch.device("cuda:0")
    assert torch.equal(got.final_x.cpu(), want.final_x)
    np.testing.assert_array_equal(got.final_state_bytes,
                                  want.final_state_bytes)
    share = got.final_x.numel() * got.final_x.element_size()
    gathered = [e["args"]["gathered_bytes"] for e in log.events
                if e["name"] == "store_blocks"]
    assert gathered == [3 * share // 4]
    peaks = [torch.cuda.max_memory_allocated(c) for c in cards]
    assert max(peaks) - min(peaks) <= share, peaks
