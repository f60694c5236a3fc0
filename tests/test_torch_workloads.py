"""The workload streams, JAX against the port: the keyed-store tables
(``WorkloadSpec`` over the three target distributions and a range of seeds,
``retwis``, ``retwis_weights``) equal the JAX package's array for array,
and the op streams built from them (``versioned_slot_op`` and its per-object
``versioned_slot_cell_op``, the sweep streams ``gset_unique_sweep_op`` and
``gcounter_sweep_op``, ``seed_perm``) give the same deltas on the same
states."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.sync import workloads as jW

from repro_torch.sync import workloads as tW

torch.set_num_threads(1)


def spec_pair(**kw):
    return jW.WorkloadSpec(**kw), tW.WorkloadSpec(**kw)


@pytest.mark.parametrize("dist", tW.DISTS)
@pytest.mark.parametrize("seed", [0, 1, 7, 123, 65535])
def test_tables_equal_jax(dist, seed):
    kw = dict(objects=37, nodes=5, rounds=6, ops_per_node=4, dist=dist,
              zipf=1.3, hot_frac=0.2, hot_mass=0.8, seed=seed)
    j, t = spec_pair(**kw)
    np.testing.assert_array_equal(t.object_probs(), j.object_probs())
    np.testing.assert_array_equal(t.kind_probs(), j.kind_probs())
    for a, b in zip(t.streams(), j.streams()):
        np.testing.assert_array_equal(a, b)
    got, want = t.update_counts(), j.update_counts()
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("zipf", [0.5, 0.75, 1.0, 1.25, 1.5])
def test_retwis_tables_and_weights_equal_jax(zipf):
    j = jW.retwis(96, 16, 40, 6, zipf, seed=0)
    t = tW.retwis(96, 16, 40, 6, zipf, seed=0)
    assert t == tW.WorkloadSpec(**{f: getattr(j, f) for f in (
        "objects", "nodes", "rounds", "ops_per_node", "dist", "zipf",
        "seed")})
    np.testing.assert_array_equal(t.update_counts(), j.update_counts())
    np.testing.assert_array_equal(tW.retwis_weights(97),
                                  jW.retwis_weights(97))
    assert (tW.ID_B, tW.CONTENT_B, tW.USER_B, tW.FOLLOW_B, tW.WALL_B,
            tW.TL_B) == (jW.ID_B, jW.CONTENT_B, jW.USER_B, jW.FOLLOW_B,
                         jW.WALL_B, jW.TL_B)
    assert [(k.name, k.prob, k.updates) for k in tW.RETWIS_MIX] == \
        [(k.name, k.prob, k.updates) for k in jW.RETWIS_MIX]


def test_a_custom_mix_renormalises_like_jax():
    mix_t = (tW.OpKind("a", 2.0, 1), tW.OpKind("b", 1.0, 3))
    mix_j = (jW.OpKind("a", 2.0, 1), jW.OpKind("b", 1.0, 3))
    t = tW.WorkloadSpec(objects=9, nodes=3, rounds=4, ops_per_node=2,
                        dist="uniform", mix=mix_t, seed=5)
    j = jW.WorkloadSpec(objects=9, nodes=3, rounds=4, ops_per_node=2,
                        dist="uniform", mix=mix_j, seed=5)
    np.testing.assert_array_equal(t.kind_probs(), j.kind_probs())
    np.testing.assert_array_equal(t.update_counts(), j.update_counts())


def test_workload_spec_validation():
    for kw in (dict(objects=0, nodes=1, rounds=1),
               dict(objects=1, nodes=1, rounds=1, dist="pareto"),
               dict(objects=1, nodes=1, rounds=1, dist="hotset",
                    hot_frac=0.0),
               dict(objects=1, nodes=1, rounds=1,
                    mix=(tW.OpKind("bad", -0.5),)),
               dict(objects=1, nodes=1, rounds=1,
                    mix=(tW.OpKind("zero", 0.0),))):
        with pytest.raises(ValueError):
            tW.WorkloadSpec(**kw)


@pytest.mark.parametrize("slots", [8, 32])
def test_versioned_slot_ops_equal_jax(slots):
    spec = tW.retwis(objects=5, nodes=4, rounds=6, ops_per_node=3, zipf=1.0)
    counts = spec.update_counts()
    rng = np.random.default_rng(slots)
    x = rng.integers(0, 40, size=(5, 4, slots)).astype(np.int32)
    jop = jW.versioned_slot_op(counts, slots)
    top = tW.versioned_slot_op(counts, slots)
    for t in range(spec.rounds):
        want = np.asarray(jop(jnp.asarray(x), jnp.asarray(t)))
        got = top(torch.from_numpy(x), t)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        for b in range(5):
            cell = tW.versioned_slot_cell_op(counts, b, slots)(
                torch.from_numpy(x[b]), t)
            np.testing.assert_array_equal(cell.numpy(), want[b])
            jcell = jW.versioned_slot_cell_op(counts, b, slots)(
                jnp.asarray(x[b]), jnp.asarray(t))
            np.testing.assert_array_equal(cell.numpy(), np.asarray(jcell))
    with pytest.raises(ValueError):
        top(torch.zeros((4, 4, slots), dtype=torch.int32), 0)


@pytest.mark.parametrize("seeds", [(0,), (0, 3, 11), (5, 5)])
def test_sweep_streams_equal_jax(seeds):
    n, events, b = 4, 6, 3 if len(seeds) != 2 else 2
    for s in seeds:
        np.testing.assert_array_equal(tW.seed_perm(events, s),
                                      jW.seed_perm(events, s))
    jop = jW.gset_unique_sweep_op(n, events, seeds)
    top = tW.gset_unique_sweep_op(n, events, seeds)
    x = np.zeros((b if len(seeds) == 1 else len(seeds), n, n * events), bool)
    for t in range(events + 2):
        want = np.asarray(jop(jnp.asarray(x), jnp.asarray(t)))
        np.testing.assert_array_equal(top(torch.from_numpy(x), t).numpy(),
                                      want)
        for i, s in enumerate(seeds):
            single = tW.gset_unique_op(n, events, s)(
                torch.from_numpy(x[i]), t)
            np.testing.assert_array_equal(single.numpy(), want[i])
    if len(seeds) > 1:               # one seed broadcasts to any batch
        with pytest.raises(ValueError):
            top(torch.zeros((len(seeds) + 1, n, n * events),
                            dtype=torch.bool), 0)
    g = np.arange(2 * n * n, dtype=np.int32).reshape(2, n, n)
    np.testing.assert_array_equal(
        tW.gcounter_sweep_op(n)(torch.from_numpy(g), 0).numpy(),
        np.asarray(jW.gcounter_sweep_op(n)(jnp.asarray(g), jnp.asarray(0))))
