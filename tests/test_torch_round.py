"""One synchronous round, JAX against the port.

A random carry (states, δ-buffers, buffer counts) and a random δ from a
seeded numpy generator are carried across by ``repro_torch.convert``; one
``SyncAlgorithm.round_step`` of the JAX reference engine and of each of the
port's three engines must then agree exactly on the new carry and on the
round's tx / mem / cpu / max_mem_node, for the five δ-family algorithms on
the paper's tree and partial mesh, over a bool GSet and a bit-packed
BitGSet (words with bit 31 set).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import types as jtypes
from repro.sync import SyncAlgorithm as JaxAlgorithm
from repro.sync import topology as jtopo

from repro_torch import convert
from repro_torch.core import types as ttypes
from repro_torch.sync import (ALGORITHMS, ENGINES, RESYNC_ALGORITHMS,
                              SyncAlgorithm)

# The states here are small: one intra-op thread per test process keeps
# the suite's parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

TOPOS = {"tree15": lambda: jtopo.tree(15),
         "mesh15d4": lambda: jtopo.partial_mesh(15, 4)}
LATTICES = {"gset": (jtypes.GSet(80), ttypes.GSet(80)),
            "bitgset": (jtypes.BitGSet(32 * 6), ttypes.BitGSet(32 * 6))}


def random_carry(lattice_name, algo, topo, seed):
    rng = np.random.default_rng(seed)
    n, p = topo.num_nodes, topo.max_degree

    def state(*shape):
        if lattice_name == "gset":
            return rng.random(shape + (80,)) < 0.2
        return rng.integers(0, 2**32, size=shape + (6,), dtype=np.uint32) \
            & rng.integers(0, 2**32, size=shape + (6,), dtype=np.uint32)

    x = state(n)
    if algo == "state":
        buf = None
    elif algo in ("bp", "bprr"):
        buf = state(n, p + 1)
    else:
        buf = state(n)
    buf_elems = rng.integers(0, 50, size=n).astype(np.int32)
    return x, buf, buf_elems, state(n)


@functools.lru_cache(maxsize=None)
def jax_round(lattice_name, algo, topo_name):
    topo = TOPOS[topo_name]()
    seed = 1000 * sorted(LATTICES).index(lattice_name) \
        + 10 * ALGORITHMS.index(algo) + sorted(TOPOS).index(topo_name)
    x, buf, buf_elems, delta = random_carry(lattice_name, algo, topo, seed)
    alg = JaxAlgorithm(name=algo, lattice=LATTICES[lattice_name][0].lattice,
                       topo=topo, engine="reference")
    carry = alg.init(jnp.asarray(x))
    carry = carry._replace(
        buf=None if buf is None else jnp.asarray(buf),
        buf_elems=jnp.asarray(buf_elems))
    out, metrics = jax.jit(alg.round_step)(carry, jnp.asarray(delta))
    return (topo, (x, buf, buf_elems, delta),
            jax.device_get((out.x, out.buf, out.buf_elems)),
            jax.device_get(tuple(metrics)))


@pytest.mark.parametrize("lattice_name", sorted(LATTICES))
@pytest.mark.parametrize("topo_name", sorted(TOPOS))
@pytest.mark.parametrize("algo", [a for a in ALGORITHMS
                                  if a not in RESYNC_ALGORITHMS])
@pytest.mark.parametrize("engine", ENGINES)
def test_one_round_matches_jax(lattice_name, topo_name, algo, engine):
    jtp, (x, buf, buf_elems, delta), want_carry, want_metrics = \
        jax_round(lattice_name, algo, topo_name)
    topo = convert.topology_to_torch(jtp.name, jtp.nbrs, jtp.mask, jtp.rev)
    alg = SyncAlgorithm(name=algo, lattice=LATTICES[lattice_name][1].lattice,
                        topo=topo, engine=engine, metric_dtype=torch.int32)
    assert alg.resolved_engine == engine
    carry = convert.carry_to_torch(x, buf, buf_elems)
    out, metrics = alg.round_step(carry, convert.to_torch(delta))
    words = lattice_name == "bitgset"
    got_carry = convert.carry_to_numpy(out, words)[:3]
    for nm, g, w in zip(("x", "buf", "buf_elems"), got_carry, want_carry):
        if w is None:
            assert g is None, nm
        else:
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=nm)
    for nm, g, w in zip(("tx", "mem", "cpu", "max_mem_node"), metrics,
                        want_metrics):
        assert int(g) == int(w), nm
    # the round never wrote into the carry it was given
    x2, buf2, be2, _ = convert.carry_to_numpy(carry, words)
    np.testing.assert_array_equal(x2, x)
    np.testing.assert_array_equal(be2, buf_elems)
    if buf is not None:
        np.testing.assert_array_equal(buf2, buf)


def test_topology_tables_carry_across_both_ways():
    for make in TOPOS.values():
        jtp = make()
        topo = convert.topology_to_torch(jtp.name, jtp.nbrs, jtp.mask, jtp.rev)
        for got, want in zip(convert.topology_to_numpy(topo),
                             (jtp.nbrs, jtp.mask, jtp.rev)):
            np.testing.assert_array_equal(got, np.asarray(want))
        assert (topo.num_nodes, topo.max_degree) == (jtp.num_nodes,
                                                     jtp.max_degree)


@pytest.mark.parametrize("algo", ["bp", "bprr"])
def test_naive_leave_one_out_is_the_same_round(algo):
    """The direct O(P²) fold and the prefix/suffix fold give the same BP
    sends, hence the same round."""
    jtp, (x, buf, buf_elems, delta), _, _ = jax_round("bitgset", algo,
                                                      "mesh15d4")
    topo = convert.topology_to_torch(jtp.name, jtp.nbrs, jtp.mask, jtp.rev)
    outs = []
    for loo in ("prefix", "naive"):
        alg = SyncAlgorithm(name=algo, lattice=LATTICES["bitgset"][1].lattice,
                            topo=topo, loo=loo)
        carry = convert.carry_to_torch(x, buf, buf_elems)
        outs.append(alg.round_step(carry, convert.to_torch(delta)))
    (c1, m1), (c2, m2) = outs
    for a, b in zip(tuple(c1) + tuple(m1), tuple(c2) + tuple(m2)):
        assert (a is None and b is None) or torch.equal(a, b)


def test_carried_buffer_is_slot_major_and_comes_back():
    """A JAX per-origin buffer [N, P+1, U] becomes the port's contiguous
    slot-major [P+1, N, U] and converts back unchanged."""
    _, (x, buf, buf_elems, _), _, _ = jax_round("gset", "bprr", "mesh15d4")
    carry = convert.carry_to_torch(x, buf, buf_elems)
    n, k, u = buf.shape
    assert tuple(carry.buf.shape) == (k, n, u) and carry.buf.is_contiguous()
    for o in range(k):
        np.testing.assert_array_equal(carry.buf[o].numpy(), buf[:, o])
    np.testing.assert_array_equal(convert.carry_to_numpy(carry)[1], buf)


@pytest.mark.parametrize("lattice_name", sorted(LATTICES))
@pytest.mark.parametrize("loo", ["prefix", "naive"])
def test_kernel_sends_are_the_reference_sends(lattice_name, loo):
    """The kernel engines' leave-one-out sends (``buffer_fold`` over the
    slot-major buffer) equal the reference loop's."""
    jtp, (x, buf, buf_elems, _), _, _ = jax_round(lattice_name, "bprr",
                                                  "mesh15d4")
    topo = convert.topology_to_torch(jtp.name, jtp.nbrs, jtp.mask, jtp.rev)
    lat = LATTICES[lattice_name][1].lattice
    carry = convert.carry_to_torch(x, buf, buf_elems)
    ref = SyncAlgorithm(name="bprr", lattice=lat, topo=topo, loo=loo)
    kern = SyncAlgorithm(name="bprr", lattice=lat, topo=topo, engine="fused")
    assert torch.equal(ref._loo_sends(carry.buf), kern._loo_sends(carry.buf))
