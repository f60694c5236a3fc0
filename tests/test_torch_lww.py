"""LWWMap (lex-pair states, a tuple per state) through the port's sync
path, against the JAX package.

* One round: a random LWWMap carry — ``(t, v)`` states, the buffer of each
  algorithm as a tuple, ``digest_driven``'s remote digests of lex-pair
  states — goes through one ``round_step`` of the JAX reference engine and
  of the port under each engine name (all resolve to ``reference``), with
  and without fault masks; the new carry and the round's metrics agree
  exactly.
* Whole runs: the five δ-family algorithms on the tree and the partial
  mesh, all seven under loss composed with churn, and both resync modes
  from a divergent start, through JAX ``simulate(..., wide_metrics=False)``
  and the port under the three engine names: per-round tx / mem / cpu /
  max_mem_node, ``uniform`` and the final states agree exactly. The op
  writes contended keys, so equal timestamps meet and the larger value
  must win, negative values included.
* A PNCounter (a product) and a linear sum (a rank-0 tag leaf beside its
  sides) run through ``simulate`` like the JAX package's.
* Multi-leaf digests equal the JAX package's words; ``convert`` carries
  tuple states and slot-major tuple buffers across and back.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import LWWMap as JLWWMap
from repro.core import PNCounter as JPNCounter
from repro.core import lattice as jlat
from repro.core import value_lattices as jvl
from repro.sync import DigestSpec as JaxSpec
from repro.sync import FaultSchedule as JaxSchedule
from repro.sync import SyncAlgorithm as JaxAlgorithm
from repro.sync import digest as jd
from repro.sync import simulate as jax_simulate
from repro.sync import topology as jtopo
from repro.sync.faults import RoundFaults as JaxRoundFaults

from repro_torch import convert, kernels
from repro_torch.core import LWWMap, MapLattice, PNCounter, linear_sum
from repro_torch.core import value_lattices as vl
from repro_torch.sync import (ALGORITHMS, ENGINES, RESYNC_ALGORITHMS,
                              DigestSpec, FaultSchedule, SyncAlgorithm,
                              simulate)
from repro_torch.sync import digest as D
from repro_torch.sync import topology as ttopo
from repro_torch.sync.faults import RoundFaults

# The states here are small: one intra-op thread per test process keeps
# the suite's parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

DELTA_ALGORITHMS = [a for a in ALGORITHMS if a not in RESYNC_ALGORITHMS]
N, U, ACTIVE, QUIET, BE = 15, 120, 6, 6, 8
GROUPS = (np.arange(N) >= N // 2).astype(np.int32)


def topos(name):
    return (jtopo.by_name(name, N, 4), ttopo.by_name(name, N, 4))


# -- the op: contended writes ----------------------------------------------------
#
# Node n writes keys (n + 3t) mod U and (7n + t) mod U at its own current
# timestamp + 1 with value (5n + t) mod 7 - 3, so nodes that meet on a key
# write equal timestamps with different values (negative ones included).

def keys_vals(t):
    n = np.arange(N)
    k = np.stack([(n + 3 * t) % U, (7 * n + t) % U], 1)       # [N, 2]
    return n, k, ((5 * n + t) % 7 - 3).astype(np.int32)


def jax_op(x, t):
    ts, vals = x
    n = jnp.arange(N)
    rows = jnp.stack([n, n], 1)
    k = jnp.stack([(n + 3 * t) % U, (7 * n + t) % U], 1)
    val = ((5 * n + t) % 7 - 3).astype(jnp.int32)
    dt = jnp.zeros_like(ts).at[rows, k].set(ts[rows, k] + 1)
    dv = jnp.zeros_like(vals).at[rows, k].set(
        jnp.broadcast_to(val[:, None], (N, 2)))
    return (dt, dv)


def torch_op(x, t):
    ts, vals = x
    n, k, val = keys_vals(t)
    rows = torch.from_numpy(np.stack([n, n], 1)).to(ts.device)
    k = torch.from_numpy(k).to(ts.device)
    dt, dv = torch.zeros_like(ts), torch.zeros_like(vals)
    dt[rows, k] = ts[rows, k] + 1
    dv[rows, k] = torch.from_numpy(val).to(vals.device)[:, None].expand(N, 2)
    return (dt, dv)


def joiner_x0(rng_seed=5):
    """Every node but node 0 holds the first third of the keys at (1, 4);
    a few keys differ between donors."""
    rng = np.random.default_rng(rng_seed)
    ts = np.zeros((N, U), np.int32)
    ts[1:, : U // 3] = 1
    va = np.where(ts > 0, 4, 0).astype(np.int32)
    bump = (rng.random((N, U)) < 0.05) & (ts > 0)
    ts[bump] = 2
    va[bump] = rng.integers(-3, 6, size=int(bump.sum()))
    return ts, va


def schedules(F, topo, rounds):
    return F.bernoulli(topo, rounds, 0.2, seed=3).compose(
        F.churn(topo, rounds, [(1, 1, 5), (N - 2, 2, 7)]))


# -- one round ---------------------------------------------------------------------

def rand_lww(rng, *lead):
    ts = (rng.integers(0, 4, size=lead + (U,))
          * (rng.random(lead + (U,)) < 0.5)).astype(np.int32)
    va = np.where(ts > 0, rng.integers(-3, 5, size=lead + (U,)), 0)
    return ts, va.astype(np.int32)


@functools.lru_cache(maxsize=None)
def jax_round(algo, faulted):
    jtp, _ = topos("mesh")
    rng = np.random.default_rng(11 + 2 * ALGORITHMS.index(algo) + faulted)
    n, p = N, jtp.max_degree
    x, delta = rand_lww(rng, n), rand_lww(rng, n)
    spec = JaxSpec(BE)
    lat = JLWWMap(U).lattice
    buf = aux = None
    if algo == "state_driven":
        buf = rand_lww(rng, n, p)
    elif algo in ("bp", "bprr"):
        buf = rand_lww(rng, n, p + 1)
    elif algo in ("classic", "rr"):
        buf = rand_lww(rng, n)
    elif algo == "digest_driven":
        remote = tuple(np.array(a[:, None].repeat(p, 1)) for a in x)
        remote[0][rng.random((n, p, U)) < 0.05] += 1     # a few stale blocks
        aux = (np.asarray(jd.digest_state(tuple(map(jnp.asarray, remote)),
                                          spec)),
               rng.random((n, p)) < 0.7)
    buf_elems = rng.integers(0, 50, size=n).astype(np.int32)
    rf = views = None
    if faulted:
        link = rng.random((1, n, p)) > 0.3
        up = np.ones((1, n), bool)
        up[0, 4] = False
        v = JaxSchedule(jtp, link, up).views(1)
        rf = JaxRoundFaults(v.recv_ok[0], v.send_ok[0], v.up[0])
        views = tuple(np.asarray(a[0]) for a in v)
    alg = JaxAlgorithm(name=algo, lattice=lat, topo=jtp, digest=spec)
    carry = alg.init(tuple(map(jnp.asarray, x)))._replace(
        buf=None if buf is None else tuple(map(jnp.asarray, buf)),
        buf_elems=jnp.asarray(buf_elems),
        aux=None if aux is None else tuple(map(jnp.asarray, aux)))
    out, metrics = jax.jit(alg.round_step)(
        carry, tuple(map(jnp.asarray, delta)), rf)
    return ((x, buf, buf_elems, aux, delta, views),
            jax.device_get((out.x, out.buf, out.buf_elems, out.aux)),
            jax.device_get(tuple(metrics)))


def assert_tree_equal(got, want, what):
    if want is None:
        assert got is None, what
        return
    if isinstance(want, (tuple, list)):
        assert isinstance(got, tuple) and len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            assert_tree_equal(g, w, f"{what}[{i}]")
        return
    np.testing.assert_array_equal(got, np.asarray(want), err_msg=what)


@pytest.mark.parametrize("faulted", [False, True])
@pytest.mark.parametrize("algo", ALGORITHMS)
@pytest.mark.parametrize("engine", ENGINES)
def test_one_lww_round_matches_jax(algo, engine, faulted):
    (x, buf, buf_elems, aux, delta, views), want_carry, want_metrics = \
        jax_round(algo, faulted)
    _, ttp = topos("mesh")
    alg = SyncAlgorithm(name=algo, lattice=LWWMap(U).lattice, topo=ttp,
                        engine=engine, metric_dtype=torch.int32,
                        digest=DigestSpec(BE))
    assert alg.resolved_engine == "reference"
    carry = convert.carry_to_torch(x, buf, buf_elems, aux)
    rf = None if views is None else RoundFaults(*map(convert.to_torch,
                                                     views))
    out, metrics = alg.round_step(carry, convert.to_torch(delta), rf)
    got = convert.carry_to_numpy(out, words=False)
    for nm, g, w in zip(("x", "buf", "buf_elems"), got, want_carry):
        assert_tree_equal(g, w, nm)
    if want_carry[3] is None:
        assert got[3] is None
    else:
        for nm, g, w in zip(("digests", "have"), got[3], want_carry[3]):
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=nm)
    for nm, g, w in zip(("tx", "mem", "cpu", "max_mem_node"), metrics,
                        want_metrics):
        assert int(g) == int(w), nm


# -- whole runs ----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def jax_run(algo, topo_name, faulted=False, joiner=False):
    jtp, _ = topos(topo_name)
    x0 = None if not joiner else tuple(map(jnp.asarray, joiner_x0()))
    r = jax_simulate(algo, JLWWMap(U).lattice, jtp, jax_op, ACTIVE, QUIET,
                     x0=x0,
                     faults=schedules(JaxSchedule, jtp, ACTIVE) if faulted
                     else None,
                     track_convergence=True, digest=JaxSpec(BE),
                     wide_metrics=False)
    return (r.tx, r.mem, r.cpu, r.max_mem_node, r.uniform,
            tuple(np.asarray(a) for a in r.final_x))


def check_run(algo, topo_name, faulted=False, joiner=False):
    want = jax_run(algo, topo_name, faulted, joiner)
    _, ttp = topos(topo_name)
    x0 = None if not joiner else convert.to_torch(joiner_x0())
    for engine in ENGINES:
        kernels.reset_launches()
        r = simulate(algo, LWWMap(U).lattice, ttp, torch_op, ACTIVE, QUIET,
                     x0=x0,
                     faults=schedules(FaultSchedule, ttp, ACTIVE) if faulted
                     else None,
                     track_convergence=True, digest=DigestSpec(BE),
                     engine=engine, wide_metrics=False, device="cpu")
        for nm, g, w in zip(("tx", "mem", "cpu", "max_mem_node", "uniform"),
                            (r.tx, r.mem, r.cpu, r.max_mem_node, r.uniform),
                            want):
            np.testing.assert_array_equal(g, w, err_msg=f"{engine} {nm}")
        assert isinstance(r.final_x, tuple) and len(r.final_x) == 2
        for leaf, w in zip(r.final_x, want[5]):
            np.testing.assert_array_equal(leaf.numpy(), w,
                                          err_msg=f"{engine} final_x")
        assert sum(kernels.launch_counts().values()) == 0


@pytest.mark.parametrize("topo_name", ["tree", "mesh"])
@pytest.mark.parametrize("algo", DELTA_ALGORITHMS)
def test_lww_simulate_matches_jax(algo, topo_name):
    check_run(algo, topo_name)


@pytest.mark.parametrize("algo", ALGORITHMS)
def test_lww_faulted_simulate_matches_jax(algo):
    """Loss (20%, seed 3) composed with churn of two nodes."""
    check_run(algo, "mesh", faulted=True)


@pytest.mark.parametrize("algo", RESYNC_ALGORITHMS + ("bprr",))
def test_lww_resync_from_a_joiner_matches_jax(algo):
    """Node 0 starts at ⊥, the others hold a third of the keys (some at
    a later timestamp); the op keeps writing meanwhile."""
    check_run(algo, "mesh", joiner=True)


def test_lww_resolves_to_the_reference_engine():
    _, ttp = topos("mesh")
    for engine in ENGINES:
        for algo in ALGORITHMS:
            alg = SyncAlgorithm(name=algo, lattice=LWWMap(U).lattice,
                                topo=ttp, engine=engine)
            assert alg.resolved_engine == "reference"


# -- other tuple lattices through simulate ------------------------------------------

def pn_ops():
    def jop(x, t):
        p, n = x
        i = jnp.arange(N)
        dp = jnp.zeros_like(p).at[i, i].set(p[i, i] + 1)
        dn = jnp.zeros_like(n).at[i, (i + 1) % N].set(
            jnp.where(t % 2 == 1, n[i, (i + 1) % N] + 1, 0))
        return (dp, dn)

    def top(x, t):
        p, n = x
        i = torch.arange(N)
        dp, dn = torch.zeros_like(p), torch.zeros_like(n)
        dp[i, i] = p[i, i] + 1
        if t % 2 == 1:
            dn[i, (i + 1) % N] = n[i, (i + 1) % N] + 1
        return (dp, dn)

    return jop, top


def linsum_ops(side=4):
    """Nodes inflate the low side early, then the cluster jumps to the high
    side (the tag flips propagate through sync)."""

    def jop(x, t):
        tags = jnp.where(t >= 2, jnp.ones((N,), jnp.int32),
                         jnp.zeros((N,), jnp.int32))
        lo = jnp.zeros((N, side), jnp.int32).at[:, 0].set(
            jnp.where(t < 2, t + 1, 0).astype(jnp.int32))
        hi = jnp.zeros((N, side), jnp.int32).at[:, 1].set(
            jnp.where(t >= 2, t + 1, 0).astype(jnp.int32))
        return (tags, lo, hi)

    def top(x, t):
        tags = torch.full((N,), int(t >= 2), dtype=torch.int32)
        lo = torch.zeros((N, side), dtype=torch.int32)
        hi = torch.zeros((N, side), dtype=torch.int32)
        if t < 2:
            lo[:, 0] = t + 1
        else:
            hi[:, 1] = t + 1
        return (tags, lo, hi)

    return jop, top


def tuple_lattices(name):
    if name == "pncounter":
        return JPNCounter(N).lattice, PNCounter(N).lattice, pn_ops()
    jlo = jlat.MapLattice(4, jvl.max_int(), "lo").build()
    jhi = jlat.MapLattice(4, jvl.max_int(), "hi").build()
    tlo = MapLattice(4, vl.max_int(), "lo").build()
    thi = MapLattice(4, vl.max_int(), "hi").build()
    return (jlat.linear_sum("linsum", jlo, jhi, None),
            linear_sum("linsum", tlo, thi, None), linsum_ops())


@pytest.mark.parametrize("algo", ["state", "classic", "bprr"])
@pytest.mark.parametrize("name", ["pncounter", "linsum"])
def test_product_and_linear_sum_simulate_match_jax(name, algo):
    jl, tl, (jop, top) = tuple_lattices(name)
    jtp, ttp = jtopo.ring(N), ttopo.ring(N)
    want = jax_simulate(algo, jl, jtp, jop, ACTIVE, QUIET,
                        track_convergence=True, wide_metrics=False)
    got = simulate(algo, tl, ttp, top, ACTIVE, QUIET, track_convergence=True,
                   wide_metrics=False, device="cpu")
    for nm in ("tx", "mem", "cpu", "max_mem_node", "uniform"):
        np.testing.assert_array_equal(getattr(got, nm), getattr(want, nm),
                                      err_msg=nm)
    assert_tree_equal(convert.to_numpy(got.final_x),
                      jax.device_get(want.final_x), "final_x")


# -- digests and conversion ---------------------------------------------------------

@pytest.mark.parametrize("be", [8, 16, 64])
def test_lww_digest_matches_jax(be):
    """Two leaves combine with the multipliers 1 and 3·LEAF_MUL mod 2³²;
    negative values hash as their 32-bit words."""
    x = rand_lww(np.random.default_rng(be), N)
    got = D.digest_state(convert.to_torch(x), DigestSpec(be))
    want = jd.digest_state(tuple(map(jnp.asarray, x)), JaxSpec(be))
    np.testing.assert_array_equal(convert.to_numpy(got, words=True),
                                  np.asarray(want))
    assert D.state_universe(LWWMap(U).lattice.bottom()) == U


def test_undigestable_tuple_states_are_refused():
    _, tl, _ = tuple_lattices("linsum")
    assert not D.digestable(tl)
    assert D.digestable(LWWMap(8).lattice)
    assert D.digestable(PNCounter(4).lattice)     # both leaves share U
    with pytest.raises(ValueError, match="universe"):
        simulate("digest_driven", tl, ttopo.ring(5), lambda x, t: x, 0, 1,
                 device="cpu")


@pytest.mark.parametrize("algo", ["bprr", "classic", "state_driven"])
def test_tuple_carry_crosses_and_comes_back(algo):
    """Tuple states and buffers become tensors leaf by leaf, the per-slot
    buffers slot-major in the port, and convert back unchanged."""
    (x, buf, buf_elems, _, _, _), _, _ = jax_round(algo, False)
    carry = convert.carry_to_torch(x, buf, buf_elems)
    assert isinstance(carry.x, tuple) and isinstance(carry.buf, tuple)
    for leaf, w in zip(carry.x, x):
        assert leaf.dtype == torch.int32 and tuple(leaf.shape) == w.shape
    if algo != "classic":
        n, p = buf[0].shape[:2]
        for leaf, w in zip(carry.buf, buf):
            assert tuple(leaf.shape) == (p, n, U) and leaf.is_contiguous()
            np.testing.assert_array_equal(leaf[1].numpy(), w[:, 1])
    back = convert.carry_to_numpy(carry)
    assert_tree_equal(back[0], x, "x")
    assert_tree_equal(back[1], buf, "buf")
    np.testing.assert_array_equal(back[2], buf_elems)
