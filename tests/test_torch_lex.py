"""The port's lex-pair, product and linear-sum lattices against the JAX
package's (``repro.core``), and the lattice laws on the port alone.

* Parity: random states (a seeded numpy generator) of LWWMap's lex-pair
  map, PNCounter's product, a product of unequal maps, and a linear sum of
  two max maps go through ``join``, ``leq``, ``delta``, ``size``,
  ``is_bottom`` and the pointwise masks of both packages, unbatched and
  with a leading node axis; ``decompose_dense``, ``join_all``,
  ``leq_from_join`` and the mutators and δ-mutators of PNCounter, LWWMap
  and LexCounter likewise. Tolerance 0.
* Laws (``tests/test_lattice_properties.py``, whose hypothesis strategies
  skip without hypothesis): join laws, the canonical order, Δ correct and
  minimal, size counts irreducibles, ⇓x joins back to x and is
  irredundant, every mutator an inflation and m(x) = x ⊔ mᵟ(x) — over the
  same seeded draws.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import LWWMap as JLWWMap
from repro.core import LexCounter as JLexCounter
from repro.core import PNCounter as JPNCounter
from repro.core import decompose_dense as jdecompose
from repro.core import join_all as jjoin_all
from repro.core import lattice as jlat
from repro.core import value_lattices as jvl
from repro.core.types import GCounter as JGCounter
from repro.core.types import GSet as JGSet

from repro_torch import convert
from repro_torch.core import (GCounter, GSet, LexCounter, LWWMap, MapLattice,
                              PNCounter, decompose_dense, join_all,
                              leq_from_join, linear_sum, product,
                              tree_leaves, tree_map)
from repro_torch.core import value_lattices as vl

# The states here are small: one intra-op thread per test process keeps
# the suite's parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

U = 8
SIDE = 4
SEEDS = range(6)


def seeded(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


# -- lattices and state draws (numpy; each side converts) -----------------------

def lww_state(rng, lead=()):
    ts = rng.integers(0, 5, size=lead + (U,)).astype(np.int32)
    va = np.where(ts > 0, rng.integers(-3, 5, size=lead + (U,)), 0)
    return (ts, va.astype(np.int32))


def pn_state(rng, lead=()):
    return tuple(rng.integers(0, 6, size=lead + (U,)).astype(np.int32)
                 for _ in range(2))


def mixed_state(rng, lead=()):
    return (rng.integers(0, 2, size=lead + (U,)).astype(bool),
            rng.integers(0, 6, size=lead + (SIDE,)).astype(np.int32))


def linsum_state(rng, lead=()):
    """Canonical A ⊕ B points: the tag selects the side, the other side is
    ⊥ (a tag-1 point with a ⊥ high side is ⊥_B, above all of A)."""
    tag = rng.integers(0, 2, size=lead).astype(np.int32)
    side = rng.integers(0, 5, size=lead + (SIDE,)).astype(np.int32)
    hi = tag[..., None] == 1
    return (np.asarray(tag), np.where(hi, 0, side).astype(np.int32),
            np.where(hi, side, 0).astype(np.int32))


def jax_linsum():
    lo = jlat.MapLattice(SIDE, jvl.max_int(), "lo").build()
    hi = jlat.MapLattice(SIDE, jvl.max_int(), "hi").build()
    return jlat.linear_sum("linsum", lo, hi, None)


def torch_linsum():
    lo = MapLattice(SIDE, vl.max_int(), "lo").build()
    hi = MapLattice(SIDE, vl.max_int(), "hi").build()
    return linear_sum("linsum", lo, hi, None)


LATTICES = {   # name -> (JAX lattice, port lattice, state draw)
    "lww": (JLWWMap(U).lattice, LWWMap(U).lattice, lww_state),
    "lex_map": (jlat.MapLattice(U, jvl.lex_pair(), "lw").build(),
                MapLattice(U, vl.lex_pair(), "lw").build(), lww_state),
    "pncounter": (JPNCounter(U).lattice, PNCounter(U).lattice, pn_state),
    "product_mixed": (
        jlat.product("mixed", (JGSet(U).lattice, JGCounter(SIDE).lattice)),
        product("mixed", (GSet(U).lattice, GCounter(SIDE).lattice)),
        mixed_state),
    "linsum": (jax_linsum(), torch_linsum(), linsum_state),
}


def to_jax(state):
    return tree_map(jnp.asarray, state) if isinstance(state, tuple) \
        else jnp.asarray(state)


def jax_tree_to_np(state):
    if isinstance(state, (tuple, list)):
        return tuple(jax_tree_to_np(s) for s in state)
    return np.asarray(state)


def assert_same(got, want, what):
    g = convert.to_numpy(got)
    w = jax_tree_to_np(want)
    if isinstance(w, tuple):
        assert isinstance(g, tuple) and len(g) == len(w), what
        for i, (gl, wl) in enumerate(zip(g, w)):
            assert_same(gl, wl, f"{what}[{i}]") if isinstance(wl, tuple) \
                else np.testing.assert_array_equal(gl, wl, err_msg=what)
    else:
        np.testing.assert_array_equal(g, w, err_msg=what)


# -- parity ---------------------------------------------------------------------

@pytest.mark.parametrize("lead", [(), (3,)], ids=["point", "nodes"])
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", sorted(LATTICES))
def test_lattice_ops_match_jax(name, seed, lead):
    jl, tl, draw = LATTICES[name]
    rng = seeded(name, seed, lead)
    a, b = draw(rng, lead), draw(rng, lead)
    ja, jb = to_jax(a), to_jax(b)
    ta, tb = convert.to_torch(a), convert.to_torch(b)
    assert_same(tl.join(ta, tb), jl.join(ja, jb), "join")
    assert_same(tl.leq(ta, tb), jl.leq(ja, jb), "leq")
    assert_same(tl.delta(ta, tb), jl.delta(ja, jb), "delta")
    assert_same(tl.delta(tb, ta), jl.delta(jb, ja), "delta'")
    assert_same(tl.size(ta), jl.size(ja), "size")
    assert_same(tl.is_bottom(ta), jl.is_bottom(ja), "is_bottom")
    assert_same(tl.irreducible_mask(ta), jl.irreducible_mask(ja), "irr")
    assert_same(tl.novel_mask(ta, tb), jl.novel_mask(ja, jb), "novel")
    assert tl.kernel_kind is None and jl.kernel_kind is None


@pytest.mark.parametrize("name", sorted(LATTICES))
def test_bottom_matches_jax(name):
    jl, tl, _ = LATTICES[name]
    bot = tl.bottom()
    assert_same(bot, jl.bottom(), "bottom")
    assert bool(tl.is_bottom(bot))
    jleaves = [np.asarray(a) for a in jax.tree.leaves(jl.bottom())]
    assert [convert.to_numpy(a).dtype for a in tree_leaves(bot)] == \
        [a.dtype for a in jleaves]


def test_lex_pair_value_lattice():
    v = vl.lex_pair()
    assert v.arity == 2 and vl.max_int().arity == 1
    assert v.dtype == (torch.int32, torch.int32)
    bt, bv = v.bottom((3,))
    assert bt.dtype == bv.dtype == torch.int32 and bt.shape == (3,)
    a = (torch.tensor([2, 2, 1, 0]), torch.tensor([1, 5, 9, 0]))
    b = (torch.tensor([2, 3, 0, 0]), torch.tensor([4, 0, 3, 0]))
    t, val = v.join(a, b)
    assert t.tolist() == [2, 3, 1, 0] and val.tolist() == [4, 0, 9, 0]
    assert v.leq(a, b).tolist() == [True, True, False, True]
    assert v.is_bottom(b).tolist() == [False, False, False, True]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", ["lww", "gcounter", "gset"])
def test_decompose_dense_and_join_all_match_jax(name, seed):
    rng = seeded("decompose", name, seed)
    if name == "lww":
        jm, tm = jlat.MapLattice(U, jvl.lex_pair()), MapLattice(U, vl.lex_pair())
        x = lww_state(rng)
    elif name == "gcounter":
        jm, tm = jlat.MapLattice(U, jvl.max_int()), MapLattice(U, vl.max_int())
        x = rng.integers(0, 4, size=U).astype(np.int32)
        x[rng.random(U) < 0.4] = 0
    else:
        jm, tm = jlat.MapLattice(U, jvl.or_bool()), MapLattice(U, vl.or_bool())
        x = rng.integers(0, 2, size=U).astype(bool)
    jstack, jmask = jdecompose(jm, to_jax(x))
    tstack, tmask = decompose_dense(tm, convert.to_torch(x))
    assert_same(tstack, jstack, "stack")
    assert_same(tmask, jmask, "mask")
    states = [tree_map(lambda a, k=k: a[k], tstack) for k in range(U)]
    jstates = [jax_tree_leaf(jstack, k) for k in range(U)]
    assert_same(join_all(tm.build(), states, tmask),
                jjoin_all(jm.build(), jstates, jmask), "join_all")
    assert_same(join_all(tm.build(), states), jjoin_all(jm.build(), jstates),
                "join_all unmasked")


def jax_tree_leaf(stack, k):
    if isinstance(stack, tuple):
        return tuple(s[k] for s in stack)
    return stack[k]


@pytest.mark.parametrize("seed", SEEDS)
def test_leq_from_join_is_the_order(seed):
    lat = LWWMap(U).lattice
    rng = seeded("leq_from_join", seed)

    def equal(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    leq = leq_from_join(lat.join, equal)
    for _ in range(10):
        a = convert.to_torch(lww_state(rng))
        b = lat.join(a, convert.to_torch(lww_state(rng))) \
            if rng.random() < 0.5 else convert.to_torch(lww_state(rng))
        assert leq(a, b) == bool(lat.leq(a, b))


# -- the types' mutators and δ-mutators --------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_pncounter_mutators_match_jax(seed):
    rng = seeded("pn", seed)
    j, t = JPNCounter(U), PNCounter(U)
    s = pn_state(rng)
    js, ts = to_jax(s), convert.to_torch(s)
    for i in rng.integers(0, U, size=3):
        i = int(i)
        for fn in ("inc", "dec", "inc_delta", "dec_delta"):
            assert_same(getattr(t, fn)(ts, i), getattr(j, fn)(js, i), fn)
        js, ts = j.inc(j.dec(js, i), (i + 1) % U), t.inc(t.dec(ts, i),
                                                          (i + 1) % U)
        assert int(t.value(ts)) == int(j.value(js))
        assert_same(ts, js, "state")


@pytest.mark.parametrize("seed", SEEDS)
def test_lwwmap_mutators_match_jax(seed):
    rng = seeded("lww_put", seed)
    j, t = JLWWMap(U), LWWMap(U)
    s = lww_state(rng)
    js, ts = to_jax(s), convert.to_torch(s)
    for _ in range(3):
        key, stamp, val = (int(v) for v in (rng.integers(0, U),
                                            rng.integers(1, 9),
                                            rng.integers(-5, 5)))
        assert_same(t.put_delta(ts, key, stamp, val),
                    j.put_delta(js, key, stamp, val), "put_delta")
        js, ts = j.put(js, key, stamp, val), t.put(ts, key, stamp, val)
        assert_same(ts, js, "put")


@pytest.mark.parametrize("seed", SEEDS)
def test_lexcounter_mutators_match_jax(seed):
    rng = seeded("lexc", seed)
    j, t = JLexCounter(U), LexCounter(U)
    s = lww_state(rng)
    js, ts = to_jax(s), convert.to_torch(s)
    for _ in range(3):
        i, val = int(rng.integers(0, U)), int(rng.integers(-5, 9))
        assert_same(t.set_value_delta(ts, i, val),
                    j.set_value_delta(js, i, val), "set_value_delta")
        js, ts = j.set_value(js, i, val), t.set_value(ts, i, val)
        assert_same(ts, js, "set_value")
        assert int(t.value(ts)) == int(j.value(js))


def test_pncounter():
    pn = PNCounter(num_replicas=3)
    lat = pn.lattice
    s = lat.bottom()
    s = pn.inc(s, 0)
    s = pn.inc(s, 1)
    s = pn.dec(s, 2)
    assert int(pn.value(s)) == 1
    d = pn.inc_delta(s, 0)
    assert eq(lat, lat.join(s, d), pn.inc(s, 0))
    assert int(lat.size(d)) == 1


def test_lww_map_last_writer_wins():
    lm = LWWMap(num_keys=4)
    lat = lm.lattice
    s = lm.put(lat.bottom(), 1, ts=5, val=10)
    s2 = lm.put(lat.bottom(), 1, ts=7, val=20)
    j = lat.join(s, s2)
    assert int(j[0][1]) == 7 and int(j[1][1]) == 20
    # the delta of an older write against the newer state is ⊥
    assert bool(lat.is_bottom(lat.delta(s, j)))


def test_lexcounter_single_writer():
    lc = LexCounter(num_replicas=2)
    lat = lc.lattice
    s = lc.set_value(lat.bottom(), 0, 42)
    s = lc.set_value(s, 0, 17)    # an arbitrary change, with a version bump
    assert int(s[1][0]) == 17 and int(s[0][0]) == 2
    d = lc.set_value_delta(s, 1, 5)
    assert eq(lat, lat.join(s, d), lc.set_value(s, 1, 5))


def test_mutators_leave_their_arguments():
    s = LWWMap(4).lattice.bottom()
    LWWMap(4).put(s, 1, 3, 3)
    LexCounter(4).set_value(s, 1, 3)
    PNCounter(4).inc(s, 1)
    PNCounter(4).dec(s, 1)
    assert all(int(leaf.abs().sum()) == 0 for leaf in s)


# -- linear sum ----------------------------------------------------------------------

def test_linear_sum_construct():
    """Every high element is above every low element; joins across sides
    absorb the low side; Δ respects the order."""
    L = torch_linsum()
    bot = L.bottom()
    x_low = (torch.tensor(0), torch.tensor([1, 0, 2, 0], dtype=torch.int32),
             torch.zeros(4, dtype=torch.int32))
    x_high = (torch.tensor(1), torch.zeros(4, dtype=torch.int32),
              torch.tensor([0, 3, 0, 0], dtype=torch.int32))
    assert bool(L.leq(bot, x_low)) and bool(L.leq(x_low, x_high))
    assert not bool(L.leq(x_high, x_low))
    j = L.join(x_low, x_high)
    assert int(j[0]) == 1
    assert eq(L, j, x_high)
    d = L.delta(x_high, x_low)
    assert eq(L, L.join(d, x_low), L.join(x_high, x_low))
    assert int(L.size(x_low)) == 2 and int(L.size(x_high)) == 1
    assert bool(L.is_bottom(bot)) and not bool(L.is_bottom(x_high))


@pytest.mark.parametrize("seed", SEEDS)
def test_linear_sum_delta_bottom_when_below(seed):
    """Whenever x ⊑ y the optimal Δ(x, y) is ⊥, and Δ never carries more
    irreducibles than x."""
    L = torch_linsum()
    rng = seeded("linsum_below", seed)
    for _ in range(10):
        x = convert.to_torch(linsum_state(rng))
        y = convert.to_torch(linsum_state(rng))
        d = L.delta(x, y)
        if bool(L.leq(x, y)):
            assert bool(L.is_bottom(d))
        assert int(L.size(d)) <= int(L.size(x))


@pytest.mark.parametrize("seed", SEEDS)
def test_linear_sum_high_absorbs_low(seed):
    L = torch_linsum()
    rng = seeded("linsum_absorb", seed)
    for _ in range(10):
        lo = convert.to_torch(linsum_state(rng))
        hi = convert.to_torch(linsum_state(rng))
        if int(lo[0]) != 0 or int(hi[0]) != 1:
            continue
        assert bool(L.leq(lo, hi))
        assert eq(L, L.join(lo, hi), hi)


# -- laws, on the port alone ---------------------------------------------------------

def eq(lat, a, b):
    return bool(lat.leq(a, b)) and bool(lat.leq(b, a))


def draws(name, seed, k):
    _, lat, draw = LATTICES[name]
    rng = seeded("laws", name, seed)
    return lat, [convert.to_torch(draw(rng)) for _ in range(k)]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", sorted(LATTICES))
def test_join_laws(name, seed):
    lat, (a, b, c) = draws(name, seed, 3)
    assert eq(lat, lat.join(a, b), lat.join(b, a))
    assert eq(lat, lat.join(lat.join(a, b), c), lat.join(a, lat.join(b, c)))
    assert eq(lat, lat.join(a, a), a)
    assert eq(lat, lat.join(a, lat.bottom()), a)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", sorted(LATTICES))
def test_canonical_order(name, seed):
    lat, (a, b) = draws(name, seed, 2)
    j = lat.join(a, b)
    assert bool(lat.leq(a, j)) and bool(lat.leq(b, j))
    assert bool(lat.leq(a, b)) == eq(lat, lat.join(a, b), b)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", sorted(LATTICES))
def test_delta_correct_and_minimal(name, seed):
    lat, (a, b, c) = draws(name, seed, 3)
    d = lat.delta(a, b)
    assert eq(lat, lat.join(d, b), lat.join(a, b))
    # minimal against any c that also works; c = b ⊔ a's own part always does
    for cand in (c, a, lat.join(a, c)):
        if eq(lat, lat.join(cand, b), lat.join(a, b)):
            assert bool(lat.leq(d, cand))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", ["lww", "lex_map", "pncounter",
                                  "product_mixed"])
def test_size_counts_irreducibles(name, seed):
    lat, (a,) = draws(name, seed, 1)
    mask = lat.irreducible_mask(a)
    masks = mask if isinstance(mask, tuple) else (mask,)
    assert int(lat.size(a)) == sum(int(m.sum()) for m in masks)


@pytest.mark.parametrize("seed", SEEDS)
def test_decomposition_joins_back_and_is_irredundant(seed):
    lat_map = MapLattice(U, vl.lex_pair(), "lw")
    lat = lat_map.build()
    x = convert.to_torch(lww_state(seeded("decomp_law", seed)))
    stack, mask = decompose_dense(lat_map, x)
    states = [tree_map(lambda a, k=k: a[k], stack) for k in range(U)]
    assert eq(lat, join_all(lat, states, mask), x)
    kept = [k for k in range(U) if bool(mask[k])]
    for drop in kept:
        m = mask.clone()
        m[drop] = False
        assert not bool(lat.leq(x, join_all(lat, states, m)))


@pytest.mark.parametrize("seed", SEEDS)
def test_mutators_inflate_and_match_their_deltas(seed):
    rng = seeded("mutators", seed)
    lm, lc, pn = LWWMap(U), LexCounter(U), PNCounter(U)
    s = convert.to_torch(lww_state(rng))
    p = convert.to_torch(pn_state(rng))
    key, val = int(rng.integers(0, U)), int(rng.integers(-3, 9))
    stamp = int(s[0][key]) + 1
    cases = [
        (lm.lattice, s, lm.put(s, key, stamp, val),
         lm.put_delta(s, key, stamp, val)),
        (lc.lattice, s, lc.set_value(s, key, val),
         lc.set_value_delta(s, key, val)),
        (pn.lattice, p, pn.inc(p, key), pn.inc_delta(p, key)),
        (pn.lattice, p, pn.dec(p, key), pn.dec_delta(p, key)),
    ]
    for lat, x, mx, dx in cases:
        assert bool(lat.leq(x, mx))
        assert eq(lat, mx, lat.join(x, dx))
