"""The port's lattices and dense CRDT types against the JAX package's.

For GSet, GCounter, GMap and BitGSet, random [N, U] states from a seeded
numpy generator go through both packages' join / leq / delta / size /
is_bottom / irreducible_mask / novel_mask and the optimal δ-mutators, and
must agree exactly. BitGSet words span the whole uint32 range, so words
with bit 31 set (negative as the port's int32 bit-views) are covered.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import types as jtypes

from repro_torch import convert
from repro_torch.core import types as ttypes

# The states here are small: one intra-op thread per test process keeps
# the suite's parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

N, U = 7, 96


def make(name, rng):
    """(JAX type, port type, states a, b as numpy). Some rows of a are ⊥
    and some rows of b lie above a, so both outcomes of leq/is_bottom
    occur."""
    if name == "gset":
        jt, tt = jtypes.GSet(U), ttypes.GSet(U)
        a = rng.integers(0, 2, size=(N, U)).astype(bool)
        b = rng.integers(0, 2, size=(N, U)).astype(bool)
    elif name == "bitgset":
        jt, tt = jtypes.BitGSet(32 * U), ttypes.BitGSet(32 * U)
        a = rng.integers(0, 2**32, size=(N, U), dtype=np.uint32)
        b = rng.integers(0, 2**32, size=(N, U), dtype=np.uint32)
        a[:, 0] |= np.uint32(0x80000000)          # bit 31 in every row
    else:
        jt = jtypes.GCounter(U) if name == "gcounter" else jtypes.GMap(U)
        tt = ttypes.GCounter(U) if name == "gcounter" else ttypes.GMap(U)
        a = rng.integers(0, 4, size=(N, U)).astype(np.int32)
        b = rng.integers(0, 4, size=(N, U)).astype(np.int32)
    a[0] = 0                                       # a ⊥ row
    b[1] = np.asarray(jt.lattice.join(jnp.asarray(a[1]), jnp.asarray(b[1])))
    return jt, tt, a, b


LATTICES = ("gset", "gcounter", "gmap", "bitgset")
BINARY = ("join", "leq", "delta", "novel_mask")
UNARY = ("size", "is_bottom", "irreducible_mask")


def check(got, want, words):
    np.testing.assert_array_equal(convert.to_numpy(got, words),
                                  np.asarray(want))


@pytest.mark.parametrize("name", LATTICES)
@pytest.mark.parametrize("fn", BINARY)
def test_binary_ops_match_jax(name, fn, rng):
    jt, tt, a, b = make(name, rng)
    words = name == "bitgset" and fn in ("join", "delta")
    for x, y in ((a, b), (b, a), (a, a)):
        want = getattr(jt.lattice, fn)(jnp.asarray(x), jnp.asarray(y))
        got = getattr(tt.lattice, fn)(convert.to_torch(x), convert.to_torch(y))
        check(got, want, words)


@pytest.mark.parametrize("name", LATTICES)
@pytest.mark.parametrize("fn", UNARY)
def test_unary_ops_match_jax(name, fn, rng):
    jt, tt, a, b = make(name, rng)
    for x in (a, b):
        want = getattr(jt.lattice, fn)(jnp.asarray(x))
        got = getattr(tt.lattice, fn)(convert.to_torch(x))
        check(got, want, False)
    if fn == "size":
        assert tt.lattice.size(convert.to_torch(a)).dtype == torch.int32


@pytest.mark.parametrize("name", LATTICES)
def test_bottom_and_kernel_kind_match_jax(name, rng):
    jt, tt, _, _ = make(name, rng)
    check(tt.lattice.bottom(), jt.lattice.bottom(), name == "bitgset")
    assert tt.lattice.kernel_kind == jt.lattice.kernel_kind


def test_popcount_counts_bit_31():
    w = np.array([0, 1, 0x80000000, 0xFFFFFFFF, 0x7FFFFFFF, 0xF0F0F0F0],
                 np.uint32)
    want = [bin(int(v)).count("1") for v in w]
    assert ttypes.popcount32(convert.to_torch(w)).tolist() == want


def test_mutators_match_jax(rng):
    jt, tt, a, b = make("gcounter", rng)
    x = a[2]
    check(tt.inc(convert.to_torch(x), 3), jt.inc(jnp.asarray(x), 3), False)
    check(tt.inc_delta(convert.to_torch(x), 3),
          jt.inc_delta(jnp.asarray(x), 3), False)
    jt, tt, a, b = make("gset", rng)
    for e in (0, 5):
        check(tt.add_delta(convert.to_torch(a[2]), e),
              jt.add_delta(jnp.asarray(a[2]), e), False)
    check(tt.add_mask_delta(convert.to_torch(a), convert.to_torch(b)),
          jt.add_mask_delta(jnp.asarray(a), jnp.asarray(b)), False)
    jt, tt, a, b = make("gmap", rng)
    keys = b > 1
    check(tt.bump_delta(convert.to_torch(a), convert.to_torch(keys)),
          jt.bump_delta(jnp.asarray(a), jnp.asarray(keys)), False)
    check(tt.bump(convert.to_torch(a), convert.to_torch(keys)),
          jt.bump(jnp.asarray(a), jnp.asarray(keys)), False)
    jt, tt, a, b = make("bitgset", rng)
    check(tt.add_mask_delta(convert.to_torch(a), convert.to_torch(b)),
          jt.add_mask_delta(jnp.asarray(a), jnp.asarray(b)), True)
