"""The port's elementwise kernels (``join``, ``delta_extract``,
``lex_join_delta``) against the JAX package's.

The plain PyTorch versions (what ``repro_torch.kernels.ops`` runs for CPU
tensors) are held against ``repro.kernels.ops`` (the Pallas kernels in
interpret mode) and ``repro.kernels.ref`` over the shapes and dtypes of
``tests/test_kernels.py``: int32, uint32 (as int32 bit-views of values
below 2³¹ for ``max``, full words for ``bitor``) and int8, plus bool and
uint8 states. Inputs come from a seeded numpy generator; tolerance 0 and
equal counts (every quantity is an integer or a bit pattern). The wrappers
must refuse the dtypes their kernels do not take.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref

from repro_torch import convert
from repro_torch.kernels import delta_extract as kdelta
from repro_torch.kernels import join as kjoin
from repro_torch.kernels import lex_join as klex
from repro_torch.kernels import ops

# The states here are small: one intra-op thread per test process keeps
# the suite's parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

SHAPES = [(64,), (1000,), (7, 333), (512, 1024), (3, 5, 129), (2048, 2048)]
DTYPES = {"int32": np.int32, "uint32": np.uint32, "int8": np.int8}


def seeded(*key):
    """A numpy generator seeded by the test case (the same in every
    process)."""
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def same(got, want, words=False):
    np.testing.assert_array_equal(convert.to_numpy(got, words=words),
                                  np.asarray(want))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_join_max_matches_jax(shape, dtype):
    rng = seeded("join", shape, dtype)
    a = rng.integers(0, 100, size=shape).astype(DTYPES[dtype])
    b = rng.integers(0, 100, size=shape).astype(DTYPES[dtype])
    got = ops.join(convert.to_torch(a), convert.to_torch(b))
    want = jops.join(jnp.asarray(a), jnp.asarray(b))
    words = dtype == "uint32"
    same(got, want, words)
    same(got, jref.join(jnp.asarray(a), jnp.asarray(b)), words)


@pytest.mark.parametrize("shape", SHAPES)
def test_join_bitor_matches_jax(shape):
    """Full 32-bit words, bit 31 included."""
    rng = seeded("join_or", shape)
    a = rng.integers(0, 2**32, size=shape, dtype=np.uint32)
    b = rng.integers(0, 2**32, size=shape, dtype=np.uint32)
    got = ops.join(convert.to_torch(a), convert.to_torch(b), kind="bitor")
    same(got, jops.join(jnp.asarray(a), jnp.asarray(b), kind="bitor"), True)


@pytest.mark.parametrize("dtype", ["bool", "uint8"])
def test_join_flags_match_jax(dtype):
    rng = seeded("join_flags", dtype)
    a, b = (rng.integers(0, 2, size=(7, 333)).astype(dtype) for _ in "ab")
    got = ops.join(convert.to_torch(a), convert.to_torch(b))
    assert got.dtype == convert.to_torch(a).dtype
    same(got, jops.join(jnp.asarray(a), jnp.asarray(b)))


def delta_inputs(kind, dtype, shape, rng):
    if kind == "bitor":
        return (rng.integers(0, 2**32, size=shape, dtype=np.uint32)
                for _ in "dx")
    if dtype == "bool":
        return (rng.integers(0, 2, size=shape).astype(bool) for _ in "dx")
    return (rng.integers(0, 8, size=shape).astype(dtype) for _ in "dx")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind,dtype", [("max", "int32"), ("bitor", "uint32"),
                                        ("max", "int8"), ("max", "uint8"),
                                        ("max", "bool")])
def test_delta_extract_matches_jax(shape, kind, dtype):
    d, x = delta_inputs(kind, dtype, shape, seeded("delta", shape, kind, dtype))
    s, xj, cnt = ops.delta_extract(convert.to_torch(d), convert.to_torch(x),
                                   kind=kind)
    js, jxj, jcnt = jops.delta_extract(jnp.asarray(d), jnp.asarray(x),
                                       kind=kind)
    rs, rxj, rcnt = jref.delta_extract(jnp.asarray(d), jnp.asarray(x),
                                       kind=kind)
    words = kind == "bitor"
    same(s, js, words)
    same(xj, jxj, words)
    same(s, rs, words)
    same(xj, rxj, words)
    assert cnt.dtype == torch.int32 and cnt.ndim == 0
    assert int(cnt) == int(jcnt) == int(rcnt)


@pytest.mark.parametrize("shape", [(100,), (7, 333), (512, 257), (64,),
                                   (3, 5, 129)])
def test_lex_join_delta_matches_jax(shape):
    """Timestamps and values from a small range, so ties (the max-value
    rule) and ⊥ pairs are frequent."""
    rng = seeded("lex", shape)
    ta, va, tb, vb = (rng.integers(0, 5, size=shape).astype(np.int32)
                      for _ in range(4))
    (t, v), (dt, dv), cnt = ops.lex_join_delta(
        convert.to_torch((ta, va)), convert.to_torch((tb, vb)))
    (jt, jv), (jdt, jdv), jcnt = jops.lex_join_delta(
        (jnp.asarray(ta), jnp.asarray(va)), (jnp.asarray(tb), jnp.asarray(vb)))
    rt, rv, rdt, rdv, rcnt = jref.lex_join_delta(
        *(jnp.asarray(a) for a in (ta, va, tb, vb)))
    for g, w, r in ((t, jt, rt), (v, jv, rv), (dt, jdt, rdt), (dv, jdv, rdv)):
        same(g, w)
        same(g, r)
    assert cnt.dtype == torch.int32 and cnt.ndim == 0
    assert int(cnt) == int(jcnt) == int(rcnt)


def test_lex_join_delta_signed_ties():
    """Negative values compare signed; on equal timestamps the larger value
    wins; Δ(b, a) keeps b's pair only where b ⋢ a and b ≠ (0, 0)."""
    ta = torch.tensor([1, 2, 2, 0, 3, 0], dtype=torch.int32)
    va = torch.tensor([5, -4, 7, 0, 1, 0], dtype=torch.int32)
    tb = torch.tensor([1, 2, 2, 0, 2, 1], dtype=torch.int32)
    vb = torch.tensor([-6, 3, 7, -1, 9, -2], dtype=torch.int32)
    (t, v), (dt, dv), cnt = ops.lex_join_delta((ta, va), (tb, vb))
    assert t.tolist() == [1, 2, 2, 0, 3, 1]
    assert v.tolist() == [5, 3, 7, 0, 1, -2]
    assert dt.tolist() == [0, 2, 0, 0, 0, 1]
    assert dv.tolist() == [0, 3, 0, 0, 0, -2]
    assert int(cnt) == 2


@pytest.mark.parametrize("dtype", [torch.uint32, torch.int64, torch.int16,
                                   torch.float32])
def test_join_and_delta_refuse_other_dtypes(dtype):
    a = torch.zeros(8, dtype=dtype)
    with pytest.raises(TypeError, match="does not take"):
        ops.join(a, a)
    with pytest.raises(TypeError, match="does not take"):
        ops.delta_extract(a, a)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int8, torch.bool])
def test_bitor_refuses_byte_words(dtype):
    a = torch.zeros(8, dtype=dtype)
    with pytest.raises(TypeError, match="does not take"):
        ops.join(a, a, kind="bitor")
    with pytest.raises(TypeError, match="does not take"):
        ops.delta_extract(a, a, kind="bitor")


@pytest.mark.parametrize("dtype", [torch.int64, torch.uint32, torch.int8,
                                   torch.float32])
def test_lex_join_delta_refuses_other_dtypes(dtype):
    good = torch.zeros(8, dtype=torch.int32)
    bad = torch.zeros(8, dtype=dtype)
    with pytest.raises(TypeError, match="int32"):
        ops.lex_join_delta((good, bad), (good, good))


def test_mismatched_operands_are_refused():
    a = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        ops.join(a, torch.zeros(9, dtype=torch.int32))
    with pytest.raises(ValueError):
        ops.delta_extract(a, a.to(torch.int8))
    with pytest.raises(ValueError):
        ops.lex_join_delta((a, a), (a, torch.zeros(9, dtype=torch.int32)))


def test_cpu_calls_launch_nothing():
    """On the CPU every wrapper takes its plain version: no launch is
    counted."""
    before = (kjoin.launches, kdelta.launches, klex.launches)
    a = torch.arange(16, dtype=torch.int32)
    ops.join(a, a)
    ops.delta_extract(a, a)
    ops.lex_join_delta((a, a), (a, a))
    assert (kjoin.launches, kdelta.launches, klex.launches) == before


def test_empty_states():
    e = torch.zeros((0, 4), dtype=torch.int32)
    assert ops.join(e, e).shape == (0, 4)
    s, xj, cnt = ops.delta_extract(e, e)
    assert s.shape == xj.shape == (0, 4) and int(cnt) == 0
