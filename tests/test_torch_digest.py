"""The digest layer and the two digest kernels, JAX against the port.

* ``sync/digest.py``: ``mix``, ``or_fold``, ``digest_state``, ``digest_diff``,
  ``block_mask_to_elems``/``extract_blocks``, ``merkle_levels``,
  ``descent_words`` and ``routed_descent_words`` (against the JAX
  package's ``descent_words`` of the routed trees) of the port equal the
  JAX package's word for word
  (uint32 words ↔ int32 bit-views) for GSet (bool), GMap (int32) and
  BitGSet words with bit 31 set, at block widths 8, 32 and 64 and
  universes off every block multiple (the zero-padded last block enters
  the hash).
* The plain versions of ``digest_blocks`` and ``masked_extract`` (what the
  wrappers run for a CPU tensor) equal the JAX Pallas kernels run in
  interpret mode (``repro.kernels.ops``) and the JAX oracles
  (``repro.kernels.ref``), masks all-zero, all-one and random.

Inputs come from a seeded numpy generator; every comparison is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.sync import digest as jd

from repro_torch import convert
from repro_torch.kernels import ops
from repro_torch.sync import digest as td

# The states here are small: one intra-op thread per test process keeps
# the suite's parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

LATTICES = {"gset": ("max", np.bool_), "gmap": ("max", np.int32),
            "bitgset": ("bitor", np.uint32)}
# the JAX side compiled once per shape (its eager ops compile one by one)
J_DIGEST = jax.jit(jd.digest_state, static_argnums=(1, 2))
J_LEVELS = jax.jit(jd.merkle_levels)
J_DESCENT = jax.jit(jd.descent_words)


def rand_state(rng, name, *shape):
    dt = LATTICES[name][1]
    if dt == np.bool_:
        return rng.random(shape) < 0.3
    if dt == np.uint32:
        x = rng.integers(0, 2**32, size=shape, dtype=np.uint32)
        x[..., ::3] |= np.uint32(1 << 31)                  # the top bit set
        x[..., 1::5] = 0xFFFFFFFF                          # v + 1 wraps to 0
        return x
    return rng.integers(0, 9, size=shape).astype(np.int32) \
        * (rng.random(shape) < 0.5)


def words(a):
    """A port digest (int32 bit-views) as the JAX package's uint32 words."""
    return convert.to_numpy(a, words=True)


def test_mix_and_or_fold():
    rng = np.random.default_rng(0)
    v = rng.integers(0, 2**32, size=(7, 64), dtype=np.uint32)
    v[0, :4] = (0, 1, 0x80000000, 0xFFFFFFFF)
    np.testing.assert_array_equal(words(td.mix(convert.to_torch(v))),
                                  np.asarray(jd.mix(jnp.asarray(v))))
    np.testing.assert_array_equal(
        words(td.or_fold(convert.to_torch(v))),
        np.asarray(jd.or_fold(jnp.asarray(v))))


@pytest.mark.parametrize("name", sorted(LATTICES))
@pytest.mark.parametrize("be", [8, 32, 64])
@pytest.mark.parametrize("u", [100, 333])
def test_digest_and_merkle_descent_match_jax(name, be, u):
    kind = LATTICES[name][0]
    rng = np.random.default_rng(be * 1000 + u)
    x = rand_state(rng, name, 6, u)
    x[1] = x[0]                                  # equal trees cost one node
    spec_j, spec_t = jd.DigestSpec(be), td.DigestSpec(be)
    want = np.asarray(J_DIGEST(jnp.asarray(x), spec_j, kind))
    got = td.digest_state(convert.to_torch(x), spec_t, kind)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(words(got), want)
    assert spec_t.num_blocks(u) == spec_j.num_blocks(u)
    assert spec_t.words(u) == spec_j.words(u)

    # digest_diff and the extraction it drives, every node against every
    # other (a broadcast pair, as the resync round takes them)
    jl, jr = jnp.asarray(want)[:, None], jnp.asarray(want)[None]
    tl, tr = got[:, None], got[None]
    diff = td.digest_diff(tl, tr)
    np.testing.assert_array_equal(diff.numpy(),
                                  np.asarray(jd.digest_diff(jl, jr)))
    em_j = jd.block_mask_to_elems(jd.digest_diff(jl, jr), u, spec_j)
    em_t = td.block_mask_to_elems(diff, u, spec_t)
    np.testing.assert_array_equal(em_t.numpy(), np.asarray(em_j))
    np.testing.assert_array_equal(
        convert.to_numpy(td.extract_blocks(convert.to_torch(x)[:, None],
                                           em_t), words=x.dtype == np.uint32),
        np.asarray(jd.extract_blocks(jnp.asarray(x)[:, None], em_j)))

    lv_j = J_LEVELS(jnp.asarray(want))
    lv_t = td.merkle_levels(got)
    assert len(lv_t) == len(lv_j)
    for a, b in zip(lv_t, lv_j):
        np.testing.assert_array_equal(words(a), np.asarray(b))
    dw = td.descent_words(tl, tr)
    np.testing.assert_array_equal(dw.numpy(),
                                  np.asarray(J_DESCENT(jl, jr)))
    assert int(dw[0, 1]) == td.CHANNELS
    # the resync round's form: every tree priced against every other
    # (src[p, r] = p), held to the JAX package's routed trees directly
    src = torch.arange(6)[:, None].expand(6, 6)
    jw = jnp.asarray(want)
    np.testing.assert_array_equal(
        td.routed_descent_words(got, src).numpy(),
        np.asarray(J_DESCENT(jw[None], jw[src.numpy()])))


def test_spec_and_universe_checks():
    with pytest.raises(ValueError):
        td.DigestSpec(12)
    with pytest.raises(ValueError):
        td.DigestSpec(4)
    with pytest.raises(ValueError):
        td.state_universe(torch.zeros(()))
    assert td.DigestSpec().block_elems == jd.DigestSpec().block_elems


@pytest.mark.parametrize("name", sorted(LATTICES))
@pytest.mark.parametrize("be", [8, 32, 64])
def test_plain_digest_blocks_matches_the_jax_kernel(name, be):
    kind = LATTICES[name][0]
    rng = np.random.default_rng(be + 7)
    x = rand_state(rng, name, 9, 333)
    got = ops.digest_blocks(convert.to_torch(x), block_elems=be, kind=kind)
    want = np.asarray(jops.digest_blocks(jnp.asarray(x), block_elems=be,
                                         kind=kind, interpret=True))
    np.testing.assert_array_equal(words(got), want)
    np.testing.assert_array_equal(
        words(got), np.asarray(jref.digest_blocks(jnp.asarray(x), be, kind)))
    # leading axes pass through
    got3 = ops.digest_blocks(convert.to_torch(x.reshape(3, 3, 333)),
                             block_elems=be, kind=kind)
    np.testing.assert_array_equal(words(got3).reshape(want.shape), want)


@pytest.mark.parametrize("name", sorted(LATTICES))
@pytest.mark.parametrize("be", [8, 64])
@pytest.mark.parametrize("masks", ["zeros", "ones", "random"])
def test_plain_masked_extract_matches_the_jax_kernel(name, be, masks):
    rng = np.random.default_rng(be)
    n, u, p = 9, 333, 4
    nb = -(-u // be)
    x = rand_state(rng, name, n, u)
    bm = {"zeros": np.zeros((n, p, nb), bool),
          "ones": np.ones((n, p, nb), bool),
          "random": rng.random((n, p, nb)) < 0.5}[masks]
    # the port's masks and sends are slot-major: [P, N, nB] -> [P, N, U]
    got = ops.masked_extract(convert.to_torch(x),
                             convert.to_torch(bm.swapaxes(0, 1)),
                             block_elems=be)
    assert got.dtype == convert.to_torch(x).dtype
    want = np.asarray(jops.masked_extract(jnp.asarray(x), jnp.asarray(bm),
                                          block_elems=be, interpret=True))
    flat = x.dtype == np.uint32
    np.testing.assert_array_equal(
        convert.to_numpy(got, words=flat).swapaxes(0, 1), want)
    np.testing.assert_array_equal(
        convert.to_numpy(got, words=flat).swapaxes(0, 1),
        np.asarray(jref.masked_extract(jnp.asarray(x), jnp.asarray(bm), be)))


def test_wrappers_refuse_bad_arguments():
    x = torch.zeros((3, 40), dtype=torch.int32)
    with pytest.raises(ValueError):
        ops.digest_blocks(x, block_elems=24)
    with pytest.raises(ValueError):
        ops.masked_extract(x, torch.zeros((2, 3, 4), dtype=torch.bool),
                           block_elems=8)            # 40 / 8 = 5 blocks
    with pytest.raises(TypeError):
        ops.digest_blocks(x.to(torch.int64), block_elems=8)
