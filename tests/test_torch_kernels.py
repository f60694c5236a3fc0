"""The port's kernels against the JAX package's.

Each plain PyTorch version (what a kernel wrapper runs for a CPU tensor) is
held against the JAX Pallas kernel run in interpret mode
(``repro.kernels.ops``) and against the JAX oracle (``repro.kernels.ref``),
over the flag and shape grid of ``chip_smoke.py``'s kernel phase: kinds
max (int32, bool) and bitor (uint32 words with bit 31 set), buffers of
K ∈ {0, 1, P+1}, extracts, the masked inbox, active/delivered masks with
zeros, N = 9 nodes and U = 333 columns (not tile multiples). Inputs come
from a seeded numpy generator; every comparison is exact (tolerance 0:
all quantities are integers or bit patterns).

The ``cuda`` case holds the CUDA kernels themselves against JAX where a
machine has both an sm_90 card and JAX; ``tests/test_torch_cuda.py`` holds
them against the plain versions where only the port is installed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.sync import topology as jtopo

from repro_torch import convert
from repro_torch.kernels import _build
from repro_torch.kernels import ops, round_step as kstep

# The states here are small: one intra-op thread per test process keeps
# the suite's parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

N, U = 9, 333
KINDS = {  # name -> (kernel kind, numpy dtype)
    "max_i32": ("max", np.int32),
    "max_bool": ("max", np.bool_),
    "bitor_u32": ("bitor", np.uint32),
}
# (K, per_origin, extracts) per algorithm flavour; "P+1" resolved per topology
FLAVORS = {
    "state": (0, False, False),
    "classic": (1, False, False),
    "bp": ("P+1", True, False),
    "rr": (1, False, True),
    "bprr": ("P+1", True, True),
}


def rand_state(rng, kind_name, *shape):
    _, dt = KINDS[kind_name]
    if dt == np.bool_:
        return rng.integers(0, 2, size=shape).astype(bool)
    if dt == np.uint32:
        return rng.integers(0, 2**32, size=shape, dtype=np.uint32)
    return rng.integers(0, 50, size=shape).astype(np.int32)


def assert_same(got, want, words, name):
    if want is None:
        assert got is None, name
        return
    np.testing.assert_array_equal(convert.to_numpy(got, words),
                                  np.asarray(want), err_msg=name)


def step_case(rng, kind_name, flavor, b=1):
    topo = jtopo.partial_mesh(N, 4)
    p = topo.max_degree
    k, per_origin, extracts = FLAVORS[flavor]
    k = p + 1 if k == "P+1" else k
    delta, x = rand_state(rng, kind_name, b, N, U), rand_state(rng, kind_name, b, N, U)
    buf = rand_state(rng, kind_name, k, b, N, U) if k else None
    active = (rng.integers(0, 2, size=(b, N, p)) * np.asarray(topo.mask)).astype(np.int32)
    delivered = rng.integers(0, 2, size=(b, N)).astype(np.int32) if k else None
    return topo, (delta, x, buf, active, delivered), per_origin, extracts


def jx(arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


def run_port_step(arrays, topo, kind, per_origin, extracts, emit_inbox, device):
    t = [None if a is None else convert.to_torch(a, device) for a in arrays]
    return kstep.round_step(*t, convert.to_torch(np.asarray(topo.nbrs), device),
                            convert.to_torch(np.asarray(topo.rev), device),
                            kind=kind, per_origin=per_origin, extracts=extracts,
                            emit_inbox=emit_inbox)


STEP_NAMES = ("x'", "buf'", "inbox", "dsz_op", "xsz", "ssend", "cnt", "dsz")
STEP_CASES = [(k, f, False) for k in KINDS for f in FLAVORS] + \
    [("max_i32", "bprr", True), ("bitor_u32", "state", True)]


@pytest.mark.parametrize("kind_name,flavor,want_inbox", STEP_CASES)
def test_round_step_plain_vs_jax(kind_name, flavor, want_inbox, rng):
    """``want_inbox`` asks the JAX wrapper for the inbox where the flavour
    does not need it; the port's kernel emits it on ``emit_inbox``."""
    kind = KINDS[kind_name][0]
    topo, arrays, per_origin, extracts = step_case(rng, kind_name, flavor)
    emit = (arrays[2] is not None and not extracts) or want_inbox
    got = run_port_step(arrays, topo, kind, per_origin, extracts, emit, "cpu")
    kw = dict(nbrs=topo.nbrs, rev=topo.rev, kind=kind, per_origin=per_origin,
              extracts=extracts)
    pallas = jops.sync_round(*jx(arrays), want_inbox=want_inbox, **kw)
    oracle = jref.sync_round(*jx(arrays), emit_inbox=emit, **kw)
    words = kind == "bitor"
    for nm, g, pw, ow in zip(STEP_NAMES, got, pallas, oracle):
        assert_same(g, pw, words and nm in ("x'", "buf'", "inbox"), nm)
        assert_same(g, ow, words and nm in ("x'", "buf'", "inbox"), nm)


@pytest.mark.parametrize("flavor", ["classic", "bprr"])
def test_sync_round_emits_the_inbox_the_flavour_needs(flavor, rng):
    """``sync_round`` asks for the masked inbox exactly where the classic/bp
    keep gate reads it (buffered, not extracting) and is otherwise
    ``round_step`` itself."""
    topo, arrays, per_origin, extracts = step_case(rng, "max_i32", flavor)
    t = [convert.to_torch(a) for a in arrays]
    nbrs = convert.to_torch(np.asarray(topo.nbrs))
    rev = convert.to_torch(np.asarray(topo.rev))
    got = ops.sync_round(*t, nbrs=nbrs, rev=rev, kind="max",
                         per_origin=per_origin, extracts=extracts)
    want = kstep.round_step(*t, nbrs, rev, kind="max", per_origin=per_origin,
                            extracts=extracts, emit_inbox=not extracts)
    assert (got[2] is None) == extracts
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)


RECV_FLAGS = [(True, True), (False, False)]


@pytest.mark.parametrize("kind_name", sorted(KINDS))
@pytest.mark.parametrize("emit_stored,emit_cov", RECV_FLAGS)
def test_round_recv_plain_vs_jax(kind_name, emit_stored, emit_cov, rng):
    kind = KINDS[kind_name][0]
    p = 4
    d, x = rand_state(rng, kind_name, p, N, U), rand_state(rng, kind_name, N, U)
    active = rng.integers(0, 2, size=(N, p)).astype(np.int32)
    xo, s, cov, cnt, dsz = ops.round_recv(
        convert.to_torch(d), convert.to_torch(x), kind=kind,
        active=convert.to_torch(active), emit_stored=emit_stored,
        emit_cov=emit_cov)
    pallas = jops.round_recv(*jx((d, x)), kind=kind, active=jnp.asarray(active),
                             emit_stored=emit_stored, emit_cov=emit_cov)
    dm = np.where(active.T[..., None] != 0, d, np.zeros((), d.dtype))
    rx, rs, rcnt, rdsz, rcov = jref.round_recv(*jx((dm, x)), kind=kind,
                                               emit_cov=True)
    words = kind == "bitor"
    for g, pw, ow, nm in ((xo, pallas[0], rx, "x'"), (cnt, pallas[3], rcnt, "cnt"),
                          (dsz, pallas[4], rdsz, "dsz")):
        assert_same(g, pw, words and nm == "x'", nm)
        assert_same(g, ow, words and nm == "x'", nm)
    assert_same(s, pallas[1], words, "stored")
    assert_same(s, rs if emit_stored else None, words, "stored")
    assert_same(cov, pallas[2], False, "cov")
    assert_same(cov, rcov if emit_cov else None, False, "cov")


@pytest.mark.parametrize("kind_name", sorted(KINDS))
@pytest.mark.parametrize("k", [2, 5])
def test_buffer_fold_plain_vs_jax(kind_name, k, rng):
    kind = KINDS[kind_name][0]
    buf = rand_state(rng, kind_name, k, N, U)
    got = ops.buffer_fold(convert.to_torch(buf), kind=kind)
    words = kind == "bitor"
    assert_same(got, jops.buffer_fold(jnp.asarray(buf), kind=kind), words,
                "pallas")
    assert_same(got, jref.buffer_fold(jnp.asarray(buf), kind=kind), words,
                "ref")


def test_buffer_fold_folds_a_batch_of_buffers(rng):
    """A [K, B, N, U] stack of buffers folds as each [K, N, U] buffer does:
    the slot axis is the only one the fold reads across."""
    buf = convert.to_torch(rand_state(rng, "bitor_u32", 5, 3, N, U))
    whole = ops.buffer_fold(buf, kind="bitor")
    for b in range(3):
        assert torch.equal(whole[:, b], ops.buffer_fold(buf[:, b], kind="bitor"))


def test_pack_unpack_bits_vs_jax(rng):
    mask = rng.integers(0, 2, size=(N, U)).astype(bool)
    words = ops.pack_bits(torch.from_numpy(mask))
    np.testing.assert_array_equal(convert.to_numpy(words, True),
                                  np.asarray(jops.pack_bits(jnp.asarray(mask))))
    assert torch.equal(ops.unpack_bits(words, U), torch.from_numpy(mask))


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros((1, N, U), dtype=torch.float32)
    with pytest.raises(TypeError):
        _build.kernel_view(x, "max")
    with pytest.raises(TypeError):
        _build.kernel_view(x.to(torch.uint8), "bitor")
    topo = jtopo.partial_mesh(N, 4)
    nbrs = convert.to_torch(np.asarray(topo.nbrs))
    xi = x.to(torch.int32)
    with pytest.raises(ValueError):   # per-origin buffer needs P+1 slots
        ops.sync_round(xi, xi, torch.zeros((2, 1, N, U), dtype=torch.int32),
                       torch.ones((1, N, 4), dtype=torch.int32),
                       torch.ones((1, N), dtype=torch.int32), nbrs=nbrs,
                       rev=nbrs, kind="max", per_origin=True)


@pytest.mark.parametrize("dtype", [torch.int64, torch.int8, torch.float32])
def test_sync_wrappers_refuse_with_the_dtype_named(dtype):
    """The sync kernels take bool/uint8/int32 (max) and int32 words (bitor)
    only — not int8, which only the elementwise kernels take — and the
    refusal names the dtype (building its message once sorted torch
    dtypes, which raised a TypeError of its own)."""
    x = torch.zeros((3, N, U), dtype=dtype)
    for call in (lambda: ops.buffer_fold(x),
                 lambda: ops.round_recv(x, x[0]),
                 lambda: ops.digest_blocks(x[0], block_elems=8)):
        with pytest.raises(TypeError, match=f"does not take {dtype}"):
            call()


def test_round_step_shared_memory_budget():
    """The paper's mesh takes a block of 32 columns x 15 node-threads in
    21 KB; beyond 32 nodes a block keeps 32 node-threads; a working set too
    large for one block raises instead of launching."""
    assert kstep.block_rows(15, 4, 5, True, 4) == 15
    assert kstep.smem_bytes(15, 4, 5, True, 4) < 22 * 1024
    assert kstep.block_rows(40, 8, 9, True, 4) == 32
    with pytest.raises(ValueError):
        kstep.block_rows(400, 8, 9, True, 4)


@pytest.fixture
def sm90():
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("needs an sm_90 CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind_name", sorted(KINDS))
def test_cuda_kernels_vs_jax(sm90, kind_name, rng):
    kind = KINDS[kind_name][0]
    words = kind == "bitor"
    topo, arrays, _, _ = step_case(rng, kind_name, "bprr")
    got = run_port_step(arrays, topo, kind, True, True, True, sm90)
    want = jref.sync_round(*jx(arrays), nbrs=topo.nbrs, rev=topo.rev,
                           kind=kind, per_origin=True, extracts=True,
                           emit_inbox=True)
    for nm, g, w in zip(STEP_NAMES, got, want):
        assert_same(g, w, words and nm in ("x'", "buf'", "inbox"), nm)
    buf = rand_state(rng, kind_name, 5, N, U)
    assert_same(ops.buffer_fold(convert.to_torch(buf, sm90), kind=kind),
                jref.buffer_fold(jnp.asarray(buf), kind=kind), words, "fold")
