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
    """The paper's mesh (N = 15, P = 4, K = 5, int32) takes the bulk-copy
    ring of 128-column tiles, three stages and register tallies in 480
    threads within 227 KB; beyond 16 nodes a block keeps shared counters
    and at most 32 node-warps; a working set too large for every plan
    raises instead of launching."""
    pl = kstep.plan(15, 4, 5, True, 4, 4_194_304, True)
    assert (pl.bulk, pl.tile, pl.vec_bytes, pl.stages, pl.threads,
            pl.reg_tally) == (True, 128, 16, 3, 480, kstep.REG_TALLY_P)
    assert pl.smem == pl.table_bytes + pl.bar_bytes + (2 * 4 + 3 * 7) * 15 \
        * 512 <= kstep.SMEM_LIMIT
    pl = kstep.plan(40, 8, 9, True, 4, 1024, True)
    assert pl.threads == 1024 and pl.reg_tally == 0
    assert pl.smem <= kstep.SMEM_LIMIT
    with pytest.raises(ValueError):
        kstep.plan(400, 8, 9, True, 4, 1024, True)


def first_design_accepts(n, p, k, per_origin, elem_size):
    """The shapes the first round_step design took (its block_rows): a
    block of 32 columns held x, the K slots and the S sends of every node
    in shared memory."""
    s = p if per_origin else 1
    return kstep.table_bytes(n, p) + elem_size * 32 * n * (1 + k + s) \
        <= kstep.SMEM_LIMIT


@pytest.mark.parametrize("elem_size", [1, 4])
@pytest.mark.parametrize("flavor", sorted(FLAVORS))
def test_round_step_plans_cover_every_first_design_shape(flavor, elem_size):
    """Every (N, P, K, element size) that the first design took gets a
    launchable plan within 227 KB, aligned or not: a block of whole warps
    (at most 1,024 threads), ring stages 0 (direct loads) or 2-3 (bulk
    copies of 16-byte multiples), register tallies only for N <= 16 and
    P <= REG_TALLY_P."""
    k0, per_origin, _ = FLAVORS[flavor]
    taken = 0
    for n in (1, 2, 9, 15, 16, 17, 32, 33, 40, 64, 100, 200, 450, 900):
        for p in (1, 2, 3, 4, 8, 9, 16, 32, 64):
            k = p + 1 if k0 == "P+1" else k0
            if not first_design_accepts(n, p, k, per_origin, elem_size):
                continue
            taken += 1
            for u, aligned in ((1001, True), (1024, True), (1024, False),
                               (4_194_304, True)):
                pl = kstep.plan(n, p, k, per_origin, elem_size, u, aligned)
                assert pl.smem <= kstep.SMEM_LIMIT
                assert pl.threads % 32 == 0 and 32 <= pl.threads <= 1024
                assert pl.threads == 32 * (n if pl.reg_tally else min(n, 32))
                assert pl.stages in (0, 2, 3)
                assert pl.bulk <= (aligned and (u * elem_size) % 16 == 0)
                assert pl.tile * elem_size == 32 * (pl.vec_bytes or elem_size)
                assert (pl.reg_tally == kstep.REG_TALLY_P) == (
                    n <= kstep.REG_TALLY_N and p <= kstep.REG_TALLY_P)
    assert taken > 50


@pytest.mark.parametrize("n,p,k,per_origin,elem_size", [
    (15, 4, 5, True, 4),      # GMap / BitGSet bprr on mesh15d4
    (15, 4, 1, False, 4),     # classic
    (15, 4, 0, False, 4),     # state
    (15, 3, 4, True, 4),      # bprr on tree15
    (15, 4, 5, True, 1),      # bool states
])
def test_round_step_scale_shapes_take_the_bulk_path(n, p, k, per_origin,
                                                    elem_size):
    pl = kstep.plan(n, p, k, per_origin, elem_size, 4_194_304, True)
    assert pl.bulk and pl.stages >= 2 and pl.reg_tally
    # int32: 16 bytes a lane; uint8: 4 (one element a register)
    assert pl.vec_bytes == 4 * elem_size and pl.tile == 128


@pytest.mark.parametrize("elem_size", [1, 4])
@pytest.mark.parametrize("u,aligned", [(1001, True), (1500, True),
                                       (1024, False)])
def test_round_step_unaligned_rows_load_directly(u, aligned, elem_size):
    """Rows not a multiple of 16 bytes (U = 1001; the paper's bool GSet,
    U = 1,500) or a base off 16 bytes load one element a lane."""
    if u == 1500 and elem_size == 4:
        aligned = False
    pl = kstep.plan(15, 4, 5, True, elem_size, u, aligned)
    assert not pl.bulk and pl.vec_bytes == 0 and pl.tile == 32


@pytest.mark.parametrize("m,u,be,elem_size,aligned,vec", [
    (15, 4_194_304, 64, 4, True, 4),      # the scale join's digest
    (15, 2 ** 27 // 32, 64, 4, True, 4),  # BitGSet words
    (15, 1024, 8, 1, True, 1),            # be below a uint8 vector
    (15, 4096, 32, 1, True, 16),
    (9, 1001, 64, 4, True, 1),            # rows off 16 bytes
    (9, 1024, 64, 4, False, 1),           # an offset view
    (40, 70, 128, 1, True, 1),
    (15, 1000, 1024, 4, True, 4),         # one zero-padded block of 256 lanes
])
def test_digest_blocks_plan(m, u, be, elem_size, aligned, vec):
    """16-byte loads where the base, the row width and the block allow it;
    every block of every row lies in one warp task of the grid."""
    from repro_torch.kernels import digest_blocks as kdig

    pl = kdig.plan(m, u, be, elem_size, aligned)
    assert pl.vec == vec and pl.vector == (vec > 1)
    assert pl.lanes_per_block * vec == be
    assert pl.task_vectors == max(32 * kdig.UNROLL, pl.lanes_per_block)
    assert pl.task_blocks * pl.lanes_per_block == pl.task_vectors
    nb = -(-u // be)
    assert pl.grid_x * kdig.WARPS * pl.task_blocks >= nb
    assert (pl.grid_x - 1) * kdig.WARPS * pl.task_blocks < nb
    assert pl.grid_y == min(m, 65535)


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


def test_batch_layouts_on_the_cpu():
    """Every path kernel's wrapper takes a batch's leading (config, node)
    axes as rows (the port's one batch layout) — one result, the unbatched
    one row by row; ``round_recv``'s short-row path is the rows of at most
    32 vectors."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import round_recv as kr
    from repro_torch.sync import topology

    g = torch.Generator().manual_seed(3)
    b, n, u, p = 3, 6, 16, 4
    x = torch.randint(0, 5, (b, n, u), generator=g, dtype=torch.int32)
    d = torch.randint(0, 5, (p, b, n, u), generator=g, dtype=torch.int32)
    buf = torch.randint(0, 5, (p + 1, b, n, u), generator=g,
                        dtype=torch.int32)
    masks = torch.randint(0, 2, (p, b, n, 2), generator=g).bool()
    flat = ops.round_recv(d.reshape(p, b * n, u), x.reshape(b * n, u))
    got = ops.round_recv(d, x)
    for a, w in zip(got, flat):
        assert (a is None) == (w is None)
        assert w is None or torch.equal(a.reshape(w.shape), w)
    assert torch.equal(ops.buffer_fold(buf).reshape(p, b * n, u),
                       ops.buffer_fold(buf.reshape(p + 1, b * n, u)))
    assert torch.equal(ops.digest_blocks(x, block_elems=8)[1],
                       ops.digest_blocks(x[1], block_elems=8))
    assert torch.equal(ops.masked_extract(x, masks, block_elems=8)[:, 2],
                       ops.masked_extract(x[2], masks[:, 2], block_elems=8))
    topo = topology.partial_mesh(n, 4)
    act = topo.mask.to(torch.int32).expand(b, n, p).contiguous()
    dlv = torch.ones((b, n), dtype=torch.int32)
    got = ops.round_step(d[0], x, buf, act, dlv, topo.nbrs, topo.rev,
                         per_origin=True, extracts=True)
    one = ops.round_step(d[0][1:2], x[1:2], buf[:, 1:2], act[1:2],
                         dlv[1:2], topo.nbrs, topo.rev, per_origin=True,
                         extracts=True)
    assert torch.equal(got[0][1:2], one[0])
    assert torch.equal(got[1][:, 1:2], one[1])
    assert kr.short_rows(32, 4, True) and kr.short_rows(128, 4, True)
    assert not kr.short_rows(132, 4, True) and kr.short_rows(32, 4, False)
    assert not kr.short_rows(33, 4, False) and kr.short_rows(512, 1, True)
