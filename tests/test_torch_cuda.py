"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an sm_90 CUDA device and skips elsewhere; the file
imports no JAX, so it runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Inputs come from a seeded numpy generator; the kernel's output on the card
must equal the plain version's on the CPU exactly (tolerance 0), and each
wrapper must count one launch per call.
"""

import numpy as np
import pytest
import torch

from repro_torch import convert, kernels
from repro_torch.core import GCounter, GMap, GSet, LWWMap
from repro_torch.kernels import buffer_fold as kfold
from repro_torch.kernels import delta_extract as kdelta
from repro_torch.kernels import digest_blocks as kdig
from repro_torch.kernels import join as kjoin
from repro_torch.kernels import lex_join as klex
from repro_torch.kernels import masked_extract as kext
from repro_torch.kernels import ops
from repro_torch.kernels import round_recv as krecv
from repro_torch.kernels import round_step as kstep
from repro_torch.kernels import slot_bump as ksb
from repro_torch.sync import (ENGINES, DigestSpec, FaultSchedule, simulate,
                              topology, workloads)
from test_torch_slot_bump import slot_rows

KINDS = {"max_i32": ("max", np.int32), "max_bool": ("max", np.bool_),
         "bitor_u32": ("bitor", np.uint32)}
FLAVORS = {"state": (0, False, False), "classic": (1, False, False),
           "bp": ("P+1", True, False), "rr": (1, False, True),
           "bprr": ("P+1", True, True)}


@pytest.fixture
def sm90():
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("needs an sm_90 CUDA device")
    return torch.device("cuda")


def rand_state(rng, kind_name, *shape):
    dt = KINDS[kind_name][1]
    if dt == np.bool_:
        return rng.integers(0, 2, size=shape).astype(bool)
    if dt == np.uint32:
        return rng.integers(0, 2**32, size=shape, dtype=np.uint32)
    return rng.integers(0, 50, size=shape).astype(np.int32)


def both(a, dev):
    """The same numpy input on the CPU and on the card."""
    t = convert.to_torch(a)
    return t, t.to(dev)


def assert_equal(got, want, name):
    assert (got is None) == (want is None), name
    if got is not None:
        assert torch.equal(got.cpu(), want), name


def offset_view(t, offset):
    """``t`` as a view ``offset`` elements into a larger buffer (offset 1:
    not 16-byte aligned)."""
    if not offset:
        return t
    flat = torch.zeros(t.numel() + offset, dtype=t.dtype, device=t.device)
    flat[offset:] = t.reshape(-1)
    return flat[offset:].view(t.shape)


# U of the round_step / digest cases: rows not 16-byte aligned (1001, direct
# loads), whole bulk-copy tiles (1024), aligned rows with a ragged last tile
# (1000 int32; bool rows of 1000 bytes are not aligned, so 4,096 there), and
# an aligned width in a view off 16 bytes
WIDTHS = ["u1001", "u1024", "ragged", "offset"]


def width(name, kind_name):
    """(U, offset) of a WIDTHS case."""
    return {"u1001": (1001, 0), "u1024": (1024, 0), "offset": (1024, 1),
            "ragged": (4096 if kind_name == "max_bool" else 1000, 0),
            "u64": (64, 0), "u7": (7, 0)}[name]


@pytest.mark.cuda
@pytest.mark.parametrize("kind_name", sorted(KINDS))
@pytest.mark.parametrize("flavor", sorted(FLAVORS))
@pytest.mark.parametrize("topo_name", ["mesh9d4", "tree15", "mesh40d4"])
@pytest.mark.parametrize("w", WIDTHS)
def test_round_step_kernel_vs_plain(sm90, kind_name, flavor, topo_name, w,
                                    rng):
    """B = 2 configs; N = 40 takes more nodes than a block has node-warps
    (32); the widths take the direct, bulk-copy and ragged paths."""
    topo = {"mesh9d4": lambda: topology.partial_mesh(9, 4),
            "tree15": lambda: topology.tree(15),
            "mesh40d4": lambda: topology.partial_mesh(40, 4)}[topo_name]()
    (u, off), n, p, b = width(w, kind_name), topo.num_nodes, topo.max_degree, 2
    k, per_origin, extracts = FLAVORS[flavor]
    k = p + 1 if k == "P+1" else k
    arrays = [rand_state(rng, kind_name, b, n, u),
              rand_state(rng, kind_name, b, n, u),
              rand_state(rng, kind_name, k, b, n, u) if k else None,
              (rng.integers(0, 2, size=(b, n, p))
               * topo.mask.numpy()).astype(np.int32),
              rng.integers(0, 2, size=(b, n)).astype(np.int32) if k else None]
    cpu = [None if a is None else both(a, sm90)[0] for a in arrays]
    dev = [None if a is None else both(a, sm90)[1] for a in arrays]
    dev[0] = offset_view(dev[0], off)
    kind = KINDS[kind_name][0]
    for emit_inbox in (False, True):
        kw = dict(kind=kind, per_origin=per_origin, extracts=extracts,
                  emit_inbox=emit_inbox)
        n0 = kstep.launches
        got = kstep.round_step(*dev, topo.nbrs.to(sm90), topo.rev.to(sm90),
                               **kw)
        torch.cuda.synchronize()
        assert kstep.launches == n0 + 1
        want = kstep.round_step(*cpu, topo.nbrs, topo.rev, **kw)
        for nm, g, w in zip(("x'", "buf'", "inbox", "dsz_op", "xsz",
                             "ssend", "cnt", "dsz"), got, want):
            assert_equal(g, w, nm)


@pytest.mark.cuda
@pytest.mark.parametrize("kind_name", sorted(KINDS))
@pytest.mark.parametrize("emit_stored,emit_cov",
                         [(False, False), (True, False), (False, True),
                          (True, True)])
def test_round_recv_kernel_vs_plain(sm90, kind_name, emit_stored, emit_cov,
                                    rng):
    p, m, u = 4, 15, 1001
    d = both(rand_state(rng, kind_name, p, m, u), sm90)
    x = both(rand_state(rng, kind_name, m, u), sm90)
    act = both(rng.integers(0, 2, size=(m, p)).astype(np.int32), sm90)
    kw = dict(kind=KINDS[kind_name][0], emit_stored=emit_stored,
              emit_cov=emit_cov)
    n0 = krecv.launches
    got = ops.round_recv(d[1], x[1], active=act[1], **kw)
    torch.cuda.synchronize()
    assert krecv.launches == n0 + 1
    want = ops.round_recv(d[0], x[0], active=act[0], **kw)
    for nm, g, w in zip(("x'", "stored", "cov", "cnt", "dsz"), got, want):
        assert_equal(g, w, nm)


@pytest.mark.cuda
@pytest.mark.parametrize("kind_name", sorted(KINDS))
@pytest.mark.parametrize("k", [2, 5, 9])
@pytest.mark.parametrize("configs", [0, 2])
def test_buffer_fold_kernel_vs_plain(sm90, kind_name, k, configs, rng):
    """[K, N, U] and a batch [K, B, N, U] of buffers."""
    shape = (k, configs, 15, 1001) if configs else (k, 15, 1001)
    buf = both(rand_state(rng, kind_name, *shape), sm90)
    kind = KINDS[kind_name][0]
    n0 = kfold.launches
    got = ops.buffer_fold(buf[1], kind=kind)
    torch.cuda.synchronize()
    assert kfold.launches == n0 + 1
    assert_equal(got, ops.buffer_fold(buf[0], kind=kind), "sends")


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["state", "classic", "bp", "rr", "bprr"])
def test_simulate_on_the_card_matches_the_cpu(sm90, algo):
    topo = topology.partial_mesh(15, 4)
    for lat, op in ((GSet(90).lattice, workloads.gset_unique_op(15, 6)),
                    (GCounter(15).lattice, workloads.gcounter_op(15))):
        want = simulate(algo, lat, topo, op, 6, 4, device="cpu")
        for engine in ENGINES:
            kernels.reset_launches()
            got = simulate(algo, lat, topo, op, 6, 4, engine=engine)
            counts = kernels.launch_counts()
            assert counts["round_step"] == (10 if engine == "mega" else 0)
            assert counts["round_recv"] == (10 if engine == "fused" else 0)
            for nm in ("tx", "mem", "cpu", "max_mem_node"):
                np.testing.assert_array_equal(getattr(got, nm),
                                              getattr(want, nm))
            assert torch.equal(got.final_x.cpu(), want.final_x)


@pytest.mark.cuda
def test_wrappers_refuse_non_contiguous_input(sm90):
    buf = torch.zeros((64, 5, 15), dtype=torch.int32, device=sm90)
    with pytest.raises(ValueError):
        ops.buffer_fold(buf.transpose(0, 2))
    topo = topology.partial_mesh(15, 4).on(sm90)
    x = torch.zeros((1, 15, 64), dtype=torch.int32, device=sm90)
    slots = torch.zeros((1, 15, 5, 64), dtype=torch.int32, device=sm90)
    with pytest.raises(ValueError):
        kstep.round_step(x, x, slots.permute(2, 0, 1, 3),
                         torch.ones((1, 15, 4), dtype=torch.int32, device=sm90),
                         torch.ones((1, 15), dtype=torch.int32, device=sm90),
                         topo.nbrs, topo.rev, per_origin=True)


@pytest.mark.cuda
@pytest.mark.parametrize("kind_name", sorted(KINDS))
@pytest.mark.parametrize("be", [8, 32, 64, 128, 256, 1024])
def test_digest_blocks_kernel_vs_plain(sm90, kind_name, be, rng):
    """U off the block and 32-element multiples: the zero-padded last block
    enters the hash; BitGSet words with bit 31 set order as unsigned; 16-byte
    aligned rows (1024, 4,096, and 1,000 int32 with a padded last block)
    take the vector loads, a view off 16 bytes the one-element ones; be 256
    and 1,024 give blocks of more lanes than a warp."""
    kind = KINDS[kind_name][0]
    for n, u, off in ((9, 1001, 0), (15, 333, 0), (40, 70, 0),
                      (15, 1024, 0), (15, 4096, 0), (15, 1000, 0),
                      (9, 1024, 1)):
        x = both(rand_state(rng, kind_name, n, u), sm90)
        x = (x[0], offset_view(x[1], off))
        n0 = kdig.launches
        got = ops.digest_blocks(x[1], block_elems=be, kind=kind)
        torch.cuda.synchronize()
        assert kdig.launches == n0 + 1
        assert_equal(got, ops.digest_blocks(x[0], block_elems=be, kind=kind),
                     f"digest n={n} u={u}")


@pytest.mark.cuda
@pytest.mark.parametrize("kind_name", sorted(KINDS))
@pytest.mark.parametrize("be", [8, 32, 64, 128])
@pytest.mark.parametrize("p", [1, 4, 8])
def test_masked_extract_kernel_vs_plain(sm90, kind_name, be, p, rng):
    """Masks all-zero, all-one and random; rows 16-byte aligned (U = 1024)
    and not (U = 1001, 70)."""
    for n, u in ((9, 1001), (15, 1024), (40, 70)):
        nb = -(-u // be)
        x = both(rand_state(rng, kind_name, n, u), sm90)
        for masks in (np.zeros((p, n, nb), bool), np.ones((p, n, nb), bool),
                      rng.random((p, n, nb)) < 0.5):
            m = both(masks, sm90)
            n0 = kext.launches
            got = ops.masked_extract(x[1], m[1], block_elems=be)
            torch.cuda.synchronize()
            assert kext.launches == n0 + 1
            assert_equal(got, ops.masked_extract(x[0], m[0], block_elems=be),
                         f"extract n={n} u={u}")


def expected_launches(engine, algo, rounds):
    kern = engine in ("fused", "mega")
    resync = algo in ("state_driven", "digest_driven")
    return {"round_step": rounds if engine == "mega" and not resync else 0,
            "round_recv": rounds if kern and (resync or engine == "fused")
            else 0,
            "buffer_fold": rounds if engine == "fused"
            and algo in ("bp", "bprr") else 0,
            "digest_blocks": rounds if kern and algo == "digest_driven"
            else 0,
            "masked_extract": rounds if kern and algo == "digest_driven"
            else 0,
            "join": 0, "delta_extract": 0, "lex_join_delta": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["state", "classic", "bp", "rr", "bprr",
                                  "state_driven", "digest_driven"])
def test_faulted_simulate_on_the_card_matches_the_cpu(sm90, algo):
    """Loss, a partition and a down node on the paper's mesh from a
    divergent start; the kernel engines launch their kernels every round
    (mega runs the per-phase kernels for the resync modes)."""
    topo = topology.partial_mesh(15, 4)
    groups = (np.arange(15) >= 7).astype(np.int32)
    sched = FaultSchedule.partition(topo, 6, 1, 4, groups).compose(
        FaultSchedule.bernoulli(topo, 8, 0.2, seed=3)).compose(
        FaultSchedule.churn(topo, 6, [(4, 2, 5)]))
    lat, op = GMap(300).lattice, workloads.gmap_block_op(15, 300, 10)
    x0 = torch.zeros((15, 300), dtype=torch.int32)
    x0[1:, :97] = 3
    kw = dict(x0=x0, faults=sched, digest=DigestSpec(32))
    want = simulate(algo, lat, topo, op, 6, 6, device="cpu", **kw)
    for engine in ENGINES:
        kernels.reset_launches()
        got = simulate(algo, lat, topo, op, 6, 6, engine=engine, **kw)
        torch.cuda.synchronize()
        assert kernels.launch_counts() == expected_launches(engine, algo, 12)
        for nm in ("tx", "mem", "cpu", "max_mem_node", "uniform"):
            np.testing.assert_array_equal(getattr(got, nm),
                                          getattr(want, nm))
        assert torch.equal(got.final_x.cpu(), want.final_x)


# -- the elementwise kernels (join, delta_extract, lex_join_delta) -------------

ELEMENTWISE = {"max_u8": ("max", np.uint8), "max_i8": ("max", np.int8),
               "max_i32": ("max", np.int32), "max_bool": ("max", np.bool_),
               "bitor_u32": ("bitor", np.uint32)}
SHAPES = [(64,), (1000,), (7, 333), (3, 5, 129), (1, 4099)]


def elementwise_state(rng, kind_name, shape):
    dt = ELEMENTWISE[kind_name][1]
    if dt == np.bool_:
        return rng.integers(0, 2, size=shape).astype(bool)
    if dt == np.uint32:
        return rng.integers(0, 2**32, size=shape, dtype=np.uint32)
    if dt == np.int8:
        return rng.integers(-128, 128, size=shape).astype(np.int8)
    return rng.integers(0, 9, size=shape).astype(dt)


def views(a, b, dev, offset):
    """The pair on the CPU and on the card; ``offset`` > 0 makes the card's
    operands views that start ``offset`` elements into a larger buffer (not
    16-byte aligned: the kernels take their scalar path)."""
    cpu = (convert.to_torch(a), convert.to_torch(b))
    if not offset:
        return cpu, tuple(t.to(dev) for t in cpu)
    card = []
    for t in cpu:
        flat = torch.zeros(t.numel() + offset, dtype=t.dtype, device=dev)
        flat[offset:] = t.reshape(-1).to(dev)
        card.append(flat[offset:].view(t.shape))
    return cpu, tuple(card)


@pytest.mark.cuda
@pytest.mark.parametrize("kind_name", sorted(ELEMENTWISE))
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("offset", [0, 1])
def test_join_kernel_vs_plain(sm90, kind_name, shape, offset, rng):
    kind = ELEMENTWISE[kind_name][0]
    cpu, card = views(elementwise_state(rng, kind_name, shape),
                      elementwise_state(rng, kind_name, shape), sm90, offset)
    n0 = kjoin.launches
    got = ops.join(*card, kind=kind)
    torch.cuda.synchronize()
    assert kjoin.launches == n0 + 1
    assert_equal(got, ops.join(*cpu, kind=kind), "join")


@pytest.mark.cuda
@pytest.mark.parametrize("kind_name", sorted(ELEMENTWISE))
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("offset", [0, 1])
def test_delta_extract_kernel_vs_plain(sm90, kind_name, shape, offset, rng):
    kind = ELEMENTWISE[kind_name][0]
    cpu, card = views(elementwise_state(rng, kind_name, shape),
                      elementwise_state(rng, kind_name, shape), sm90, offset)
    n0 = kdelta.launches
    got = ops.delta_extract(*card, kind=kind)
    torch.cuda.synchronize()
    assert kdelta.launches == n0 + 1
    assert got[2].device.type == "cuda" and got[2].dtype == torch.int32
    for nm, g, w in zip(("s", "xj", "count"), got,
                        ops.delta_extract(*cpu, kind=kind)):
        assert_equal(g, w, nm)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("offset", [0, 1])
def test_lex_join_delta_kernel_vs_plain(sm90, shape, offset, rng):
    """Timestamps and values from a small signed range: ties, negative
    values and ⊥ pairs are frequent."""
    a = [rng.integers(-2, 4, size=shape).astype(np.int32) for _ in range(4)]
    cpu_a, card_a = views(a[0], a[1], sm90, offset)
    cpu_b, card_b = views(a[2], a[3], sm90, offset)
    n0 = klex.launches
    got = ops.lex_join_delta(card_a, card_b)
    torch.cuda.synchronize()
    assert klex.launches == n0 + 1
    want = ops.lex_join_delta(cpu_a, cpu_b)
    for nm, g, w in zip(("t", "v"), got[0], want[0]):
        assert_equal(g, w, nm)
    for nm, g, w in zip(("dt", "dv"), got[1], want[1]):
        assert_equal(g, w, nm)
    assert_equal(got[2], want[2], "count")


@pytest.mark.cuda
def test_elementwise_wrappers_refuse_non_contiguous_input(sm90):
    a = torch.zeros((64, 8), dtype=torch.int32, device=sm90).T
    with pytest.raises(ValueError):
        ops.join(a, a)
    with pytest.raises(ValueError):
        ops.delta_extract(a, a)
    with pytest.raises(ValueError):
        ops.lex_join_delta((a, a), (a, a))


def lww_op(n, u):
    keys = torch.arange(n)[:, None] * 7 + torch.arange(3)

    def op(x, t):
        ts, vals = x
        rows = torch.arange(n, device=ts.device)[:, None].expand(n, 3)
        k = ((keys + t) % u).to(ts.device)
        dt, dv = torch.zeros_like(ts), torch.zeros_like(vals)
        dt[rows, k] = ts[rows, k] + 1
        dv[rows, k] = ((rows * 3 + t) % 5 - 2).to(vals.dtype)
        return (dt, dv)

    return op


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["classic", "bprr", "state_driven",
                                  "digest_driven"])
def test_lww_simulate_on_the_card_matches_the_cpu(sm90, algo):
    """LWWMap under loss and churn from a divergent start: every engine
    name runs the reference round, launches no kernel, and equals the CPU
    run."""
    topo = topology.partial_mesh(15, 4)
    sched = FaultSchedule.bernoulli(topo, 8, 0.2, seed=3).compose(
        FaultSchedule.churn(topo, 6, [(4, 2, 5)]))
    u = 300
    x0 = (torch.zeros((15, u), dtype=torch.int32),
          torch.zeros((15, u), dtype=torch.int32))
    x0[0][1:, :97], x0[1][1:, :97] = 2, -1
    kw = dict(x0=x0, faults=sched, digest=DigestSpec(32))
    lat, op = LWWMap(u).lattice, lww_op(15, u)
    want = simulate(algo, lat, topo, op, 6, 6, device="cpu", **kw)
    for engine in ENGINES:
        kernels.reset_launches()
        got = simulate(algo, lat, topo, op, 6, 6, engine=engine, **kw)
        torch.cuda.synchronize()
        assert sum(kernels.launch_counts().values()) == 0
        for nm in ("tx", "mem", "cpu", "max_mem_node", "uniform"):
            np.testing.assert_array_equal(getattr(got, nm),
                                          getattr(want, nm))
        for g, w in zip(got.final_x, want.final_x):
            assert torch.equal(g.cpu(), w)


# -- the batch axes and the store's shapes ---------------------------------------

# Rows of the short-row path (at most 32 vectors: U = 32 / 64 int32 in
# 16-byte vectors, 24 bools and 5 int32 one element a lane, 3 words) and a
# long row (200 int32), each over more rows than a grid dimension holds.
RECV_ROWS = [("max_i32", 32), ("max_i32", 64), ("max_i32", 5),
             ("max_bool", 32), ("max_bool", 24), ("bitor_u32", 3),
             ("max_i32", 200)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind_name,u", RECV_ROWS)
def test_round_recv_beyond_65535_rows(sm90, kind_name, u, rng):
    p, m = 4, 70_001
    elem = 1 if kind_name == "max_bool" else 4
    assert krecv.short_rows(u, elem, (u * elem) % 16 == 0) == (u != 200)
    d = both(rand_state(rng, kind_name, p, m, u), sm90)
    x = both(rand_state(rng, kind_name, m, u), sm90)
    act = both(rng.integers(0, 2, size=(m, p)).astype(np.int32), sm90)
    kw = dict(kind=KINDS[kind_name][0], emit_stored=True, emit_cov=True)
    n0 = krecv.launches
    got = ops.round_recv(d[1], x[1], active=act[1], **kw)
    torch.cuda.synchronize()
    assert krecv.launches == n0 + 1
    want = ops.round_recv(d[0], x[0], active=act[0], **kw)
    for nm, g, w in zip(("x'", "stored", "cov", "cnt", "dsz"), got, want):
        assert_equal(g, w, nm)


@pytest.mark.cuda
@pytest.mark.parametrize("kind_name,u", RECV_ROWS)
def test_round_recv_grid_strides(sm90, kind_name, u, rng, monkeypatch):
    """With the grid capped at 3 blocks, every short-row warp and every
    long-row gridDim.y row walks its grid-stride loop many times (the
    store's shapes need 2^20 blocks before the cap bites), equal to the
    plain version."""
    monkeypatch.setattr(krecv, "MAX_BLOCKS", 3)
    p, m = 4, 1_001
    d = both(rand_state(rng, kind_name, p, m, u), sm90)
    x = both(rand_state(rng, kind_name, m, u), sm90)
    act = both(rng.integers(0, 2, size=(m, p)).astype(np.int32), sm90)
    kw = dict(kind=KINDS[kind_name][0], emit_stored=True, emit_cov=True)
    got = ops.round_recv(d[1], x[1], active=act[1], **kw)
    want = ops.round_recv(d[0], x[0], active=act[0], **kw)
    for nm, g, w in zip(("x'", "stored", "cov", "cnt", "dsz"), got, want):
        assert_equal(g, w, nm)


@pytest.mark.cuda
@pytest.mark.parametrize("flavor", ["bprr", "classic", "state"])
@pytest.mark.parametrize("u", [32, 64, 160])
def test_round_step_beyond_65535_configs(sm90, flavor, u, rng):
    """More configs than a grid dimension holds, equal to the plain version
    on the card. Short rows (U = 32, 64 int32) take one persistent launch
    and count one; long rows (U = 160: 40 lane vectors) are cut into
    chunks of 65,535 configs and count two."""
    topo = topology.partial_mesh(16, 4).on(sm90)
    n, p, b = 16, 4, 3_001 if u == 64 else 65_537
    k, per_origin, extracts = FLAVORS[flavor]
    k = p + 1 if k == "P+1" else k
    g = torch.Generator(device=sm90).manual_seed(u)

    def ints(*shape):
        return torch.randint(0, 50, shape, generator=g, device=sm90,
                             dtype=torch.int32)

    delta, x = ints(b, n, u), ints(b, n, u)
    buf = ints(k, b, n, u) if k else None
    active = (torch.randint(0, 2, (b, n, p), generator=g, device=sm90,
                            dtype=torch.int32) * topo.mask).to(torch.int32)
    dlv = torch.randint(0, 2, (b, n), generator=g, device=sm90,
                        dtype=torch.int32) if k else None
    kw = dict(kind="max", per_origin=per_origin, extracts=extracts,
              emit_inbox=not extracts and k > 0)
    n0 = kstep.launches
    got = ops.round_step(delta, x, buf, active, dlv, topo.nbrs, topo.rev,
                         **kw)
    torch.cuda.synchronize()
    pl = kstep.last_launch[0]
    assert pl.short == (u != 160)
    assert kstep.launches == n0 + (1 if pl.short else 2) \
        == n0 + kstep.launches_for(b, pl)
    want = kstep.plain(delta, x, buf, active, dlv, topo.nbrs, topo.rev, **kw)
    for nm, a, w in zip(("x'", "buf'", "inbox", "dsz_op", "xsz", "ssend",
                         "cnt", "dsz"), got, want):
        assert (a is None) == (w is None), nm
        if a is not None:
            assert torch.equal(a, w), nm


# the short-row grid: widths about the 32-vector threshold (U = 33 int32 is
# 33 four-byte lanes: long; bool rows of 33-128 bytes are short), node
# counts about a warp and beyond 1,024 threads (N = 64, U = 128 int32)
SHORT_U = (1, 7, 31, 32, 33, 64, 100, 128)
SHORT_N = (3, 15, 16, 17, 50, 64)


def round_case(rng, kind_name, flavor, b, n, u):
    """Numpy operands of one round on partial_mesh(n, 4) (n = 3: degree 2)
    with random active and delivered masks, and the topology."""
    topo = topology.partial_mesh(n, 4 if n > 4 else 2)
    p = topo.max_degree
    k, per_origin, extracts = FLAVORS[flavor]
    k = p + 1 if k == "P+1" else k
    arrays = [rand_state(rng, kind_name, b, n, u),
              rand_state(rng, kind_name, b, n, u),
              rand_state(rng, kind_name, k, b, n, u) if k else None,
              (rng.integers(0, 2, size=(b, n, p))
               * topo.mask.numpy()).astype(np.int32),
              rng.integers(0, 2, size=(b, n)).astype(np.int32) if k else None]
    return topo, arrays, k, per_origin, extracts


@pytest.mark.cuda
@pytest.mark.parametrize("kind_name", sorted(KINDS))
@pytest.mark.parametrize("flavor", sorted(FLAVORS))
def test_round_step_short_kernel_vs_plain(sm90, kind_name, flavor, rng):
    """Every U of SHORT_U and N of SHORT_N at B = 1, g - 1 and g + 1 (g the
    plan's configs a block; B = 3,001 at N = 16, U = 32), the inbox on and
    off in turns, every fourth case δ in a view off 16 bytes: bit for bit
    the plain version, on the kernel the plan names (short where
    ``short_plans`` has a plan), one launch counted; and under every other
    ring plan of the ladder (16-byte rows: senders in other warps, other
    configs a block), one ring launch counted."""
    from repro_torch.kernels import _build as KB

    kind = KINDS[kind_name][0]
    elem = 1 if kind_name == "max_bool" else 4
    case = 0
    for n in SHORT_N:
        for u in SHORT_U:
            off = int(case % 4 == 3)
            topo, _, k, per_origin, extracts = round_case(
                rng, kind_name, flavor, 1, n, 1)
            p = topo.max_degree
            aligned = not off
            g = kstep.plan(n, p, k, per_origin, elem, u, aligned).configs
            bs = sorted({1, max(1, g - 1), g + 1}
                        | ({3_001} if (n, u) == (16, 32) else set()))
            for b in bs:
                topo, arrays, k, per_origin, extracts = round_case(
                    rng, kind_name, flavor, b, n, u)
                cpu = [None if a is None else both(a, sm90)[0]
                       for a in arrays]
                dev = [None if a is None else both(a, sm90)[1]
                       for a in arrays]
                dev[0] = offset_view(dev[0], off)
                kw = dict(kind=kind, per_origin=per_origin,
                          extracts=extracts, emit_inbox=bool(case % 2))
                case += 1
                n0 = kstep.launches
                got = kstep.round_step(*dev, topo.nbrs.to(sm90),
                                       topo.rev.to(sm90), **kw)
                torch.cuda.synchronize()
                pl = kstep.last_launch[0]
                assert pl.short == bool(kstep.short_plans(
                    n, p, k, per_origin, elem, u, aligned)), (n, u, pl)
                assert kstep.launches == n0 + 1
                want = kstep.round_step(*cpu, topo.nbrs, topo.rev, **kw)
                for nm, a, w in zip(("x'", "buf'", "inbox", "dsz_op", "xsz",
                                     "ssend", "cnt", "dsz"), got, want):
                    assert_equal(a, w, f"{nm} n={n} u={u} b={b} off={off}")
                rings = [q for q in kstep.plans(n, p, k, per_origin, elem, u,
                                                aligned)
                         if q.short and q.bulk and q != pl]
                views = [None if t is None else KB.kernel_view(t, kind)
                         for t in dev[:3]]
                for q in rings:
                    r0 = kstep.ring_launches
                    got = kstep._launch(*views, *dev[3:], topo.nbrs.to(sm90),
                                        topo.rev.to(sm90), kind, per_origin,
                                        extracts, kw["emit_inbox"], pl=q)
                    torch.cuda.synchronize()
                    assert kstep.ring_launches == r0 + 1
                    for nm, a, w in zip(("x'", "buf'", "inbox", "dsz_op",
                                         "xsz", "ssend", "cnt", "dsz"), got,
                                        want):
                        assert_equal(a, w, f"{nm} n={n} u={u} b={b} {q}")


@pytest.mark.cuda
@pytest.mark.parametrize("flavor", sorted(FLAVORS))
@pytest.mark.parametrize("n,u", [(16, 32), (50, 64), (15, 7), (3, 64),
                                 (17, 32)])
def test_round_step_short_grid_strides(sm90, flavor, n, u, rng,
                                       monkeypatch):
    """With the short-row grid capped at 3 blocks, every block walks many
    groups of configs (the store's shapes walk 8-114 groups a block; every
    stage of the ring is refilled many times over, and B = 301 leaves a
    last group short of g configs), under every short-row plan, equal to
    the plain version."""
    monkeypatch.setattr(kstep, "MAX_BLOCKS", 3)
    topo, arrays, k, per_origin, extracts = round_case(
        rng, "max_i32", flavor, 301, n, u)
    dev = [None if a is None else both(a, sm90)[1] for a in arrays]
    args = (*dev, topo.nbrs.to(sm90), topo.rev.to(sm90), "max", per_origin,
            extracts, True)
    want = kstep.plain(*args)
    cands = kstep.short_plans(n, topo.max_degree, k, per_origin, 4, u, True)
    assert cands
    for pl in cands:
        got = kstep._launch(*args, pl=pl)
        torch.cuda.synchronize()
        assert kstep.last_launch == (pl, 3)
        for nm, a, w in zip(("x'", "buf'", "inbox", "dsz_op", "xsz",
                             "ssend", "cnt", "dsz"), got, want):
            assert (a is None) == (w is None), (pl, nm)
            if a is not None:
                assert torch.equal(a, w), (pl, nm)


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [30_000, 196_608])
def test_round_step_store_shapes_run_the_ring(sm90, nb):
    """The Retwis store cells' round ([30,000, 50, 64] bprr, and a card's
    block of the 786,432-object store, [196,608, 50, 64]) runs the
    short-row ring: three rounds count three launches and three ring
    launches; at 30,000 configs the round equals the plain version."""
    topo = topology.partial_mesh(50, 4).on(sm90)
    n, p, u = 50, topo.max_degree, 64
    g = torch.Generator(device=sm90).manual_seed(nb)

    def ints(*shape):
        return torch.randint(0, 50, shape, generator=g, device=sm90,
                             dtype=torch.int32)

    torch.cuda.empty_cache()
    args = (ints(nb, n, u), ints(nb, n, u), ints(p + 1, nb, n, u),
            topo.mask.to(torch.int32).expand(nb, n, p).contiguous(),
            ints(nb, n) % 2, topo.nbrs, topo.rev)
    kw = dict(kind="max", per_origin=True, extracts=True)
    n0, r0 = kstep.launches, kstep.ring_launches
    for _ in range(3):
        got = ops.round_step(*args, **kw)
    torch.cuda.synchronize()
    pl = kstep.last_launch[0]
    assert pl.short and pl.bulk and pl.stages >= 2 and pl.configs == 1
    assert kstep.launches - n0 == kstep.ring_launches - r0 == 3
    if nb == 30_000:
        want = kstep.plain(*args, **kw)
        for nm, a, w in zip(("x'", "buf'", "inbox", "dsz_op", "xsz",
                             "ssend", "cnt", "dsz"), got, want):
            assert (a is None) == (w is None), nm
            if a is not None:
                assert torch.equal(a, w), nm
    del got, args
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("kind_name", sorted(KINDS))
def test_path_kernels_take_batch_axes(sm90, kind_name, rng):
    """The five path kernels on a batch's [B, N, U] (and slot-major
    [K, B, N, U]) operands, against their plain versions on the CPU."""
    b, n, u, p, be = 300, 16, 64, 4, 8
    kind = KINDS[kind_name][0]
    x = both(rand_state(rng, kind_name, b, n, u), sm90)
    buf = both(rand_state(rng, kind_name, p + 1, b, n, u), sm90)
    d = both(rand_state(rng, kind_name, p, b, n, u), sm90)
    act = both(rng.integers(0, 2, size=(b, n, p)).astype(np.int32), sm90)
    masks = both(rng.integers(0, 2, size=(p, b, n, u // be)).astype(bool),
                 sm90)
    got = ops.round_recv(d[1], x[1], kind=kind, active=act[1])
    want = ops.round_recv(d[0], x[0], kind=kind, active=act[0])
    for nm, g, w in zip(("x'", "stored", "cov", "cnt", "dsz"), got, want):
        assert_equal(g, w, f"round_recv {nm}")
    assert_equal(ops.buffer_fold(buf[1], kind=kind),
                 ops.buffer_fold(buf[0], kind=kind), "buffer_fold")
    assert_equal(ops.digest_blocks(x[1], block_elems=be, kind=kind),
                 ops.digest_blocks(x[0], block_elems=be, kind=kind),
                 "digest_blocks")
    if kind == "max":
        assert_equal(ops.masked_extract(x[1], masks[1], block_elems=be),
                     ops.masked_extract(x[0], masks[0], block_elems=be),
                     "masked_extract")
    topo = topology.partial_mesh(n, 4)
    dlv = both(rng.integers(0, 2, size=(b, n)).astype(np.int32), sm90)
    got = ops.round_step(d[1][0], x[1], buf[1], act[1], dlv[1],
                         topo.nbrs.to(sm90), topo.rev.to(sm90), kind=kind,
                         per_origin=True, extracts=True)
    want = ops.round_step(d[0][0], x[0], buf[0], act[0], dlv[0], topo.nbrs,
                          topo.rev, kind=kind, per_origin=True, extracts=True)
    for nm, g, w in zip(("x'", "buf'", "inbox", "dsz_op", "xsz", "ssend",
                         "cnt", "dsz"), got, want):
        assert_equal(g, w, f"round_step {nm}")


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("lead", [(300, 16), (4099,)], ids=["BN", "N"])
@pytest.mark.parametrize("u", [1, 3, 8, 32, 64, 100])
def test_slot_bump_kernel_vs_plain(sm90, u, lead, offset, rng):
    """The versioned-slot kernel equals its plain version bit for bit, on
    the vector path (U = 32, 64 on aligned bases) and the row path (U = 1,
    3, 8, 100, and x one element off a 16-byte boundary), one launch a
    call."""
    x, cnt = slot_rows(rng, lead, u)
    xc, xd = both(x, sm90)
    cc, cd = both(cnt, sm90)
    n0 = ksb.launches
    got = ksb.slot_bump(offset_view(xd, offset), cd, u)
    torch.cuda.synchronize()
    assert ksb.launches == n0 + 1
    assert got.dtype == torch.int32 and got.is_contiguous()
    assert torch.equal(got.cpu(), ksb.plain(xc, cc, u))


@pytest.mark.cuda
@pytest.mark.parametrize("u", [3, 32, 64])
def test_slot_bump_grid_strides(sm90, u, rng, monkeypatch):
    """With the grid capped at one block (8 warps, 256 rows a sweep),
    its warps walk 5,001 rows, equal to the plain version."""
    monkeypatch.setattr(ksb, "MAX_BLOCKS", 1)
    x, cnt = slot_rows(rng, (5001,), u)
    xc, xd = both(x, sm90)
    cc, cd = both(cnt, sm90)
    got = ksb.slot_bump(xd, cd, u)
    assert torch.equal(got.cpu(), ksb.plain(xc, cc, u))


@pytest.mark.cuda
def test_slot_bump_refuses_what_the_kernel_does_not_take(sm90):
    x = torch.zeros((6, 5, 8), dtype=torch.int32, device=sm90)
    cnt = torch.ones((6, 5), dtype=torch.int32, device=sm90)
    n0 = ksb.launches
    for bad_x, bad_cnt, slots, err in (
            (x.transpose(0, 1), cnt.T, 8, ValueError),      # non-contiguous
            (x.long(), cnt, 8, TypeError),
            (x, cnt.long(), 8, TypeError),
            (x, cnt[:, :4], 8, ValueError),
            (x, cnt, 4, ValueError),
            (x, cnt.cpu(), 8, ValueError)):
        with pytest.raises(err):
            ksb.slot_bump(bad_x, bad_cnt, slots)
    assert ksb.launches == n0


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", [1, 3])
def test_store_op_stream_launches_once_a_round_a_block(sm90, blocks):
    """A Retwis store on the card runs its op stream through the kernel:
    one launch a block for its check at set-up and one a block for each
    active round, none in the quiet rounds; equal to the CPU run."""
    from repro_torch.sync import simulate_store

    lat, topo, spec = retwis_store()
    want = simulate_store("bprr", lat, topo, spec, 6, 4, device="cpu")
    n0 = ksb.launches
    got = simulate_store("bprr", lat, topo, spec, 6, 4, engine="mega",
                         shard=True, device=["cuda:0"] * blocks)
    assert ksb.launches - n0 == blocks * (6 + 1)
    assert torch.equal(got.final_x.cpu(), want.final_x)
    np.testing.assert_array_equal(got.tx, want.tx)


def retwis_store(objects=40, nodes=16, slots=32, rounds=6, ops=6):
    from repro_torch.core import MapLattice
    from repro_torch.core import value_lattices as vl
    from repro_torch.sync import StoreSpec

    wl = workloads.retwis(objects, nodes, rounds, ops, 1.0, seed=0)
    lat = MapLattice(slots, vl.max_int(), "retwis").build()
    spec = StoreSpec(objects=objects,
                     op_fn=workloads.versioned_slot_op(wl.update_counts(),
                                                       slots),
                     weights=workloads.retwis_weights(objects))
    return lat, topology.partial_mesh(nodes, 4), spec


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["classic", "bprr", "state_driven",
                                  "digest_driven"])
def test_store_on_the_card_matches_the_cpu(sm90, algo):
    from repro_torch.sync import simulate_store

    lat, topo, spec = retwis_store()
    want = simulate_store(algo, lat, topo, spec, 6, 4, device="cpu",
                          digest=DigestSpec(8))
    for engine in ENGINES:
        got = simulate_store(algo, lat, topo, spec, 6, 4, engine=engine,
                             digest=DigestSpec(8))
        for nm in ("tx", "mem", "cpu", "max_mem_node"):
            np.testing.assert_array_equal(getattr(got, nm),
                                          getattr(want, nm))
        np.testing.assert_array_equal(got.final_state_bytes,
                                      want.final_state_bytes)
        assert torch.equal(got.final_x.cpu(), want.final_x)


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["classic", "bprr", "digest_driven"])
def test_sweep_on_the_card_matches_the_cpu(sm90, algo):
    from repro_torch.sync import SweepSpec, simulate_sweep

    topo = topology.partial_mesh(15, 4)
    n, events = 15, 6
    scheds = [None, FaultSchedule.bernoulli(topo, events, 0.2, seed=3),
              FaultSchedule.partition(topo, events, 1, 4,
                                      (np.arange(n) >= 7).astype(np.int32))]
    spec = SweepSpec(batch=3, op_fn=workloads.gset_unique_sweep_op(
        n, events, (0, 3, 11)), faults=scheds)
    lat = GSet(n * events).lattice
    want = simulate_sweep(algo, lat, topo, spec, events, 6, device="cpu",
                          digest=DigestSpec(8))
    for engine in ENGINES:
        got = simulate_sweep(algo, lat, topo, spec, events, 6, engine=engine,
                             digest=DigestSpec(8))
        for nm in ("tx", "mem", "cpu", "max_mem_node", "uniform"):
            np.testing.assert_array_equal(getattr(got, nm),
                                          getattr(want, nm))
        assert torch.equal(got.final_x.cpu(), want.final_x)


@pytest.mark.cuda
@pytest.mark.parametrize("kind_name", sorted(KINDS))
def test_mega_round_with_the_inbox_and_extracts(sm90, kind_name, rng):
    """The flags the provenance path adds: ``ops.sync_round`` of a bprr
    round (extracts) with ``want_inbox``, and of a state round (no buffer)
    with ``want_inbox``, on the card against the CPU; then a small mega
    bprr run with telemetry and provenance on the card against the CPU."""
    from repro_torch.obs import ProvenanceSpec, TelemetrySpec

    topo = topology.partial_mesh(15, 4)
    b, n, u, p = 2, 15, 200, 4
    d = both(rand_state(rng, kind_name, b, n, u), sm90)
    x = both(rand_state(rng, kind_name, b, n, u), sm90)
    buf = both(rand_state(rng, kind_name, p + 1, b, n, u), sm90)
    act = both((rng.integers(0, 2, size=(b, n, p))
                * topo.mask.numpy()).astype(np.int32), sm90)
    dlv = both(rng.integers(0, 2, size=(b, n)).astype(np.int32), sm90)
    kind = KINDS[kind_name][0]
    for bf, dl, flags in ((buf, dlv, dict(per_origin=True, extracts=True)),
                          ((None, None), (None, None), {})):
        n0 = kstep.launches
        got = ops.sync_round(d[1], x[1], bf[1], act[1], dl[1],
                             nbrs=topo.nbrs.to(sm90), rev=topo.rev.to(sm90),
                             kind=kind, want_inbox=True, **flags)
        torch.cuda.synchronize()
        assert kstep.launches == n0 + 1
        want = ops.sync_round(d[0], x[0], bf[0], act[0], dl[0],
                              nbrs=topo.nbrs, rev=topo.rev, kind=kind,
                              want_inbox=True, **flags)
        assert got[2] is not None
        for nm, g, w in zip(("x'", "buf'", "inbox", "dsz_op", "xsz",
                             "ssend", "cnt", "dsz"), got, want):
            assert_equal(g, w, f"sync_round {nm} {flags}")
    if kind_name != "max_i32":
        return
    lat, op = GSet(15 * 6).lattice, workloads.gset_unique_op(15, 6)
    kw = dict(telemetry=TelemetrySpec(), provenance=ProvenanceSpec(),
              faults=FaultSchedule.bernoulli(topo, 6, 0.1, seed=7))
    want = simulate("bprr", lat, topo, op, 6, 4, device="cpu", **kw)
    got = simulate("bprr", lat, topo, op, 6, 4, engine="mega", **kw)
    for f in want.telemetry._fields[:6]:
        np.testing.assert_array_equal(getattr(got.telemetry, f),
                                      getattr(want.telemetry, f))
    for f in want.provenance._fields[:10]:
        g, w = getattr(got.provenance, f), getattr(want.provenance, f)
        if isinstance(g, torch.Tensor):
            assert torch.equal(g.cpu(), w), f
        else:
            np.testing.assert_array_equal(g, w)


@pytest.mark.cuda
def test_runtime_on_the_card_matches_the_cpu(sm90):
    """The elastic-churn fleet (membership, heartbeats, progress, the
    checkpoint registry and a shard ledger) on the card equals its CPU
    run, with the JAX example's numbers."""
    from repro_torch.elastic_churn import Fleet, run

    fleet = Fleet(ledger=64)
    want = run(fleet, "cpu", verbose=False)
    got = run(fleet, "cuda", verbose=False)
    for k in ("detected", "plans", "bootstrap", "latest_step", "progress",
              "rx_novel", "rx_redundant", "sent_elements", "converged",
              "drain_rounds"):
        assert got[k] == want[k], k
    for name, a in want["final"].items():
        np.testing.assert_array_equal(got["final"][name], a, err_msg=name)
    plain = run(Fleet(), "cuda", verbose=False)
    assert (plain["detected"], plain["bootstrap"], plain["latest_step"],
            plain["progress"], plain["rx_novel"], plain["rx_redundant"]) \
        == ({7: 10}, [78], 19, 142_336, 5_815, 13_316)


def _launched(fn):
    """``fn()`` and the kernel launches it made."""
    before = kernels.launch_counts()
    out = fn()
    return out, {k: v - before[k] for k, v in kernels.launch_counts().items()}


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", [1, 3, 5])
def test_padded_and_sharded_store_on_the_card(sm90, blocks):
    """The Retwis store over ``["cuda:0"] * k`` blocks (padded where k does
    not divide the objects) equals the unsharded run and launches each
    round's kernels once a block: one block issues exactly the unsharded
    run's launches."""
    from repro_torch.sync import simulate_store

    lat, topo, spec = retwis_store()
    for engine in ENGINES:
        want, w_launches = _launched(lambda: simulate_store(
            "bprr", lat, topo, spec, 6, 4, engine=engine))
        got, g_launches = _launched(lambda: simulate_store(
            "bprr", lat, topo, spec, 6, 4, engine=engine, shard=True,
            device=["cuda:0"] * blocks))
        assert g_launches == {k: v * blocks for k, v in w_launches.items()}
        for nm in ("tx", "mem", "cpu", "max_mem_node"):
            np.testing.assert_array_equal(getattr(got, nm),
                                          getattr(want, nm))
        assert torch.equal(got.final_x, want.final_x)
        np.testing.assert_array_equal(got.final_state_bytes,
                                      want.final_state_bytes)
        padded = simulate_store("bprr", lat, topo, spec, 6, 4,
                                engine=engine, pad_to=blocks + 1)
        np.testing.assert_array_equal(padded.tx, want.tx)
        assert torch.equal(padded.final_x, want.final_x)
        red = simulate_store("bprr", lat, topo, spec, 6, 4, engine=engine,
                             shard=True, object_metrics=False,
                             device=["cuda:0"] * blocks)
        assert red.sim.tx.shape[0] == blocks
        np.testing.assert_array_equal(red.store_tx, want.store_tx)
        np.testing.assert_array_equal(red.store_max_mem_node,
                                      want.store_max_mem_node)


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["bprr", "digest_driven"])
def test_sharded_runs_over_several_cards(sm90, algo):
    """A store and a sweep with one block a card (``device="cuda"`` over
    every visible card) equal their CPU runs on every engine, with the
    last card current: each kernel launches on the card that holds its
    block, whichever card is current. Skips with fewer than two cards."""
    from repro_torch.sync import SweepSpec, simulate_store, simulate_sweep

    k = torch.cuda.device_count()
    if k < 2:
        pytest.skip("needs two CUDA devices or more")
    lat, topo, spec = retwis_store(objects=8 * k + 3)   # pads to 9k
    n, events = 15, 6
    gtopo, glat = topology.partial_mesh(n, 4), GSet(n * events).lattice
    sweep = SweepSpec(batch=2 * k, op_fn=workloads.gset_unique_sweep_op(
        n, events, tuple(range(2 * k))))
    kw = dict(digest=DigestSpec(8))
    want = simulate_store(algo, lat, topo, spec, 6, 4, device="cpu", **kw)
    want_sw = simulate_sweep(algo, glat, gtopo, sweep, events, 4,
                             device="cpu", **kw)
    for engine in ENGINES:
        with torch.cuda.device(k - 1):
            got, used = _launched(lambda: simulate_store(
                algo, lat, topo, spec, 6, 4, engine=engine, shard=True,
                device="cuda", **kw))
            got_sw = simulate_sweep(algo, glat, gtopo, sweep, events, 4,
                                    engine=engine, shard=True,
                                    device="cuda", **kw)
        assert (sum(used.values()) > 0) == (engine != "reference")
        for nm in ("tx", "mem", "cpu", "max_mem_node"):
            np.testing.assert_array_equal(getattr(got, nm),
                                          getattr(want, nm))
            np.testing.assert_array_equal(getattr(got_sw, nm),
                                          getattr(want_sw, nm))
        assert got.final_x.device == torch.device("cuda", 0)
        assert torch.equal(got.final_x.cpu(), want.final_x)
        assert torch.equal(got_sw.final_x.cpu(), want_sw.final_x)


# -- the model side: the decoder stack and the server on the card ---------------

# Card and CPU round the same bf16 operations but sum products in other
# orders (cuBLAS against oneDNN), so a value may differ by an ulp in any
# layer: 8 bf16 epsilons (0.0625, atol = rtol), as the CPU parity tests
# hold the port to the JAX package.
MODEL_TOL = 8 * torch.finfo(torch.bfloat16).eps


def _model_inputs(cfg, b, s, rng):
    from repro_torch.models import transformer as TT

    f = cfg.frontend_len if cfg.frontend == "vision" else 0
    batch = {}
    if cfg.frontend is not None:
        n = s if cfg.frontend == "audio" else f
        batch["embeds"] = torch.tensor(rng.normal(size=(b, n, cfg.d_model)),
                                       dtype=torch.bfloat16)
    if cfg.frontend != "audio":
        batch["tokens"] = torch.tensor(
            rng.integers(0, cfg.vocab_size, (b, s - f)), dtype=torch.int32)
    return TT, batch


def _close(got, want, what):
    torch.testing.assert_close(got.float().cpu(), want.float(),
                               rtol=MODEL_TOL, atol=MODEL_TOL, msg=what)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepseek-coder-33b", "gemma2-27b",
                                  "qwen3-0.6b", "qwen2.5-14b",
                                  "mixtral-8x22b", "qwen3-moe-30b-a3b",
                                  "recurrentgemma-2b", "rwkv6-1.6b",
                                  "musicgen-large", "internvl2-26b"])
def test_model_on_the_card_matches_the_cpu(sm90, arch, rng):
    """Every smoke config: prefill (logits, cache) and 6 decode steps on the
    card against the CPU run with the same weights (copied, not redrawn)
    and inputs; then, for the text configs, ``generate``'s tokens equal
    wherever the CPU step's top-1/top-2 margin exceeds twice the
    tolerance. No sync kernel is launched."""
    from repro_torch import convert
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve
    from repro_torch.train import steps as TS

    cfg = get_smoke_config(arch)
    TT, batch = _model_inputs(cfg, 2, 24, rng)
    card = TT.init_params(cfg, seed=0, device=sm90)
    cpu = card.copy_to("cpu")
    before = kernels.launch_counts()
    prefill, decode = TS.make_prefill(cfg), TS.make_decode(cfg)
    steps = 6
    with torch.no_grad():
        runs = []
        for model, dev in ((cpu, "cpu"), (card, sm90)):
            bt = {k: v.to(dev) for k, v in batch.items()}
            cache = TT.init_cache(cfg, 2, 24 + steps, device=dev)
            feats, cache, _ = TT.forward(cfg, model, bt, mode="prefill",
                                         cache=cache)
            logits = [TT.lm_head(cfg, model, feats[:, -1:])]
            for i in range(steps):
                if cfg.frontend == "audio":
                    step = {"embeds": batch["embeds"][:, i:i + 1].to(dev)}
                else:
                    step = {"tokens": torch.full((2, 1), 7 + i,
                                                 dtype=torch.int32,
                                                 device=dev)}
                lg, cache = decode(model, cache, step, 24 + i)
                logits.append(lg)
            runs.append((logits, convert.cache_to_numpy(cfg, cache)))
    (want, want_cache), (got, got_cache) = runs
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.device.type == "cuda"
        _close(g, w, f"{arch} step {i}")
    def leaves(c):
        return [leaf for layer in c["blocks"] + c["tail"]
                for leaf in layer.values()]

    for i, (g, w) in enumerate(zip(leaves(got_cache), leaves(want_cache))):
        _close(torch.from_numpy(g), torch.from_numpy(w),
               f"{arch} cache leaf {i}")
    lg, _ = prefill(card, {k: v.to(sm90) for k, v in batch.items()})
    _close(lg, want[0], f"{arch} make_prefill")
    if cfg.frontend is None:
        sr = serve.ServeRun(cfg=cfg)
        g_card, _ = serve.generate(sr, params=card, device=sm90)
        g_cpu, _ = serve.generate(sr, params=cpu, device="cpu")
        assert g_card.device.type == "cuda"
        # the CPU steps' logits, teacher-forced with its own tokens
        prompts = torch.as_tensor(np.random.default_rng(sr.seed).integers(
            0, cfg.vocab_size, (sr.batch, sr.prompt_len)), dtype=torch.int32)
        with torch.no_grad():
            cache = TT.init_cache(cfg, sr.batch, sr.prompt_len
                                  + sr.max_new_tokens, device="cpu")
            feats, cache, _ = TT.forward(cfg, cpu, {"tokens": prompts},
                                         mode="prefill", cache=cache)
            step_logits = [TT.lm_head(cfg, cpu, feats[:, -1:])[:, 0]]
            for i in range(sr.max_new_tokens - 1):
                lg, cache = decode(cpu, cache, {"tokens": g_cpu[:, i:i + 1]},
                                   sr.prompt_len + i)
                step_logits.append(lg[:, 0])
        top2 = torch.stack(step_logits, 1).float().topk(2, dim=-1).values
        margin = top2[..., 0] - top2[..., 1]
        got_t, want_t = g_card.cpu(), g_cpu
        for b in range(sr.batch):
            for i in range(sr.max_new_tokens):
                if margin[b, i] > 2 * MODEL_TOL:
                    assert got_t[b, i] == want_t[b, i], (arch, b, i)
                elif got_t[b, i] != want_t[b, i]:
                    break
    assert kernels.launch_counts() == before


TRAIN_TOL = 1e-4       # float32 on both sides: reduction order only


def _f32(cfg, model):
    from repro_torch.models import transformer as TT
    from repro_torch.optim.adamw import tree_map

    return TT.Decoder(cfg, tree_map(lambda t: t.detach().float(),
                                    model.tensors()))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepseek-coder-33b", "gemma2-27b",
                                  "qwen3-0.6b", "qwen2.5-14b",
                                  "mixtral-8x22b", "qwen3-moe-30b-a3b",
                                  "recurrentgemma-2b", "rwkv6-1.6b",
                                  "musicgen-large", "internvl2-26b"])
def test_train_step_on_the_card_matches_the_cpu(sm90, arch, rng):
    """One training step of every smoke config (remat as configured) on
    the card against the CPU, in float32 with the same weights (copied)
    and inputs: the loss and every gradient leaf at atol = rtol = 1e-4,
    the params after one AdamW step likewise except where the clipped
    gradient is below 1e-6 (Adam's first step g/(|g| + ε) turns on ε
    there; held within 2·lr). No sync kernel is launched."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as TT
    from repro_torch.optim import AdamW, constant
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import steps as TS

    cfg = get_smoke_config(arch)
    _, batch = _model_inputs(cfg, 2, 32, rng)       # 32 positions in all
    batch["labels"] = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                   (2, 32)),
                                      dtype=torch.int32)
    batch["loss_mask"] = torch.ones((2, 32), dtype=torch.bfloat16)
    model = _f32(cfg, TT.init_params(cfg, seed=0, device="cpu"))
    before = kernels.launch_counts()
    lr = 1e-3
    runs = []
    for dev in ("cpu", sm90):
        m = model.copy_to(dev)
        bt = {k: v.to(dev) for k, v in batch.items()}
        loss, _, grads = TS.make_grad_fn(cfg)(m, bt)
        opt = AdamW(lr=constant(lr))
        state, met = TS.make_train_step(cfg, opt)(
            TS.init_train_state(cfg, opt, m), bt)
        runs.append((loss.item(), [g.cpu() for g in tree_leaves(grads)],
                     [p.detach().cpu() for p in
                      tree_leaves(state.params.tensors())],
                     float(met["grad_norm"])))
    (l0, g0, p0, n0), (l1, g1, p1, _) = runs
    torch.testing.assert_close(l1, l0, atol=TRAIN_TOL, rtol=TRAIN_TOL)
    for i, (a, b) in enumerate(zip(g1, g0)):
        torch.testing.assert_close(a, b, atol=TRAIN_TOL, rtol=TRAIN_TOL,
                                   msg=f"{arch} grad leaf {i}")
    scale = min(1.0, 1.0 / max(n0, 1e-9))
    for i, (a, b, g) in enumerate(zip(p1, p0, g0)):
        allowed = TRAIN_TOL + TRAIN_TOL * b.abs() + torch.where(
            (g * scale).abs() < 1e-6, 2 * lr, 0.0)
        assert bool(((a - b).abs() <= allowed).all()), (arch, i)
    assert kernels.launch_counts() == before


@pytest.mark.cuda
def test_microbatched_step_on_the_card_returns_float32_params(sm90, rng):
    """The reference's dtype rule on the card: bf16 weights stay bf16 after
    an unbatched step and turn float32 (the accumulator's dtype) after a
    microbatched one, with the loss of both within 5e-3 relative."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as TT
    from repro_torch.optim import AdamW, constant
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import steps as TS

    cfg = get_smoke_config("qwen2.5-14b")
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                    (4, 32)),
                                       dtype=torch.int32, device=sm90),
             "labels": torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                    (4, 32)),
                                       dtype=torch.int32, device=sm90),
             "loss_mask": torch.ones((4, 32), dtype=torch.bfloat16,
                                     device=sm90)}
    opt = AdamW(lr=constant(0.0), weight_decay=0.0)
    out = {}
    for mb in (1, 2):
        model = TT.init_params(cfg, seed=0, device=sm90)
        state, m = TS.make_train_step(cfg, opt, microbatches=mb)(
            TS.init_train_state(cfg, opt, model), batch)
        out[mb] = ({t.dtype for t in tree_leaves(state.params.tensors())},
                   float(m["loss"]))
    assert out[1][0] == {torch.bfloat16} and out[2][0] == {torch.float32}
    assert abs(out[1][1] - out[2][1]) <= 5e-3 * abs(out[1][1])


@pytest.mark.cuda
def test_train_100m_tiny_on_the_card(sm90, tmp_path):
    """``python -m repro_torch.train_100m --tiny`` (the card by default)
    exits 0: the loss fell; it prints the example's last line."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.train_100m", "--tiny", "--ckpt",
         str(tmp_path / "ck")], cwd=repo,
        env=dict(os.environ, PYTHONPATH=str(repo / "src")),
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[-1].endswith(
        "tokens consumed (CRDT progress counter): 7,680")


# -- round_step's plans and the model side's meshes (slice 10) -----------------

@pytest.mark.cuda
@pytest.mark.parametrize("kind_name", sorted(KINDS))
@pytest.mark.parametrize("flavor", sorted(FLAVORS))
@pytest.mark.parametrize("topo_name", ["mesh9d4", "mesh40d4"])
@pytest.mark.parametrize("w", ["u1024", "ragged", "u1001", "u64", "u7"])
def test_every_round_step_plan_equals_plain(sm90, kind_name, flavor,
                                            topo_name, w, rng):
    """Each plan on ``round_step.plans``' ladder, the default first,
    computes the plain version's round exactly, on B = 2 configs; U = 64 and 7 are
    short rows, whose ladders hold the short-row kernel's plans (configs
    a block, direct or staged loads)."""
    from repro_torch.kernels import _build as KB

    topo = {"mesh9d4": lambda: topology.partial_mesh(9, 4),
            "mesh40d4": lambda: topology.partial_mesh(40, 4)}[topo_name]()
    (u, _), n, p, b = width(w, kind_name), topo.num_nodes, topo.max_degree, 2
    k, per_origin, extracts = FLAVORS[flavor]
    k = p + 1 if k == "P+1" else k
    arrays = [rand_state(rng, kind_name, b, n, u),
              rand_state(rng, kind_name, b, n, u),
              rand_state(rng, kind_name, k, b, n, u) if k else None,
              (rng.integers(0, 2, size=(b, n, p))
               * topo.mask.numpy()).astype(np.int32),
              rng.integers(0, 2, size=(b, n)).astype(np.int32) if k else None]
    dev = [None if a is None else both(a, sm90)[1] for a in arrays]
    kind = KINDS[kind_name][0]
    delta, x = (KB.kernel_view(t, kind) for t in dev[:2])
    buf = None if dev[2] is None else KB.kernel_view(dev[2], kind)
    args = (delta, x, buf, dev[3], dev[4], topo.nbrs.to(sm90),
            topo.rev.to(sm90), kind, per_origin, extracts, not extracts)
    want = kstep.plain(*args)
    cands = kstep.plans(n, p, k, per_origin, x.element_size(), u, True)
    assert cands[0] == kstep.plan(n, p, k, per_origin, x.element_size(), u,
                                  True)
    for pl in cands:
        got = kstep._launch(*args, pl=pl)
        torch.cuda.synchronize()
        for nm, g, wv in zip(("x'", "buf'", "inbox", "dsz_op", "xsz",
                              "ssend", "cnt", "dsz"), got, want):
            assert (g is None) == (wv is None), (pl, nm)
            if g is not None:
                assert torch.equal(g, wv), (pl, nm)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mixtral-8x22b"])
def test_one_rank_mesh_train_step_equals_the_plain_one(sm90, arch):
    """A one-rank NCCL group's (1, 1) mesh on the card: the smoke config's
    float32 weights placed by ``param_specs`` / ``to_named``, a train step
    with hints and ``grad_specs`` equal to the plain one (loss and params
    within 1e-4 of their scale). The group is torn down after."""
    import socket

    import torch.distributed as dist

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as TT
    from repro_torch.models.params import tree_map
    from repro_torch.optim import AdamW, constant
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import sharding as SH
    from repro_torch.train import steps as TS

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        cfg = get_smoke_config(arch)
        model = TT.init_params(cfg, seed=0, device=sm90)
        model = TT.Decoder(cfg, tree_map(lambda _, t: t.float(),
                                         model.tensors()))
        g = torch.Generator(device=sm90).manual_seed(0)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 16),
                                         generator=g, device=sm90,
                                         dtype=torch.int32),
                 "labels": torch.randint(0, cfg.vocab_size, (2, 16),
                                         generator=g, device=sm90,
                                         dtype=torch.int32),
                 "loss_mask": torch.ones((2, 16), device=sm90)}
        hints = TT.ShardingHints(data_axes="data", model_axis="model")
        p_sp = SH.param_specs(cfg, mesh, "train")
        smodel = TT.Decoder(cfg, SH.to_named(model.tensors(), p_sp, mesh))
        sbatch = SH.to_named(batch, SH.batch_specs(cfg, mesh, batch), mesh)
        optim = AdamW(lr=constant(1e-3))
        new, m = TS.make_train_step(cfg, optim)(
            TS.init_train_state(cfg, optim, model), batch)
        snew, sm = TS.make_train_step(cfg, optim, hints=hints,
                                      grad_specs=p_sp)(
            TS.init_train_state(cfg, optim, smodel), sbatch)
        loss, sloss = float(m["loss"]), float(sm["loss"].full_tensor())
        assert abs(sloss - loss) <= 1e-4 * abs(loss)
        for a, w in zip(tree_leaves(SH.full_tree(snew.params.tensors())),
                        tree_leaves(new.params.tensors())):
            assert float((a - w).abs().max()) <= 1e-4 * max(
                float(w.abs().max()), 1.0)
    finally:
        dist.destroy_process_group()


def retwis_store_args(seed, objects=3000, nodes=16, slots=16,
                      rounds=12):
    """A small Retwis store run's arguments, op stream drawn from ``seed``."""
    from repro_torch.core import MapLattice
    from repro_torch.core import value_lattices as vl
    from repro_torch.sync import StoreSpec
    counts = workloads.retwis(objects, nodes, rounds, 4, 1.0,
                              seed=seed).update_counts()
    spec = StoreSpec(objects=objects, weights=workloads.retwis_weights(
        objects), op_fn=workloads.versioned_slot_op(counts, slots))
    return ("bprr", MapLattice(slots, vl.max_int()).build(),
            topology.partial_mesh(nodes, 4), spec, rounds - 3, 3)


@pytest.mark.cuda
def test_store_results_reach_pinned_memory_once(sm90):
    """A store's results reach the host in pinned memory equal to the CPU
    run's; a result kept while the next run of its size runs keeps its
    values; and once a run of that size has pinned its blocks, the next
    run (the first result dropped) pins no new bytes, by the
    ``results_to_host`` counter and by the allocator's own statistics."""
    import gc

    from repro_torch.obs import TraceLog
    from repro_torch.sync import simulate_store

    fields = ("tx", "mem", "cpu", "max_mem_node", "final_state_bytes")

    def arrays(res):
        return [getattr(res, f) for f in fields]

    def run(seed, trace=None):
        return simulate_store(*retwis_store_args(seed), engine="mega",
                              trace=trace, device=sm90)

    def two_kept():
        # a function of its own, so that no name outlives the two results
        first = run(1)
        want = simulate_store(*retwis_store_args(1), engine="mega",
                              device="cpu")
        for f, a, b in zip(fields, arrays(first), arrays(want)):
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a, b, err_msg=f)
            assert a.flags.c_contiguous, f
            assert torch.from_numpy(a).is_pinned(), f
        kept = [a.copy() for a in arrays(first)]
        second = run(2)
        for f, a, b, c in zip(fields, arrays(first), kept, arrays(second)):
            np.testing.assert_array_equal(a, b, err_msg=f)
            assert not np.shares_memory(a, c), f
        assert any(not np.array_equal(a, c)
                   for a, c in zip(arrays(first), arrays(second)))

    two_kept()
    gc.collect()
    for seed in (3, 4):
        log = TraceLog()
        before = torch.cuda.host_memory_stats()["allocated_bytes.allocated"]
        res = run(seed, log)
        after = torch.cuda.host_memory_stats()["allocated_bytes.allocated"]
        (counter,) = [e["args"] for e in log.events
                      if e["name"] == "results_to_host"]
        assert counter["bytes"] == sum(a.nbytes for a in arrays(res))
        assert counter["pinned_bytes"] == 0 and after == before, seed
        del res
