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
from repro_torch.sync import (ENGINES, DigestSpec, FaultSchedule, simulate,
                              topology, workloads)

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
            "ragged": (4096 if kind_name == "max_bool" else 1000, 0)}[name]


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
@pytest.mark.parametrize("u", [32, 64])
def test_round_step_beyond_65535_configs(sm90, flavor, u, rng):
    """More configs than a grid dimension holds: the launch is cut into
    chunks of 65,535 (two launches counted), equal to the plain version
    on the card."""
    topo = topology.partial_mesh(16, 4).on(sm90)
    n, p, b = 16, 4, 65_537 if u == 32 else 3_001
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
    assert kstep.launches == n0 + -(-b // kstep.MAX_CONFIGS)
    want = kstep.plain(delta, x, buf, active, dlv, topo.nbrs, topo.rev, **kw)
    for nm, a, w in zip(("x'", "buf'", "inbox", "dsz_op", "xsz", "ssend",
                         "cnt", "dsz"), got, want):
        assert (a is None) == (w is None), nm
        if a is not None:
            assert torch.equal(a, w), nm


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
