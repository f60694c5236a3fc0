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
