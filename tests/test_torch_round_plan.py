"""``round_step``'s launch plan: the ladder :func:`round_step.plans` and
its first entry, :func:`round_step.plan`, the one plan a launch runs,
chosen from the operands' shape and alignment alone.

The card-side checks (every plan on the ladder against the plain version)
are in ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase 13."""

import ast
import json
import pathlib

import pytest
import torch

from repro_torch.kernels import _build as KB
from repro_torch.kernels import round_step as ks
from repro_torch.sync import topology


@pytest.mark.parametrize("shape,first", [
    # the scale phase's mesh bprr: the long-row ring of 128 columns
    ((15, 4, 5, True, 4, 4_194_304, True), (128, 3, 1, False)),
    # the Retwis store, bprr: the short-row ring, two stages of 89.6 KB
    ((50, 4, 5, True, 4, 64, True), (64, 2, 1, True)),
    # the Retwis store, classic: three stages of 38.4 KB
    ((50, 4, 1, False, 4, 64, True), (64, 3, 1, True)),
    # the million-object store: six configs a block, two stages
    ((16, 4, 5, True, 4, 32, True), (32, 2, 6, True)),
    # bool rows, not aligned: long rows, direct loads of one element
    ((9, 4, 0, False, 1, 300, False), (32, 0, 1, False)),
    # 40 nodes × 8 send rows: only 4-byte lanes' ring fits
    ((40, 8, 9, True, 4, 1000, True), (32, 2, 1, False)),
])
def test_plans_start_with_plan_and_fit(shape, first):
    """The ladder starts with :func:`round_step.plan` (its tile, stages,
    configs a block and kernel as given), holds no plan twice, fits shared
    memory, and keeps direct loads on the short-row ladder beside the
    ring; rows off 16 bytes have direct loads only."""
    cands = ks.plans(*shape)
    assert cands[0] == ks.plan(*shape)
    assert (cands[0].tile, cands[0].stages, cands[0].configs,
            cands[0].short) == first
    assert len(set(cands)) == len(cands)
    for pl in cands:
        assert pl.smem <= ks.SMEM_LIMIT
        assert pl.bulk == (pl.vec_bytes > 0 and pl.stages > 0)
        if pl.short:       # a lane group's columns
            assert pl.tile == pl.lanes * (pl.vec_bytes // shape[4] or 1)
        else:              # a warp's
            assert pl.tile == 32 * (pl.vec_bytes or shape[4]) // shape[4]
    if cands[0].short:
        assert any(not pl.bulk for pl in cands)   # direct loads stay
    n, p, k, per_origin, elem, u, aligned = shape
    if not aligned or (u * elem) % 16:
        assert cands == (ks.plan(*shape),)        # direct loads only


@pytest.mark.parametrize("shape,ring,direct", [
    # Np = 56: {1, 64 // 56, 256 // 56}; 400 ring lanes or 800 direct:
    # g = 1 either way
    ((50, 4, 5, True, 4, 64, True), [(1, 2)], [1]),
    ((50, 4, 1, False, 4, 64, True), [(1, 3)], [1]),
    # Np = 16: the ring's most 6 (two stages and the send buffer fill
    # shared memory), direct 8; 256 // 16 cut to them
    ((16, 4, 5, True, 4, 32, True), [(6, 2), (1, 3), (4, 3)], [8, 1, 4]),
    ((16, 4, 1, False, 4, 32, True), [(7, 3), (1, 3), (4, 3)], [8, 1, 4]),
    ((9, 4, 0, False, 4, 64, True), [(6, 3), (1, 3), (4, 3)], [7, 1, 4]),
    ((15, 4, 5, True, 1, 128, True), [], [2, 1]),   # bool: direct only
])
def test_short_row_ladder_starts_from_the_tpu_choices(shape, ring, direct):
    """The short-row ladder: the ring's plans, then direct loads', each
    over the most configs a block that fit it and then the TPU kernel's g
    choices {1, 64 // Np, 256 // Np} cut to that, a ring plan with the
    most stages that fit and two 16-byte vectors a lane; no long-row plan.
    The default (first) is the ring with the most configs where a ring
    fits, else direct loads with the most configs."""
    cands = ks.plans(*shape)
    short = [pl for pl in cands if pl.short]
    assert [(pl.configs, pl.stages) for pl in short if pl.bulk] == ring
    assert [pl.configs for pl in short if not pl.bulk] == direct
    assert cands == tuple(short) and cands[0] == ks.plan(*shape)
    n, p, k, per_origin, elem, u, _ = shape
    s = p if per_origin and k else 1
    for pl in short:
        lanes = -(-pl.configs * n * pl.lanes // 32) * 32
        assert pl.threads == lanes + (32 if pl.bulk else 0) <= (
            ks.RING_THREADS if pl.bulk else ks.MAX_THREADS)
        assert pl.bulk == (pl.stages in ks.STAGES) == (pl.vec_bytes == 32)
        if not pl.bulk:
            assert pl.smem == pl.configs * 2 * s * n * u * elem \
                <= ks.SMEM_LIMIT
    assert short[0] == next(pl for pl in short if pl.bulk == bool(ring))
    assert short[0].configs == (ring[0][0] if ring else direct[0])


@pytest.mark.parametrize("shape,ring", [
    ((50, 4, 5, True, 4, 64, True), True),     # the Retwis store: bprr,
    ((50, 4, 1, False, 4, 64, True), True),    # classic,
    ((50, 4, 0, False, 4, 64, True), True),    # state
    ((16, 4, 5, True, 4, 32, True), True),     # the million-object store
    ((3, 2, 3, True, 4, 32, True), True),      # N = 3, P = 2
    ((17, 4, 5, True, 4, 64, True), True),     # a node past a warp's rows
    ((16, 4, 5, True, 4, 8, True), True),      # one ring lane a row
    ((15, 3, 4, True, 4, 100, True), False),   # 25 vectors: an odd count
    ((16, 4, 5, True, 4, 48, True), False),    # 12 vectors: 6 lanes
    ((16, 4, 5, True, 4, 32, False), False),   # an offset base
    ((16, 4, 5, True, 4, 34, True), False),    # 136-byte rows: 8-byte lanes
    ((50, 4, 5, True, 1, 64, True), False),    # uint8 rows
    ((15, 4, 1, False, 1, 128, True), False),
])
def test_short_row_ring_fits_shared_memory(shape, ring):
    """Each ring plan's shared memory, exactly: its stages of the 2+K
    input planes of g configs' rows, plus a full and an empty mbarrier a
    stage, plus one buffer of the S send rows, within SMEM_LIMIT; the
    most stages of STAGES that fit, two 16-byte vectors a lane. Rows off
    16 bytes, of uint8, or not an even number of 16-byte vectors whose
    half is a power of two get no ring plan."""
    n, p, k, per_origin, elem, u, aligned = shape
    short = [pl for pl in ks.plans(*shape) if pl.short]
    rings = [pl for pl in short if pl.bulk]
    assert short and bool(rings) == ring
    assert short[0] == ks.plan(*shape) == (rings or short)[0]
    s = p if per_origin and k else 1
    for pl in rings:
        assert pl.vec_bytes == 32 and pl.stages in ks.STAGES
        assert 2 * pl.lanes * 16 == u * elem
        row = pl.configs * n * u * elem
        stage = (2 + k) * row
        assert pl.bar_bytes == pl.stages * 2 * 8
        assert pl.smem == pl.stages * stage + pl.bar_bytes + s * row \
            <= ks.SMEM_LIMIT
        more = [st for st in ks.STAGES if st > pl.stages]
        assert all(st * (stage + 16) + s * row > ks.SMEM_LIMIT
                   for st in more)


def test_plans_raise_where_nothing_fits():
    with pytest.raises(ValueError, match="shared memory"):
        ks.plans(512, 16, 17, True, 4, 64, True)


def test_round_step_on_the_cpu_asks_for_no_plan(monkeypatch):
    """A CPU tensor takes the plain version: no plan is resolved."""
    def boom(*a, **k):
        raise AssertionError("resolved a plan for a CPU tensor")

    monkeypatch.setattr(ks, "plan", boom)
    x = torch.zeros((1, 3, 8), dtype=torch.int32)
    nbrs = torch.tensor([[1, 2], [0, 2], [0, 1]], dtype=torch.int32)
    rev = torch.tensor([[0, 0], [0, 1], [1, 1]], dtype=torch.int32)
    out = ks.round_step(x, x, None, torch.ones((1, 3, 2), dtype=torch.int32),
                        None, nbrs, rev)
    assert out[0].shape == x.shape


# The per-origin bprr round (K = P + 1) at three row shapes, each with
# several plans on its ladder: the Retwis cells' short rows, the
# million-object store's, and long rows (whose ladder depends on U only
# through alignment, so U = 4,096 has the 4M-key GMap's ladder).
LAUNCH_SHAPES = {"retwis": (50, 64, 2), "million": (16, 32, 6),
                 "long": (15, 4096, 10)}


def launched_plan(monkeypatch, n, u, misaligned=None):
    """The plan ``_launch`` runs, without ``pl``, for a per-origin bprr
    round of B = 2 configs on ``partial_mesh(n, 4)``, U columns, on CPU
    tensors (the card check stubbed, the kernel call recorded); the
    operand named by ``misaligned`` starts 4 bytes past a 16-byte
    boundary."""
    b = 2
    topo = topology.partial_mesh(n, 4)
    p = topo.max_degree
    shapes = {"delta": (b, n, u), "x": (b, n, u), "buf": (p + 1, b, n, u)}
    g = torch.Generator().manual_seed(5)
    ops = {}
    for name, shape in shapes.items():
        size = torch.Size(shape).numel()
        flat = torch.randint(0, 9, (size + 4,), generator=g,
                             dtype=torch.int32)
        lo = 1 if name == misaligned else 0
        ops[name] = flat[lo:lo + size].view(shape)
        assert (ops[name].data_ptr() % 16 == 0) == (name != misaligned)
    seen = []

    def record(*args):
        seen.append(args[-1])
        return (None,) * 8, 1

    monkeypatch.setattr(KB, "check_cuda", lambda *a: None)
    monkeypatch.setattr(ks, "_kernel", record)
    monkeypatch.setattr(ks, "launches", 0)
    monkeypatch.setattr(ks, "last_launch", None)
    ks._launch(ops["delta"], ops["x"], ops["buf"],
               topo.mask.to(torch.int32).expand(b, n, p).contiguous(),
               torch.ones((b, n), dtype=torch.int32), topo.nbrs, topo.rev,
               "max", True, True, False)
    assert len(seen) == 1 and ks.last_launch == (seen[0], 1) \
        and ks.launches == 1
    return seen[0]


@pytest.mark.parametrize("env", ["none", "tune", "cached"])
@pytest.mark.parametrize("shape", sorted(LAUNCH_SHAPES))
def test_launch_plan_is_the_shapes_own(shape, env, tmp_path, monkeypatch):
    """``_launch`` without ``pl`` runs :func:`round_step.plan` of its
    operands, whatever the environment: neither ``REPRO_AUTOTUNE=1`` nor a
    cache file naming another plan on the ladder changes it."""
    n, u, ladder = LAUNCH_SHAPES[shape]
    p, k = 4, 5
    want = ks.plan(n, p, k, True, 4, u, True)
    cands = ks.plans(n, p, k, True, 4, u, True)
    assert len(cands) == ladder and cands[-1] != want
    monkeypatch.delenv("REPRO_AUTOTUNE", raising=False)
    monkeypatch.delenv("REPRO_AUTOTUNE_CACHE", raising=False)
    path = tmp_path / "plans.json"
    if env == "tune":
        monkeypatch.setenv("REPRO_AUTOTUNE", "1")
        monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(path))
    elif env == "cached":
        key = (f"round_step|cpu|max|p{p}|k{k}|po1|n{n}|b2"
               f"|u{1 << (u - 1).bit_length()}|e4|a1")
        path.write_text(json.dumps({key: {"config": list(cands[-1])}}))
        monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(path))
    assert launched_plan(monkeypatch, n, u) == want


@pytest.mark.parametrize("operand", ["delta", "x", "buf"])
def test_launch_plan_follows_the_operands_alignment(operand, monkeypatch):
    """One operand off a 16-byte boundary takes the launch to the plan of
    unaligned rows: long rows' direct loads of one element a lane."""
    got = launched_plan(monkeypatch, 15, 4096, misaligned=operand)
    assert got == ks.plan(15, 4, 5, True, 4, 4096, False)
    assert got != ks.plan(15, 4, 5, True, 4, 4096, True)
    assert (got.vec_bytes, got.stages) == (0, 0)


KERNEL_MODULES = ("round_step", "round_recv", "buffer_fold", "digest_blocks",
                  "masked_extract", "join", "delta_extract", "lex_join",
                  "slot_bump", "_build")


@pytest.mark.parametrize("name", KERNEL_MODULES)
def test_kernel_modules_do_not_import_the_facade(name):
    """A kernel wrapper never imports ``kernels.ops``, the public façade
    that wraps it, at module level or inside a function."""
    path = pathlib.Path(ks.__file__).with_name(f"{name}.py")
    facade = "repro_torch.kernels.ops"
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = "repro_torch.kernels" + (f".{node.module}" if node.module
                                            else "") \
                if node.level else node.module or ""
            names = [base] + [f"{base}.{a.name}" for a in node.names]
        else:
            continue
        assert not any(nm == facade or nm.startswith(facade + ".")
                       for nm in names), (name, node.lineno)
