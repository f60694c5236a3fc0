"""The port's dry-run on the CPU: the cells of
``tests/test_dryrun_and_hlo.py``, the per-device cost model and the H100
roofline (the sharded steps themselves: ``tests/test_torch_sharded.py``).

A process group is process-global, so everything that makes one (here the
dry-run's fake one) runs in a subprocess."""

import json
import subprocess
import sys

import pytest

from conftest import REPO, SRC

ENV = {"PYTHONPATH": str(SRC)}


def _env():
    import os
    return dict(os.environ, **ENV)


DRYRUN_CELLS = {
    "train_2x4": ["--arch", "qwen3-0.6b", "--shape", "train_4k",
                  "--mesh-shape", "2,4", "--no-save"],
    "moe_decode_2x4": ["--arch", "mixtral-8x22b", "--shape", "decode_32k",
                       "--mesh-shape", "2,4", "--no-save"],
    "multipod_2x2x2": ["--arch", "qwen3-0.6b", "--shape", "train_4k",
                       "--mesh-shape", "2,2,2", "--no-save"],
}


@pytest.fixture(scope="module")
def dryruns():
    """The three cells' dry-runs, started together (each traces alone in
    its process) and awaited by the tests that read them."""
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *args],
        cwd=REPO, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
        for name, args in DRYRUN_CELLS.items()}
    yield procs
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.mark.parametrize("cell", sorted(DRYRUN_CELLS))
def test_dryrun_cell(dryruns, cell):
    proc = dryruns[cell]
    out, err = proc.communicate(timeout=900)
    assert proc.returncode == 0, out + err[-4000:]
    assert " OK " in out and "bottleneck=" in out, out
    assert "dry-run complete: 1 ok, 0 skipped, 0 failed" in out, out
    if cell != "moe_decode_2x4":
        # the batch is sharded: a data-parallel step all-reduces or
        # reduce-scatters gradients
        assert "reduce-scatter" in out or "all-reduce" in out, out


def test_dryrun_skips_long500k_for_full_attention():
    from repro_torch.configs import shape_applicable
    ok, why = shape_applicable("deepseek-coder-33b", "long_500k")
    assert not ok and "full attention" in why
    ok, _ = shape_applicable("rwkv6-1.6b", "long_500k")
    assert ok


COST_SCRIPT = r"""
import json, torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.launch import op_cost
from repro_torch.launch.mesh import fake_process_group, make_mesh
out = {}
with fake_process_group(4):
    mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
    with FakeTensorMode():
        w1 = distribute_tensor(torch.empty(256, 256), mesh,
                               [Replicate(), Shard(1)], src_data_rank=None)
        w2 = distribute_tensor(torch.empty(256, 256), mesh,
                               [Replicate(), Shard(1)], src_data_rank=None)
        x = distribute_tensor(torch.empty(128, 256), mesh,
                              [Shard(0), Replicate()], src_data_rank=None)
        costs = [op_cost.analyze(lambda: torch.tanh(x @ w1) @ w2)[1]
                 for _ in range(2)]
        mode = op_cost.CostMode()
        with mode:
            x.redistribute(mesh, [Replicate(), Replicate()])
        out["trace"] = [list(c) for c in mode.collectives]
    out["costs"] = [[c.flops, c.hbm_bytes, c.collective_counts,
                     c.collective_chip_bytes, c.trip_counts] for c in costs]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def cost_run():
    r = subprocess.run([sys.executable, "-c", COST_SCRIPT], cwd=REPO,
                       env=_env(), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_op_cost_counts_per_device_flops(cost_run):
    """tanh(x @ w1) @ w2 on a fake 2×2 mesh: x [128, 256] over data, w1/w2
    [256, 256] column-split over model. Each device multiplies its
    [64, 256] rows by a [256, 128] column block twice (the hidden state
    gathered over model in between): 2 · 2·64·256·128 FLOPs, a quarter of
    the global 2 · 2·128·256·256. DTensor's first-call shape propagation
    is not counted, so a second call costs the same."""
    first, second = cost_run["costs"]
    assert first == second
    flops, hbm, counts, chip, trips = first
    assert flops == 2 * (2 * 64 * 256 * 128) == 2 * 2 * 128 * 256 * 256 / 4
    assert counts["all-gather"] == 1 and sum(counts.values()) == 1
    # the gathered hidden state: [64, 256] float32 over a group of 2
    assert chip["all-gather"] == 64 * 256 * 4 * (2 - 1) / 2
    assert trips == {}
    # operands and results of the two products and the tanh, at least
    assert hbm >= 4 * (64 * 256 + 256 * 128 + 64 * 128) * 2


def test_a_known_all_gather_costs_the_ring_formula(cost_run):
    """Replicating x [128, 256] float32 (Shard(0) over data) gathers its
    two [64, 256] halves: one all-gather of a 131,072-byte result over a
    group of 2, X·(g−1)/g = 65,536 bytes a device."""
    from repro_torch.launch import collectives as C

    recs = [C.Collective(*r) for r in cost_run["trace"]]
    assert [(r.kind, r.result_bytes, r.group_size) for r in recs] == [
        ("all-gather", 128 * 256 * 4, 2)]
    stats = C.analyze_collectives(recs, 4)
    assert stats.per_chip_bytes["all-gather"] == 65536.0
    assert stats.total_ops == 1 and stats.total_per_chip_bytes == 65536.0


def test_collective_ring_formulas():
    from repro_torch.launch.collectives import chip_bytes
    # all-reduce of X bytes over g=4: 2·X·3/4
    assert chip_bytes("all-reduce", 100.0, 4) == pytest.approx(150.0)
    assert chip_bytes("all-gather", 100.0, 4) == pytest.approx(75.0)
    assert chip_bytes("reduce-scatter", 25.0, 4) == pytest.approx(75.0)
    assert chip_bytes("collective-permute", 10.0, 4) == 10.0
    assert chip_bytes("all-reduce", 100.0, 1) == 0.0
    from repro.launch.hlo_cost import _collective_chip_bytes
    for kind in ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                 "collective-permute"):
        for g in (1, 2, 16):
            assert chip_bytes(kind, 1000.0, g) == \
                _collective_chip_bytes(kind, 1000.0, g)


def test_roofline_terms_and_bottleneck():
    from repro_torch.launch import roofline as R
    from repro_torch.launch.roofline import Roofline
    assert (R.PEAK_FLOPS, R.HBM_BW, R.LINK_BW) == (989e12, 3.35e12, 450e9)
    rl = Roofline(
        arch="a", shape="s", mesh="m", chips=256,
        hlo_flops_per_device=989e12,        # exactly 1s of compute
        hlo_bytes_per_device=3.35e12 / 2,   # 0.5s of HBM
        collective_bytes_per_chip=450e9 / 4,  # 0.25s of NVLink
        model_flops=989e12 * 256 * 0.5,
        memory_per_device=8 * 2**30,
    )
    assert rl.bottleneck == "compute"
    assert rl.step_time_s == pytest.approx(1.0)
    assert rl.memory_s == pytest.approx(0.5)
    assert rl.collective_s == pytest.approx(0.25)
    assert rl.useful_flops_ratio == pytest.approx(0.5)
    assert rl.mfu == pytest.approx(0.5)
    assert set(rl.row()) == set(__import__(
        "repro.launch.roofline", fromlist=["Roofline"]).Roofline(
        **{f: getattr(rl, f) for f in (
            "arch", "shape", "mesh", "chips", "hlo_flops_per_device",
            "hlo_bytes_per_device", "collective_bytes_per_chip",
            "model_flops", "memory_per_device")}).row())


def test_model_flops_equal_the_jax_ones():
    from repro.configs import SHAPES as JSHAPES
    from repro.configs import get_config as jcfg
    from repro.launch.roofline import model_flops as jmf
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.roofline import model_flops
    for arch in ("qwen3-0.6b", "mixtral-8x22b", "rwkv6-1.6b"):
        for shape in SHAPES:
            assert model_flops(get_config(arch), SHAPES[shape]) == \
                jmf(jcfg(arch), JSHAPES[shape])
