"""The port's launch-plan autotuner (``repro_torch.kernels.common``) and
``round_step``'s plan ladder, case for case against ``tests/test_autotune.py``.

The tuner runs hermetically: fake timers (no kernel timing), tmp_path cache
files and explicit modes. The card-side tuning (CUDA-event timing, every
candidate plan against the plain version) is in ``tests/test_torch_cuda.py``
and ``chip_smoke.py`` phase 13."""

import json
import types

import pytest
import torch

from repro.kernels import common as jcommon
from repro_torch.kernels import common, ops
from repro_torch.kernels import round_step as ks


@pytest.fixture(autouse=True)
def _clean_memo():
    """The process-level memo would leak winners between tests."""
    common._TUNE_MEM.clear()
    yield
    common._TUNE_MEM.clear()


def _fake_timer_for(costs):
    """A perf_counter stand-in: each bench(config) call advances the clock
    by costs[config], so the tuner's (stop - start) sees that 'duration'."""
    state = {"t": 0.0, "current": None}

    def bench(cfg):
        state["current"] = tuple(cfg)

    def timer():
        cur = state["current"]
        if cur is not None:
            state["t"] += costs[cur]
            state["current"] = None
        return state["t"]

    return timer, bench


CANDS = [(1, 512), (1, 128), (1, 1024)]


def test_off_mode_returns_default():
    cfg, src = common.tuned_block("fam", ("k",), CANDS, mode="off")
    assert (cfg, src) == (CANDS[0], "default")


def test_single_candidate_short_circuits(tmp_path):
    cfg, src = common.tuned_block("fam", ("k",), [(1, 256)], mode="tune",
                                  cache_path=tmp_path / "c.json")
    assert (cfg, src) == ((1, 256), "default")


def test_cache_mode_without_entry_is_default(tmp_path):
    cfg, src = common.tuned_block("fam", ("k",), CANDS, mode="cache",
                                  cache_path=tmp_path / "c.json")
    assert (cfg, src) == (CANDS[0], "default")


def test_tune_persists_deterministic_winner(tmp_path):
    path = tmp_path / "c.json"
    costs = {(1, 512): 3.0, (1, 128): 1.0, (1, 1024): 2.0}
    timer, bench = _fake_timer_for(costs)
    cfg, src = common.tuned_block("fam", ("k",), CANDS, bench, mode="tune",
                                  timer=timer, cache_path=path)
    assert (cfg, src) == ((1, 128), "tuned")
    saved = json.loads(path.read_text())
    key = "fam|k"
    assert saved[key]["config"] == [1, 128]
    assert set(saved[key]["timings_s"]) == {str(list(c)) for c in CANDS}

    # second resolution: memo hit, no bench calls needed
    cfg2, src2 = common.tuned_block("fam", ("k",), CANDS, mode="cache",
                                    cache_path=path)
    assert (cfg2, src2) == ((1, 128), "cache")

    # fresh process (memo cleared): the DISK cache resolves it
    common._TUNE_MEM.clear()
    cfg3, src3 = common.tuned_block("fam", ("k",), CANDS, mode="cache",
                                    cache_path=path)
    assert (cfg3, src3) == ((1, 128), "cache")


def test_corrupt_cache_recovers(tmp_path):
    path = tmp_path / "c.json"
    path.write_text("{not json!!")
    cfg, src = common.tuned_block("fam", ("k",), CANDS, mode="cache",
                                  cache_path=path)
    assert (cfg, src) == (CANDS[0], "default")
    # corrupt ENTRY (wrong types / config not a candidate) also falls back
    path.write_text(json.dumps({"fam|k": {"config": [9, 9]},
                                "fam|k2": "garbage"}))
    cfg, src = common.tuned_block("fam", ("k",), CANDS, mode="cache",
                                  cache_path=path)
    assert (cfg, src) == (CANDS[0], "default")
    cfg, src = common.tuned_block("fam", ("k2",), CANDS, mode="cache",
                                  cache_path=path)
    assert (cfg, src) == (CANDS[0], "default")
    # and tuning OVER a corrupt cache rewrites it cleanly
    costs = {(1, 512): 2.0, (1, 128): 5.0, (1, 1024): 1.0}
    timer, bench = _fake_timer_for(costs)
    cfg, src = common.tuned_block("fam", ("k",), CANDS, bench, mode="tune",
                                  timer=timer, cache_path=path)
    assert (cfg, src) == ((1, 1024), "tuned")
    assert json.loads(path.read_text())["fam|k"]["config"] == [1, 1024]


def test_failing_candidate_skipped(tmp_path):
    costs = {(1, 512): 2.0, (1, 1024): 3.0}

    def bench(cfg):
        if tuple(cfg) == (1, 128):
            raise RuntimeError("too much shared memory")
        real_bench(cfg)

    timer, real_bench = _fake_timer_for(costs)
    cfg, src = common.tuned_block("fam", ("k",), CANDS, bench, mode="tune",
                                  timer=timer,
                                  cache_path=tmp_path / "c.json")
    assert (cfg, src) == ((1, 512), "tuned")


def test_tune_mode_without_bench_is_default(tmp_path):
    cfg, src = common.tuned_block("fam", ("k",), CANDS, None, mode="tune",
                                  cache_path=tmp_path / "c.json")
    assert (cfg, src) == (CANDS[0], "default")


def test_shape_bucket_pow2():
    ns = (1, 2, 3, 128, 129, 1000)
    assert [common.shape_bucket(n) for n in ns] == \
        [1, 2, 4, 128, 256, 1024] == [jcommon.shape_bucket(n) for n in ns]


def test_autotune_mode_env(monkeypatch):
    for v, want in (("", "cache"), ("1", "tune"), ("0", "off"),
                    ("tune", "tune")):
        monkeypatch.setenv("REPRO_AUTOTUNE", v)
        assert common.autotune_mode() == want == jcommon.autotune_mode()
    monkeypatch.delenv("REPRO_AUTOTUNE", raising=False)
    assert common.autotune_mode() == "cache"


def test_autotune_cache_path_env(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "alt.json"))
    assert common.autotune_cache_path() == tmp_path / "alt.json"
    monkeypatch.delenv("REPRO_AUTOTUNE_CACHE")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    path = common.autotune_cache_path()
    assert path == tmp_path / "repro-crdt-torch" / "autotune.json"
    assert path != jcommon.autotune_cache_path()


def test_backend_key_names_the_device():
    """The CPU is its own namespace; a card's key carries its name and
    compute capability (checked on the card in test_torch_cuda.py)."""
    assert common.backend_key("cpu") == "cpu"
    assert common.backend_key(torch.device("cpu")) == "cpu"


def test_disk_cache_is_reread_when_the_file_changes(tmp_path):
    path = tmp_path / "c.json"
    path.write_text(json.dumps({"fam|k": {"config": [1, 128]}}))
    assert common.tuned_block("fam", ("k",), CANDS, mode="cache",
                              cache_path=path) == ((1, 128), "cache")
    common._TUNE_MEM.clear()
    path.write_text(json.dumps({"fam|k": {"config": [1, 1024]}}))
    assert common.tuned_block("fam", ("k",), CANDS, mode="cache",
                              cache_path=path) == ((1, 1024), "cache")


@pytest.mark.parametrize("shape", [
    (15, 4, 5, True, 4, 4_194_304, True),   # the scale phase's mesh bprr
    (50, 4, 5, True, 4, 64, True),          # the Retwis store, bprr
    (50, 4, 1, False, 4, 64, True),         # the Retwis store, classic
    (16, 4, 5, True, 4, 32, True),          # the million-object store
    (9, 4, 0, False, 1, 300, False),        # bool rows, not aligned
    (40, 8, 9, True, 4, 1000, True),
])
def test_plans_start_with_plan_and_fit(shape):
    cands = ks.plans(*shape)
    assert cands[0] == ks.plan(*shape)
    assert len(set(cands)) == len(cands)
    for pl in cands:
        assert pl.smem <= ks.SMEM_LIMIT
        assert pl.bulk == (pl.vec_bytes > 0 and pl.stages > 0)
        assert pl.tile == 32 * (pl.vec_bytes or shape[4]) // shape[4]
    n, p, k, per_origin, elem, u, aligned = shape
    if not aligned or (u * elem) % 16:
        assert cands == (ks.plan(*shape),)        # direct loads only


def test_plans_raise_where_nothing_fits():
    with pytest.raises(ValueError, match="shared memory"):
        ks.plans(512, 16, 17, True, 4, 64, True)


def test_sync_round_block_default_is_plan(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "c.json"))
    monkeypatch.delenv("REPRO_AUTOTUNE", raising=False)
    pl, src = ops.sync_round_block(30_000, 50, 64, p=4, k=5, per_origin=True,
                                   device="cpu")
    assert (pl, src) == (ks.plan(50, 4, 5, True, 4, 64, True), "default")


def test_sync_round_block_resolves_from_cache(tmp_path, monkeypatch):
    """The wrapper's key scheme round-trips through the disk cache: a tuned
    winner is what an untuned later call resolves, as a Plan."""
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "c.json"))
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    seen = []
    cands = ks.plans(15, 4, 5, True, 4, 4_194_304, True)
    timer, fake = _fake_timer_for({c: float(len(cands) - i)
                                   for i, c in enumerate(cands)})
    monkeypatch.setattr(ops, "time", types.SimpleNamespace(perf_counter=timer))

    def bench(pl):
        seen.append(pl)
        fake(pl)

    kw = dict(p=4, k=5, per_origin=True, kind="max", elem_size=4,
              aligned=True, device="cpu")
    blk, src = ops.sync_round_block(1, 15, 4_194_304, tune_bench=bench, **kw)
    assert src == "tuned"
    assert blk == cands[-1] and isinstance(blk, ks.Plan)
    assert set(seen) == set(cands)
    assert all(isinstance(pl, ks.Plan) for pl in seen)
    common._TUNE_MEM.clear()
    monkeypatch.setenv("REPRO_AUTOTUNE", "")
    blk2, src2 = ops.sync_round_block(1, 15, 4_194_304, **kw)
    assert (blk2, src2) == (blk, "cache")
    # another bucket of U, or an unaligned launch, is another key
    assert ops.sync_round_block(1, 15, 1 << 23, **kw)[1] == "default"
    assert ops.sync_round_block(1, 15, 4_194_304, **dict(
        kw, aligned=False))[1] == "default"


def test_stale_cached_plan_is_ignored(tmp_path, monkeypatch):
    """A cached plan that is no longer on the ladder (another shared-memory
    layout, say) resolves to the default, not to a launch of it."""
    path = tmp_path / "c.json"
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(path))
    monkeypatch.delenv("REPRO_AUTOTUNE", raising=False)
    kw = dict(p=4, k=5, per_origin=True, device="cpu")
    ops.sync_round_block(1, 15, 4_194_304, **kw)
    key = ("round_step|cpu|max|p4|k5|po1|n15|b1|u4194304|e4|a1")
    stale = list(ks.plan(15, 4, 5, True, 4, 4_194_304, True))
    stale[-1] += 16                                # smem no longer matches
    path.write_text(json.dumps({key: {"config": stale}}))
    assert ops.sync_round_block(1, 15, 4_194_304, **kw) == (
        ks.plan(15, 4, 5, True, 4, 4_194_304, True), "default")
    good = list(ks.plans(15, 4, 5, True, 4, 4_194_304, True)[3])
    path.write_text(json.dumps({key: {"config": good}}))
    assert ops.sync_round_block(1, 15, 4_194_304, **kw) == (
        ks.Plan(*good), "cache")


def test_round_step_on_the_cpu_asks_for_no_plan(monkeypatch):
    """A CPU tensor takes the plain version: no plan is resolved."""
    def boom(*a, **k):
        raise AssertionError("resolved a plan for a CPU tensor")

    monkeypatch.setattr(ops, "sync_round_block", boom)
    x = torch.zeros((1, 3, 8), dtype=torch.int32)
    nbrs = torch.tensor([[1, 2], [0, 2], [0, 1]], dtype=torch.int32)
    rev = torch.tensor([[0, 0], [0, 1], [1, 1]], dtype=torch.int32)
    out = ks.round_step(x, x, None, torch.ones((1, 3, 2), dtype=torch.int32),
                        None, nbrs, rev)
    assert out[0].shape == x.shape


def test_pad_and_grid_helpers_match_the_jax_package():
    import jax.numpy as jnp
    import numpy as np

    a = np.arange(3 * 1000, dtype=np.int32).reshape(3, 1000)
    got, shape, n = common.pad_to_2d(torch.from_numpy(a), (8, 128))
    want, wshape, wn = jcommon.pad_to_2d(jnp.asarray(a), (8, 128))
    assert (tuple(shape), n) == (tuple(wshape), wn)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert common.grid_for(got.shape, (8, 128)) == \
        jcommon.grid_for(want.shape, (8, 128))
    np.testing.assert_array_equal(
        common.unpad_from_2d(got, shape, n).numpy(), a)
