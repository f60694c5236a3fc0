"""The four-card Retwis store (``retwis786k.bprr.x4``) on four CPU blocks:
a sound run is correct; the timed path broken underneath, and the control,
are not; and the cell's own readers read a hand-built trace of two or four
cards right, and nothing where there is nothing to read."""

import pytest

from crdtbench import check, harness, traffic
from crdtbench import trace as tr
from crdtbench.control import DROP
from crdtbench.tests import conftest
from crdtbench.tests.test_crdtbench_faults import FAULTS

CELL = "retwis786k.bprr.x4"
CONFIG = "retwis-mesh50-786k-x4"

# ``conftest.small_root`` cuts every configuration of BENCHMARK.json to its
# entry in ``conftest.SMALL``, and that file is not this module's to edit:
# the four-card store's CPU cut (the 30K store's, at 100 objects, 25 a
# block, its reference in blocks of 10) is added here, when pytest imports
# this module, which it does before it runs any test of the folder. The
# store kind splits the objects evenly over the cards, so the count is a
# multiple of four.
conftest.SMALL.setdefault(CONFIG, {
    "topology": {"kind": "partial_mesh", "nodes": 8, "degree": 4},
    "objects": 100, "slots": 16, "rounds": {"active": 6, "quiet": 3},
    "reference_objects_per_block": 10})


def run(bench, root, seed=2 ** 32 + 9):
    return harness.run_cell(bench, CELL, seed, 0.05, False, ["cpu"] * 4,
                            0.0, root=root)


def test_the_cut_keeps_the_cells_shape(bench, small_root):
    cell, config, mix = harness.find_cell(bench, CELL, small_root)
    assert cell["chips"] == 4 and mix["pool"] == 1
    assert config["shard"] and not config["object_metrics"]
    assert config["objects"] == 100 and config["slots"] == 16


def test_a_sound_run_on_four_blocks_is_correct(bench, small_root):
    out = run(bench, small_root)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert out["device"]["count"] == 4
    assert set(out["metrics"]) == {"round_ms", "sim_p95_ms", "peak_mem_gib",
                                   "setup_s"}


@pytest.mark.parametrize("fault", ["first_card_only", "half_batch",
                                   "metric_altered", "state_altered",
                                   "unchanged_state"])
def test_a_broken_timed_path_is_not_correct(bench, small_root, monkeypatch,
                                            fault):
    FAULTS[fault][0](monkeypatch)
    out = run(bench, small_root)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("seed", [21, 2 ** 31 + 22, 23])
def test_the_control_fails_and_the_reference_holds(bench, small_root, seed):
    _, config, mix = harness.find_cell(bench, CELL, small_root)
    devices = ["cpu"] * 4
    entry = traffic.generate(mix, config, seed)[0]
    ref = check.reference_answer(config, mix, entry, devices)
    assert not any(check.judge(config, mix, entry, ref, devices).values())
    ctl = check.reference_answer(config, mix, entry, devices, drop=DROP)
    got = check.judge(config, mix, entry, ctl, devices)
    assert any(got[k] > check.LIMITS[k] for k in got), got


# -- the cell's readers on a hand-built trace ------------------------------

ROUND_STEP = ("void short_kernel<int, MaxOp, 16, false>(int const*, int "
              "const*, int const*, int const*, int const*, int const*, int "
              "const*, int*, int*, int*, int*, int*, int*, int*, long long, "
              "int, int, int, int, int, int, int, int)")
PTOP = "Memcpy PtoP (Device -> Device)"
DTOD = "Memcpy DtoD (Device -> Device)"
SHAPE = {"b": 196608, "n": 50, "u": 64, "p": 4, "k": 5}


def cards_trace(cards):
    """Card c runs ``round_step`` for 100 + 100 c µs of a 1,000 µs window;
    card 0 also gathers (two peer copies) and copies within itself; the
    host labels a check and two gathers."""
    def x(cat, name, ts, dur, **kw):
        return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, **kw)

    host = dict(pid=99, tid=1)
    events = [x("user_annotation", tr.WINDOW, 0, 1000, **host),
              x("user_annotation", "store.check", 10, 30, **host),
              x("user_annotation", "store.gather", 700, 50, **host),
              x("user_annotation", "store.gather", 800, 70, **host),
              x("user_annotation", "store.check", 10, 999, pid=99, tid=2)]
    for c in cards:
        gpu = dict(pid=c, tid=7, args={"device": c})
        events.append(x("kernel", ROUND_STEP, 100, 100 + 100 * c, **gpu))
    gpu0 = dict(pid=0, tid=8, args={"device": 0})
    events += [x("gpu_memcpy", PTOP, 700, 40, **gpu0),
               x("gpu_memcpy", PTOP, 750, 20, **gpu0),
               x("gpu_memcpy", DTOD, 900, 30, **gpu0)]
    return tr.from_events(events, rounds=4, cards=list(cards),
                          step_shape=SHAPE)


def read(name, t):
    return harness.reader("layer_metrics", name)(t)


@pytest.mark.parametrize("cards", [[0, 1], [0, 1, 2, 3]])
def test_the_cells_readers_on_a_hand_built_trace(cards):
    t = cards_trace(cards)
    busy0 = 100 + 60 + 30          # round_step, the peer copies, DtoD
    last = 100 + 100 * cards[-1]
    assert read("card_skew_pct", t) == pytest.approx(
        100.0 * abs(last - busy0) / max(last, busy0))
    assert read("p2p_ms_per_round", t) == pytest.approx(0.060 / 4)
    assert read("store_check_ms_per_round", t) == pytest.approx(0.030 / 4)
    assert read("store_gather_ms_per_round", t) == pytest.approx(0.120 / 4)
    assert read("device_idle_pct.x4", t) == pytest.approx(
        100.0 * (1 - min(busy0, 200) / 1000))
    launches = [100 + 100 * c for c in cards]
    mean_ms = sum(launches) / len(launches) / 1e3
    from crdtbench import peaks
    assert read("round_step_roofline.x4", t) == pytest.approx(
        100 * peaks.step_bound_ms(**SHAPE) / mean_ms)


def test_the_cells_readers_with_nothing_to_read_give_nothing():
    t = cards_trace([0, 1, 2, 3])
    t.host = [h for h in t.host if h[0] == tr.WINDOW]
    t.copies = [c for c in t.copies if "PtoP" not in c.name]
    assert read("store_check_ms_per_round", t) is None
    assert read("store_gather_ms_per_round", t) is None
    assert read("p2p_ms_per_round", t) is None
    one = cards_trace([0])
    assert read("card_skew_pct", one) is None
    one.kernels, one.copies, one.step_shape = [], [], None
    for name in ("card_skew_pct", "device_idle_pct.x4",
                 "round_step_roofline.x4"):
        assert read(name, one) is None
