"""``BENCHMARK.json`` keeps to the benchmark's contract (keys, names,
lengths, bounds, cells and their files), and the readers of the traced
window do their arithmetic right on a trace made by hand."""

import json
import re
from pathlib import Path

import pytest

import crdtbench
from crdtbench import find, harness, peaks
from crdtbench import trace as tr

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_the_top_level(bench):
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(bench["command"]) <= 32
    assert all(line(w) for w in bench["command"])
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    for w in bench["command"][1:]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in bench["paths"])
    rs = bench["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits its time
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configurations(bench):
    names = [c["name"] for c in bench["configs"]]
    assert 1 <= len(names) <= 24 and len(set(names)) == len(names)
    used = {w["config"] for w in bench["workloads"]}
    files = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in bench["paths"])
        assert c["file"] not in files
        files.add(c["file"])
        with open(ROOT / c["file"]) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"]
        assert len(c["reduced"]) <= 16 and all(NAME.match(k)
                                               for k in c["reduced"])
        assert sorted(c["reduced"]) == sorted(cfg["reduced"])
        for k in c["reduced"]:
            assert not re.search(r"(_dim|_rank)$|slots|width|size", k)
            assert k in cfg.get("source_values", {})
        # a scale raised above the source's is named apart, not as a cut
        for k in cfg.get("scaled_up", []):
            assert k not in c["reduced"] and k in cfg["source_values"]
            assert cfg[k] > cfg["source_values"][k]


def test_cells(bench):
    cells = bench["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({w["name"] for w in cells}) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    wide = [w for w in cells if w["chips"] == 4]
    assert len(wide) <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and line(w["why"])
        mix = ROOT / "crdtbench" / "mixes" / f"{w['traffic']}.json"
        assert mix.is_file()
        e2e = harness.metrics_of(bench, w["name"], "end_to_end")
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert harness.metrics_of(bench, w["name"], "per_layer")


def test_metrics(bench):
    e2e = bench["end_to_end"]
    names = [m["name"] for m in e2e + bench["per_layer"]]
    assert len(set(names)) == len(names)
    assert 1 <= len(e2e) <= 16 and 1 <= len(bench["per_layer"]) <= 128
    cells = {w["name"] for w in bench["workloads"]}
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert (ROOT / "crdtbench" / "end_to_end"
                / f"{m['name']}.py").is_file()
    assert {m["name"]: m["bound"] for m in e2e}["setup_s"] <= 0.25
    layers = {}
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and line(m["layer"])
        assert m["moves"] in {e["name"] for e in e2e}
        assert set(m.get("workloads", cells)) <= cells
        assert (ROOT / "crdtbench" / "layer_metrics"
                / f"{m['name']}.py").is_file()
        layers.setdefault(m["layer"], m["name"])
    for m in e2e + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


# Kernel names as the profiler gives them on the card
ROUND_STEP = ("void short_kernel<int, MaxOp, 16, false>(int const*, int "
              "const*, int const*, int const*, int const*, int const*, int "
              "const*, int*, int*, int*, int*, int*, int*, int*, long long, "
              "int, int, int, int, int, int, int, int)")
ROUND_STEP_LONG = "void round_step_kernel<int, MaxOp, 16, 4>(int const*)"
RECV_SHORT = "void short_kernel<int, MaxOp, 16>(int const*, int*, int)"
RECV_LONG = "void long_kernel<int, MaxOp>(int const*, int const*, long long)"
ATEN = ("void at::native::vectorized_elementwise_kernel<4, at::native::"
        "FillFunctor<int>, std::array<char*, 1ul> >(int, at::native::"
        "FillFunctor<int>, std::array<char*, 1ul>)")


def test_kernel_names_are_classified():
    assert tr.is_round_step(ROUND_STEP) and tr.is_round_step(ROUND_STEP_LONG)
    for n in (RECV_SHORT, RECV_LONG, ATEN):
        assert not tr.is_round_step(n)
    for n in (ROUND_STEP, ROUND_STEP_LONG, RECV_SHORT, RECV_LONG,
              "void extract_kernel<int, true>(int const*)"):
        assert tr.is_port_kernel(n)
    assert not tr.is_port_kernel(ATEN)


def hand_trace():
    def x(cat, name, ts, dur, **kw):
        return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, **kw)

    gpu = dict(pid=0, tid=7, args={"device": 0})
    host = dict(pid=99, tid=1)
    events = [
        x("user_annotation", tr.WINDOW, 0, 1000, **host),
        x("user_annotation", "sim.call", 50, 900, **host),
        x("cpu_op", "aten::copy_", 390, 100, **host),
        x("kernel", ROUND_STEP, 100, 200, **gpu),
        x("kernel", ATEN, 200, 200, **gpu),
        x("kernel", ROUND_STEP, 600, 100, **gpu),
        x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 800, 50, **gpu),
        x("kernel", ATEN, 1500, 10, **gpu),             # after the window
    ]
    return tr.from_events(events, rounds=2, cards=[0],
                          step_shape={"b": 1, "n": 15, "u": 1000, "p": 4,
                                      "k": 5})


def test_the_traced_window_is_read_right():
    t = hand_trace()
    assert len(t.kernels) == 3 and t.window_s == pytest.approx(1e-3)
    assert t.busy_s(0) == pytest.approx(450e-6)        # a union, not a sum
    assert t.gaps(0) == [(0, 100), (400, 200), (700, 100), (850, 150)]

    def read(name):
        return harness.reader("layer_metrics", name)(t)

    assert read("device_idle_pct") == pytest.approx(55.0)
    assert read("launches_per_round") == pytest.approx(1.5)
    assert read("aten_ms_per_round") == pytest.approx(0.1)
    assert read("d2h_ms_per_round") == pytest.approx(0.025)
    bound = peaks.step_bound_ms(1, 15, 1000, 4, 5)
    assert read("round_step_roofline") == pytest.approx(100 * bound / 0.15)
    b = t.breakdown()
    assert b["device_ops"][0] == [ROUND_STEP[:200], pytest.approx(300e-6)]
    assert b["idle_gaps"][0] == ["sim.call/aten::copy_", pytest.approx(2e-4)]
    assert len(b["idle_gaps"]) == 4


def test_a_reader_with_nothing_to_read_gives_nothing():
    t = hand_trace()
    t.kernels, t.copies, t.step_shape = [], [], None
    for name in ("round_step_roofline", "launches_per_round",
                 "aten_ms_per_round", "d2h_ms_per_round", "device_idle_pct"):
        assert harness.reader("layer_metrics", name)(t) is None


def test_the_window_metrics():
    w = harness.Window(setup_s=12.5, window_s=3.0, rounds=600,
                       sims_s=[0.1 * i for i in range(1, 21)],
                       peak_bytes=3 * 2 ** 30)

    def read(name):
        return harness.reader("end_to_end", name)(w)

    assert read("round_ms") == pytest.approx(5.0)
    assert read("sim_p95_ms") == pytest.approx(1905.0)
    assert read("peak_mem_gib") == pytest.approx(3.0)
    assert read("setup_s") == 12.5


def test_the_parts_of_a_cell_are_found_by_name(bench):
    for path in sorted((ROOT / "crdtbench" / "mixes").glob("*.json")):
        kind = find("kinds", json.loads(path.read_text())["kind"])
        for fn in ("entry", "build", "reference", "judge"):
            assert callable(getattr(kind, fn)), (path.name, fn)
    for c in bench["configs"]:
        with open(ROOT / c["file"]) as f:
            params = dict(json.load(f)["topology"])
        topo = find("topologies", params.pop("kind"))
        want = topo.program(**params).neighbor_lists()
        assert [list(nb) for nb in want] == topo.neighbours(**params)


def test_a_part_added_as_a_file_is_found_without_an_edit(tmp_path,
                                                         monkeypatch):
    (tmp_path / "kinds").mkdir()
    (tmp_path / "kinds" / "later_kind.py").write_text(
        "def entry(mix, config, seed):\n    return {'seed': seed}\n")
    monkeypatch.setattr(crdtbench, "HERE", tmp_path)
    got = crdtbench.find("kinds", "later_kind").entry({}, {}, 7)
    assert got == {"seed": 7}
    with pytest.raises(KeyError):
        crdtbench.find("kinds", "no_such_kind")
