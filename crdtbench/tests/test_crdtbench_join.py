"""The rejoin cell ``gmap4m.join-digest``: its entry in ``BENCHMARK.json``
and the readers of the resync round's labels and of the descent kernel's
roofline, on traces made by hand."""

import pytest

from crdtbench import find, harness, peaks
from crdtbench import trace as tr
from crdtbench.tests import conftest

CELL = "gmap4m.join-digest"
CONFIG = "gmap-rejoin15-4m"
READERS = ("resync_descent_ms_per_round", "resync_descent_launches_per_round",
           "resync_digest_ms_per_round", "resync_receive_ms_per_round")
ROOFLINE = "merkle_descent_roofline"
# the device readings of the accepted cells, re-exported for this one
DEVICE = ("device_idle_pct.join", "aten_ms_per_round.join",
          "launches_per_round.join", "d2h_ms_per_round.join")

# ``conftest.small_root`` cuts every configuration of BENCHMARK.json to its
# entry in ``conftest.SMALL``, and that file is not this module's to edit:
# the rejoin deployment's CPU cut (4 tiles of 1,024 keys) is added here,
# when pytest imports this module, before it runs any test of the folder.
conftest.SMALL.setdefault(CONFIG, {"keys": 4096})


def read(name, t):
    return harness.reader("layer_metrics", name)(t)


def resync_trace(labelled: bool = True):
    """Two rounds: each a digest, an extract, a descent issuing launches
    and a receive; one launch outside every descent."""
    def x(cat, name, ts, dur, **kw):
        return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, **kw)

    host = dict(pid=99, tid=1)
    gpu = dict(pid=0, tid=7, args={"device": 0})
    events = [x("user_annotation", tr.WINDOW, 0, 10000, **host),
              x("user_annotation", "sim.call", 10, 9900, **host)]
    for r, at in enumerate((100, 5100)):
        spans = [("resync.digest", at, 300), ("resync.extract", at + 300, 200),
                 ("resync.descent", at + 500, 2000 + 1000 * r),
                 ("resync.receive", at + 3600, 400)]
        for name, ts, dur in spans:
            if labelled:
                events.append(x("user_annotation", name, ts, dur, **host))
        for k in range(3 + r):               # launches inside the descent
            events.append(x("cuda_runtime", "cudaLaunchKernel",
                            at + 600 + 100 * k, 5, **host))
        events.append(x("cuda_driver", "cuLaunchKernel", at + 3700, 5,
                        **host))             # inside the receive
        events.append(x("cuda_runtime", "cudaStreamSynchronize", at + 700, 5,
                        **host))
        events.append(x("kernel", "digest_kernel", at + 200, 50, **gpu))
    events.append(x("cuda_runtime", "cudaLaunchKernel", 700, 5, pid=99,
                    tid=2))                  # another thread
    return tr.from_events(events, rounds=2, cards=[0])


def test_the_resync_readers_read_their_labels():
    t = resync_trace()
    assert read("resync_descent_ms_per_round", t) == pytest.approx(2.5)
    assert read("resync_descent_launches_per_round", t) == pytest.approx(3.5)
    assert read("resync_digest_ms_per_round", t) == pytest.approx(0.5)
    assert read("resync_receive_ms_per_round", t) == pytest.approx(0.4)


def test_the_resync_readers_give_nothing_without_the_labels():
    t = resync_trace(labelled=False)
    for name in READERS:
        assert read(name, t) is None, name


def test_the_cell_entry(bench):
    cells = {w["name"]: w for w in bench["workloads"]}
    assert cells[CELL] == {**cells[CELL], "config": CONFIG,
                           "traffic": "join-quarter-tiles.digest",
                           "chips": 1}
    assert list(cells)[-1] == CELL
    configs = {c["name"]: c for c in bench["configs"]}
    assert list(configs)[-1] == CONFIG and configs[CONFIG]["reduced"] == []
    # a deployment of its own: another source than the δ path's map
    assert configs[CONFIG]["source"] != configs["gmap-mesh15-4m"]["source"]
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for name in ("round_ms", "sim_p95_ms"):
        assert e2e[name]["workloads"] == ["retwis30k.bprr",
                                          "retwis786k.bprr.x4", CELL]
        assert e2e[name]["bound"] == 0.25
    for name, bound in (("round_ms.map", 0.015), ("sim_p95_ms.map", 0.05)):
        assert e2e[name]["workloads"] == ["gmap4m.bprr"]
        assert e2e[name]["bound"] == bound
    assert "workloads" not in e2e["peak_mem_gib"]
    assert "workloads" not in e2e["setup_s"]
    reported = [m["name"] for m in harness.metrics_of(bench, CELL,
                                                      "per_layer")]
    assert reported == list(READERS) + [ROOFLINE] + list(DEVICE)
    layers = {m["name"]: m["layer"] for m in bench["per_layer"]}
    for m in bench["per_layer"]:
        if m["name"] in reported:
            assert m["workloads"] == [CELL] and m["moves"] == "round_ms"
            assert m["source"] == ("program_span" if m["name"] in READERS
                                   else "device_trace")
        else:
            assert CELL not in m["workloads"], m["name"]
    t = resync_trace()
    for name in DEVICE:
        # the accepted metric's layer, and its reader re-exported
        base = name.removesuffix(".join")
        assert layers[name] == layers[base]
        assert harness.reader("layer_metrics", name).__module__ \
            == f"crdtbench.layer_metrics.{base}"
        assert read(name, t) == read(base, t)
    assert [m["name"] for m in bench["per_layer"]][-9:] == reported


def test_the_rejoin_deployment_is_the_maps_widths(bench):
    """The rejoin deployment is the 4M-key map of the δ cell at its widths,
    topology and guarantees of delivery, with its own source."""
    _, config, mix = harness.find_cell(bench, CELL)
    _, delta, _ = harness.find_cell(bench, "gmap4m.bprr")
    for key in ("system", "topology", "keys", "value", "shard", "converges",
                "source_values", "scaled_up"):
        assert config[key] == delta[key], key
    assert config["name"] == CONFIG and config["reduced"] == []
    assert config["keys"] % mix["tile"] == 0 and mix["tile"] % mix["block"] == 0


def test_a_sound_heal_of_the_cells_own_entry_is_correct(bench, small_root,
                                                        seed=2 ** 32 + 11):
    """The cell as BENCHMARK.json names it, on the CPU at 4,096 keys: every
    check 0, every replica converged, the cell's end-to-end metrics."""
    cell, config, _ = harness.find_cell(bench, CELL, small_root)
    assert config["name"] == CONFIG and config["keys"] == 4096
    out = harness.run_cell(bench, CELL, seed, 0.05, False, ["cpu"], 0.0,
                           root=small_root)
    assert out["correct"], out["checks"]
    assert all(c["value"] == 0 for c in out["checks"].values()), \
        out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["metrics"]) == {
        m["name"] for m in harness.metrics_of(bench, CELL, "end_to_end")}


def kernel_trace(names_durs, labels=()):
    """One round's window holding the kernels ``(name, us)`` and the host
    labels ``labels``."""
    events = [dict(ph="X", cat="user_annotation", name=tr.WINDOW, ts=0,
                   dur=1000, pid=99, tid=1)]
    for i, name in enumerate(labels):
        events.append(dict(ph="X", cat="user_annotation", name=name,
                           ts=20 + 100 * i, dur=5, pid=99, tid=1))
    at = 10
    for name, dur in names_durs:
        events.append(dict(ph="X", cat="kernel", name=name, ts=at, dur=dur,
                           pid=0, tid=7, args={"device": 0}))
        at += dur + 1
    return tr.from_events(events, rounds=1, cards=[0])


def test_the_descent_roofline_reads_its_kernels():
    """Two calls of two fold launches and a compare each, their shapes
    read from the program's labels (15 trees of 65,536 leaves and 7 of
    1,000, 4 slots): the mean least bytes of a call over the calls' mean
    time; nothing without the kernels or without the labels."""
    rl = find("layer_metrics", ROOFLINE)
    assert rl.call_bytes(15, 65536, 4) == 12 * 15 * 65536 + 12 * 4 * 15
    fold = "merkle_fold_kernel(unsigned int const*, long long, long long)"
    diff = "merkle_diff_kernel(unsigned int const*, long long)"
    kernels = [(fold, 10.0), (fold, 2.0), (diff, 8.0)] * 2 \
        + [("void fold_kernel<int, MaxOp>(int const*)", 50.0)]
    labels = ("merkle_descent rows=15 blocks=65536 slots=4",
              "merkle_descent rows=7 blocks=1000 slots=4", "resync.descent")
    want = 100.0 * (rl.call_bytes(15, 65536, 4) + rl.call_bytes(7, 1000, 4)) \
        / 2 / peaks.HBM_BYTES_PER_S / 20e-6
    assert read(ROOFLINE, kernel_trace(kernels, labels)) \
        == pytest.approx(want)
    assert read(ROOFLINE, kernel_trace(kernels)) is None
    assert read(ROOFLINE, kernel_trace([("digest_kernel", 5.0)],
                                       labels)) is None
