"""A whole run on the CPU (the harness without its look for a card, at
sizes a test holds) comes out correct, and not correct with the timed path
broken underneath: a round that returns its state unchanged, the ops of
half the batch left out, the blocks of the other cards left out of the
gathered result, and a metric or a final state altered where it is made."""

import pytest
import torch

from crdtbench import harness

from repro_torch.sync import algorithms, simulator, store

CELLS = ("retwis30k.bprr", "gmap4m.bprr", "gmap4m.join-digest",
         "retwis.sharded")


def run(bench, root, cell, seed=2 ** 32 + 5):
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}[cell]
    return harness.run_cell(bench, cell, seed, 0.05, False, ["cpu"] * chips,
                            0.0, root=root)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(test_bench, small_root, cell):
    out = run(test_bench, small_root, cell)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["metrics"]) == {
        m["name"] for m in harness.metrics_of(test_bench, cell,
                                              "end_to_end")}
    assert list(out)[-1] == "checks"


def unchanged_state(monkeypatch):
    orig = algorithms.SyncAlgorithm.round_step

    def step(self, carry, *a, **k):
        return (carry,) + tuple(orig(self, carry, *a, **k)[1:])

    monkeypatch.setattr(algorithms.SyncAlgorithm, "round_step", step)


def half_batch(monkeypatch):
    orig = simulator.RoundLoop.__init__

    def init(self, alg, carry, op_fn, *a, **k):
        def half(x, t):
            d = op_fn(x, t)
            d[d.shape[0] // 2:] = 0
            return d

        orig(self, alg, carry, half, *a, **k)

    monkeypatch.setattr(simulator.RoundLoop, "__init__", init)


def first_card_only(monkeypatch):
    orig = store.cat_results

    def gather(parts, device):
        return orig([parts[0]] + [p._replace(final_x=torch.zeros_like(
            p.final_x)) for p in parts[1:]], device)

    monkeypatch.setattr(store, "cat_results", gather)


def altered(field):
    def plant(monkeypatch):
        def wrap(orig):
            def collect(*a, **k):
                res = orig(*a, **k)
                if field == "tx":
                    res.tx[..., -1] += 1
                else:
                    res.final_x.view(-1)[-1] += 1
                return res
            return collect

        monkeypatch.setattr(simulator, "collect_result",
                            wrap(simulator.collect_result))
        monkeypatch.setattr(store, "collect_result",
                            wrap(store.collect_result))
    return plant


FAULTS = {"unchanged_state": (unchanged_state, CELLS),
          "half_batch": (half_batch, ("retwis30k.bprr", "gmap4m.bprr",
                                      "retwis.sharded")),
          "first_card_only": (first_card_only, ("retwis.sharded",)),
          "metric_altered": (altered("tx"), CELLS),
          "state_altered": (altered("x"), CELLS)}


@pytest.mark.parametrize("fault,cell", [(f, c) for f, (_, cells) in
                                        FAULTS.items() for c in cells])
def test_a_broken_timed_path_is_not_correct(test_bench, small_root,
                                            monkeypatch, fault, cell):
    FAULTS[fault][0](monkeypatch)
    out = run(test_bench, small_root, cell)
    assert not out["correct"], out["checks"]
    assert any(v["value"] > v["limit"] for v in out["checks"].values())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS[:3])
def test_a_sound_run_on_the_card(test_bench, small_root, cell):
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an sm_90 CUDA card")
    out = harness.run_cell(test_bench, cell, 77, 0.5, False,
                           [torch.device("cuda:0")], 0.0, root=small_root)
    assert out["correct"], out["checks"]
    assert out["device"]["memory_peak_bytes"] > 0
