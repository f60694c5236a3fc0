"""One run of one cell: make the inputs from the seed, warm up, time whole
simulations back to back for a window (or profile some under ``--trace
1``), then judge a seed-drawn sample of the window's answers against the
plain reference.

Everything that belongs to a cell is found by name: the cell in
``BENCHMARK.json``, its configuration file (``configs/<config>.json``) and
the topology it names (``topologies/<kind>.py``), its mix
(``mixes/<traffic>.json``) and the mix's kind (``kinds/<kind>.py``: inputs,
calls, reference and comparison), and its metrics' readers
(``end_to_end/<metric>.py`` over the window's timings,
``layer_metrics/<metric>.py`` over the traced window).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import sys
import time
from pathlib import Path
from typing import List

import numpy as np
import torch

from crdtbench import check, find, guard, program, traffic
from crdtbench import trace as tr

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
TRACE_S = 2.0          # least wall time the traced run profiles
OCCURRENCES = 3        # the answer judged: one of a pool entry's first 3


@dataclasses.dataclass
class Window:
    setup_s: float
    window_s: float
    rounds: int
    sims_s: List[float]
    peak_bytes: int


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(bench: dict, name: str, root: Path = ROOT):
    """``(cell, config, mix)`` of the cell ``name``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r}; the cells are {sorted(cells)}")
    cell = cells[name]
    files = {c["name"]: c["file"] for c in bench["configs"]}
    config = load_json(root / files[cell["config"]])
    mix = load_json(HERE / "mixes" / f"{cell['traffic']}.json")
    return cell, config, mix


def metrics_of(bench: dict, cell: str, section: str) -> list:
    """The metrics of ``section`` that ``cell`` reports."""
    return [m for m in bench[section]
            if cell in m.get("workloads", [cell])]


def reader(folder: str, name: str):
    """The ``read`` function of ``<folder>/<name>.py``."""
    return find(folder, name).read


def sync(devices) -> None:
    for d in {torch.device(d) for d in devices}:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def peak_bytes(devices) -> int:
    cards = {torch.device(d) for d in devices
             if torch.device(d).type == "cuda"}
    return max((torch.cuda.max_memory_allocated(d) for d in cards),
               default=0)


class Sampler:
    """Keeps, for every pool entry, the answer of a seed-drawn occurrence
    among its first ``OCCURRENCES`` in the window (its last, if it ran
    fewer times); the answers are judged once the window has closed."""

    def __init__(self, seed: int, pool: int):
        rng = np.random.default_rng(traffic.pool_seed(seed, 1 << 20))
        self.want = rng.integers(OCCURRENCES, size=pool).tolist()
        self.seen = [0] * pool
        self.kept = [None] * pool

    @classmethod
    def none(cls, pool: int) -> "Sampler":
        """A sampler that keeps no answer."""
        out = cls(0, pool)
        out.want = [-1] * pool
        return out

    def wants(self, entry: int) -> bool:
        return self.seen[entry] <= self.want[entry]

    def done(self) -> bool:
        return all(s > w for s, w in zip(self.seen, self.want))

    def keep(self, entry: int, ans) -> None:
        if ans is not None:
            self.kept[entry] = ans
        self.seen[entry] += 1


def simulations(cell, sampler, stop, record):
    """Whole simulations back to back, cycling through the pool, until
    ``stop(elapsed seconds)`` at the end of a cycle (so every pool entry
    has an answer); a simulation started is finished and counted. Returns
    ``(wall seconds, per-simulation seconds)``; the wall time leaves out
    the copies of the answers kept for the judge, which are the
    harness's work and not the program's."""
    times, k, kept_s = [], 0, 0.0
    t_start = time.perf_counter()
    while True:
        with record("pool.next"):
            entry = k % len(cell.calls)
            call = cell.calls[entry]
        t0 = time.perf_counter()
        with record("sim.call"):
            res = call()
        with record("sim.result"):
            sync(cell.devices)
            t1 = time.perf_counter()
        if sampler.wants(entry):
            sampler.keep(entry, program.answer(res))
            kept_s += time.perf_counter() - t1
        else:
            sampler.keep(entry, None)
        del res
        times.append(t1 - t0)
        k += 1
        if k % len(cell.calls) == 0 and stop(t1 - t_start - kept_s):
            return time.perf_counter() - t_start - kept_s, times


def run_cell(bench: dict, name: str, seed: int, seconds: float, traced: bool,
             devices: list, t_process: float, scratch: Path = None,
             root: Path = ROOT) -> dict:
    """The result line of one run (without the device's name)."""
    _, config, mix = find_cell(bench, name, root)
    pool = traffic.generate(mix, config, seed)
    cell = program.build(config, mix, pool, devices)
    for call in cell.calls:                     # warm-up: every pool entry
        res = call()
        sync(devices)
        del res
    sync(devices)
    setup_s = time.perf_counter() - t_process
    sampler = Sampler(seed, len(cell.calls))

    if traced:
        trace = _traced(cell, min(seconds, TRACE_S), scratch)
        # the answers judged: a pool cycle or three after the profile,
        # kept as in an untraced window, so no copy of theirs is traced
        simulations(cell, sampler, lambda s: sampler.done(),
                    lambda name: contextlib.nullcontext())
        metrics = {}
        for m in metrics_of(bench, name, "per_layer"):
            v = reader("layer_metrics", m["name"])(trace)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        attempted = trace.rounds // cell.rounds
    else:
        wall, sims = simulations(cell, sampler, lambda s: s >= seconds,
                                 lambda name: contextlib.nullcontext())
        ms = sorted(1e3 * s for s in sims)
        print(f"window: {len(sims)} simulations in {wall:.3f} s; ms min "
              f"{ms[0]:.3f} median {ms[len(ms) // 2]:.3f} max {ms[-1]:.3f}",
              file=sys.stderr)
        window = Window(setup_s, wall, cell.rounds * len(sims), sims,
                        peak_bytes(devices))
        metrics = {m["name"]: {"value": float(reader("end_to_end",
                                                     m["name"])(window)),
                               "unit": m["unit"]}
                   for m in metrics_of(bench, name, "end_to_end")}
        attempted = len(sims)
    peak = peak_bytes(devices)
    del cell
    gc.collect()
    if any(torch.device(d).type == "cuda" for d in devices):
        torch.cuda.empty_cache()
    guard.check("once the window closed")

    numbers = dict.fromkeys(check.LIMITS, 0)
    failed = 0
    for entry, ans in enumerate(sampler.kept):
        got = check.judge(config, mix, pool[entry], ans, devices)
        failed += any(got[k] > check.LIMITS[k] for k in got)
        for k, v in got.items():
            numbers[k] += v
        sampler.kept[entry] = None
        del ans
    out = {"correct": failed == 0 and all(
               numbers[k] <= check.LIMITS[k] for k in numbers),
           "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": {"count": len(devices), "memory_peak_bytes": peak}}
    if traced:
        cards = trace.cards
        out["device"]["busy_s"] = sum(trace.busy_s(c) for c in cards) \
            / len(cards)
        out["device"]["window_s"] = trace.window_s
        out["breakdown"] = trace.breakdown()
    out["checks"] = {k: {"value": v, "limit": check.LIMITS[k]}
                     for k, v in numbers.items()}
    return out


def _traced(cell, least_s: float, scratch: Path) -> tr.Trace:
    """Profile whole simulations until ``least_s`` seconds have passed."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = any(torch.device(d).type == "cuda" for d in cell.devices)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        with record_function(tr.WINDOW):
            _, sims = simulations(cell, Sampler.none(len(cell.calls)),
                                  lambda s: s >= least_s, record_function)
    scratch.mkdir(parents=True, exist_ok=True)
    path = scratch / "trace.json"
    prof.export_chrome_trace(str(path))
    del prof
    try:
        cards = sorted({torch.device(d).index or 0 for d in cell.devices})
        return tr.read(path, cell.rounds * len(sims), cards, cell.step_shape)
    finally:
        path.unlink()
