"""Structured trace export: Chrome-trace/Perfetto JSON and a JSONL event
log, PyTorch counterpart of ``repro.obs.trace``.

``TraceLog`` collects host-side events — phase spans, instant markers
(chunk boundaries, checkpoint saves), and per-round counter tracks built
from a :class:`~repro_torch.obs.telemetry.TelemetryResult` — and renders them
two ways:

* ``export_chrome(path)`` — the Chrome trace event format
  (``{"traceEvents": [...]}``), loadable in ``chrome://tracing`` and
  https://ui.perfetto.dev;
* ``export_jsonl(path)`` — one JSON object per line, the greppable log.

``annotate(name)`` is ``torch.profiler.record_function(name)``: it labels
a region (its kernel launches) in a ``torch.profiler`` trace.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Optional

import numpy as np

_PID = 1          # single-process traces; tid separates tracks
TID_PHASES = 1    # host phase spans (build / compile / scan / export)
TID_MARKS = 2     # instant markers (chunk boundaries, checkpoint saves)
TID_LINEAGE = 3   # per-element propagation spans (provenance lineage)


class TraceLog:
    """Append-only host event log with a monotonic µs clock."""

    def __init__(self, clock=time.perf_counter):
        self._clock = clock
        self._t0 = clock()
        self.events: list[dict] = []

    def _now_us(self) -> float:
        return (self._clock() - self._t0) * 1e6

    def instant(self, name: str, tid: int = TID_MARKS, **args):
        """A zero-duration marker (Chrome ``ph: "i"``)."""
        self.events.append({"name": name, "ph": "i", "s": "t",
                            "ts": self._now_us(), "pid": _PID, "tid": tid,
                            "args": args})

    def complete(self, name: str, ts_us: float, dur_us: float,
                 tid: int = TID_PHASES, **args):
        """A span with explicit start/duration (Chrome ``ph: "X"``)."""
        self.events.append({"name": name, "ph": "X", "ts": ts_us,
                            "dur": dur_us, "pid": _PID, "tid": tid,
                            "args": args})

    def counter(self, name: str, values: dict, ts_us: Optional[float] = None):
        """One sample of a counter track (Chrome ``ph: "C"``)."""
        self.events.append({"name": name, "ph": "C",
                            "ts": self._now_us() if ts_us is None else ts_us,
                            "pid": _PID, "tid": 0,
                            "args": {k: float(v) for k, v in values.items()}})

    @contextlib.contextmanager
    def span(self, name: str, **args):
        """Measure a host phase as a complete event (wall clock)."""
        t0 = self._now_us()
        try:
            yield self
        finally:
            self.complete(name, t0, self._now_us() - t0, **args)

    # -- telemetry counter tracks --------------------------------------------

    def add_round_counters(self, tele, prefix: str = "",
                           round_us: float = 1000.0,
                           ts0_us: Optional[float] = None):
        """Render an (unbatched) TelemetryResult as per-round counter
        tracks, one tick = ``round_us`` on the trace timeline: redundancy
        ratio, staleness max, buffer occupancy total, divergence total.
        """
        if tele.batch is not None:
            raise ValueError(
                "add_round_counters wants a single-run telemetry result — "
                "pass tele.cell(b) for one cell of a batched run")
        red = tele.redundancy_over_time()
        t0 = self._now_us() if ts0_us is None else ts0_us
        rounds = tele.recv_elems.shape[0]
        for t in range(rounds):
            ts = t0 + t * round_us
            vals = {
                "recv_elems": int(tele.recv_elems[t].sum()),
                "novel_elems": int(tele.novel_elems[t].sum()),
                "buf_elems": int(tele.buf_elems[t].sum()),
                "div_gap": int(tele.div_gap[t].sum()),
                "stale_max": int(tele.stale_rounds[t].max()),
                "ack_lag_max": int(tele.ack_lag[t].max()),
            }
            if red[t] == red[t]:              # not NaN
                vals["redundancy"] = float(red[t])
            self.counter(f"{prefix}round", vals, ts_us=ts)

    # -- provenance lineage tracks -------------------------------------------

    def add_propagation_spans(self, prov, elems=None, prefix: str = "",
                              round_us: float = 1000.0,
                              ts0_us: Optional[float] = None):
        """Render an (unbatched) ProvenanceResult's element lineages as
        complete spans on the lineage track: one span per covered element
        from its first birth round to the round its LAST covered node
        obtained it, annotated with origins, coverage, hop depth, and the
        per-cause waste split. ``elems`` restricts to a subset (default:
        every element covered anywhere). One round = ``round_us`` µs on
        the trace timeline, matching ``add_round_counters``."""
        if prov.batch is not None:
            raise ValueError(
                "add_propagation_spans wants a single-run provenance "
                "result — pass prov.cell(b) for one cell of a batched run")
        prov = prov.numpy()
        t0 = self._now_us() if ts0_us is None else ts0_us
        n, e = prov.cov.shape
        if elems is None:
            elems = np.nonzero((prov.cov != 0).any(axis=0))[0]
        for el in elems:
            el = int(el)
            covered = prov.cov[:, el] != 0
            if not covered.any():
                continue
            births = prov.birth[covered, el]
            # pre-run (x0-seeded) coverage has birth −1: clamp to round 0
            t_first = max(int(births.min()), 0)
            t_last = max(int(births.max()), 0)
            info = prov.lineage(el)
            self.complete(
                f"{prefix}elem:{el}",
                t0 + t_first * round_us,
                (t_last - t_first + 1) * round_us,
                tid=TID_LINEAGE,
                element=el,
                origins=info["origins"],
                nodes_covered=int(covered.sum()),
                total_nodes=n,
                full_coverage_round=info["full_coverage_round"],
                max_hop=int(prov.hop[covered, el].max()),
                waste_backprop=int(
                    prov.waste_bp_elems[:, el].astype(np.int64).sum()),
                waste_concurrent=int(
                    prov.waste_cp_elems[:, el].astype(np.int64).sum()))

    # -- export --------------------------------------------------------------

    def export_chrome(self, path) -> None:
        """Chrome trace event format (Perfetto/chrome://tracing JSON)."""
        doc = {"traceEvents": self.events, "displayTimeUnit": "ms"}
        with open(path, "w") as f:
            json.dump(doc, f)

    def export_jsonl(self, path) -> None:
        """One JSON event per line."""
        with open(path, "w") as f:
            for ev in self.events:
                f.write(json.dumps(ev) + "\n")


def annotate(name: str):
    """Label a region for device-side profiling: a
    ``torch.profiler.record_function`` context (its launches show under
    ``name`` in a ``torch.profiler`` trace; a no-op cost outside one)."""
    import torch

    return torch.profiler.record_function(name)
