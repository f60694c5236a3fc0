"""Trace export, stall detection and profiling labels, JAX against the port.

* ``TraceLog``: spans, instants, complete events and counters on the same
  clock give the JAX package's events; its round counter tracks and
  propagation spans from the port's telemetry and provenance equal the
  ones the JAX package renders from its own, and both exports write the
  same documents.
* ``detect_stalls`` over the port's channels flags what the JAX package's
  flags over its own: ``fig_provenance.py``'s two anomalies (a joining
  replica under bprr: non-convergence; a mid-run partition under
  full-state sync: fault stalls), at a small size.
* The store's trace: the ``store_scan`` span, the chunk boundaries and the
  checkpoint saves, named and annotated as the JAX package's, and the
  port's own ``results_to_host`` counter after them.
* ``annotate`` labels a region in a ``torch.profiler`` trace.
"""

import itertools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import types as jtypes
from repro.obs import ProvenanceSpec as JaxProvenanceSpec
from repro.obs import TelemetrySpec as JaxTelemetrySpec
from repro.obs import TraceLog as JaxTraceLog
from repro.obs import anomaly as janomaly
from repro.sync import FaultSchedule as JaxSchedule
from repro.sync import StoreSpec as JaxStoreSpec
from repro.sync import simulate as jax_simulate
from repro.sync import simulate_store as jax_simulate_store
from repro.sync import topology as jtopo
from repro.sync import workloads as jW

from repro_torch.core import types as ttypes
from repro_torch.obs import (FAULT_STALL, NON_CONVERGENCE, ProvenanceSpec,
                             StallEvent, TelemetrySpec, TraceLog, annotate,
                             detect_stalls)
from repro_torch.sync import (FaultSchedule, StoreSpec, simulate,
                              simulate_store)
from repro_torch.sync import topology as ttopo
from repro_torch.sync import workloads as tW

torch.set_num_threads(1)

N, EVENTS, QUIET, U = 9, 8, 10, 64


def clock():
    """A deterministic clock: 0, 1e-6, 2e-6, ... seconds."""
    ticks = itertools.count()
    return lambda: next(ticks) * 1e-6


def events_of(log):
    return json.loads(json.dumps(log.events))


def test_primitives_match_jax(tmp_path):
    logs = [TraceLog(clock=clock()), JaxTraceLog(clock=clock())]
    for log in logs:
        with log.span("phase", n=3):
            log.instant("mark", rounds_done=4)
        log.complete("x", 10.0, 5.0, tid=3, k="v")
        log.counter("c", {"a": 1, "b": 2.5})
        log.counter("c", {"a": 2}, ts_us=99.0)
    assert events_of(logs[0]) == events_of(logs[1])
    for i, log in enumerate(logs):
        log.export_chrome(tmp_path / f"{i}.json")
        log.export_jsonl(tmp_path / f"{i}.jsonl")
    for ext in ("json", "jsonl"):
        assert (tmp_path / f"0.{ext}").read_text() == \
            (tmp_path / f"1.{ext}").read_text()
    with pytest.raises(RuntimeError, match="boom"):
        with logs[0].span("doomed"):
            raise RuntimeError("boom")
    assert logs[0].events[-1]["name"] == "doomed"


def runs(algo="classic"):
    """The same run in both packages, with telemetry and provenance."""
    jr = jax_simulate(algo, jtypes.GSet(N * EVENTS).lattice, jtopo.tree(N),
                      jW.gset_unique_op(N, EVENTS), EVENTS, QUIET,
                      wide_metrics=False, telemetry=JaxTelemetrySpec(),
                      provenance=JaxProvenanceSpec())
    tr = simulate(algo, ttypes.GSet(N * EVENTS).lattice, ttopo.tree(N),
                  tW.gset_unique_op(N, EVENTS), EVENTS, QUIET,
                  engine="mega", telemetry=TelemetrySpec(),
                  provenance=ProvenanceSpec(), device="cpu")
    return jr, tr


@pytest.mark.parametrize("algo", ["classic", "bprr"])
def test_counters_and_spans_match_jax(algo):
    jr, tr = runs(algo)
    logs = [TraceLog(clock=clock()), JaxTraceLog(clock=clock())]
    for log, r in zip(logs, (tr, jr)):
        log.add_round_counters(r.telemetry, prefix="run/", ts0_us=0.0)
        log.add_propagation_spans(r.provenance, prefix="classic/",
                                  ts0_us=0.0)
        log.add_propagation_spans(r.provenance, elems=range(5), ts0_us=7.0,
                                  round_us=10.0)
    got, want = events_of(logs[0]), events_of(logs[1])
    assert len(got) == EVENTS + QUIET + N * EVENTS + 5
    assert got == want


def test_single_run_views_are_refused():
    ttp = ttopo.ring(4)
    spec = StoreSpec(objects=2, op_fn=tW.gset_unique_sweep_op(4, 2, (0,)))
    r = simulate_store("bprr", ttypes.GSet(8).lattice, ttp, spec, 2,
                       telemetry=TelemetrySpec(),
                       provenance=ProvenanceSpec(), device="cpu")
    log = TraceLog()
    with pytest.raises(ValueError, match="single-run"):
        log.add_round_counters(r.telemetry)
    with pytest.raises(ValueError, match="single-run"):
        log.add_propagation_spans(r.provenance)
    log.add_round_counters(r.telemetry.cell(1))
    assert len(log.events) == 2


def test_zero_round_run_exports(tmp_path):
    r = simulate("state", ttypes.GSet(8).lattice, ttopo.ring(4),
                 lambda x, t: x, 0, 0, telemetry=TelemetrySpec(),
                 device="cpu")
    assert r.telemetry.recv_elems.shape == (0, 4)
    log = TraceLog()
    log.add_round_counters(r.telemetry)
    assert log.events == []
    log.export_chrome(tmp_path / "t.json")
    assert json.loads((tmp_path / "t.json").read_text())["traceEvents"] == []


# -- stall detection ------------------------------------------------------------------

def join_x0():
    x0 = np.zeros((N, U), bool)
    x0[1:, : U // 4] = True
    return x0


def stalls(events):
    return [(e.node, e.start, e.end, e.gap, e.cause) for e in events]


@pytest.mark.parametrize("algo", ["bprr", "state_driven"])
def test_join_stalls_match_jax(algo):
    """A joining replica (fig_provenance's anomaly/join): bprr's quiescent
    buffers send nothing, so node 0's gap is non-convergence;
    state_driven's resync closes it (nothing flagged)."""
    jtp, ttp = jtopo.partial_mesh(N, 4), ttopo.partial_mesh(N, 4)
    jr = jax_simulate(algo, jtypes.GSet(U).lattice, jtp,
                      lambda x, t: jnp.zeros_like(x), 0, QUIET,
                      x0=jnp.asarray(join_x0()), wide_metrics=False,
                      telemetry=JaxTelemetrySpec())
    tr = simulate(algo, ttypes.GSet(U).lattice, ttp,
                  lambda x, t: torch.zeros_like(x), 0, QUIET,
                  x0=torch.as_tensor(join_x0()), engine="fused",
                  track_convergence=True, telemetry=TelemetrySpec(),
                  device="cpu")
    got = detect_stalls(tr.telemetry, tx=tr.tx, k=3)
    want = janomaly.detect_stalls(jr.telemetry, tx=jr.tx, k=3)
    assert stalls(got) == stalls(want)
    if algo == "bprr":
        assert got and all(e.cause == NON_CONVERGENCE and e.node == 0
                           for e in got)
    else:
        assert got == []


def test_partition_stalls_match_jax():
    """A mid-run partition under full-state sync (fig_provenance's
    anomaly/partition): traffic flows, so every stall is a fault stall."""
    total = EVENTS + QUIET
    groups = [0] * (N // 2) + [1] * (N - N // 2)
    jtp, ttp = jtopo.partial_mesh(N, 4), ttopo.partial_mesh(N, 4)
    jr = jax_simulate("state", jtypes.GSet(N * EVENTS).lattice, jtp,
                      jW.gset_unique_op(N, EVENTS), 2, total - 2,
                      faults=JaxSchedule.partition(jtp, total, 1, total - 2,
                                                   groups),
                      wide_metrics=False, telemetry=JaxTelemetrySpec())
    tr = simulate("state", ttypes.GSet(N * EVENTS).lattice, ttp,
                  tW.gset_unique_op(N, EVENTS), 2, total - 2,
                  faults=FaultSchedule.partition(ttp, total, 1, total - 2,
                                                 groups),
                  engine="mega", telemetry=TelemetrySpec(), device="cpu")
    got = detect_stalls(tr.telemetry, tx=tr.tx, k=3)
    assert stalls(got) == stalls(janomaly.detect_stalls(jr.telemetry,
                                                        tx=jr.tx, k=3))
    assert got and all(e.cause == FAULT_STALL for e in got)
    assert all(isinstance(e, StallEvent) and e.rounds >= 3 for e in got)


def test_stall_detector_edges():
    gap = np.array([[0, 5], [0, 5], [0, 5], [0, 5], [0, 2]])
    want = janomaly.detect_stalls(gap, k=2)
    assert stalls(detect_stalls(gap, k=2)) == stalls(want)
    assert stalls(detect_stalls(gap, tx=np.zeros(5), k=2)) == stalls(
        janomaly.detect_stalls(gap, tx=np.zeros(5), k=2))
    with pytest.raises(ValueError, match="single-run"):
        detect_stalls(gap[None])
    with pytest.raises(ValueError):
        detect_stalls(gap, k=0)
    with pytest.raises(ValueError):
        detect_stalls(gap, tx=np.zeros(4))


# -- the store's trace ----------------------------------------------------------------

def test_store_trace_matches_jax(tmp_path):
    """Chunked and checkpointed: one ``store_scan`` span around the run, a
    ``chunk_boundary`` instant per chunk, a ``checkpoint_save`` span per
    save, with the JAX package's names, order and arguments."""
    n, b, t, q = 5, 2, 3, 4
    jtp, ttp = jtopo.ring(n), ttopo.ring(n)
    jlog, tlog = JaxTraceLog(), TraceLog()
    jax_simulate_store(
        "bprr", jtypes.GSet(n * t).lattice, jtp,
        JaxStoreSpec(objects=b, op_fn=jW.gset_unique_sweep_op(n, t, (0,))),
        t, q, wide_metrics=False, chunk_rounds=3,
        checkpoint=str(tmp_path / "j"), telemetry=JaxTelemetrySpec(),
        trace=jlog)
    simulate_store(
        "bprr", ttypes.GSet(n * t).lattice, ttp,
        StoreSpec(objects=b, op_fn=tW.gset_unique_sweep_op(n, t, (0,))),
        t, q, chunk_rounds=3, checkpoint=tmp_path / "t",
        telemetry=TelemetrySpec(), trace=tlog, device="cpu")

    def shape(log):
        return [(e["name"], e["ph"], e["args"]) for e in log.events]

    # the port adds one results_to_host counter, last; the rest is the JAX
    # package's trace
    assert [e["name"] for e in tlog.events].count("results_to_host") == 1
    assert tlog.events[-1]["name"] == "results_to_host"
    assert shape(tlog)[:-1] == shape(jlog)
    assert [e["name"] for e in tlog.events].count("chunk_boundary") == 3
    plain = TraceLog()
    simulate_store("bprr", ttypes.GSet(n * t).lattice, ttp,
                   StoreSpec(objects=b,
                             op_fn=tW.gset_unique_sweep_op(n, t, (0,))),
                   t, q, trace=plain, device="cpu")
    assert [e["name"] for e in plain.events] == ["store_scan",
                                                 "results_to_host"]


def test_annotate_labels_a_profiled_region():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with annotate("sync_round"):
            torch.ones(4).sum()
    assert "sync_round" in [e.key for e in prof.key_averages()]
