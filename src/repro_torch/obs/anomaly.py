"""Convergence anomaly detection over telemetry channels, a copy of
``repro.obs.anomaly`` (pure numpy; the port keeps its own).

A healthy synchronization run shrinks every node's divergence gap
(``TelemetryResult.div_gap``: elements the cluster knows that the node
does not) every round the node is up and traffic flows. Two distinct
pathologies break that, and they need different responses:

* **fault_stall** — messages were moving (the cluster transmitted during
  the window) but the node's gap did not shrink: loss/partition/churn is
  eating exactly the deltas this node needed. Transient; resolves when
  the fault clears or a resync round-trip repairs it.
* **non_convergence** — the gap is stuck AND the cluster sent (almost)
  nothing the whole window: nothing in flight could possibly close the
  gap. This is the algorithmic signature of e.g. bprr's tx=0 join gap
  (DESIGN.md §13): quiescent senders have empty buffers, so a joining
  replica starves forever without a resync family.

``detect_stalls`` flags maximal windows of ≥ k rounds where a node's gap
is positive and never shrinks, then classifies each by the cluster's
transmission over the window. Pure numpy on host-side channels: nothing
here touches the device.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

FAULT_STALL = "fault_stall"
NON_CONVERGENCE = "non_convergence"


@dataclasses.dataclass(frozen=True)
class StallEvent:
    """One flagged stall window: node ``node`` held a positive,
    non-shrinking divergence gap from round ``start`` through ``end``
    (inclusive), ending the window at ``gap`` elements behind."""

    node: int
    start: int
    end: int
    gap: int
    cause: str  # FAULT_STALL | NON_CONVERGENCE

    @property
    def rounds(self) -> int:
        return self.end - self.start + 1


def detect_stalls(div_gap, tx=None, k: int = 3,
                  tx_eps: int = 0) -> List[StallEvent]:
    """Flag per-node stall windows in a single-run ``div_gap`` channel.

    ``div_gap`` is a [T, N] array (or a ``TelemetryResult``, whose
    ``div_gap`` attribute is used). ``tx`` is the cluster's per-round
    transmission ([T], e.g. ``SimResult.tx``); without it every stall is
    conservatively classified ``fault_stall`` (traffic unknown). A round
    t ≥ 1 is *stuck* for node n when ``gap[t] > 0`` and
    ``gap[t] >= gap[t-1]``; maximal stuck runs of at least ``k`` rounds
    become events. A window whose total cluster transmission is ≤
    ``tx_eps`` is ``non_convergence`` (nothing in flight could have
    closed the gap), otherwise ``fault_stall``.
    """
    gap = np.asarray(getattr(div_gap, "div_gap", div_gap))
    if gap.ndim != 2:
        raise ValueError(
            f"detect_stalls wants a single-run [T, N] div_gap channel, "
            f"got shape {gap.shape} — pass telemetry.cell(b) for one "
            f"cell of a batched result")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    txv: Optional[np.ndarray] = None
    if tx is not None:
        txv = np.asarray(tx)
        if txv.shape[:1] != gap.shape[:1]:
            raise ValueError(
                f"tx has {txv.shape[0] if txv.ndim else 0} rounds but "
                f"div_gap has {gap.shape[0]}")

    t_total, n = gap.shape
    events: List[StallEvent] = []

    def close(nd: int, start: int, end: int) -> None:
        if end - start + 1 < k:
            return
        if txv is not None and float(txv[start:end + 1].sum()) <= tx_eps:
            cause = NON_CONVERGENCE
        else:
            cause = FAULT_STALL
        events.append(StallEvent(node=nd, start=start, end=end,
                                 gap=int(gap[end, nd]), cause=cause))

    for nd in range(n):
        run_start = None
        for t in range(1, t_total + 1):
            stuck = (t < t_total and gap[t, nd] > 0
                     and gap[t, nd] >= gap[t - 1, nd])
            if stuck and run_start is None:
                run_start = t
            elif not stuck and run_start is not None:
                close(nd, run_start, t - 1)
                run_start = None
    events.sort(key=lambda ev: (ev.start, ev.node))
    return events
