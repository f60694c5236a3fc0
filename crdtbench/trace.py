"""The traced run: ``torch.profiler`` (CPU and CUDA) over whole simulations
inside the window, read back from its Chrome trace into a :class:`Trace`
that the per-layer readers (``layer_metrics/<name>.py``) take.

The harness labels its own phases with ``record_function``: the window
(``crdtbench.window``) and, for every simulation, ``pool.next``,
``sim.call`` (the call into the program) and ``sim.result`` (the wait for
the card); the answers judged are kept after the profile. A device is busy
while any kernel, copy or memset runs on it; the union of those
intervals, not their sum, since operations of several streams or blocks
overlap.
"""

from __future__ import annotations

import dataclasses
import json
from collections import defaultdict
from pathlib import Path
from typing import List, Optional

WINDOW = "crdtbench.window"
SPANS = ("pool.next", "sim.call", "sim.result")

# The program's CUDA kernels (``src/repro_torch/csrc/*.cu``) by function
# name; every other kernel is PyTorch's own.
PORT_KERNELS = frozenset((
    "round_step_kernel", "short_kernel", "long_kernel", "fold_kernel",
    "digest_kernel", "extract_kernel", "join_kernel", "delta_kernel",
    "lex_kernel"))


@dataclasses.dataclass
class Op:
    name: str
    card: int
    ts: float           # microseconds
    dur: float


def base_name(name: str) -> str:
    """A kernel's function name (as the profiler demangles it) without its
    return type, template arguments and parameters."""
    s = name[5:] if name.startswith("void ") else name
    cut = min([i for i in (s.find("<"), s.find("(")) if i >= 0],
              default=len(s))
    return s[:cut].strip()


def template_args(name: str) -> int:
    """How many template arguments a demangled kernel name carries."""
    start = name.find("<")
    if start < 0:
        return 0
    depth, count = 0, 1
    for ch in name[start:]:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
            if depth == 0:
                return count
        elif ch == "," and depth == 1:
            count += 1
    return count


def is_port_kernel(name: str) -> bool:
    return base_name(name) in PORT_KERNELS


def is_round_step(name: str) -> bool:
    """``round_step``'s kernels: the long-row ``round_step_kernel`` and the
    short-row ``short_kernel<T, Op, VB, PF>`` (``round_recv``'s short
    kernel takes three template arguments)."""
    base = base_name(name)
    if base == "round_step_kernel":
        return True
    return base == "short_kernel" and template_args(name) == 4


@dataclasses.dataclass
class Trace:
    t0: float                      # the window, microseconds
    t1: float
    rounds: int                    # rounds profiled
    cards: List[int]
    kernels: List[Op]
    copies: List[Op]
    sets: List[Op]
    host: list                     # (name, ts, dur) on the window's thread
    step_shape: Optional[dict] = None

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def intervals(self, card: int) -> list:
        """The merged busy intervals of ``card`` inside the window."""
        spans = sorted((max(o.ts, self.t0), min(o.ts + o.dur, self.t1))
                       for o in self.kernels + self.copies + self.sets
                       if o.card == card)
        out = []
        for a, b in spans:
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_s(self, card: int) -> float:
        return sum(b - a for a, b in self.intervals(card)) / 1e6

    def gaps(self, card: int) -> list:
        """``(start, length)`` of every idle stretch of ``card`` inside the
        window, microseconds."""
        out, at = [], self.t0
        for a, b in self.intervals(card):
            if a > at:
                out.append((at, a - at))
            at = max(at, b)
        if self.t1 > at:
            out.append((at, self.t1 - at))
        return out

    def host_at(self, t: float) -> str:
        """What the host was doing at ``t``: the harness span open then and
        the innermost operation inside it."""
        span, inner, best = "harness", None, None
        for name, ts, dur in self.host:
            if ts <= t < ts + dur:
                if name in SPANS:
                    span = name
                elif name != WINDOW and (best is None or ts >= best):
                    inner, best = name, ts
        return span if inner is None else f"{span}/{inner}"

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took the most time and the longest
        idle stretches, each named, in seconds."""
        by_name = defaultdict(float)
        for o in self.kernels + self.copies + self.sets:
            by_name[o.name[:200]] += o.dur / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(((s, d) for c in self.cards for s, d in self.gaps(c)),
                      key=lambda g: -g[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[self.host_at(s + min(d, 1.0) / 2), d / 1e6]
                              for s, d in gaps]}


def read(path: Path, rounds: int, cards: List[int],
         step_shape: Optional[dict] = None) -> Trace:
    """A :class:`Trace` from a Chrome trace that ``torch.profiler`` wrote
    around one ``crdtbench.window`` annotation."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return from_events(events, rounds, cards, step_shape)


def from_events(events: list, rounds: int, cards: List[int],
                step_shape: Optional[dict] = None) -> Trace:
    window = [e for e in events if e.get("ph") == "X"
              and e.get("cat") == "user_annotation" and e["name"] == WINDOW]
    if len(window) != 1:
        raise ValueError(f"{len(window)} {WINDOW} annotations in the trace")
    w = window[0]
    t0, t1, tid = float(w["ts"]), float(w["ts"]) + float(w["dur"]), w["tid"]
    groups = {"kernel": [], "gpu_memcpy": [], "gpu_memset": []}
    host = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat in groups:
            card = int((e.get("args") or {}).get("device", e.get("pid", 0)))
            groups[cat].append(Op(e["name"], card, float(e["ts"]),
                                  float(e.get("dur", 0.0))))
        elif cat in ("cpu_op", "user_annotation", "cuda_runtime",
                     "cuda_driver") and e.get("tid") == tid:
            host.append((e["name"], float(e["ts"]), float(e.get("dur", 0.0))))

    def inside(ops):
        return [o for o in ops if o.ts < t1 and o.ts + o.dur > t0]

    return Trace(t0, t1, rounds, list(cards), inside(groups["kernel"]),
                 inside(groups["gpu_memcpy"]), inside(groups["gpu_memset"]),
                 host, step_shape)
