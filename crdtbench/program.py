"""The system under test, called as a user calls it: ``repro_torch.sync``'s
``simulate_store`` or ``simulate``, with the inputs the traffic generator
made.

:func:`build` turns a configuration, a mix and a pool of generated inputs
into one zero-argument call a pool entry, each running one whole
simulation; the mix's kind (``kinds/<kind>.py``) says how. :func:`answer`
keeps what a call returned for the comparison, all of it on the host (the
round metrics as int64 [4, T, B], the final states, the convergence flags
and the byte footprints where the call gives them), so that the answers
kept for the judge hold no device memory.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch

from crdtbench import find


@dataclasses.dataclass
class Cell:
    calls: List[Callable]          # one whole simulation a pool entry
    rounds: int                    # rounds a simulation
    devices: List[torch.device]    # the cards a simulation uses
    step_shape: Optional[dict]     # one round_step call: b, n, u, p, k


def topology_of(config: dict):
    """The program's topology of ``config`` (``topologies/<kind>.py``)."""
    params = dict(config["topology"])
    return find("topologies", params.pop("kind")).program(**params)


def build(config: dict, mix: dict, pool: list, devices: list) -> Cell:
    return find("kinds", mix["kind"]).build(config, mix, pool, devices)


def answer(res) -> dict:
    """What the comparison reads of a call's result: ``metrics`` int64
    [4, T, B] (tx, mem, cpu, max_mem_node; B objects, the cards' partials
    of a store run with its object metrics reduced, or 1), ``final_x``
    ([B, N, U] or [N, U]), ``uniform`` [T(, B)] or None and ``bytes`` (a
    store's weighted final footprint [B, N]) or None."""
    sim = getattr(res, "sim", res)
    fields = [np.asarray(getattr(sim, f), np.int64)
              for f in ("tx", "mem", "cpu", "max_mem_node")]
    metrics = np.stack([f.T if f.ndim == 2 else f[:, None] for f in fields])
    uni = None if sim.uniform is None else np.asarray(sim.uniform, bool)
    fsb = getattr(res, "final_state_bytes", None)
    return {"metrics": metrics, "final_x": sim.final_x.cpu(), "uniform": uni,
            "bytes": None if fsb is None else np.asarray(fsb)}
