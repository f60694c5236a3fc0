"""The comparison that decides ``correct``: a call's answer against the
plain reference (``crdtbench/reference``) run on the same generated
inputs. The mix's kind (``kinds/<kind>.py``) runs the reference and
compares; this module holds what every kind shares.

Every number compared counts exact disagreements, so every limit is 0:

* ``state_mismatch``: final slots that differ from the reference's;
* ``metric_mismatch``: per-round tx / mem / cpu / max_mem_node entries
  that differ (per object, per card's partial, or per run);
* ``uniform_mismatch``: rounds whose convergence flag differs, where the
  call tracks convergence;
* ``bytes_mismatch``: per-(object, replica) weighted footprints that
  differ, where the call reports them;
* ``unconverged``: objects (or runs) whose replicas do not all hold one
  state at the end, where the configuration states convergence.

The reference runs on the cards the simulation used, after the program's
state is freed.
"""

from __future__ import annotations

import numpy as np
import torch

from crdtbench import find
from crdtbench.reference import crdt

LIMITS = {"state_mismatch": 0, "metric_mismatch": 0, "uniform_mismatch": 0,
          "bytes_mismatch": 0, "unconverged": 0}


def differ(a: np.ndarray, b: np.ndarray) -> int:
    if a.shape != b.shape:
        return int(max(a.size, b.size))
    return int((a != b).sum())


def states_differ(got: torch.Tensor, want: torch.Tensor) -> int:
    if tuple(got.shape) != tuple(want.shape):
        return int(max(got.numel(), want.numel()))
    return int((got.to(want.device) != want).sum())


def split(x: torch.Tensor) -> int:
    """Objects of ``x[B, N, U]`` whose replicas disagree."""
    return int((~(x == x[:, :1]).all(-1).all(-1)).sum())


def routes_of(config: dict, device) -> crdt.Routes:
    """The reference's routes of ``config``'s topology, from the frozen
    neighbour lists of ``topologies/<kind>.py``."""
    params = dict(config["topology"])
    lists = find("topologies", params.pop("kind")).neighbours(**params)
    return crdt.routes(lists, device)


def judge(config: dict, mix: dict, entry: dict, ans: dict, devices: list) \
        -> dict:
    """The numbers compared for one answer ``ans`` (see
    :func:`crdtbench.program.answer`) of pool entry ``entry``."""
    return find("kinds", mix["kind"]).judge(config, mix, entry, ans, devices)


def reference_answer(config: dict, mix: dict, entry: dict, devices: list,
                     drop=None) -> dict:
    """The reference's whole answer in the layout of
    :func:`crdtbench.program.answer`; ``drop`` breaks delivery (the
    control)."""
    return find("kinds", mix["kind"]).reference(config, mix, entry, devices,
                                                drop)


def judge_whole(ans: dict, want: dict, converges: bool) -> dict:
    """The numbers compared, with the reference's answer ``want`` whole."""
    out = dict.fromkeys(LIMITS, 0)
    out["state_mismatch"] = states_differ(ans["final_x"], want["final_x"])
    if converges:
        out["unconverged"] = split(ans["final_x"][None])
    if ans["uniform"] is not None:
        out["uniform_mismatch"] = differ(ans["uniform"], want["uniform"])
    out["metric_mismatch"] = differ(ans["metrics"], want["metrics"])
    return out
