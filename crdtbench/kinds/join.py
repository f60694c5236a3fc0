"""A joining replica healed by the resync (``simulate`` with ``x0=`` and
a ``DigestSpec``): replica 0 starts at ⊥, the others hold ``held`` of the
``block``-key digest blocks of every ``tile``-key tile, cyclically from a
seed-drawn block of each tile, at version ``value``; ``rounds`` sync-only
rounds, no ops."""

from __future__ import annotations

import numpy as np
import torch

from crdtbench import check, program, traffic
from crdtbench.reference import crdt


def entry(mix: dict, config: dict, seed: int) -> dict:
    keys, tile, block = config["keys"], mix["tile"], mix["block"]
    starts = np.random.default_rng(seed).integers(tile // block,
                                                  size=keys // tile)
    return {"seed": seed, "x0": traffic.join_start(
        config["topology"]["nodes"], keys, tile, mix["held"], block,
        mix["value"], starts)}


def build(config: dict, mix: dict, pool: list, devices: list) \
        -> program.Cell:
    from repro_torch.core import GMap
    from repro_torch.sync import DigestSpec, simulate

    if config["value"] != "max_int32":
        raise ValueError(f"a join of {config['value']!r} values")
    topo = program.topology_of(config)
    algo, engine = mix["algorithm"], mix["engine"]
    lat = GMap(config["keys"]).lattice
    dev = devices[0]
    spec = DigestSpec(mix["block"])
    calls = []
    for e in pool:
        x0 = torch.as_tensor(e["x0"], device=dev)
        calls.append(lambda x0=x0: simulate(
            algo, lat, topo, _no_op, 0, mix["rounds"], x0=x0, engine=engine,
            digest=spec, device=str(dev), track_convergence=True))
    # the resync never calls round_step: no step shape
    return program.Cell(calls, mix["rounds"], list(devices), None)


def _no_op(x, t):
    return torch.zeros_like(x)


def reference(config: dict, mix: dict, entry: dict, devices: list,
              drop=None) -> dict:
    if mix["algorithm"] != "digest_driven":
        raise ValueError(f"no reference for a {mix['algorithm']!r} join")
    dev = devices[0]
    m, x, uni = crdt.run_digest(torch.as_tensor(entry["x0"], device=dev),
                                check.routes_of(config, dev), mix["rounds"],
                                mix["block"], drop)
    return {"metrics": m.cpu().numpy()[..., None], "final_x": x,
            "uniform": uni.cpu().numpy(), "bytes": None}


def judge(config: dict, mix: dict, entry: dict, ans: dict, devices: list) \
        -> dict:
    """A join states convergence whatever the configuration says."""
    return check.judge_whole(ans, reference(config, mix, entry, devices),
                             True)
