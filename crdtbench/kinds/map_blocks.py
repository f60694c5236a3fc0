"""The paper's GMap K% micro-benchmark (Table I): one grow-only map of
``keys`` max-int32 versions under ``simulate``; every replica bumps its
own K% key block each active round, the blocks rotated along the keys by
a seed-drawn shift."""

from __future__ import annotations

import numpy as np
import torch

from crdtbench import check, program, traffic
from crdtbench.reference import crdt


def entry(mix: dict, config: dict, seed: int) -> dict:
    keys = config["keys"]
    shift = int(np.random.default_rng(seed).integers(keys))
    return {"seed": seed, "shift": shift, "blocks": traffic.key_blocks(
        config["topology"]["nodes"], keys, mix["k_pct"], shift)}


def build(config: dict, mix: dict, pool: list, devices: list) \
        -> program.Cell:
    from repro_torch.core import GMap
    from repro_torch.sync import simulate

    if config["value"] != "max_int32":
        raise ValueError(f"a GMap of {config['value']!r} values")
    topo = program.topology_of(config)
    algo, engine = mix["algorithm"], mix["engine"]
    active, quiet = config["rounds"]["active"], config["rounds"]["quiet"]
    lat = GMap(config["keys"]).lattice
    dev = devices[0]
    calls = []
    for e in pool:
        blocks = torch.as_tensor(e["blocks"], device=dev)

        def op_fn(x, t, blocks=blocks):
            return torch.where(blocks, x + 1, 0).to(x.dtype)

        calls.append(lambda op_fn=op_fn: simulate(
            algo, lat, topo, op_fn, active, quiet, engine=engine,
            device=str(dev)))
    p = topo.max_degree
    step = {"b": 1, "n": topo.num_nodes, "u": config["keys"], "p": p,
            "k": p + 1 if algo in ("bp", "bprr") else 1}
    return program.Cell(calls, active + quiet, list(devices), step)


def reference(config: dict, mix: dict, entry: dict, devices: list,
              drop=None) -> dict:
    dev = devices[0]
    blocks = torch.as_tensor(entry["blocks"], device=dev)
    x0 = torch.zeros((1,) + tuple(blocks.shape), dtype=torch.int32,
                     device=dev)
    m, x, uni = crdt.run_delta(
        mix["algorithm"], x0, lambda x, t: crdt.block_bumps(x, blocks),
        check.routes_of(config, dev), config["rounds"]["active"],
        config["rounds"]["quiet"], drop)
    return {"metrics": m.cpu().numpy(), "final_x": x[0],
            "uniform": uni.cpu().numpy()[:, 0], "bytes": None}


def judge(config: dict, mix: dict, entry: dict, ans: dict, devices: list) \
        -> dict:
    return check.judge_whole(ans, reference(config, mix, entry, devices),
                             config.get("converges", False))
