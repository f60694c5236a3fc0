"""A Retwis store (paper §V-D): ``simulate_store`` over ``objects``
objects of ``slots`` max-int32 slots, each its own δ-CRDT, driven by
``versioned_slot_op`` from a seed-drawn count table (Table II's mix,
``ops_per_node`` ops a replica a round, targets zipf ``zipf``). With
``"shard": true`` the store is split by object over the cards, one block
a card."""

from __future__ import annotations

import numpy as np
import torch

from crdtbench import check, program, traffic
from crdtbench.reference import crdt


def entry(mix: dict, config: dict, seed: int) -> dict:
    return {"seed": seed, "counts": traffic.retwis_counts(
        config["objects"], config["topology"]["nodes"],
        config["rounds"]["active"], mix["ops_per_node"], mix["zipf"], seed)}


def build(config: dict, mix: dict, pool: list, devices: list) \
        -> program.Cell:
    from repro_torch.core import MapLattice
    from repro_torch.core import value_lattices as vl
    from repro_torch.sync import StoreSpec, simulate_store
    from repro_torch.sync import workloads as W

    if config["value"] != "max_int32":
        raise ValueError(f"a Retwis store of {config['value']!r} values")
    topo = program.topology_of(config)
    algo, engine = mix["algorithm"], mix["engine"]
    active, quiet = config["rounds"]["active"], config["rounds"]["quiet"]
    objects, slots = config["objects"], config["slots"]
    lat = MapLattice(slots, vl.max_int(), "retwis").build()
    shard = config.get("shard", False)
    device = [str(d) for d in devices] if shard else str(devices[0])
    weights = traffic.retwis_weights(objects)
    calls = []
    for e in pool:
        spec = StoreSpec(objects=objects, weights=weights,
                         op_fn=W.versioned_slot_op(e["counts"], slots))
        calls.append(lambda spec=spec: simulate_store(
            algo, lat, topo, spec, active, quiet, engine=engine,
            shard=shard, object_metrics=config["object_metrics"],
            device=device))
    p = topo.max_degree
    step = {"b": objects // len(devices) if shard else objects,
            "n": topo.num_nodes, "u": slots, "p": p,
            "k": p + 1 if algo in ("bp", "bprr") else 1}
    return program.Cell(calls, active + quiet, list(devices), step)


def blocks(config: dict, mix: dict, entry: dict, devices: list, drop=None):
    """The store's reference, object block by object block on the card
    that ran those objects: yields ``(lo, hi, metrics int64 [4, T, hi -
    lo], final x[hi - lo, N, U])``."""
    counts = entry["counts"]                       # [T, N, B] int32
    objects, slots = config["objects"], config["slots"]
    active, quiet = config["rounds"]["active"], config["rounds"]["quiet"]
    shards = len(devices) if config.get("shard") else 1
    per_card = objects // shards
    step = min(config.get("reference_objects_per_block", objects), per_card)
    routes = {}
    lo = 0
    while lo < objects:
        hi = min(lo + step, (lo // per_card + 1) * per_card)
        dev = devices[lo // per_card]
        if str(dev) not in routes:
            routes[str(dev)] = check.routes_of(config, dev)
        cnt = torch.as_tensor(counts[:, :, lo:hi], device=dev)
        x0 = torch.zeros((hi - lo, config["topology"]["nodes"], slots),
                         dtype=torch.int32, device=dev)
        m, x, _ = crdt.run_delta(
            mix["algorithm"], x0,
            lambda x, t: crdt.slot_bumps(x, cnt[t].T), routes[str(dev)],
            active, quiet, drop)
        yield lo, hi, m.cpu().numpy(), x
        del cnt, x0, m, x
        lo = hi


def layout(config: dict, devices: list, metrics: np.ndarray):
    """Per-object metrics [4, T, B] in the answer's layout: as they are,
    or the per-card partials (sums; the max of max_mem_node) of a run
    whose object metrics were reduced in the loop."""
    if config["object_metrics"]:
        return metrics
    shards = len(devices) if config.get("shard") else 1
    parts = metrics.reshape(metrics.shape[:2] + (shards, -1))
    return np.concatenate([parts[:3].sum(-1), parts[3:].max(-1)])


def footprint(x: torch.Tensor, weights: np.ndarray) -> np.ndarray:
    """The weighted final footprint [B, N] of the states ``x[B, N, U]``."""
    return (crdt.size(x).double() * torch.as_tensor(
        weights[:, None], device=x.device)).cpu().numpy()


def reference(config: dict, mix: dict, entry: dict, devices: list,
              drop=None) -> dict:
    dev = devices[0]
    ms, xs = [], []
    for _, _, m, x in blocks(config, mix, entry, devices, drop):
        ms.append(m)
        xs.append(x.to(dev))
    x = torch.cat(xs)
    return {"metrics": layout(config, devices, np.concatenate(ms, -1)),
            "final_x": x, "uniform": None,
            "bytes": footprint(x, traffic.retwis_weights(config["objects"]))}


def judge(config: dict, mix: dict, entry: dict, ans: dict, devices: list) \
        -> dict:
    """Compared block by block: the reference's final states never all
    live at once."""
    out = dict.fromkeys(check.LIMITS, 0)
    weights = traffic.retwis_weights(config["objects"])
    ms = []
    fx = ans["final_x"]
    for lo, hi, m, x in blocks(config, mix, entry, devices):
        ms.append(m)
        got = fx[lo:hi].to(x.device)
        out["state_mismatch"] += check.states_differ(got, x)
        if config.get("converges"):
            out["unconverged"] += check.split(got)
        if ans["bytes"] is not None:
            out["bytes_mismatch"] += check.differ(
                ans["bytes"][lo:hi], footprint(x, weights[lo:hi]))
        del got
    if fx.shape[0] != config["objects"]:
        out["state_mismatch"] += int(fx[0].numel()) * config["objects"]
    out["metric_mismatch"] = check.differ(
        ans["metrics"], layout(config, devices, np.concatenate(ms, -1)))
    return out
