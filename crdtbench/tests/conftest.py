"""Fixtures of the benchmark's own tests: the program on the path, and
the cells' configurations at sizes a CPU test holds (the same files with
their scale cut; every width kept)."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

SMALL = {
    "retwis-mesh50-30k": {"topology": {"kind": "partial_mesh", "nodes": 8,
                                       "degree": 4},
                          "objects": 96, "slots": 16,
                          "rounds": {"active": 6, "quiet": 3}},
    "gmap-mesh15-4m": {"keys": 4096, "rounds": {"active": 6, "quiet": 4}},
}

# Paths that no cell of BENCHMARK.json drives yet, held to the reference
# here so that a later cell of them needs data files alone: the
# digest-driven join, and a store sharded by object over four cards with
# its metrics reduced in the loop. A test configuration is a benchmark
# configuration with some keys changed.
EXTRA_CONFIGS = {
    "retwis-sharded": ("retwis-mesh50-30k", {
        "shard": True, "object_metrics": False, "converges": False,
        "rounds": {"active": 5, "quiet": 0},
        "reference_objects_per_block": 16}),
}
EXTRA_CELLS = [
    {"name": "gmap4m.join-digest", "config": "gmap-mesh15-4m",
     "traffic": "join-quarter-tiles.digest", "chips": 1},
    {"name": "retwis.sharded", "config": "retwis-sharded",
     "traffic": "retwis-zipf1-ops10.bprr", "chips": 4},
]


@pytest.fixture(scope="session")
def bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


@pytest.fixture(scope="session")
def test_bench(bench):
    """``BENCHMARK.json`` with the test-only cells of :data:`EXTRA_CELLS`."""
    out = json.loads(json.dumps(bench))
    for name in EXTRA_CONFIGS:
        out["configs"].append({"name": name,
                               "file": f"crdtbench/configs/{name}.json"})
    out["workloads"] += EXTRA_CELLS
    return out


@pytest.fixture(scope="session")
def small_root(tmp_path_factory, bench):
    """A root whose configuration files are the benchmark's, cut to
    :data:`SMALL`'s scale, and the test-only ones of
    :data:`EXTRA_CONFIGS`."""
    root = tmp_path_factory.mktemp("small")
    small = {}
    for c in bench["configs"]:
        with open(ROOT / c["file"]) as f:
            cfg = json.load(f)
        cfg.update(SMALL[c["name"]])
        small[c["name"]] = cfg
    files = [(c["file"], small[c["name"]]) for c in bench["configs"]]
    for name, (base, keys) in EXTRA_CONFIGS.items():
        files.append((f"crdtbench/configs/{name}.json",
                      dict(small[base], name=name, **keys)))
    for file, cfg in files:
        path = root / file
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(cfg))
    return root


def chips_of(bench, cell):
    return {w["name"]: w["chips"] for w in bench["workloads"]}[cell]
