"""The Retwis example, JAX against the port.

``repro_torch.retwis_app.run("cpu")`` returns the numbers of the JAX
package's ``examples/retwis_app.py``, computed here through
``repro.sync.simulate_store(..., wide_metrics=False)`` with the example's
spec (the example itself calls it with the default ``wide_metrics=True``,
which JAX 0.9.0 refuses): the total and per-node KB, the convergence
round, the hottest object of each class with its KB, elements and
convergence round, and the final footprint. Both packages hold the byte
totals as float64, so the numbers are compared exactly and the printed
lines, formatted with the example's own format strings, line for line.
``chip_smoke.py`` pins the same numbers for its card run.
"""

import ast
import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

from repro.core import value_lattices as jvl
from repro.core.lattice import MapLattice as JaxMapLattice
from repro.sync import StoreSpec as JaxStoreSpec
from repro.sync import simulate_store as jax_simulate_store
from repro.sync import topology as jtopo
from repro.sync import workloads as jW

from repro_torch import retwis_app

REPO = Path(__file__).resolve().parents[1]


@functools.lru_cache(maxsize=None)
def jax_example():
    """The JAX example's run and lines (its ``main`` with
    ``wide_metrics=False``)."""
    objects, nodes, slots, rounds = 24, 8, 16, 30
    topo = jtopo.partial_mesh(nodes, 4)
    lat = JaxMapLattice(slots, jvl.max_int(), "retwis").build()
    wl = jW.retwis(objects, nodes, rounds, ops_per_node=4, zipf=1.2, seed=7)
    spec = JaxStoreSpec(objects=objects,
                        op_fn=jW.versioned_slot_op(wl.update_counts(), slots),
                        weights=jW.retwis_weights(objects))
    res = jax_simulate_store("bprr", lat, topo, spec, active_rounds=rounds,
                             quiet_rounds=8, track_convergence=True,
                             wide_metrics=False)
    classes = ("followers", "wall", "timeline")
    lines = [f"retwis store: {objects} objects × {nodes} nodes, "
             f"{rounds} rounds (+8 drain)",
             f"  transmitted {res.total_tx_bytes / 1e3:8.1f} KB total "
             f"({res.total_tx_bytes / nodes / 1e3:.1f} KB/node)"]
    conv = res.convergence_round()
    assert (conv >= 0).all()
    lines.append(f"  all {objects} objects converged by round "
                 f"{int(conv.max())}")
    tx_totals = res.tx_bytes.sum(axis=1)
    hottest = []
    for cls in range(3):
        ids = np.arange(cls, objects, 3)
        hot = ids[np.argmax(tx_totals[ids])]
        obj = res.object_result(int(hot))
        hottest.append({"class": classes[cls], "object": int(hot),
                        "tx_bytes": float(tx_totals[hot]),
                        "elements": int(obj.tx.sum()),
                        "converged": int(conv[hot])})
        lines.append(f"  hottest {classes[cls]:9s} object #{hot:2d}: "
                     f"{tx_totals[hot] / 1e3:7.1f} KB sent, "
                     f"{int(obj.tx.sum())} elements, "
                     f"converged at round {int(conv[hot])}")
    mb = res.final_state_bytes.sum() / 1e3
    lines.append(f"  final store footprint {mb:.1f} KB across the cluster")
    lines.append("retwis_app OK")
    numbers = {"total_tx_bytes": float(res.total_tx_bytes),
               "converged_by": int(conv.max()), "hottest": hottest,
               "footprint_bytes": float(res.final_state_bytes.sum())}
    return numbers, lines


@functools.lru_cache(maxsize=None)
def port_run():
    return retwis_app.run("cpu")


def test_numbers_match_jax():
    want, _ = jax_example()
    got = port_run()
    assert {k: got[k] for k in want} == want


def test_printed_lines_match_jax(capsys):
    _, want = jax_example()
    got = port_run()["lines"]
    assert got == want
    capsys.readouterr()
    retwis_app.run("cpu")
    assert capsys.readouterr().out.splitlines() == want


def test_chip_smoke_pins_the_jax_numbers():
    """``chip_smoke.py``'s ``RETWIS_APP_EXPECT`` (the card run's oracle)
    equals the JAX example's numbers."""
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    pinned = [ast.literal_eval(node.value) for node in tree.body
              if isinstance(node, ast.Assign)
              and [getattr(t, "id", None) for t in node.targets]
              == ["RETWIS_APP_EXPECT"]]
    want, _ = jax_example()
    assert pinned == [want]


def test_module_runs_on_the_cpu():
    """``python -m repro_torch.retwis_app --device cpu`` prints the JAX
    example's lines, ending ``retwis_app OK``."""
    _, want = jax_example()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.retwis_app", "--device", "cpu"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO / "src")),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines() == want
