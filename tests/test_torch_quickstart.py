"""``python -m repro_torch.quickstart`` against the JAX package.

The port's quickstart on ``--device cpu`` prints and returns the numbers of
the JAX package's ``examples/quickstart.py``: the GCounter state, value
and δ-mutator, Δ(a, b) of two GSets, the transmission of state / classic /
bprr on the paper's partial mesh (each run converged), and the novel count
of ``delta_extract`` over a 65,536-entry map. The JAX side is computed here
through ``repro`` (``simulate(..., wide_metrics=False)``; the example
itself calls ``simulate`` with the default ``wide_metrics=True``, which
this JAX version refuses). Without a card and without ``--device`` the
quickstart raises.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import GCounter, GSet
from repro.kernels import ops as kops
from repro.sync import converged, simulate, topology

from repro_torch import quickstart

# The states here are small: one intra-op thread per test process keeps
# the suite's parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def jax_numbers() -> dict:
    """examples/quickstart.py's numbers, computed through ``repro``."""
    out = {}
    gc = GCounter(num_replicas=3)
    p = gc.lattice.bottom()
    for _ in range(5):
        p = gc.inc(p, 0)
    p = gc.inc(p, 1)
    out["gcounter"] = np.asarray(p).tolist()
    out["gcounter_value"] = int(gc.value(p))
    out["inc_delta"] = np.asarray(gc.inc_delta(p, 2)).tolist()
    gs = GSet(universe=8)
    a = jnp.asarray([1, 1, 1, 0, 0, 0, 0, 0], bool)
    b = jnp.asarray([1, 0, 0, 1, 0, 0, 0, 0], bool)
    out["delta"] = np.asarray(gs.lattice.delta(a, b)).astype(int).tolist()
    n, rounds = 15, 30
    topo = topology.partial_mesh(n, 4)
    lat = GSet(universe=n * rounds).lattice

    def op_fn(x, t):
        ids = jnp.arange(n) * rounds + jnp.minimum(t, rounds - 1)
        return jnp.zeros((n, n * rounds), bool).at[
            jnp.arange(n), ids].set(True)

    out["tx"], out["converged"] = {}, {}
    for algo in ("state", "classic", "bprr"):
        res = simulate(algo, lat, topo, op_fn, active_rounds=rounds,
                       quiet_rounds=10, wide_metrics=False)
        out["tx"][algo] = res.total_tx
        out["converged"][algo] = converged(lat, res.final_x)
    rng = np.random.default_rng(0)
    d = jnp.asarray(rng.integers(0, 10, size=(1 << 16,)), jnp.int32)
    x = jnp.asarray(rng.integers(0, 10, size=(1 << 16,)), jnp.int32)
    out["novel"] = int(kops.delta_extract(d, x)[2])
    return out


def test_quickstart_on_the_cpu_matches_jax(capsys):
    got = quickstart.main(["--device", "cpu"])
    assert capsys.readouterr().out.rstrip().endswith("quickstart OK")
    want = jax_numbers()
    assert got == want
    assert all(got["converged"].values())
    assert got["tx"]["bprr"] < got["tx"]["classic"] < got["tx"]["state"]


def test_quickstart_without_a_card_raises():
    """No ``--device``: the card is asked for, and without one the
    quickstart raises instead of running on the CPU."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "repro_torch.quickstart"],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert "quickstart OK" not in out.stdout


@pytest.mark.parametrize("device", ["cuda", "cuda:0"])
def test_run_refuses_a_missing_card(device, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quickstart.run(device)
