"""The port stands alone: importing ``repro_torch`` (every module, the fault
schedules, digests and digest kernels included) and ``chip_smoke.py`` pulls
in neither ``jax`` nor the JAX package ``repro``, no source file of theirs
imports either, and the entry points run on the card unless told otherwise —
without a card, ``simulate`` with no ``device=`` raises instead of falling
back to the CPU, for the δ-family, a faulted resync run and an LWWMap run
alike, and so do ``simulate_sweep``, ``simulate_store``, the gossip runtime
(``GossipNode``, ``CheckpointRegistry``, ``ShardLedger``,
``ProgressCounter``), ``elastic_churn``, the model side's server
(``generate``, ``init_params``, ``init_cache``, ``python -m
repro_torch.launch.serve``) and its training (``launch.train.run``,
``train_100m.main``, ``data.batch_for_step``, ``python -m
repro_torch.train_100m``), the model meshes (``make_mesh``,
``make_production_mesh``), the observability oracles
(``oracle_channels``, ``oracle_provenance``) and the Retwis example
(``retwis_app.run``, ``python -m repro_torch.retwis_app``). The oracles
import no kernel, engine or algorithm module: they share no code with
what they check."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
SOURCES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) \
    + [REPO / "chip_smoke.py"]


def run_python(code, **env):
    full = dict(os.environ, PYTHONPATH=str(REPO / "src"), **env)
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=full,
                          capture_output=True, text=True, timeout=120)


def foreign(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_source_imports_jax_or_repro(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        assert not any(foreign(n) for n in names), (path, names)


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys, runpy\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "runpy.run_path('chip_smoke.py', run_name='not_main')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "print('FOREIGN', bad)\n")
    out = run_python(code)
    assert out.returncode == 0, out.stderr
    assert "FOREIGN []" in out.stdout, out.stdout


def test_entry_points_default_to_the_card():
    code = (
        "import torch\n"
        "from repro_torch.core import GCounter\n"
        "from repro_torch.sync import simulate, topology, workloads\n"
        "from repro_torch import kernels\n"
        "assert not torch.cuda.is_available()\n"
        "try:\n"
        "    simulate('bprr', GCounter(3).lattice, topology.ring(3),\n"
        "             workloads.gcounter_op(3), 2)\n"
        "except RuntimeError as e:\n"
        "    print('RAISED', e)\n"
        "from repro_torch.sync import FaultSchedule\n"
        "f = FaultSchedule.bernoulli(topology.ring(3), 2, 0.5, seed=1)\n"
        "try:\n"
        "    simulate('digest_driven', GCounter(3).lattice, topology.ring(3),\n"
        "             workloads.gcounter_op(3), 2, faults=f, engine='fused')\n"
        "except RuntimeError as e:\n"
        "    print('RAISED', e)\n"
        "r = simulate('bprr', GCounter(3).lattice, topology.ring(3),\n"
        "             workloads.gcounter_op(3), 2, engine='mega', device='cpu')\n"
        "r = simulate('digest_driven', GCounter(3).lattice, topology.ring(3),\n"
        "             workloads.gcounter_op(3), 2, faults=f, engine='mega',\n"
        "             device='cpu')\n"
        "from repro_torch.core import LWWMap\n"
        "from repro_torch.kernels import ops\n"
        "lww = LWWMap(3).lattice\n"
        "try:\n"
        "    simulate('bprr', lww, topology.ring(3), lambda x, t: x, 2,\n"
        "             engine='mega')\n"
        "except RuntimeError as e:\n"
        "    print('RAISED', e)\n"
        "simulate('bprr', lww, topology.ring(3), lambda x, t: x, 2,\n"
        "         engine='mega', device='cpu')\n"
        "from repro_torch.sync import (StoreSpec, SweepSpec, simulate_store,\n"
        "                              simulate_sweep)\n"
        "g = GCounter(3).lattice\n"
        "for run in (lambda **k: simulate_sweep(\n"
        "                'bprr', g, topology.ring(3), SweepSpec(\n"
        "                    2, workloads.gcounter_sweep_op(3)), 2, **k),\n"
        "            lambda **k: simulate_store(\n"
        "                'bprr', g, topology.ring(3), StoreSpec(\n"
        "                    2, workloads.gcounter_sweep_op(3)), 2, **k)):\n"
        "    try:\n"
        "        run(engine='mega')\n"
        "    except RuntimeError as e:\n"
        "        print('RAISED', e)\n"
        "    run(engine='mega', device='cpu')\n"
        "from repro_torch import elastic_churn, retwis_app\n"
        "from repro_torch.obs import oracle\n"
        "from repro_torch.checkpoint import CheckpointRegistry\n"
        "from repro_torch.data import ProgressCounter, ShardLedger\n"
        "from repro_torch.runtime import GossipNode, LocalTransport\n"
        "for make in (lambda **k: GossipNode(0, [1], LocalTransport(), **k),\n"
        "             lambda **k: CheckpointRegistry(8, **k),\n"
        "             lambda **k: ShardLedger(8, **k),\n"
        "             lambda **k: ProgressCounter(3, 0, **k),\n"
        "             lambda **k: elastic_churn.run(verbose=False, **k),\n"
        "             lambda **k: retwis_app.run(**k),\n"
        "             lambda **k: oracle.oracle_channels(\n"
        "                 'bprr', g, topology.ring(3), workloads.gcounter_op(3),\n"
        "                 2, **k),\n"
        "             lambda **k: oracle.oracle_provenance(\n"
        "                 'bprr', g, topology.ring(3), workloads.gcounter_op(3),\n"
        "                 2, **k)):\n"
        "    try:\n"
        "        make()\n"
        "    except RuntimeError as e:\n"
        "        print('RAISED', e)\n"
        "    make(device='cpu')\n"
        "a = torch.arange(8, dtype=torch.int32)\n"
        "ops.join(a, a); ops.delta_extract(a, a)\n"
        "ops.lex_join_delta((a, a), (a, a))\n"
        "print('CPU', r.total_tx, sum(kernels.launch_counts().values()),\n"
        "      sorted(kernels.KERNELS))\n")
    out = run_python(code, CUDA_VISIBLE_DEVICES="")
    assert out.returncode == 0, out.stderr
    assert out.stdout.count("RAISED no CUDA device") == 13, out.stdout
    # the CPU runs and calls took the plain versions: no kernel was launched
    assert "CPU" in out.stdout and " 0 ['buffer_fold', 'delta_extract', " \
        "'digest_blocks', 'join', 'lex_join_delta', 'masked_extract', " \
        "'merkle_descent', 'round_recv', 'round_step']" in out.stdout, \
        out.stdout


def test_serving_defaults_to_the_card():
    """The model side's entry points (``generate``, ``init_params``,
    ``init_tree``, ``init_cache``, ``python -m repro_torch.launch.serve``)
    raise without a card unless given ``device="cpu"``."""
    code = (
        "import torch\n"
        "from repro_torch.configs import get_smoke_config\n"
        "from repro_torch.launch import serve\n"
        "from repro_torch.models import params, transformer\n"
        "assert not torch.cuda.is_available()\n"
        "cfg = get_smoke_config('qwen3-0.6b')\n"
        "sr = serve.ServeRun(cfg, batch=1, prompt_len=4, max_new_tokens=2)\n"
        "for run in (lambda **k: serve.generate(sr, **k),\n"
        "            lambda **k: transformer.init_params(cfg, **k),\n"
        "            lambda **k: params.init_tree(\n"
        "                transformer.layer_param_defs(cfg), **k),\n"
        "            lambda **k: transformer.init_cache(cfg, 1, 4, **k)):\n"
        "    try:\n"
        "        run()\n"
        "    except RuntimeError as e:\n"
        "        print('RAISED', e)\n"
        "    run(device='cpu')\n"
        "print('CPU', tuple(serve.generate(sr, device='cpu')[0].shape))\n")
    out = run_python(code, CUDA_VISIBLE_DEVICES="")
    assert out.returncode == 0, out.stderr
    assert out.stdout.count("RAISED no CUDA device") == 4, out.stdout
    assert "CPU (1, 2)" in out.stdout, out.stdout
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve"], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=str(REPO / "src"),
                 CUDA_VISIBLE_DEVICES=""),
        capture_output=True, text=True, timeout=120)
    assert cli.returncode != 0 and "no CUDA device" in cli.stderr
    assert cli.stdout == ""


def test_training_defaults_to_the_card():
    """The training entry points (``launch.train.run``,
    ``train_100m.main``, ``data.batch_for_step``, ``python -m
    repro_torch.train_100m``) raise without a card unless given the CPU."""
    code = (
        "import os, tempfile, torch\n"
        "from repro_torch import train_100m\n"
        "from repro_torch.configs import get_smoke_config\n"
        "from repro_torch.data import DataConfig, batch_for_step\n"
        "from repro_torch.launch import train\n"
        "assert not torch.cuda.is_available()\n"
        "cfg = get_smoke_config('qwen3-0.6b')\n"
        "tr = train.TrainRun(cfg, steps=2, global_batch=2, seq_len=8,\n"
        "                    log_every=0)\n"
        "ck = os.path.join(tempfile.mkdtemp(), 'ck')\n"
        "dc = DataConfig(vocab_size=64, seq_len=8, global_batch=2)\n"
        "for run, cpu in (\n"
        "        (lambda **k: train.run(tr, **k), {'device': 'cpu'}),\n"
        "        (lambda *a: train_100m.main(['--tiny', '--steps', '10',\n"
        "                                     '--ckpt', ck, *a]),\n"
        "         ('--device', 'cpu')),\n"
        "        (lambda **k: batch_for_step(dc, 0, 0, **k),\n"
        "         {'device': 'cpu'})):\n"
        "    try:\n"
        "        run()\n"
        "    except RuntimeError as e:\n"
        "        print('RAISED', e)\n"
        "    out = run(*cpu) if isinstance(cpu, tuple) else run(**cpu)\n"
        "print('CPU', len(out), tuple(out['tokens'].shape),\n"
        "      out['tokens'].device)\n")
    out = run_python(code, CUDA_VISIBLE_DEVICES="")
    assert out.returncode == 0, out.stderr
    assert out.stdout.count("RAISED no CUDA device") == 3, out.stdout
    assert "CPU 3 (2, 8) cpu" in out.stdout, out.stdout
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.train_100m", "--tiny"], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=str(REPO / "src"),
                 CUDA_VISIBLE_DEVICES=""),
        capture_output=True, text=True, timeout=120)
    assert cli.returncode != 0 and "no CUDA device" in cli.stderr
    assert cli.stdout == ""


def test_model_meshes_default_to_the_card(tmp_path):
    """``make_mesh`` / ``make_production_mesh`` build CUDA meshes unless told
    otherwise: in a one-rank gloo group without a card they raise rather
    than fall back to the CPU (and the production mesh names its size)."""
    code = (
        "import torch, torch.distributed as dist\n"
        "from repro_torch.launch.mesh import make_mesh, make_production_mesh\n"
        f"dist.init_process_group('gloo', store=dist.FileStore("
        f"{str(tmp_path / 'store')!r}, 1), rank=0, world_size=1)\n"
        "for f in (lambda: make_mesh((1, 1), ('data', 'model')),\n"
        "          make_production_mesh):\n"
        "    try:\n"
        "        f()\n"
        "    except RuntimeError as e:\n"
        "        print('RAISED', e)\n"
        "m = make_mesh((1, 1), ('data', 'model'), device_type='cpu')\n"
        "print('CPU', m.device_type, m.mesh_dim_names)\n"
        "dist.destroy_process_group()\n")
    out = run_python(code)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert "RAISED" in lines[0] and "no card" in lines[0], out.stdout
    assert "RAISED" in lines[1] and "256" in lines[1], out.stdout
    assert lines[2] == "CPU cpu ('data', 'model')", out.stdout


def test_retwis_app_cli_defaults_to_the_card():
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.retwis_app"], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=str(REPO / "src"),
                 CUDA_VISIBLE_DEVICES=""),
        capture_output=True, text=True, timeout=120)
    assert cli.returncode != 0 and "no CUDA device" in cli.stderr
    assert cli.stdout == ""


def test_oracle_imports_no_engine_code():
    """``obs/oracle.py`` imports nothing of ``repro_torch.kernels``,
    ``sync.engine`` or ``sync.algorithms``, and none of the channel code
    of ``obs.telemetry`` / ``obs.provenance`` it is held against."""
    path = REPO / "src" / "repro_torch" / "obs" / "oracle.py"
    banned = ("repro_torch.kernels", "repro_torch.sync.engine",
              "repro_torch.sync.algorithms")
    channel_code = {"round_channels", "cluster_gap", "_cluster_join",
                    "round_update", "_unpack_bits", "_elem_mask",
                    "_novel_elem_mask"}
    seen = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods = [(a.name, []) for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [(node.module, [a.name for a in node.names])]
        else:
            continue
        for mod, names in mods:
            seen.append(mod)
            full = [mod] + [f"{mod}.{n}" for n in names]
            assert not any(f == b or f.startswith(b + ".")
                           for f in full for b in banned), (mod, names)
            if mod in ("repro_torch.obs.telemetry",
                       "repro_torch.obs.provenance"):
                assert not channel_code & set(names), (mod, names)
            if mod in ("repro_torch.obs", "repro_torch.sync"):
                assert not {"telemetry", "provenance", "engine",
                            "algorithms"} & set(names), (mod, names)
    assert "repro_torch.sync.digest" in seen
