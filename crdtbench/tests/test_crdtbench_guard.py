"""The benchmark refuses to run beside JAX or the JAX package (compared by
whole top-level module names), without a card, and without the program."""

import shutil
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from crdtbench import guard

ROOT = Path(__file__).resolve().parents[2]
RUN = ["--workload", "gmap4m.bprr", "--seed", "1", "--seconds", "1",
       "--trace", "0"]


@pytest.mark.parametrize("name", ["repro", "repro.x", "jax", "jax.numpy",
                                  "jaxlib.xla_client", "flax.linen"])
def test_a_planted_module_is_refused(name):
    modules = dict(sys.modules, **{name: types.ModuleType(name)})
    assert guard.forbidden_modules(modules) == [name]
    with pytest.raises(SystemExit) as e:
        guard.check("in a test", modules)
    assert e.value.code != 0


def test_the_port_and_look_alike_names_pass():
    modules = {n: None for n in ("repro_torch", "repro_torch.sync",
                                 "reprox", "jaxtyping", "flaxen", "torch")}
    assert guard.forbidden_modules(modules) == []
    guard.check("in a test", modules)


def run_script(cwd, prelude=""):
    code = (f"import sys, runpy, types; {prelude}; "
            f"sys.argv = ['run.py'] + {RUN!r}; "
            f"runpy.run_path('crdtbench/run.py', run_name='__main__')")
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_run_refuses_with_the_jax_package_loaded():
    out = run_script(ROOT, "sys.modules['repro.x'] = "
                           "types.ModuleType('repro.x')")
    assert out.returncode != 0
    assert out.stdout == ""
    assert "repro.x" in out.stderr


def test_run_refuses_without_the_cards():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")
    out = run_script(ROOT)
    assert out.returncode != 0
    assert out.stdout == ""


def test_run_refuses_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "crdtbench", tmp_path / "crdtbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run_script(tmp_path)
    assert out.returncode != 0
    assert out.stdout == ""
