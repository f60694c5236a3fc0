"""The port's training loop (``repro_torch.launch.train.run``) and its
example (``python -m repro_torch.train_100m``) on the CPU: the JAX
``run()``'s loss history from the same weights, and the JAX package's own
properties of its loop (``tests/test_train_integration.py``).

The weights reach both loops through pytest's ``monkeypatch`` (scoped to
one test): the JAX ``run()`` draws them with ``repro.launch.train.
init_tree``, which is made to return the CRC-32-keyed draw of
``test_torch_model_forward.jax_params`` (the JAX package's own keys are the
process-salted ``hash()``), and the port's ``run()`` takes that tree
through ``convert.params_to_torch``.

Over 10 bf16 steps the two loss histories agree within 2⁻¹⁰ relative (a
quarter of a bf16 epsilon; ~0.006 at a loss of 6). The JAX ``run()`` jits
its step with XLA's default excess precision (fused bf16 intermediates
kept in float32), which the test cannot switch off without changing the
JAX package, so each step's loss carries bf16 rounding that the port,
rounding every bf16 operation as written, does not share; the updates it
moves stay as small at lr 3e-4. The dense and recurrent stacks are
compared: an MoE stack's near-tied routes flip under that excess
precision (the per-operation-rounded comparisons of MoE configs are in
``test_torch_train_step.py``).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.launch.train as JT
from repro.configs import get_smoke_config as jax_smoke_config
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.launch import train as TT
from repro_torch.optim.adamw import tree_leaves
from test_torch_model_forward import jax_params

REPO = Path(__file__).resolve().parents[1]
HISTORY_RTOL = 2.0 ** -10


def carry_weights(monkeypatch, arch):
    """Both loops start from the JAX package's CRC-32-keyed draw."""
    jcfg = jax_smoke_config(arch)
    tree = jax.tree.map(np.asarray, jax_params(jcfg))
    monkeypatch.setattr(JT, "init_tree",
                        lambda defs, seed=0: jax_params(jcfg, seed))
    monkeypatch.setattr(
        TT, "init_params",
        lambda cfg, seed, device: convert.params_to_torch(cfg, tree, device))


@pytest.mark.parametrize("arch,batch,seq", [("qwen3-0.6b", 4, 64),
                                            ("deepseek-coder-33b", 2, 32),
                                            ("rwkv6-1.6b", 2, 64)])
def test_run_matches_the_jax_run(monkeypatch, arch, batch, seq):
    carry_weights(monkeypatch, arch)
    kw = dict(steps=10, global_batch=batch, seq_len=seq, log_every=0)
    _, jhist, jprog = JT.run(JT.TrainRun(cfg=jax_smoke_config(arch), **kw))
    state, hist, prog = TT.run(TT.TrainRun(cfg=get_smoke_config(arch), **kw),
                               device="cpu")
    assert len(hist) == len(jhist) == 10
    np.testing.assert_allclose(hist, jhist, rtol=HISTORY_RTOL, atol=0)
    assert prog.total == jprog.total == 10 * batch * seq
    assert int(state.opt.step) == 10


def test_loss_decreases_small_lm():
    """The JAX test's property: uniform-random tokens leave only the
    unigram distribution to learn, so the loss falls from its initial
    value toward the ln(V) floor."""
    cfg = get_smoke_config("qwen3-0.6b")
    tr = TT.TrainRun(cfg=cfg, steps=80, global_batch=4, seq_len=64,
                     lr=1e-3, warmup=10, log_every=0)
    _, hist, prog = TT.run(tr, device="cpu")
    floor = np.log(cfg.vocab_size)
    assert np.mean(hist[-10:]) < np.mean(hist[:5])
    assert np.mean(hist[-10:]) < floor + 0.6
    assert prog.total == 80 * 4 * 64


def test_checkpoint_restart_continues(tmp_path):
    """Save at 10, resume to 14: the same params as a fresh 14-step run
    from the same seed (bit for bit on the CPU; the JAX test's 2e-2 as
    well), with the restored steps' history only."""
    cfg = get_smoke_config("deepseek-coder-33b")
    d = str(tmp_path / "ck")
    kw = dict(global_batch=2, seq_len=32, log_every=0)
    TT.run(TT.TrainRun(cfg=cfg, steps=10, checkpoint_dir=d,
                       checkpoint_every=5, **kw), device="cpu")
    assert sorted(os.listdir(d)) == ["step_00000005", "step_00000010"]
    state_b, hist_b, _ = TT.run(TT.TrainRun(
        cfg=cfg, steps=14, checkpoint_dir=d, checkpoint_every=5, **kw),
        device="cpu")
    assert len(hist_b) == 4
    state_c, _, _ = TT.run(TT.TrainRun(cfg=cfg, steps=14, **kw),
                           device="cpu")
    for a, c in zip(tree_leaves(state_b.params.tensors()),
                    tree_leaves(state_c.params.tensors())):
        np.testing.assert_allclose(a.float().detach().numpy(),
                                   c.float().detach().numpy(),
                                   rtol=2e-2, atol=2e-2)
        assert torch.equal(a, c)
    for name in ("master", "mu", "nu"):
        for a, c in zip(tree_leaves(getattr(state_b.opt, name)),
                        tree_leaves(getattr(state_c.opt, name))):
            assert torch.equal(a, c), name
    assert int(state_b.opt.step) == int(state_c.opt.step) == 14


def test_microbatched_run_trains_in_float32(tmp_path):
    """Under microbatching the params turn float32 after the first step
    (the reference's dtype rule), and a checkpoint restores them so."""
    cfg = get_smoke_config("qwen3-0.6b")
    d = str(tmp_path / "ck")
    kw = dict(global_batch=4, seq_len=32, microbatches=2, log_every=0,
              checkpoint_dir=d, checkpoint_every=2)
    state, hist, _ = TT.run(TT.TrainRun(cfg=cfg, steps=2, **kw),
                            device="cpu")
    assert {t.dtype for t in tree_leaves(state.params.tensors())} \
        == {torch.float32}
    resumed, more, _ = TT.run(TT.TrainRun(cfg=cfg, steps=3, **kw),
                              device="cpu")
    assert len(more) == 1 and np.isfinite(more).all()
    assert {t.dtype for t in tree_leaves(resumed.params.tensors())} \
        == {torch.float32}


def test_train_100m_tiny_on_the_cpu(tmp_path):
    """The example's ``--tiny`` run prints the JAX example's lines (the
    model, a log line every 10 steps, a checkpoint every quarter, the
    final loss and the progress counter) and exits 0: the loss fell."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.train_100m", "--tiny",
         "--device", "cpu", "--ckpt", str(tmp_path / "ck")],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO / "src")),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0] == "model: qwen3-tiny  params≈0.1M"
    assert [ln.split()[1] for ln in lines if ln.startswith("step ")] \
        == ["10", "20", "30"]
    assert sum(ln.startswith("  checkpoint @ ") for ln in lines) == 3
    assert lines[-1].startswith("final loss ") and lines[-1].endswith(
        "tokens consumed (CRDT progress counter): 7,680")
    assert sorted(os.listdir(tmp_path / "ck")) == [
        "step_00000010", "step_00000020", "step_00000030"]
