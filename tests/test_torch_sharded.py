"""The port's sharded steps on the CPU: a train step, a prefill and decode
on 4 gloo ranks (``tests/_torch_sharded_step.py``, one process a rank)
equal to the unsharded port's.

A process group is process-global, so each rank runs in a subprocess."""

import json
import subprocess
import sys

import pytest

from conftest import REPO, SRC

ENV = {"PYTHONPATH": str(SRC)}
SHARDED = REPO / "tests" / "_torch_sharded_step.py"
TOL = 1e-4                      # of a leaf's scale, float32


def _env():
    import os
    return dict(os.environ, **ENV)


def run_ranks(tmp_path, arch, mesh="2,2", mb=1, world=4):
    out = tmp_path / "out.json"
    procs = [subprocess.Popen(
        [sys.executable, str(SHARDED), str(r), str(world),
         str(tmp_path / "store"), str(out), arch, mesh, str(mb)],
        cwd=REPO, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), logs[0][-4000:]
    return json.loads(out.read_text())


@pytest.mark.parametrize("arch,mesh,mb", [
    ("qwen3-0.6b", "2,2", 1), ("mixtral-8x22b", "2,2", 1),
    ("rwkv6-1.6b", "2,2", 1), ("qwen3-0.6b", "1,4", 1),
    ("mixtral-8x22b", "2,2", 2)])
def test_sharded_train_step_equals_the_unsharded_one(tmp_path, arch, mesh,
                                                     mb):
    """Mesh (2, 2) over ("data", "model"), and (1, 4), whose model axis is
    wider than the smoke configs' 2 KV heads (the query heads split, the
    KV heads gathered), and one step over 2 microbatches (each a slice of
    the batch re-sharded over data, float32 gradients accumulated on the
    params' placements): the weights FSDP × TP, the batch
    over data, hints and grad_specs; the loss and every gradient leaf
    within 1e-4 of its scale of the unsharded port step (float32; the
    sums run in another order), each gradient on its param's placements,
    and the params after one AdamW step within 2·lr (Adam's step is at
    most lr where the gradient's sign is settled; near ĝ ≈ ε it turns on
    rounding). Then serving: a sharded prefill and two decode steps
    (flash-decoding over the sequence-sharded cache) against the plain
    ones, within 1e-4 of the largest logit."""
    r = run_ranks(tmp_path, arch, mesh, mb)
    assert abs(r["loss"] - r["ref_loss"]) <= TOL * abs(r["ref_loss"])
    assert r["grads_on_param_placements"]
    assert len(r["grads"]) == len(r["params"]) > 10
    for i, (err, scale) in enumerate(r["grads"]):
        assert err <= TOL * max(scale, 1e-30), (i, err, scale)
    for i, (err, _) in enumerate(r["params"]):
        assert err <= 2e-3, (i, err)
    # FSDP × TP: the embedding [V, d], the vocab over model, d over data
    v, d = r["embed"]
    dp, tp = map(int, mesh.split(","))
    assert r["local_embed"] == [v // tp, d // dp]
    # serving (serve rules): the prefill's logits and two decode steps'
    # against the plain ones, the cache's sequence (or recurrent width)
    # over the model axis
    serve = r["serve"]
    assert len(serve["errs"]) == 3
    assert max(serve["errs"]) <= TOL * serve["scale"], serve
    first = next(iter(serve["cache_placements"].values()))
    assert first == "(Shard(dim=0), Shard(dim=1))", serve
