"""Single-process training driver, PyTorch port of ``repro.launch.train``.

Used by ``repro_torch.train_100m`` and the tests: builds a model from a
``ModelConfig`` (weights from the run's seed on ``device``), the
deterministic data pipeline, the AdamW step, the replicated checkpoint
registry and progress counter, and runs N steps with periodic checkpoints
and restart from the newest one. Runs on the card unless the caller passes
``device="cpu"``; nothing is compiled.

A checkpoint bundle holds ``TrainState(params=model.tensors(), opt=...)``
(the port's ``Checkpointer`` flattens dicts, lists and named tuples, not
modules); a restore rebuilds the ``Decoder`` from it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

from repro_torch.checkpoint import Checkpointer, CheckpointRegistry
from repro_torch.data import (DataConfig, ProgressCounter, ShardLedger,
                              batch_for_step)
from repro_torch.models import transformer as TR
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import init_params
from repro_torch.optim import AdamW, cosine_with_warmup
from repro_torch.sync.simulator import resolve_device
from repro_torch.train import steps as ST


@dataclasses.dataclass
class TrainRun:
    cfg: ModelConfig
    steps: int = 100
    global_batch: int = 8
    seq_len: int = 256
    lr: float = 3e-4
    warmup: int = 20
    microbatches: int = 1
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 50
    seed: int = 0
    log_every: int = 10


def _bundle(state: ST.TrainState) -> ST.TrainState:
    """The state as the checkpointer's tree (the model as its tensors)."""
    return ST.TrainState(params=state.params.tensors(), opt=state.opt)


def run(tr: TrainRun, resume: bool = True, node_id: int = 0,
        num_nodes: int = 1, on_step=None, device="cuda"):
    """Returns (final ``TrainState``, loss history, ``ProgressCounter``).
    With ``tr.checkpoint_dir`` and ``resume``, starts from the newest
    bundle there."""
    cfg = tr.cfg
    dev = resolve_device(device)
    optim = AdamW(lr=cosine_with_warmup(tr.lr, tr.warmup, tr.steps))
    state = ST.init_train_state(cfg, optim, init_params(cfg, tr.seed, dev))
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=tr.seq_len,
                      global_batch=tr.global_batch, seed=tr.seed)

    ckpt = registry = None
    start_step = 0
    if tr.checkpoint_dir:
        ckpt = Checkpointer(tr.checkpoint_dir)
        registry = CheckpointRegistry(device=dev)
        if resume:
            avail = ckpt.available_steps()
            if avail:
                start_step = avail[-1]
                tree = ckpt.restore(start_step, _bundle(state))
                state = ST.TrainState(params=TR.Decoder(cfg, tree.params),
                                      opt=tree.opt)
                registry.announce(start_step)

    progress = ProgressCounter(num_nodes=max(num_nodes, 1), node_id=node_id,
                               device=dev)
    ledger = ShardLedger(num_shards=dcfg.num_shards, device=dev)
    shard = ledger.next_unclaimed() or 0
    ledger.claim(shard)

    step_fn = ST.make_train_step(cfg, optim, microbatches=tr.microbatches)

    history = []
    t0 = time.time()
    for step in range(start_step, tr.steps):
        batch = batch_for_step(
            dcfg, shard, step, frontend=cfg.frontend, d_model=cfg.d_model,
            frontend_len=cfg.frontend_len, device=dev)
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        history.append(loss)
        progress.add(tr.global_batch * tr.seq_len)
        if on_step is not None:
            on_step(step, metrics, progress)
        if tr.log_every and (step + 1) % tr.log_every == 0:
            dt = time.time() - t0
            print(f"step {step+1:5d} loss {loss:8.4f} "
                  f"grad_norm {float(metrics['grad_norm']):7.3f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"tok/s {progress.total/max(dt,1e-9):,.0f}")
        if ckpt is not None and (step + 1) % tr.checkpoint_every == 0:
            digest = ckpt.save(step + 1, _bundle(state))
            registry.announce(step + 1)
            print(f"  checkpoint @ {step+1} digest={digest}")

    return state, history, progress
