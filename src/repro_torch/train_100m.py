"""End-to-end driver: train a ~100M-parameter qwen3-family model for a few
hundred steps, with checkpoints and the CRDT progress counter; the
counterpart of the JAX package's ``examples/train_100m.py``.

    PYTHONPATH=src python -m repro_torch.train_100m [--steps 200] [--tiny]
        [--device cpu] [--ckpt DIR]

The model is the qwen3 architecture at ~100M scale (d_model 512, 12
layers, 16k vocab; the count is printed at the start). Synthetic data is
deterministic; the loss falls from about ln(V) ≈ 9.7 within a few hundred
steps, and the run asserts that it fell. ``--tiny`` runs a small variant
(30 steps). It runs on the card unless ``--device cpu`` is given, and
raises without a card. Each invocation trains from step 0 and writes a
checkpoint every quarter of the run under ``--ckpt`` (by default
``build/train_100m`` in the repository; a bundle of the same step is
replaced).
"""

from __future__ import annotations

import argparse
from pathlib import Path

from repro_torch.launch.train import TrainRun, run
from repro_torch.models.config import ModelConfig
from repro_torch.sync.simulator import resolve_device

DEFAULT_CKPT = Path(__file__).resolve().parents[2] / "build" / "train_100m"


def model_100m():
    return ModelConfig(
        name="qwen3-100m",
        num_layers=12,
        d_model=512,
        num_heads=8,
        num_kv_heads=4,
        head_dim=64,
        d_ff=2048,
        vocab_size=16384,
        pattern=("global",),
        qk_norm=True,
        act="swiglu",
        tie_embeddings=True,
        attn_q_chunk=256,
        attn_kv_chunk=256,
        remat="none",
    )


def model_tiny():
    return ModelConfig(
        name="qwen3-tiny", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512,
        pattern=("global",), qk_norm=True, act="swiglu",
        tie_embeddings=True, attn_q_chunk=64, attn_kv_chunk=64,
        remat="none",
    )


def main(argv=None):
    """Runs the example; returns what ``run`` returns (state, loss
    history, progress counter)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--ckpt", default=str(DEFAULT_CKPT))
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = model_tiny() if args.tiny else model_100m()
    if args.tiny:
        args.steps, args.batch, args.seq = min(args.steps, 30), 4, 64
    print(f"model: {cfg.name}  params≈{cfg.param_count()/1e6:.1f}M")

    tr = TrainRun(
        cfg=cfg, steps=args.steps, global_batch=args.batch,
        seq_len=args.seq, lr=3e-4, warmup=20,
        checkpoint_dir=args.ckpt, checkpoint_every=max(args.steps // 4, 10),
        log_every=10,
    )
    state, history, progress = run(tr, resume=False, device=dev)
    print(f"\nfinal loss {history[-1]:.4f} (start {history[0]:.4f}); "
          f"tokens consumed (CRDT progress counter): {progress.total:,}")
    if not history[-1] < history[0]:
        raise AssertionError("loss must improve")
    return state, history, progress


if __name__ == "__main__":
    main()
