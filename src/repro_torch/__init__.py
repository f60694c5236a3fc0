"""PyTorch/CUDA port of ``repro``: the CRDT sync-round simulator and the
model side's serving and training paths.

Runs the paper's experiment — ``sync.simulate`` over the δ-family
algorithms (state, classic, bp, rr, bprr) and the resync modes, under fault
schedules, over the dense lattices (GSet, GCounter, GMap, BitGSet) and the
tuple-state ones (LWWMap, LexCounter, PNCounter, products, linear sums) —
on an NVIDIA H100 through ten hand-written CUDA kernels (``kernels/``,
sources in ``csrc/``), bit-identical to the JAX package, with sweeps and
stores in device blocks (``launch.mesh``) and the control-plane gossip
runtime (``runtime``). The model side is here too: the decoder stack for
all ten architectures (``models``, ``configs``), prefill and cached decode
(``train.steps``) and the batched greedy server (``launch.serve``); the
training step with chunked cross-entropy, microbatching and remat
(``train``), AdamW with float32 masters (``optim``), the synthetic data
pipeline (``data``) and the training loop with checkpoint and restart
(``launch.train``, ``train_100m``), in plain PyTorch as the JAX package
has it in plain ``jnp``. Entry points run on the card unless the caller
passes ``device="cpu"`` (``python -m repro_torch.quickstart``,
``python -m repro_torch.elastic_churn``, ``python -m
repro_torch.launch.serve`` and ``python -m repro_torch.train_100m`` take
``--device cpu``). The package imports
torch, numpy and the standard library only.
"""
