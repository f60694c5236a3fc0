"""PyTorch/CUDA port of ``repro``: the CRDT sync-round simulator and the
model side's serving path.

Runs the paper's experiment — ``sync.simulate`` over the δ-family
algorithms (state, classic, bp, rr, bprr) and the resync modes, under fault
schedules, over the dense lattices (GSet, GCounter, GMap, BitGSet) and the
tuple-state ones (LWWMap, LexCounter, PNCounter, products, linear sums) —
on an NVIDIA H100 through eight hand-written CUDA kernels (``kernels/``,
sources in ``csrc/``), bit-identical to the JAX package, with sweeps and
stores in device blocks (``launch.mesh``) and the control-plane gossip
runtime (``runtime``). The model side's serving path
is here too: the decoder stack for all ten architectures (``models``,
``configs``), prefill and cached decode (``train.steps``) and the batched
greedy server (``launch.serve``), in plain PyTorch as the JAX package has
it in plain ``jnp``. Entry points run on the card unless the caller
passes ``device="cpu"`` (``python -m repro_torch.quickstart``,
``python -m repro_torch.elastic_churn`` and ``python -m
repro_torch.launch.serve`` take ``--device cpu``). The package imports
torch, numpy and the standard library only.
"""
