"""PyTorch/CUDA port of the CRDT sync-round simulator (``repro``).

Runs the paper's experiment — ``sync.simulate`` over the δ-family
algorithms (state, classic, bp, rr, bprr) and the dense lattices (GSet,
GCounter, GMap, BitGSet) — on an NVIDIA H100 through three hand-written
CUDA kernels (``kernels/``, sources in ``csrc/``), bit-identical to the JAX
package. Entry points run on the card unless the caller passes
``device="cpu"``. The package imports torch, numpy and the standard library
only.
"""
