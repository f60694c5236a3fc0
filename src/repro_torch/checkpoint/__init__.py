"""Chunk-boundary checkpoints of the port's runs (PyTorch)."""

from repro_torch.checkpoint.checkpointer import Checkpointer

__all__ = ["Checkpointer"]
