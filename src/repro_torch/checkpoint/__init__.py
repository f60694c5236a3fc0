"""Chunk-boundary checkpoints of the port's runs and the replicated
checkpoint registry (PyTorch)."""

from repro_torch.checkpoint.checkpointer import (Checkpointer,
                                                CheckpointRegistry)

__all__ = ["CheckpointRegistry", "Checkpointer"]
