"""The data plane's replicated shard ledger and progress counter
(PyTorch)."""

from repro_torch.data.pipeline import ProgressCounter, ShardLedger

__all__ = ["ProgressCounter", "ShardLedger"]
