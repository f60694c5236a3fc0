"""The data plane, PyTorch port of ``repro.data``: the deterministic
synthetic pipeline (``DataConfig``, ``synth_block``, ``batch_for_step``)
and the replicated shard ledger and progress counter."""

from repro_torch.data.pipeline import (DataConfig, ProgressCounter,
                                       ShardLedger, batch_for_step,
                                       synth_block)

__all__ = ["DataConfig", "ProgressCounter", "ShardLedger", "batch_for_step",
           "synth_block"]
