"""The model side's optimizer, PyTorch port of ``repro.optim``: AdamW with
float32 masters (``adamw``), learning-rate schedules (``schedule``) and
top-k gradient compression (``compression``)."""

from repro_torch.optim.adamw import AdamW, AdamWState
from repro_torch.optim.schedule import constant, cosine_with_warmup
from repro_torch.optim import compression

__all__ = ["AdamW", "AdamWState", "compression", "constant",
           "cosine_with_warmup"]
