"""The model side's steps, PyTorch port of ``repro.train``: the training
step (``steps.TrainState``, ``init_train_state``, ``make_loss_fn``,
``make_train_step``) over the chunked cross-entropy of ``losses``, and
the serving steps (``steps.make_prefill``, ``steps.make_decode``)."""

from repro_torch.train import losses, steps

__all__ = ["losses", "steps"]
