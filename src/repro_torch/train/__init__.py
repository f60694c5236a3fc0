"""Serving steps of the model side (``steps.make_prefill``,
``steps.make_decode``); the training steps come with the training slice."""
