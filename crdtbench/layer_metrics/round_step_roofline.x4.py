"""``round_step_roofline`` of the four-card store, read at one card's
shape (its block of objects): the same reading of the traced window."""

from crdtbench.layer_metrics.round_step_roofline import read  # noqa: F401
