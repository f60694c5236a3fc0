"""``round_step_roofline`` of the cells that report ``round_ms.map``: the
same reading of the traced window."""

from crdtbench.layer_metrics.round_step_roofline import read  # noqa: F401
