"""``aten_ms_per_round`` of the cells that report ``round_ms.map``: the
same reading of the traced window."""

from crdtbench.layer_metrics.aten_ms_per_round import read  # noqa: F401
