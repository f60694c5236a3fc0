"""``device_idle_pct`` of the cells that report ``round_ms.map``: the
same reading of the traced window."""

from crdtbench.layer_metrics.device_idle_pct import read  # noqa: F401
