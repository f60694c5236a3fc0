"""``device_idle_pct`` of the rejoin cell, whose ``round_ms`` is the
resync round's: the same reading of the traced window."""

from crdtbench.layer_metrics.device_idle_pct import read  # noqa: F401
