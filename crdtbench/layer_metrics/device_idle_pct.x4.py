"""``device_idle_pct`` of the four-card store (the most idle card): the
same reading of the traced window."""

from crdtbench.layer_metrics.device_idle_pct import read  # noqa: F401
