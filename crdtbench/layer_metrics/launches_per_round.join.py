"""``launches_per_round`` of the rejoin cell, whose ``round_ms`` is the
resync round's: the same reading of the traced window."""

from crdtbench.layer_metrics.launches_per_round import read  # noqa: F401
