"""``sim_p95_ms`` of the cells of one long-row map, which spread far less
than a store's: the same reading of the window, under a name of its own
so that its bound is set from its own spread."""

from crdtbench.end_to_end.sim_p95_ms import read  # noqa: F401
