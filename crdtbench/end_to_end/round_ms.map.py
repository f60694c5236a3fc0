"""``round_ms`` of the cells of one long-row map, which spread far less
than a store's: the same reading of the window, under a name of its own
so that its bound is set from its own spread."""

from crdtbench.end_to_end.round_ms import read  # noqa: F401
