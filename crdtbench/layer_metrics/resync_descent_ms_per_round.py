"""Host ms a round inside the program's ``resync.descent`` label (the
Merkle-descent price of every digest message of a digest-driven resync
round). Nothing where the program has no such label."""

from crdtbench.layer_metrics.store_gather_ms_per_round import span_ms


def read(t):
    return span_ms(t, "resync.descent")
