"""Host ms a round inside the program's ``resync.receive`` label (a
resync round's gather, mask and join fold, then the stored digests'
update). Nothing where the program has no such label."""

from crdtbench.layer_metrics.store_gather_ms_per_round import span_ms


def read(t):
    return span_ms(t, "resync.receive")
