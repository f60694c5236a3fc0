"""Host ms a round inside the program's ``store.check`` label (the checks
of the initial states and the op stream before a store runs). Nothing where
the program has no such label."""

from crdtbench.layer_metrics.store_gather_ms_per_round import span_ms


def read(t):
    return span_ms(t, "store.check")
