"""Host ms a round inside the program's ``resync.digest`` and
``resync.extract`` labels (a digest-driven round's local digests and their
diff against the stored remote digests, then Δ(state, blocks) for every
slot). Nothing where the program has no such labels."""

from crdtbench.layer_metrics.store_gather_ms_per_round import span_ms


def read(t):
    parts = [span_ms(t, name) for name in ("resync.digest", "resync.extract")]
    if None in parts:
        return None
    return sum(parts)
