"""Host ms a round inside the program's ``store.gather`` label (the
blocks' final states gathered on the first card, the pad masked out, the
footprint brought to the host). Nothing where the program has no such
label."""


def span_ms(t, name):
    """Host ms a round inside the labels ``name`` of the traced window."""
    durs = [dur for n, _, dur in t.host if n == name]
    if not durs or not t.rounds:
        return None
    return sum(durs) / 1e3 / t.rounds


def read(t):
    return span_ms(t, "store.gather")
