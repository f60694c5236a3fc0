"""How unevenly the cards of a sharded run are kept busy: 100 × (the
busiest card's busy seconds − the least busy card's) / the busiest card's,
over the traced window, in %. Nothing with fewer than two cards or an idle
window."""


def read(t):
    busy = [t.busy_s(c) for c in t.cards]
    if len(busy) < 2 or max(busy) <= 0:
        return None
    return 100.0 * (max(busy) - min(busy)) / max(busy)
