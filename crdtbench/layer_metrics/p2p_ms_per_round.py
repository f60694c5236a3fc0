"""Device ms a round of copies from one card to another (the final states
gathered on the first card), summed over the cards: the profiler names
them ``Memcpy PtoP``."""


def read(t):
    p2p = [c.dur for c in t.copies if "PtoP" in c.name]
    if not p2p or not t.rounds:
        return None
    return sum(p2p) / 1e3 / t.rounds
