"""Device ms a round, a card, of copies from the device to the host (the
round metrics and results reaching the host)."""


def read(t):
    d2h = [c.dur for c in t.copies if "DtoH" in c.name]
    if not d2h or not t.rounds:
        return None
    return sum(d2h) / 1e3 / t.rounds / len(t.cards)
