"""The share of the traced window in which no kernel, copy or memset ran,
on the most idle card, in %."""


def read(t):
    if t.window_s <= 0 or not (t.kernels or t.copies):
        return None
    return max(100.0 * (1.0 - t.busy_s(c) / t.window_s) for c in t.cards)
