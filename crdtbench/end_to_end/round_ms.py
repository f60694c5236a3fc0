"""The window's wall time over all rounds of the simulations it
completed, in ms."""


def read(w):
    return w.window_s * 1e3 / w.rounds
