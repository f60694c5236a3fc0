"""The 95th percentile of one whole simulation's wall time (call to
result on the host), over every simulation of the window, in ms (linear
interpolation between order statistics)."""

import numpy as np


def read(w):
    return float(np.percentile(np.asarray(w.sims_s) * 1e3, 95))
