"""``round_step``'s share of its roofline: the byte bound of one call at
the cell's shapes (``peaks.step_bound_ms``) over the mean device time of a
``round_step`` launch in the traced window, in %. Nothing where the cell
launches no ``round_step``."""

from crdtbench import peaks
from crdtbench.trace import is_round_step


def read(t):
    launches = [k for k in t.kernels if is_round_step(k.name)]
    if not launches or t.step_shape is None:
        return None
    mean_ms = sum(k.dur for k in launches) / len(launches) / 1e3
    return 100.0 * peaks.step_bound_ms(**t.step_shape) / mean_ms
