"""``merkle_descent``'s share of its roofline: the least bytes of the calls
in the traced window, at the chip's memory bandwidth, over the device time
of their launches (the fold launches and the compare), in %. Each call's
shapes come from the trace: the program labels every launch
``merkle_descent rows=R blocks=nB slots=P``. Nothing where no such label
or no ``merkle_descent`` kernel is in the window."""

import re

from crdtbench import peaks
from crdtbench.trace import base_name

LABEL = re.compile(r"merkle_descent rows=(\d+) blocks=(\d+) slots=(\d+)$")
FOLD, DIFF = "merkle_fold_kernel", "merkle_diff_kernel"


def call_bytes(rows: int, blocks: int, slots: int) -> int:
    """Least bytes one call over ``rows`` trees of ``blocks`` leaf digests,
    priced for ``slots`` senders each, must move: the leaves read once,
    the int64 routes read and the int32 words written. The trees
    themselves (12 bytes an internal node: 11.8 MB at 15 × 65,536 blocks)
    fit in the card's 50 MB L2, so no write or read of theirs counts."""
    return 12 * rows * blocks + (8 + 4) * slots * rows


def read(t):
    shapes = [tuple(map(int, m.groups())) for name, _, _ in t.host
              if (m := LABEL.match(name))]
    launches = [k for k in t.kernels if base_name(k.name) in (FOLD, DIFF)]
    calls = sum(base_name(k.name) == DIFF for k in launches)
    if not shapes or not calls:
        return None
    bound_ms = sum(call_bytes(*s) for s in shapes) / len(shapes) \
        / peaks.HBM_BYTES_PER_S * 1e3
    mean_ms = sum(k.dur for k in launches) / calls / 1e3
    return 100.0 * bound_ms / mean_ms
