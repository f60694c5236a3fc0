"""Kernel launches a round issued inside the program's ``resync.descent``
label: the runtime and driver calls whose name contains ``Launch``
(``cudaLaunchKernel``, ``cuLaunchKernel``, ...) on the window's thread
that start inside the label, over the rounds profiled. Nothing where the
program has no such label."""

import bisect


def read(t):
    spans = sorted((ts, ts + dur) for name, ts, dur in t.host
                   if name == "resync.descent")
    if not spans or not t.rounds:
        return None
    starts = [a for a, _ in spans]
    launches = 0
    for name, ts, _ in t.host:
        if "Launch" in name:
            i = bisect.bisect_right(starts, ts) - 1
            launches += i >= 0 and ts < spans[i][1]
    return launches / t.rounds
