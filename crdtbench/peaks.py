"""The chip's peaks and the byte bounds of the program's kernels.

Peaks are NVIDIA's data sheet for one H100 SXM (80 GB HBM3): 3.35 TB/s of
device memory. ``step_bytes`` is the least traffic of one ``round_step``
call (the sync round's one-launch kernel): δ, x and the K buffer slots
read once; x' and the K slots written once; the active and delivered
masks and the 3P + 2 counts. Its integer operations take less time than
its bytes at these shapes, so the bound is the bytes'.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12


def step_bytes(b: int, n: int, u: int, p: int, k: int) -> int:
    """Bytes one ``round_step`` call over ``b`` configs of ``n`` replicas,
    ``u`` int32 slots, ``p`` neighbour slots and ``k`` buffer slots must
    move."""
    rows = b * n
    return (2 * k + 3) * rows * u * 4 + rows * 4 * (4 * p + 3)


def step_bound_ms(b: int, n: int, u: int, p: int, k: int) -> float:
    """The least time of one such call at the chip's memory bandwidth."""
    return step_bytes(b, n, u, p, k) / HBM_BYTES_PER_S * 1e3
