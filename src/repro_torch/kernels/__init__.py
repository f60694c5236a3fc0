"""The port's hand-written CUDA kernels (``csrc/``), each with its plain
PyTorch version and a launch counter. :data:`KERNELS` holds the eight that
replace the JAX package's Pallas kernels; ``slot_bump``, the Retwis op
stream's kernel, replaces none and keeps its own counter
(``slot_bump.launches``), which ``chip_smoke.py`` reads beside
:func:`launch_counts`."""

from repro_torch.kernels import (buffer_fold, delta_extract, digest_blocks,
                                 join, lex_join, masked_extract, round_recv,
                                 round_step)

KERNELS = {"round_step": round_step, "round_recv": round_recv,
           "buffer_fold": buffer_fold, "digest_blocks": digest_blocks,
           "masked_extract": masked_extract, "join": join,
           "delta_extract": delta_extract, "lex_join_delta": lex_join}


def reset_launches() -> None:
    """Set every kernel's launch counter to 0 (and ``round_step``'s count
    of short-row launches that ran the ring)."""
    for mod in KERNELS.values():
        mod.launches = 0
    round_step.ring_launches = 0


def launch_counts() -> dict:
    """``{kernel: launches since the last reset}``."""
    return {name: mod.launches for name, mod in KERNELS.items()}
