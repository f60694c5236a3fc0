"""Device ms a round, a card, in kernels that are not the program's own
CUDA kernels: the op stream, the metric reductions, the convergence flags
and the copies between buffers that PyTorch runs."""

from crdtbench.trace import is_port_kernel


def read(t):
    aten = [k.dur for k in t.kernels if not is_port_kernel(k.name)]
    if not aten or not t.rounds:
        return None
    return sum(aten) / 1e3 / t.rounds / len(t.cards)
