"""AdamW with float32 master weights, PyTorch port of
``repro.optim.adamw``.

The optimizer state mirrors the parameter tree (nested dicts and lists of
tensors, as ``Decoder.tensors()`` gives them) leaf for leaf:

* ``master`` — float32 master copy (the working params are its cast)
* ``mu``/``nu`` — Adam moments in ``moments_dtype``

``update`` clips by the global gradient norm, applies decoupled weight
decay on the master inside the learning-rate product, and returns the new
params cast to each *gradient's* dtype, as the JAX package does: under
microbatching the gradients are the float32 accumulator, so the params
come back float32. It is plain tensor code under ``torch.no_grad()``, not
``torch.optim.AdamW``, whose update differs (no clipping, no masters,
decay outside the bias-corrected step).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch


def tree_map(fn, tree, *others):
    """``fn`` over the tensors of a nested dict/list/tuple ``tree``, with
    the matching leaves of ``others`` (trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(o[k] for o in others))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(o[i] for o in others))
                          for i, v in enumerate(tree))
    return fn(tree, *others)


def tree_leaves(tree) -> list:
    """The tensors of a nested dict/list/tuple tree, in its order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(tree, leaves):
    """``tree``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if isinstance(tree, dict):
        return {k: tree_unflatten(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_unflatten(v, leaves) for v in tree)
    return next(leaves)


class AdamWState(NamedTuple):
    step: torch.Tensor     # int32 0-d
    master: Any
    mu: Any
    nu: Any


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable[[torch.Tensor], torch.Tensor]   # schedule: step -> lr
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    # bf16 moments halve the optimizer state (masters stay float32)
    moments_dtype: torch.dtype = torch.float32

    @torch.no_grad()
    def init(self, params) -> AdamWState:
        """Step 0, float32 masters (a float32 leaf is shared, not copied:
        no update writes in place) and zero moments."""
        leaves = tree_leaves(params)
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=leaves[0].device),
            master=tree_map(lambda a: a.detach().to(torch.float32), params),
            mu=tree_map(self._zeros, params),
            nu=tree_map(self._zeros, params),
        )

    def _zeros(self, a):
        # zeros_like keeps a sharded leaf's placements
        return torch.zeros_like(a, dtype=self.moments_dtype,
                                memory_format=torch.contiguous_format)

    @torch.no_grad()
    def update(self, grads, state: AdamWState):
        """Returns (new params, new state, {"grad_norm", "lr"})."""
        gnorm = torch.sqrt(sum(torch.sum(g.float() * g.float())
                               for g in tree_leaves(grads)))
        scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)

        step = state.step + 1
        lr = self.lr(step)
        b1c = 1.0 - self.b1 ** step.to(torch.float32)
        b2c = 1.0 - self.b2 ** step.to(torch.float32)
        md = self.moments_dtype

        def leaf(g, m, v, p):
            # one leaf at a time, so that the scaled gradient and the
            # moments' float32 forms are transient
            g = g.float() * scale
            m = (self.b1 * m.float() + (1 - self.b1) * g).to(md)
            v = (self.b2 * v.float() + (1 - self.b2) * g * g).to(md)
            mhat = m.float() / b1c
            vhat = v.float() / b2c
            p = p - lr * (mhat / (torch.sqrt(vhat) + self.eps)
                          + self.weight_decay * p)
            return m, v, p

        out = [leaf(*x) for x in zip(*map(tree_leaves, (
            grads, state.mu, state.nu, state.master)))]
        mu, nu, master = (tree_unflatten(grads, (o[i] for o in out))
                          for i in range(3))
        params = tree_map(lambda p, g: p.to(g.dtype), master, grads)
        new_state = AdamWState(step=step, master=master, mu=mu, nu=nu)
        return params, new_state, {"grad_norm": gnorm, "lr": lr}
