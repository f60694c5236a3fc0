"""Carry states across between the JAX package and the port.

The JAX package's states, algorithm carries (``x``, ``buf``, ``buf_elems``,
``aux``) and topology tables, handed over as numpy arrays, become the port's
tensors and back. States are [N, U] on both sides. Every per-slot array is
node-major in the JAX package and slot-major in the port, so that its slots
are contiguous operands of the port's kernels: the per-origin buffer
([N, P+1, U] ↔ [P+1, N, U]), ``state_driven``'s response buffer
([N, P, U] ↔ [P, N, U]) and ``digest_driven``'s ``aux`` (remote digests
[N, P, nB, 3] ↔ [P, N, nB, 3], have-one flags [N, P] ↔ [P, N]); the carry
converters swap those two axes. A batched carry (a sweep's or a store's,
``batched=True``) has a leading config axis on both sides and its slot axis
after the config and node axes in the JAX package: per-origin buffers
[B, N, P+1, U] ↔ [P+1, B, N, U], digests [B, N, P, nB, 3] ↔
[P, B, N, nB, 3]. BitGSet words and digests change type:
uint32 in numpy, int32 bit-views in torch (same bits). Bool (GSet) stays
bool. A tuple state (an LWWMap's ``(t, v)``, a product's components) and
its buffers cross leaf by leaf, each leaf's slot axis swapped alike.

The model side's trees cross too: a JAX parameter tree, optimizer tree
or cache (numpy leaves; bfloat16 arrives as numpy's ``bfloat16`` extension
type) has one stacked dict per pattern position (``blocks``, leading axis
the group) and the ``tail`` layers; the port has one module (or dict) a
layer in stack order. ``params_to_torch``, ``cache_to_torch`` and
``train_state_to_torch`` unstack; ``params_to_numpy``, ``cache_to_numpy``
and ``train_state_to_numpy`` stack back (bf16 leaves as float32,
exactly).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.lattice import tree_leaves, tree_map
from repro_torch.sync.algorithms import AlgoCarry
from repro_torch.sync.topology import Topology, from_tables


def _leaf_to_torch(a, device):
    a = np.array(a, order="C")          # a writable, contiguous copy
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    if a.dtype.name == "bfloat16":      # ml_dtypes' type: same bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


def to_torch(a, device="cpu"):
    """numpy array (or a tuple state of them) -> tensor(s) on ``device``;
    uint32 words become int32 bit-views."""
    return tree_map(lambda leaf: _leaf_to_torch(leaf, device), a)


def to_numpy(t, words: bool = False):
    """tensor (or a tuple state of them) -> numpy array(s); ``words=True``
    returns int32 bit-views as the JAX package's uint32 words."""

    def leaf(a):
        a = a.detach().cpu().numpy()
        return a.view(np.uint32) if words else a

    return tree_map(leaf, t)


def _per_slot(x, buf) -> bool:
    """A buffer with one axis more than the states holds slots."""
    return buf is not None and \
        np.ndim(tree_leaves(buf)[0]) == np.ndim(tree_leaves(x)[0]) + 1


def carry_to_torch(x, buf, buf_elems, aux=None, device="cpu",
                   batched: bool = False) -> AlgoCarry:
    """A JAX ``AlgoCarry``'s leaves (numpy) -> the port's carry; with
    ``batched`` the leaves carry a leading config axis."""
    lead = 2 if batched else 1
    if _per_slot(x, buf):
        buf = tree_map(lambda a: np.moveaxis(np.asarray(a), lead, 0), buf)
    if aux is not None:
        aux = tuple(to_torch(np.moveaxis(np.asarray(a), lead, 0), device)
                    for a in aux)
    return AlgoCarry(x=to_torch(x, device),
                     buf=None if buf is None else to_torch(buf, device),
                     buf_elems=to_torch(buf_elems, device).to(torch.int32),
                     aux=aux)


def carry_to_numpy(carry: AlgoCarry, words: bool = False,
                   batched: bool = False):
    """The port's carry -> ``(x, buf, buf_elems, aux)`` numpy arrays in the
    JAX package's types and layouts (digests as uint32 words); with
    ``batched`` the leaves carry a leading config axis."""
    lead = 2 if batched else 1
    buf, aux = carry.buf, carry.aux
    if _per_slot(carry.x, buf):
        buf = tree_map(lambda a: a.movedim(0, lead), buf)
    if aux is not None:
        dig, have = aux
        aux = (to_numpy(dig.movedim(0, lead), words=True),
               to_numpy(have.movedim(0, lead)))
    return (to_numpy(carry.x, words),
            None if buf is None else to_numpy(buf, words),
            to_numpy(carry.buf_elems), aux)


def topology_to_torch(name: str, nbrs, mask, rev) -> Topology:
    """A JAX ``Topology``'s tables (numpy) -> the port's topology."""
    return from_tables(name, nbrs, mask, rev)


def topology_to_numpy(topo: Topology):
    """The port's topology -> ``(nbrs, mask, rev)`` numpy tables."""
    return topo.nbrs.numpy(), topo.mask.numpy(), topo.rev.numpy()


def _unstack(cfg, tree):
    """A JAX ``{"blocks": [...], "tail": [...]}`` tree -> one dict a layer
    in stack order (group g's layer i takes ``blocks[i][...][g]``)."""
    layers = [{k: v[g] for k, v in tree["blocks"][i].items()}
              for g in range(cfg.num_groups) for i in range(cfg.pattern_len)]
    return layers + list(tree["tail"])


def _stack(cfg, layers, leaf):
    """One dict a layer in stack order -> the JAX ``blocks`` (stacked over
    groups) and ``tail``, each leaf through ``leaf``."""
    p, g = cfg.pattern_len, cfg.num_groups
    blocks = [{k: np.stack([leaf(layers[gi * p + i][k]) for gi in range(g)])
               for k in layers[i]} for i in range(p)] if g else []
    return {"blocks": blocks,
            "tail": [{k: leaf(v) for k, v in layer.items()}
                     for layer in layers[g * p:]]}


def _numpy_leaf(t):
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


HEAD = ("embed", "final_norm", "lm_head")


def tree_to_torch(cfg, tree, device="cpu"):
    """A JAX parameter-shaped tree (parameters, masters, moments; numpy
    leaves) -> the port's tree (``Decoder.tensors()``'s layout) on
    ``device``."""
    out = {k: _leaf_to_torch(tree[k], device) for k in HEAD if k in tree}
    out["layers"] = [{k: _leaf_to_torch(v, device) for k, v in layer.items()}
                     for layer in _unstack(cfg, tree)]
    return out


def tree_to_numpy(cfg, tree):
    """The port's parameter-shaped tree -> the JAX layout as numpy arrays;
    bf16 leaves become float32 (exact)."""
    out = {k: _numpy_leaf(tree[k]) for k in HEAD if k in tree}
    out.update(_stack(cfg, tree["layers"], _numpy_leaf))
    return out


def params_to_torch(cfg, params, device="cpu"):
    """A JAX parameter tree (numpy leaves) -> the port's ``Decoder`` on
    ``device`` (tied or untied head as the tree has it)."""
    from repro_torch.models.transformer import Decoder

    return Decoder(cfg, tree_to_torch(cfg, params, device))


def params_to_numpy(cfg, params):
    """The port's ``Decoder`` -> the JAX parameter tree (numpy leaves, bf16
    as float32)."""
    return tree_to_numpy(cfg, params.tensors())


def train_state_to_torch(cfg, state, device="cpu"):
    """A JAX ``TrainState`` with numpy leaves (``params``; ``opt.step``,
    ``.master``, ``.mu``, ``.nu``) -> the port's ``TrainState``."""
    from repro_torch.optim import AdamWState
    from repro_torch.train.steps import TrainState

    opt = state.opt
    return TrainState(
        params=params_to_torch(cfg, state.params, device),
        opt=AdamWState(step=_leaf_to_torch(np.asarray(opt.step, np.int32),
                                           device),
                       master=tree_to_torch(cfg, opt.master, device),
                       mu=tree_to_torch(cfg, opt.mu, device),
                       nu=tree_to_torch(cfg, opt.nu, device)))


def train_state_to_numpy(cfg, state):
    """The port's ``TrainState`` -> ``{"params": ..., "opt": {"step",
    "master", "mu", "nu"}}`` in the JAX layout (numpy leaves, bf16 as
    float32)."""
    opt = state.opt
    return {"params": params_to_numpy(cfg, state.params),
            "opt": {"step": opt.step.cpu().numpy(),
                    "master": tree_to_numpy(cfg, opt.master),
                    "mu": tree_to_numpy(cfg, opt.mu),
                    "nu": tree_to_numpy(cfg, opt.nu)}}


def cache_to_torch(cfg, cache, device="cpu"):
    """A JAX cache (numpy leaves) -> the port's list of per-layer dicts."""
    return [{k: _leaf_to_torch(v, device) for k, v in layer.items()}
            for layer in _unstack(cfg, cache)]


def cache_to_numpy(cfg, cache):
    """The port's cache -> the JAX layout (``blocks`` stacked over groups,
    ``tail``) as numpy arrays; bf16 leaves become float32 (exact)."""
    return _stack(cfg, cache, _numpy_leaf)
