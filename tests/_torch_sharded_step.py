"""One rank of a sharded train step on the CPU (gloo), for
``tests/test_torch_sharded.py``:

    python tests/_torch_sharded_step.py RANK WORLD STORE OUT ARCH MESH [MB]

joins a ``world``-rank gloo group through the ``FileStore`` at STORE, builds
the mesh MESH (e.g. ``2,2`` over ("data", "model")) and runs one float32
``make_grad_fn`` of ARCH's smoke config with its weights (seed 0) and batch
(numpy seed 0) distributed by ``param_specs``/``batch_specs`` and
``to_named``, with hints and ``grad_specs`` (over MB microbatches, default
1); then one AdamW step through ``make_train_step``. Rank 0 runs the
unsharded port step on the same inputs and writes, as JSON to OUT, the loss
of both and each gradient leaf's and each param's largest difference beside
the leaf's scale, then a prefill's and two decode steps' (serve rules).
"""

import json
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import transformer as TR
from repro_torch.optim.adamw import AdamW, tree_leaves
from repro_torch.optim.schedule import constant
from repro_torch.train import sharding as SH
from repro_torch.train import steps as ST

B, S = 4, 16


def batch_for(cfg):
    rng = np.random.default_rng(0)
    out = {}
    s = S
    if cfg.frontend is not None:
        n = S // 2 if cfg.frontend == "vision" else S
        out["embeds"] = torch.from_numpy(
            rng.normal(size=(B, n, cfg.d_model)).astype(np.float32))
        s = S - n if cfg.frontend == "vision" else S
    if cfg.frontend != "audio":
        out["tokens"] = torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32))
    out["labels"] = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32))
    out["loss_mask"] = torch.from_numpy(
        (rng.random((B, S)) < 0.9).astype(np.float32))
    return out


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_f32(v) for v in tree]
    return tree.detach().float()


def _serve(cfg, plain, batch, hints, mesh):
    """Largest |logit| difference of a sharded prefill and two decode
    steps (serve rules, the cache on cache_specs) against the plain ones,
    beside the largest |logit|."""
    p_sp = SH.param_specs(cfg, mesh, "serve")
    model = TR.Decoder(cfg, SH.to_named(plain.tensors(), p_sp, mesh))
    prompt = {"tokens": batch["tokens"]}
    sprompt = SH.to_named(prompt, SH.batch_specs(cfg, mesh, prompt), mesh)
    logits, cache = ST.make_prefill(cfg)(plain, prompt)
    slogits, scache = ST.make_prefill(cfg, hints=hints)(model, sprompt)
    errs = [float((slogits.full_tensor() - logits).abs().max())]
    scale = float(logits.abs().max())
    # the decode caches span the prompt plus two steps
    s = prompt["tokens"].shape[1]
    cache = _grow(cfg, cache, s + 2)
    scache = ST._cache_on_mesh(cfg, _grow(cfg, SH.full_tree(scache), s + 2),
                               mesh)
    decode, sdecode = ST.make_decode(cfg), ST.make_decode(cfg, hints=hints)
    for i in range(2):
        tok = {"tokens": logits[:, -1:].argmax(-1).to(torch.int32)}
        stok = SH.to_named(tok, SH.batch_specs(cfg, mesh, tok), mesh)
        logits, cache = decode(plain, cache, tok, s + i)
        slogits, scache = sdecode(model, scache, stok, s + i)
        errs.append(float((slogits.full_tensor() - logits).abs().max()))
        scale = max(scale, float(logits.abs().max()))
    return {"errs": errs, "scale": scale,
            "cache_placements": {k: str(v.placements)
                                 for k, v in scache[0].items()}}


def _grow(cfg, cache, total):
    """A prefill's cache of S slots as one of ``total`` slots (ring and
    window caches keep their size), the new slots empty."""
    out = []
    for kind, layer in zip(cfg.layer_kinds, cache):
        if kind not in ("global", "local") or (
                kind == "local" and layer["k"].shape[1] >= cfg.window):
            out.append(layer)
            continue
        s = layer["k"].shape[1]
        grow = total - s
        out.append({
            "k": torch.cat([layer["k"], layer["k"].new_zeros(
                (layer["k"].shape[0], grow) + layer["k"].shape[2:])], 1),
            "v": torch.cat([layer["v"], layer["v"].new_zeros(
                (layer["v"].shape[0], grow) + layer["v"].shape[2:])], 1),
            "kpos": torch.cat([layer["kpos"], layer["kpos"].new_full(
                (layer["kpos"].shape[0], grow), TR.POS_SENTINEL)], 1)})
    return out


def main(rank, world, store, out, arch, mesh_shape, mb=1):
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        shape = tuple(int(x) for x in mesh_shape.split(","))
        mesh = make_mesh(shape, ("pod", "data", "model")[-len(shape):],
                         device_type="cpu")
        cfg = get_smoke_config(arch)
        plain = TR.Decoder(cfg, _f32(TR.init_params(cfg, 0, "cpu").tensors()))
        batch = batch_for(cfg)
        hints = TR.ShardingHints(data_axes=SH.data_axes_of(mesh),
                                 model_axis="model")
        p_sp = SH.param_specs(cfg, mesh, "train")
        model = TR.Decoder(cfg, SH.to_named(plain.tensors(), p_sp, mesh))
        sbatch = SH.to_named(batch, SH.batch_specs(cfg, mesh, batch), mesh)
        loss, _, grads = ST.make_grad_fn(cfg, mb, hints=hints,
                                         grad_specs=p_sp)(model, sbatch)
        optim = AdamW(lr=constant(1e-3))
        state = ST.init_train_state(cfg, optim, model)
        new, metrics = ST.make_train_step(cfg, optim, microbatches=mb,
                                          hints=hints, grad_specs=p_sp)(
            state, sbatch)
        full_g = tree_leaves(SH.full_tree(grads))
        full_p = tree_leaves(SH.full_tree(new.params.tensors()))
        placed = all(str(a.placements) == str(b.placements) for a, b in zip(
            tree_leaves(grads), tree_leaves(model.tensors())))
        sloss = float(loss.full_tensor())
        # serving: prefill the batch's tokens, then two decode steps
        serve = _serve(cfg, plain, batch, hints, mesh) \
            if cfg.frontend is None else None
        if rank == 0:
            ref_loss, _, ref_g = ST.make_grad_fn(cfg, mb)(plain, batch)
            ref_state = ST.init_train_state(cfg, optim, plain)
            ref_new, _ = ST.make_train_step(cfg, optim, microbatches=mb)(
                ref_state, batch)
            ref_g, ref_p = tree_leaves(ref_g), tree_leaves(
                ref_new.params.tensors())
            res = {
                "loss": sloss, "ref_loss": float(ref_loss),
                "grads": [(float((a - b).abs().max()), float(b.abs().max()))
                          for a, b in zip(full_g, ref_g)],
                "params": [(float((a - b).abs().max()), float(b.abs().max()))
                           for a, b in zip(full_p, ref_p)],
                "grads_on_param_placements": placed,
                "local_embed": list(model.embed.to_local().shape),
                "embed": list(model.embed.shape),
                "serve": serve,
            }
            with open(out, "w") as f:
                json.dump(res, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    rank, world, store, out, arch, mesh_shape = sys.argv[1:7]
    main(int(rank), int(world), store, out, arch, mesh_shape,
         int(sys.argv[7]) if len(sys.argv) > 7 else 1)
