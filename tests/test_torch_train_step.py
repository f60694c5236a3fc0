"""The port's training step (``repro_torch.train.steps``: the loss, its
gradients, one AdamW step, microbatching, remat; ``train.losses``)
against the JAX package's, for every ``SMOKE`` config on the CPU.

Weights are the JAX package's own ``_init_one`` draws keyed by a CRC-32
(``test_torch_model_forward.jax_params``), carried across with
``convert``; inputs (tokens or frontend embeddings, labels, a loss mask
with zeros) are drawn with numpy from a seed.

- float32 (weights upcast on both sides): the loss and every gradient leaf
  at atol = rtol = 1e-4; the params after one AdamW step at atol = rtol =
  1e-4, except where the clipped gradient is below 1e-6 in magnitude.
  There the first step's m̂/(√v̂ + ε) = ĝ/(|ĝ| + ε), ε = 1e-8, turns on ε:
  a float32 rounding of ĝ (~1e-7 of the leaf's largest gradient) moves it
  by up to 2, its sign included, so those entries are held within 2·lr.
- bf16, as trained: each gradient leaf within twice the JAX package's own
  bf16 noise on that leaf (its bf16 gradients against its float32 ones on
  the same weights and inputs: two evaluations each about that far from
  the float32 value lie at most twice as far apart); the loss within four
  times its noise, or 2⁻¹⁰ where that is less (one scalar is one sample of
  the rounding, not the largest of many, and can fall much closer to the
  float32 value than the rounding's spread). The JAX steps are compiled with
  ``xla_allow_excess_precision=False``, as in the forward tests.
- (``microbatches=2``: ``test_torch_train_microbatch.py``.)
- remat ``"nothing"`` / ``"dots"`` / ``"none"``: the same loss and
  gradients, bit for bit (remat recomputes the same operations).
"""

import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_smoke_config
from repro.optim import AdamW as JAdamW
from repro.optim import constant as jconstant
from repro.train import losses as JL
from repro.train import steps as JS
from repro_torch import convert
from repro_torch.configs import get_smoke_config as port_smoke_config
from repro_torch.models import transformer as TT
from repro_torch.optim import AdamW, constant
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train import losses as TL
from repro_torch.train import steps as TS
from test_torch_model_forward import PER_OP_ROUNDING, jax_params

TOL_F32 = 1e-4
LR = 1e-3
ILL_CONDITIONED = 1e-6       # |clipped gradient| below which Adam's step turns on ε
LOSS_FLOOR = 2.0 ** -10      # the bf16 loss's bound where 4 × its noise is less
B, S = 2, 64


def draw_train_batch(cfg, rng, b=B, s=S):
    """numpy inputs of ``s`` positions (vision: patch embeddings then
    tokens), labels for every position and a loss mask with ~10% zeros."""
    f = cfg.frontend_len if cfg.frontend == "vision" else 0
    out = {}
    if cfg.frontend in ("audio", "vision"):
        n = s if cfg.frontend == "audio" else f
        out["embeds"] = rng.normal(size=(b, n, cfg.d_model)).astype(np.float32)
    if cfg.frontend != "audio":
        out["tokens"] = rng.integers(0, cfg.vocab_size,
                                     (b, s - f)).astype(np.int32)
    out["labels"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    out["loss_mask"] = (rng.random((b, s)) < 0.9).astype(np.float32)
    return out


BF16_KEYS = ("embeds", "loss_mask")


def to_jax(batch):
    return {k: jnp.asarray(v, jnp.bfloat16 if k in BF16_KEYS else None)
            for k, v in batch.items()}


def to_port(batch):
    return {k: torch.from_numpy(v).to(torch.bfloat16 if k in BF16_KEYS
                                      else torch.int32)
            for k, v in batch.items()}


def numpy_tree(tree, dtype=None):
    return jax.tree.map(
        lambda a: np.asarray(a if dtype is None else a.astype(dtype)), tree)


def port_tree(cfg, tree):
    """A JAX parameter-shaped tree -> the port's leaves in order (float32
    tensors)."""
    return [t.float() for t in tree_leaves(convert.tree_to_torch(
        cfg, numpy_tree(tree, jnp.float32)))]


INPUTS, RUNS = {}, {}


def jax_inputs(arch):
    """The JAX config, its weights (numpy, bf16) and a drawn batch."""
    if arch not in INPUTS:
        cfg = get_smoke_config(arch)
        rng = np.random.default_rng(zlib.crc32(f"train/{arch}".encode()))
        INPUTS[arch] = {"cfg": cfg, "params": numpy_tree(jax_params(cfg)),
                        "batch": draw_train_batch(cfg, rng)}
    return INPUTS[arch]


def jax_run(arch):
    """The JAX side of the float32 and bf16 comparisons for ``arch``, run
    once: the loss and gradients (``value_and_grad`` of its loss), and one
    AdamW update of them — its ``train_step`` at one microbatch."""
    if arch in RUNS:
        return RUNS[arch]
    run = dict(jax_inputs(arch))
    cfg = run["cfg"]
    params = jax.tree.map(jnp.asarray, run["params"])
    p32 = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    jb = to_jax(run["batch"])
    vg = jax.value_and_grad(JS.make_loss_fn(cfg), has_aux=True)
    opt = JAdamW(lr=jconstant(LR))

    (loss, aux), grads = jax.jit(vg)(p32, jb)
    new_params, _, om = opt.update(grads, opt.init(p32))
    metrics = {k: float(v) for k, v in dict(aux, loss=loss, **om).items()}
    run["f32"] = dict(loss=float(loss), grads=grads, params=new_params,
                      metrics=metrics)

    (loss16, _), g16 = jax.jit(vg).lower(params, jb).compile(
        PER_OP_ROUNDING)(params, jb)
    run["bf16"] = dict(loss=float(loss16), grads=g16)
    RUNS[arch] = run
    return run


def assert_tree_close(got, want, what, atol=TOL_F32, rtol=TOL_F32):
    for i, (g, w) in enumerate(zip(got, want)):
        torch.testing.assert_close(g.float(), w, atol=atol, rtol=rtol,
                                   msg=lambda m: f"{what} leaf {i}: {m}")


def assert_step_close(got, want, grads, scale, what):
    """Params after one AdamW step (see the module docstring)."""
    for i, (g, w, gr) in enumerate(zip(got, want, grads)):
        band = (gr * scale).abs() < ILL_CONDITIONED
        err = (g.float() - w).abs()
        allowed = TOL_F32 + TOL_F32 * w.abs() + torch.where(band, 2 * LR, 0.0)
        assert bool((err <= allowed).all()), \
            f"{what} leaf {i}: {float((err - allowed).max())} over"


def f32_model(arch):
    cfg = port_smoke_config(arch)
    return cfg, convert.params_to_torch(
        cfg, numpy_tree(jax_inputs(arch)["params"], jnp.float32))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_float32_step_matches(arch):
    run = jax_run(arch)
    cfg, model = f32_model(arch)
    batch = to_port(run["batch"])
    loss, metrics, grads = TS.make_grad_fn(cfg)(model, batch)
    want = run["f32"]
    torch.testing.assert_close(loss.item(), want["loss"], atol=TOL_F32,
                               rtol=TOL_F32)
    jg = port_tree(cfg, want["grads"])
    assert_tree_close(tree_leaves(grads), jg, f"{arch} grads")

    opt = AdamW(lr=constant(LR))
    state, m = TS.make_train_step(cfg, opt)(
        TS.init_train_state(cfg, opt, model), batch)
    for k in ("loss", "ce", "aux", "tokens", "grad_norm", "lr"):
        torch.testing.assert_close(float(m[k]), want["metrics"][k],
                                   atol=TOL_F32, rtol=TOL_F32)
    scale = min(1.0, 1.0 / max(want["metrics"]["grad_norm"], 1e-9))
    assert_step_close(tree_leaves(state.params.tensors()),
                      port_tree(cfg, want["params"]), jg, scale,
                      f"{arch} params after one step")
    assert isinstance(state.params, TT.Decoder)
    assert int(state.opt.step) == 1


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_bf16_grads_within_the_reference_noise(arch):
    run = jax_run(arch)
    cfg = port_smoke_config(arch)
    model = convert.params_to_torch(cfg, run["params"]).requires_grad_(True)
    loss, _, grads = TS.make_grad_fn(cfg)(model, to_port(run["batch"]))
    want16, want32 = run["bf16"], run["f32"]
    noise = abs(want16["loss"] - want32["loss"])
    assert abs(loss.item() - want16["loss"]) <= max(4 * noise, LOSS_FLOOR), \
        (loss.item(), want16["loss"], noise)
    for i, (g, j16, j32) in enumerate(zip(
            tree_leaves(grads), port_tree(cfg, want16["grads"]),
            port_tree(cfg, want32["grads"]))):
        assert g.dtype == torch.bfloat16
        leaf_noise = float((j16 - j32).abs().max())
        err = float((g.float() - j16).abs().max())
        assert err <= 2 * leaf_noise, (i, err, leaf_noise)


def remat_grads(cfg, model, batch, remat):
    c = dataclasses.replace(cfg, remat=remat)
    loss, _, grads = TS.make_grad_fn(c)(model.requires_grad_(True), batch)
    return loss, tree_leaves(grads)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_remat_modes_agree(arch):
    """Remat recomputes the same operations: ``"nothing"`` and ``"dots"``
    give the ``"none"`` loss and gradients bit for bit (bf16 weights)."""
    run = jax_inputs(arch)
    cfg = port_smoke_config(arch)
    model = convert.params_to_torch(cfg, run["params"])
    batch = to_port(run["batch"])
    ref_loss, ref = remat_grads(cfg, model, batch, "none")
    for remat in ("nothing", "dots"):
        loss, grads = remat_grads(cfg, model, batch, remat)
        assert loss.item() == ref_loss.item(), remat
        for i, (g, r) in enumerate(zip(grads, ref)):
            assert torch.equal(g, r), (remat, i)


def saved_bytes(cfg, model, batch, remat):
    """Bytes autograd keeps for backward over the stack's forward (a
    selective checkpoint's kept outputs are held apart from these)."""
    total = [0]

    def pack(t):
        total[0] += t.numel() * t.element_size()
        return t

    c = dataclasses.replace(cfg, remat=remat)
    model.requires_grad_(True)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        TT.forward(c, model, batch, mode="train")
    return total[0]


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "recurrentgemma-2b",
                                  "rwkv6-1.6b", "qwen3-moe-30b-a3b"])
def test_remat_keeps_less_for_backward(arch, monkeypatch):
    """``"nothing"`` keeps less than ``"none"`` keeps for
    backward; ``"dots"`` keeps the outputs of every weight product
    (``mm``) and recomputes the batched ones (``bmm``)."""
    cfg = port_smoke_config(arch)
    model = convert.params_to_torch(cfg, jax_inputs(arch)["params"])
    batch = to_port(jax_inputs(arch)["batch"])
    nothing, none = (saved_bytes(cfg, model, batch, r)
                     for r in ("nothing", "none"))
    assert nothing < none, (nothing, none)

    seen = {}
    real = TT._keep_dots

    def spy(ctx, op, *args, **kwargs):
        policy = real(ctx, op, *args, **kwargs)
        seen.setdefault(str(op), set()).add(policy)
        return policy

    monkeypatch.setattr(TT, "_keep_dots", spy)
    saved_bytes(cfg, model, batch, "dots")
    keep, redo = (torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE,
                  torch.utils.checkpoint.CheckpointPolicy.PREFER_RECOMPUTE)
    assert seen["aten.mm.default"] == {keep}
    assert seen.get("aten.bmm.default", {redo}) == {redo}
    assert all(p == {redo} for op, p in seen.items()
               if op not in ("aten.mm.default", "aten.addmm.default"))


@pytest.mark.parametrize("s,chunk", [(50, 16), (64, 64), (37, 1024),
                                     (100, 32)])
def test_chunked_cross_entropy_pads_the_last_chunk(s, chunk):
    """S not a multiple of the chunk: padded positions are masked out;
    the sums and the gradient to the features equal the JAX package's and
    an unchunked cross-entropy."""
    arch = "qwen3-0.6b"
    run = jax_inputs(arch)
    jcfg, cfg = run["cfg"], port_smoke_config(arch)
    rng = np.random.default_rng(s * 1000 + chunk)
    feats = rng.normal(size=(2, s, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab_size, (2, s)).astype(np.int32)
    mask = (rng.random((2, s)) < 0.8).astype(np.float32)
    p32 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), run["params"])

    def jloss(f):
        tot, den = JL.chunked_cross_entropy(jcfg, p32, f, jnp.asarray(labels),
                                            jnp.asarray(mask), chunk)
        return tot, den

    (jtot, jden), jvjp = jax.vjp(jloss, jnp.asarray(feats))
    jgrad = jvjp((jnp.ones(()), jnp.zeros(())))[0]
    model = convert.params_to_torch(cfg, numpy_tree(p32))
    f = torch.from_numpy(feats).requires_grad_(True)
    tot, den = TL.chunked_cross_entropy(cfg, model, f, torch.from_numpy(labels),
                                        torch.from_numpy(mask), chunk)
    (grad,) = torch.autograd.grad(tot, f)
    assert den.item() == float(jden) == mask.sum()
    torch.testing.assert_close(tot.item(), float(jtot), atol=TOL_F32,
                               rtol=TOL_F32)
    torch.testing.assert_close(grad, torch.from_numpy(np.array(jgrad)),
                               atol=TOL_F32, rtol=TOL_F32)
    logits = TT.lm_head(cfg, model, f).float()
    direct = (torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]),
        torch.from_numpy(labels).long().reshape(-1), reduction="none")
        * torch.from_numpy(mask).reshape(-1)).sum()
    torch.testing.assert_close(tot, direct, atol=TOL_F32, rtol=TOL_F32)


def test_train_state_crosses_both_ways():
    """A JAX ``TrainState`` after one step carried into the port, stepped
    on both sides, and carried back: the same state within the float32
    tolerance (params by the band rule)."""
    arch = "deepseek-coder-33b"
    run = jax_inputs(arch)
    jcfg, cfg = run["cfg"], port_smoke_config(arch)
    p32 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), run["params"])
    opt = JAdamW(lr=jconstant(LR))
    jb = to_jax(run["batch"])
    step = jax.jit(JS.make_train_step(jcfg, opt))
    js1, _ = step(JS.init_train_state(jcfg, opt, p32), jb)
    ts1 = convert.train_state_to_torch(cfg, numpy_tree(js1))
    back = convert.train_state_to_numpy(cfg, ts1)
    for a, b in zip(jax.tree.leaves(back["params"]),
                    jax.tree.leaves(numpy_tree(js1.params))):
        np.testing.assert_array_equal(a, b)
    assert int(back["opt"]["step"]) == 1
    js2, jm2 = step(js1, jb)
    ts2, tm2 = TS.make_train_step(cfg, AdamW(lr=constant(LR)))(
        ts1, to_port(run["batch"]))
    assert int(ts2.opt.step) == 2
    torch.testing.assert_close(float(tm2["loss"]), float(jm2["loss"]),
                               atol=TOL_F32, rtol=TOL_F32)
    out = convert.train_state_to_numpy(cfg, ts2)
    for name in ("mu", "nu"):
        for a, b in zip(jax.tree.leaves(out["opt"][name]),
                        jax.tree.leaves(numpy_tree(getattr(js2.opt, name)))):
            np.testing.assert_allclose(a, b, atol=TOL_F32, rtol=TOL_F32)
