"""The port's microbatched training step (``make_train_step(...,
microbatches=2)``) against the JAX package's, on the CPU, with the
weights and inputs of ``test_torch_train_step.py``.

- float32 (weights upcast on both sides): the metrics at atol = rtol =
  1e-4; the first moments (0.1 × the clipped float32 accumulator) at atol
  1e-5, rtol 1e-4; the params after the step by that file's band rule.
- bf16 weights: the reference's dtype rule on both sides — params take the
  gradients' dtype, so after a microbatched step (float32 accumulator)
  they are float32, and after an unbatched one bf16 — with the loss within
  four times the JAX side's own bf16 noise (or 2⁻¹⁰) and the first moments
  within twice it (its bf16 run against its float32 run; see that file).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import AdamW as JAdamW
from repro.optim import constant as jconstant
from repro.train import steps as JS
from repro_torch import convert
from repro_torch.configs import get_smoke_config as port_smoke_config
from repro_torch.optim import AdamW, constant
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train import steps as TS
from test_torch_model_forward import PER_OP_ROUNDING
from test_torch_train_step import (LOSS_FLOOR, LR, TOL_F32,
                                   assert_step_close,
                                   assert_tree_close, f32_model, jax_inputs,
                                   port_tree, to_jax, to_port)

ARCHS = ["qwen2.5-14b", "mixtral-8x22b", "rwkv6-1.6b", "internvl2-26b"]
RUNS = {}


def jax_microbatched(arch):
    """The JAX microbatched step from float32 and from bf16 weights (the
    latter compiled with per-operation rounding), run once."""
    if arch not in RUNS:
        inp = jax_inputs(arch)
        cfg, jb = inp["cfg"], to_jax(inp["batch"])
        opt = JAdamW(lr=jconstant(LR))
        step = JS.make_train_step(cfg, opt, microbatches=2)
        params = jax.tree.map(jnp.asarray, inp["params"])
        p32 = jax.tree.map(lambda a: a.astype(jnp.float32), params)
        s16 = JS.init_train_state(cfg, opt, params)
        RUNS[arch] = {
            "f32": jax.jit(step)(JS.init_train_state(cfg, opt, p32), jb),
            "bf16": jax.jit(step).lower(s16, jb).compile(PER_OP_ROUNDING)(
                s16, jb)}
    return RUNS[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_microbatched_step_matches_float32(arch):
    jstate, jm = jax_microbatched(arch)["f32"]
    cfg, model = f32_model(arch)
    opt = AdamW(lr=constant(LR))
    state, m = TS.make_train_step(cfg, opt, microbatches=2)(
        TS.init_train_state(cfg, opt, model),
        to_port(jax_inputs(arch)["batch"]))
    for k in ("loss", "ce", "aux", "tokens", "grad_norm"):
        torch.testing.assert_close(float(m[k]), float(jm[k]), atol=TOL_F32,
                                   rtol=TOL_F32)
    # mu = (1 - b1) · the clipped accumulated gradient
    mu = port_tree(cfg, jstate.opt.mu)
    assert_tree_close(tree_leaves(state.opt.mu), mu, f"{arch} mu",
                      atol=TOL_F32 * 0.1)
    scale = min(1.0, 1.0 / max(float(jm["grad_norm"]), 1e-9))
    grads = [a / (0.1 * scale) for a in mu]
    assert_step_close(tree_leaves(state.params.tensors()),
                      port_tree(cfg, jstate.params), grads, scale,
                      f"{arch} params after a microbatched step")


@pytest.mark.parametrize("arch", ARCHS)
def test_microbatched_bf16_step_returns_float32_params(arch):
    runs = jax_microbatched(arch)
    (j16, jm16), (j32, jm32) = runs["bf16"], runs["f32"]
    assert {a.dtype for a in jax.tree.leaves(j16.params)} \
        == {np.dtype(np.float32)}

    inp = jax_inputs(arch)
    cfg = port_smoke_config(arch)
    opt = AdamW(lr=constant(LR))
    batch = to_port(inp["batch"])
    state, m = TS.make_train_step(cfg, opt, microbatches=2)(
        TS.init_train_state(cfg, opt, convert.params_to_torch(
            cfg, inp["params"])), batch)
    assert {t.dtype for t in tree_leaves(state.params.tensors())} \
        == {torch.float32}
    noise = abs(float(jm16["loss"]) - float(jm32["loss"]))
    assert abs(float(m["loss"]) - float(jm16["loss"])) \
        <= max(4 * noise, LOSS_FLOOR)
    for i, (g, w16, w32) in enumerate(zip(
            tree_leaves(state.opt.mu), port_tree(cfg, j16.opt.mu),
            port_tree(cfg, j32.opt.mu))):
        leaf_noise = float((w16 - w32).abs().max())
        assert float((g - w16).abs().max()) <= 2 * leaf_noise, i

    one, _ = TS.make_train_step(cfg, opt)(
        TS.init_train_state(cfg, opt, convert.params_to_torch(
            cfg, inp["params"])), batch)
    assert {t.dtype for t in tree_leaves(one.params.tensors())} \
        == {torch.bfloat16}


def test_microbatches_must_divide_the_batch():
    cfg, model = f32_model("qwen2.5-14b")
    batch = to_port(jax_inputs("qwen2.5-14b")["batch"])
    with pytest.raises(ValueError, match="microbatches"):
        TS.make_grad_fn(cfg, microbatches=3)(model, batch)
