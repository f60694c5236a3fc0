"""The port's decoder stack (``repro_torch.models.transformer`` and the
serving steps of ``repro_torch.train.steps``) against the JAX package's,
for every ``SMOKE`` config on the CPU.

Weights are drawn once by the JAX package's own ``_init_one`` (keyed by a
CRC-32 of each leaf's path, so the draw is the same in every process) and
carried across with ``convert.params_to_torch``; every input is drawn
with numpy from a seed.

- float32: the train/prefill ``forward`` with float32 weights, atol =
  rtol = 1e-4.
- bfloat16, as served: prefill logits and the filled cache, then decode
  steps from one JAX cache (``convert.cache_to_torch``), teacher-forced
  with the JAX run's greedy tokens. The JAX steps are compiled with
  ``xla_allow_excess_precision=False``: XLA otherwise keeps some fused
  bf16 intermediates in float32, a liberty of the compiler that moves a
  value by bf16 rounding noise — enough to flip a near-tied MoE route —
  whereas rounding every bf16 operation as written is what both programs
  state. The packages still sum products in different orders (XLA's CPU
  dot against oneDNN), so a value may differ by an ulp in any layer;
  ``TOL_BF16`` = 8 bf16 epsilons (8 × 2⁻⁷ = 0.0625, atol = rtol) covers a
  few such ulps reaching the logits through the stack, and is tighter than
  the JAX package's own 0.15 for its bf16 decode-vs-prefill test.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_smoke_config
from repro.models import params as JP
from repro.models import transformer as JT
from repro.train import steps as JS
from repro_torch import convert
from repro_torch.models import transformer as TT
from repro_torch.train import steps as TS

TOL_F32 = 1e-4
TOL_BF16 = 8 * torch.finfo(torch.bfloat16).eps
PER_OP_ROUNDING = {"xla_allow_excess_precision": False}
B, PROMPT, STEPS = 2, 24, 8          # cache of 32: prompt + decode steps


def jax_params(cfg, seed=0):
    """The JAX package's initialisation, keyed by a CRC-32 of each path
    (its ``init_tree`` keys by the process-salted ``hash()``)."""
    root = jax.random.PRNGKey(seed)

    def one(path, d):
        h = zlib.crc32(jax.tree_util.keystr(path).encode()) % (2 ** 31 - 1)
        return JP._init_one(d, jax.random.fold_in(root, h))

    return jax.tree_util.tree_map_with_path(
        one, JT.param_defs(cfg), is_leaf=lambda x: isinstance(x, JP.ParamDef))


def numpy_tree(tree, dtype=None):
    return jax.tree.map(
        lambda a: np.asarray(a if dtype is None else a.astype(dtype)), tree)


def compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(PER_OP_ROUNDING)


def draw_batch(cfg, b, s, rng):
    """numpy inputs: tokens, frame embeddings (audio) or patch embeddings
    followed by tokens (vision), ``s`` positions in all."""
    f = cfg.frontend_len if cfg.frontend == "vision" else 0
    out = {}
    if cfg.frontend in ("audio", "vision"):
        n = s if cfg.frontend == "audio" else f
        out["embeds"] = rng.normal(size=(b, n, cfg.d_model)).astype(np.float32)
    if cfg.frontend != "audio":
        out["tokens"] = rng.integers(0, cfg.vocab_size,
                                     (b, s - f)).astype(np.int32)
    return out


def to_jax(batch):
    return {k: jnp.asarray(v, jnp.bfloat16 if k == "embeds" else None)
            for k, v in batch.items()}


def to_port(batch):
    return {k: torch.tensor(v, dtype=torch.bfloat16 if k == "embeds"
                            else torch.int32)
            for k, v in batch.items()}


RUNS = {}


def jax_run(arch):
    """The JAX side of every comparison for ``arch``, run once."""
    if arch in RUNS:
        return RUNS[arch]
    cfg = get_smoke_config(arch)
    rng = np.random.default_rng(zlib.crc32(arch.encode()))
    params = jax_params(cfg)
    run = {"cfg": cfg, "params": numpy_tree(params)}

    # float32 train/prefill forward
    p32 = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    batch = draw_batch(cfg, B, 64, rng)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    feats, _ = jax.jit(lambda p, b: JT.forward(cfg, p, b, mode="train"))(
        p32, jb)
    run["f32"] = (numpy_tree(p32), batch, np.asarray(feats))

    # bfloat16 prefill into a cache for the decode steps too
    batch = draw_batch(cfg, B, PROMPT, rng)
    jb = to_jax(batch)

    def prefill(p, bt):
        cache = JT.init_cache(cfg, B, PROMPT + STEPS)
        feats, cache, _ = JT.forward(cfg, p, bt, mode="prefill", cache=cache)
        return JT.lm_head(cfg, p, feats[:, -1:]), cache

    logits, cache = compiled(prefill, params, jb)(params, jb)
    run["prefill"] = (batch, np.asarray(logits, np.float32),
                      numpy_tree(cache))

    # decode, teacher-forced with the JAX run's greedy tokens (audio: drawn
    # frame embeddings)
    decode = None
    steps = []
    for i in range(STEPS):
        if cfg.frontend == "audio":
            bt = {"embeds": rng.normal(size=(B, 1, cfg.d_model))
                  .astype(np.float32)}
        else:
            bt = {"tokens": np.asarray(jnp.argmax(logits[:, -1], -1),
                                       np.int32)[:, None]}
        args = (params, cache, to_jax(bt), jnp.asarray(PROMPT + i, jnp.int32))
        if decode is None:
            decode = compiled(JS.make_decode(cfg), *args)
        logits, cache = decode(*args)
        steps.append((bt, np.asarray(logits, np.float32)))
    run["decode"] = steps
    run["decode_cache"] = numpy_tree(cache, jnp.float32)
    RUNS[arch] = run
    return run


def assert_close(got, want, tol, what):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


def assert_caches_close(cfg, got, want, what):
    """Port cache (list) against a JAX cache tree: positions exactly,
    values within the bf16 tolerance."""
    got = convert.cache_to_numpy(cfg, got)
    gl, wl = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        assert g.shape == w.shape, what
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=what)
        else:
            assert_close(g, w, TOL_BF16, what)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_float32(arch):
    run = jax_run(arch)
    cfg = run["cfg"]
    p32, batch, want = run["f32"]
    model = convert.params_to_torch(cfg, p32)
    with torch.no_grad():
        feats, aux = TT.forward(cfg, model, {k: torch.from_numpy(v)
                                             for k, v in batch.items()})
    assert feats.dtype == torch.float32
    assert_close(feats, want, TOL_F32, arch)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_bfloat16(arch):
    run = jax_run(arch)
    cfg = run["cfg"]
    batch, want_logits, want_cache = run["prefill"]
    model = convert.params_to_torch(cfg, run["params"])
    with torch.no_grad():
        cache = TT.init_cache(cfg, B, PROMPT + STEPS, device="cpu")
        feats, cache, _ = TT.forward(cfg, model, to_port(batch),
                                     mode="prefill", cache=cache)
        logits = TT.lm_head(cfg, model, feats[:, -1:])
    assert logits.dtype == torch.bfloat16
    assert logits.shape == (B, 1, cfg.vocab_size)
    assert_close(logits, want_logits, TOL_BF16, f"{arch} logits")
    assert_caches_close(cfg, cache,
                        jax.tree.map(lambda a: np.asarray(a, np.float32)
                                     if a.dtype.name == "bfloat16" else a,
                                     want_cache), f"{arch} cache")
    # make_prefill: the same logits, its cache sized for the prompt alone
    logits2, cache2 = TS.make_prefill(cfg)(model, to_port(batch))
    assert torch.equal(logits2, logits), f"{arch} make_prefill"
    assert cache2[0][next(iter(cache2[0]))].device.type == "cpu"


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_bfloat16_teacher_forced(arch):
    run = jax_run(arch)
    cfg = run["cfg"]
    model = convert.params_to_torch(cfg, run["params"])
    cache = convert.cache_to_torch(cfg, run["prefill"][2])
    decode = TS.make_decode(cfg)
    for i, (bt, want) in enumerate(run["decode"]):
        logits, cache = decode(model, cache, to_port(bt), PROMPT + i)
        assert logits.shape == (B, 1, cfg.vocab_size)
        assert_close(logits, want, TOL_BF16, f"{arch} step {i}")
    assert_caches_close(cfg, cache, run["decode_cache"], f"{arch} cache")
