"""The port's optimizer side (``repro_torch.optim``: schedules, AdamW,
top-k compression) and its synthetic data pipeline (``repro_torch.data``:
``synth_block``, ``batch_for_step``) against the JAX package's, on the CPU.

Every input is drawn with numpy from a seed and handed to both packages.

- Schedules: every step 0…total, rtol 1e-6 (float32 arithmetic in the same
  order; ``cos`` may differ by an ulp between the two libraries).
- AdamW: three steps from one carried state (nonzero step, masters and
  moments) with the same gradients on both sides. float32 leaves at atol =
  rtol = 1e-6: both packages compute the same float32 expressions and may
  differ by an ulp (the global norm sums the leaves in another order).
  bf16 leaves (bf16 params, ``moments_dtype`` bf16) at one bf16 epsilon
  relative: an ulp of float32 difference can round to the neighbouring
  bf16 value.
- Compression and data: exact (indices and selections, token draws,
  bf16 bit patterns).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as JD
from repro.optim import AdamW as JAdamW
from repro.optim import AdamWState as JAdamWState
from repro.optim import compression as JC
from repro.optim import constant as jconstant
from repro.optim import cosine_with_warmup as jcosine
from repro_torch.data import DataConfig, batch_for_step, synth_block
from repro_torch.optim import AdamW, AdamWState, compression, constant
from repro_torch.optim import cosine_with_warmup
from repro_torch.optim.adamw import tree_leaves, tree_map

BF16_EPS = 2.0 ** -7
SCHEDULES = [(3e-4, 20, 100, 0.1), (1e-3, 0, 30, 0.1), (1e-2, 10, 10, 0.0),
             (5e-4, 7, 250, 0.25)]


@pytest.mark.parametrize("peak,warmup,total,floor", SCHEDULES)
def test_cosine_with_warmup_matches(peak, warmup, total, floor):
    steps = np.arange(0, total + 6, dtype=np.int32)
    want = np.asarray(jax.vmap(jcosine(peak, warmup, total, floor))(
        jnp.asarray(steps)))
    fn = cosine_with_warmup(peak, warmup, total, floor)
    got = np.array([fn(torch.tensor(s, dtype=torch.int32)).item()
                    for s in steps], np.float32)
    assert fn(torch.tensor(3, dtype=torch.int32)).dtype == torch.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("value", [0.0, 3e-4, 1.0])
def test_constant_matches(value):
    got = constant(value)(torch.tensor(5, dtype=torch.int32))
    want = jconstant(value)(jnp.asarray(5, jnp.int32))
    assert got.dtype == torch.float32 and got.shape == ()
    assert got.item() == float(want)


SHAPES = {"embed": (12, 8), "final_norm": (8,),
          "layers": [{"wq": (8, 16), "ln": (8,)}, {"wq": (8, 16), "ln": (8,)}]}


def draw(rng, shapes, scale=1.0, positive=False):
    def one(shape):
        a = rng.normal(size=shape) * scale
        return (np.abs(a) if positive else a).astype(np.float32)

    if isinstance(shapes, dict):
        return {k: draw(rng, v, scale, positive) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [draw(rng, v, scale, positive) for v in shapes]
    return one(shapes)


def jtree(tree, dtype=None):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def ttree(tree, dtype=torch.float32):
    return tree_map(lambda a: torch.from_numpy(np.asarray(a)).to(dtype), tree)


def close(got, want, tol, what):
    """Leaf by leaf, matched by key and position (JAX orders dict leaves
    by sorted key)."""
    if isinstance(got, dict):
        assert sorted(got) == sorted(want), what
        for k in got:
            close(got[k], want[k], tol, f"{what} {k}")
    elif isinstance(got, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            close(g, w, tol, f"{what} [{i}]")
    else:
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), rtol=tol,
                                   atol=tol, err_msg=what)


@pytest.mark.parametrize("clip", ["active", "inactive"])
@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("params", ["float32", "bfloat16"])
def test_adamw_three_steps_from_a_carried_state(params, moments, clip):
    """The gradients' norm is ~8: ``clip_norm`` 1 scales them, 1e6 does
    not. Parameters cast to the gradients' dtype, so bf16 gradients give
    bf16 params."""
    rng = np.random.default_rng(11)
    pd = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
    jp, tp = pd[params]
    jm, tm = pd[moments]
    kw = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
              clip_norm=1.0 if clip == "active" else 1e6)
    jopt = JAdamW(lr=jcosine(1e-2, 3, 20), moments_dtype=jm, **kw)
    topt = AdamW(lr=cosine_with_warmup(1e-2, 3, 20), moments_dtype=tm, **kw)
    master = draw(rng, SHAPES)
    mu = draw(rng, SHAPES, 0.1)
    nu = draw(rng, SHAPES, 0.01, positive=True)
    js = JAdamWState(step=jnp.asarray(5, jnp.int32), master=jtree(master),
                     mu=jtree(mu, jm), nu=jtree(nu, jm))
    ts = AdamWState(step=torch.tensor(5, dtype=torch.int32),
                    master=ttree(master), mu=ttree(mu, tm), nu=ttree(nu, tm))
    tol_p = 1e-6 if params == "float32" else BF16_EPS
    tol_m = 1e-6 if moments == "float32" else BF16_EPS
    for i in range(3):
        g = draw(rng, SHAPES)
        jparams, js, jmet = jopt.update(jtree(g, jp), js)
        tparams, ts, tmet = topt.update(ttree(g, tp), ts)
        assert int(ts.step) == int(js.step) == 6 + i
        assert all(t.dtype == tp for t in tree_leaves(tparams))
        assert all(t.dtype == tm for t in tree_leaves(ts.mu))
        close(tparams, jparams, tol_p, f"params, step {i}")
        close(ts.master, js.master, 1e-6, f"master, step {i}")
        close(ts.mu, js.mu, tol_m, f"mu, step {i}")
        close(ts.nu, js.nu, tol_m, f"nu, step {i}")
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                       rtol=1e-6)
    if clip == "active":
        assert float(tmet["grad_norm"]) > 4 * kw["clip_norm"]


@pytest.mark.parametrize("params", ["float32", "bfloat16"])
def test_adamw_init_matches(params):
    """Masters are the params in float32, moments zeros, step 0."""
    dt = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}[params]
    p = draw(np.random.default_rng(3), SHAPES)
    js = JAdamW(lr=jconstant(1e-3)).init(jtree(p, dt[0]))
    ts = AdamW(lr=constant(1e-3)).init(ttree(p, dt[1]))
    assert int(ts.step) == 0 and ts.step.dtype == torch.int32
    assert all(t.dtype == torch.float32 for t in tree_leaves(ts.master))
    close(ts.master, js.master, 0, "master")
    close(ts.mu, js.mu, 0, "mu")
    close(ts.nu, js.nu, 0, "nu")


def tied_gradient(rng, shape):
    """Values from a small set of magnitudes with random signs: most
    magnitudes tie, so the top-k order among ties decides the result."""
    mags = rng.integers(1, 6, size=shape).astype(np.float32) / 4
    return mags * rng.choice([-1.0, 1.0], size=shape).astype(np.float32)


@pytest.mark.parametrize("shape,frac", [((1000,), 0.01), ((1000,), 0.05),
                                        ((40, 25), 0.3), ((7, 3, 11), 0.5)])
def test_topk_compress_with_ties_matches(shape, frac):
    rng = np.random.default_rng(7)
    g, err = tied_gradient(rng, shape), tied_gradient(rng, shape) / 2
    jc, jerr = JC.topk_compress(jnp.asarray(g), jnp.asarray(err), frac)
    tc, terr = compression.topk_compress(torch.from_numpy(g),
                                         torch.from_numpy(err), frac)
    np.testing.assert_array_equal(tc.idx.numpy(), np.asarray(jc.idx))
    np.testing.assert_array_equal(tc.vals.numpy(), np.asarray(jc.vals))
    np.testing.assert_array_equal(terr.numpy(), np.asarray(jerr))
    assert tc.shape == tuple(jc.shape) and tc.idx.dtype == torch.int32
    np.testing.assert_array_equal(compression.decompress(tc).numpy(),
                                  np.asarray(JC.decompress(jc)))
    assert compression.compression_ratio(tc) == JC.compression_ratio(jc)


def test_error_feedback_transmits_everything():
    """As the JAX package's test: over 60 rounds compressed sends plus the
    error carry add up to 60 × the gradient."""
    g = torch.from_numpy(np.random.default_rng(0).normal(size=(1000,))
                         .astype(np.float32))
    err, acc = torch.zeros_like(g), torch.zeros_like(g)
    for _ in range(60):
        c, err = compression.topk_compress(g, err, frac=0.05)
        acc = acc + compression.decompress(c)
    np.testing.assert_allclose((acc + err).numpy(), (g * 60).numpy(),
                               rtol=1e-4, atol=1e-4)
    assert compression.compression_ratio(c) == pytest.approx(0.1)


@pytest.mark.parametrize("shard,index", [(0, 0), (3, 17), (1023, 5)])
def test_synth_block_matches(shard, index):
    for cfg in (DataConfig(vocab_size=512, seq_len=64, global_batch=4),
                DataConfig(vocab_size=151936, seq_len=33, global_batch=2,
                           seed=0)):
        jcfg = JD.DataConfig(**vars(cfg))
        got = synth_block(cfg, shard, index)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, JD.synth_block(jcfg, shard, index))


def bits(t):
    if isinstance(t, torch.Tensor):
        t = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        return t.numpy()
    a = np.asarray(t)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("frontend", [None, "audio", "vision"])
@pytest.mark.parametrize("step", [0, 3])
def test_batch_for_step_matches(frontend, step):
    cfg = DataConfig(vocab_size=1000, seq_len=48, global_batch=3, seed=5)
    kw = dict(frontend=frontend, d_model=16, frontend_len=8)
    want = JD.batch_for_step(JD.DataConfig(**vars(cfg)), 2, step, **kw)
    got = batch_for_step(cfg, 2, step, device="cpu", **kw)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == tuple(want[k].shape), k
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k
        np.testing.assert_array_equal(bits(got[k]), bits(want[k]), err_msg=k)
    assert got["loss_mask"].dtype == torch.bfloat16
    if frontend is not None:
        assert got["embeds"].dtype == torch.bfloat16
    assert math.isclose(float(got["loss_mask"].float().mean()), 1.0)
