"""The port's batched greedy server (``repro_torch.launch.serve``) against
the JAX package's, on the CPU: ``generate``'s tokens for five text
architectures (dense, local/global, MoE, RG-LRU hybrid, RWKV) at their
``SMOKE`` size with the ``ServeRun`` defaults (batch 4, prompt 32, 16 new
tokens), the same bf16 weights carried across, and ``main``'s output.

Both servers run in bf16. The JAX server's steps are compiled with
``xla_allow_excess_precision=False`` here (``jax.jit`` patched for the
test's duration), so that XLA rounds every bf16 operation as written, as
the port does, instead of keeping some fused intermediates in float32 — a
compiler liberty that moves values by bf16 noise and can flip a
near-tied MoE route (``test_torch_model_forward.py``). The logits still
differ by summation order; ``TOL_BF16`` = 8 bf16 epsilons, as there. A
greedy token is determined where the JAX step's top-1/top-2 logit margin
exceeds twice that tolerance: the port's token must equal the JAX token
at every such step. At a step below it either side may break the
near-tie; where the two break it apart, the rows no longer share a
context and that row's comparison ends.
"""

import functools
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.launch import serve as JV
from repro.models import transformer as JT
from repro.train import steps as JS
from repro_torch import convert
from repro_torch.configs import get_smoke_config as port_smoke_config
from repro_torch.launch import serve as TV
from test_torch_model_forward import PER_OP_ROUNDING, TOL_BF16, jax_params

REPO = Path(__file__).resolve().parents[1]


def jax_step_logits(sr, params, gen):
    """The JAX server's logits at each of its greedy steps (prefill's last
    position, then decode steps fed its own tokens), computed as its
    ``generate`` computes them."""
    cfg = sr.cfg
    rng = np.random.default_rng(sr.seed)
    prompts = jnp.asarray(
        rng.integers(0, cfg.vocab_size, (sr.batch, sr.prompt_len)), jnp.int32)
    total = sr.prompt_len + sr.max_new_tokens

    @jax.jit
    def prefill_full(params, tokens):
        cache = JT.init_cache(cfg, sr.batch, total)
        feats, cache, _ = JT.forward(cfg, params, {"tokens": tokens},
                                     mode="prefill", cache=cache)
        return JT.lm_head(cfg, params, feats[:, -1:]), cache

    decode = jax.jit(JS.make_decode(cfg))
    logits, cache = prefill_full(params, prompts)
    out = [np.asarray(logits[:, -1], np.float32)]
    for i in range(sr.max_new_tokens - 1):
        logits, cache = decode(params, cache, {"tokens": gen[:, i:i + 1]},
                               jnp.asarray(sr.prompt_len + i, jnp.int32))
        out.append(np.asarray(logits[:, -1], np.float32))
    return np.stack(out, axis=1)                        # [B, steps, V]


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gemma2-27b",
                                  "mixtral-8x22b", "recurrentgemma-2b",
                                  "rwkv6-1.6b"])
def test_generate_matches_the_jax_server(arch, monkeypatch):
    monkeypatch.setattr(jax, "jit", functools.partial(
        jax.jit, compiler_options=PER_OP_ROUNDING))
    cfg = get_smoke_config(arch)
    params = jax_params(cfg)
    gen, stats = JV.generate(JV.ServeRun(cfg=cfg), params=params)
    want = np.asarray(gen)
    logits = jax_step_logits(JV.ServeRun(cfg=cfg), params, gen)

    tcfg = port_smoke_config(arch)
    model = convert.params_to_torch(tcfg, jax.tree.map(np.asarray, params))
    got, tstats = TV.generate(TV.ServeRun(cfg=tcfg), params=model,
                              device="cpu")
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert set(tstats) == set(stats) == {"prefill_s", "decode_s",
                                         "tokens_per_s"}
    got = got.numpy()

    top2 = -np.sort(-logits, axis=-1)[..., :2]
    margin = top2[..., 0] - top2[..., 1]                 # [B, steps]
    determined = 0
    for b in range(want.shape[0]):
        for i in range(want.shape[1]):
            if margin[b, i] > 2 * TOL_BF16:
                assert got[b, i] == want[b, i], (arch, b, i, margin[b, i])
                determined += 1
            elif got[b, i] != want[b, i]:
                break             # a near-tie broke apart: contexts differ
    # the comparison is not vacuous: most steps are determined
    assert determined >= want.size // 2, (arch, determined)


def test_generate_refuses_frontends():
    cfg = port_smoke_config("musicgen-large")
    with pytest.raises(ValueError, match="text archs"):
        TV.generate(TV.ServeRun(cfg=cfg), device="cpu")


def test_main_prints_the_jax_lines():
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert len(lines) == 2, out.stdout
    assert lines[0].startswith("generated (4, 8): [")
    assert lines[1].startswith("prefill ") and lines[1].endswith(" tok/s")
