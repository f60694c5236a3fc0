"""bf16 decode against re-prefill, in the port and in the JAX package, on
the same weights and tokens, where the prefill and the re-prefill take
RWKV's chunked WKV (prompt and prompt + steps both multiples of its
32-token chunk) and the decode its sequential step.

The test holds the port to the JAX package there at ``SMOKE`` size:
decode logits at every step, the re-prefill's logits and the two gaps,
within ``TOL_BF16`` (8 bf16 epsilons, as in ``test_torch_model_forward``),
the JAX steps compiled with per-op rounding as there.

Run as a script, it reads both packages at the architecture's full width
with its depth cut (``--layers``) and prints, for each, the bf16 gap
between the last decode step and the re-prefill, the float32 twins' gap
(weights upcast), and the bf16 noise (bf16 re-prefill against the float32
one); the JAX package both as compiled by default and with per-op
rounding:

    PYTHONPATH=src python tests/test_torch_serve_gap.py --layers 4
"""

import argparse
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config, get_smoke_config
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.models import transformer as TT
from repro_torch.train import steps as TS
from test_torch_model_forward import PER_OP_ROUNDING, TOL_BF16, jax_params


def jax_readings(cfg, params, tokens, p, options):
    """(decode logits [B, steps, V] after prefilling ``p`` tokens, the
    re-prefill's last logits [B, V]), float32 numpy."""
    b, total = tokens.shape
    comp = {} if options is None else options
    toks = jnp.asarray(tokens)

    def prefill(prm, t):
        cache = JT.init_cache(cfg, b, total)
        feats, cache, _ = JT.forward(cfg, prm, {"tokens": t}, mode="prefill",
                                     cache=cache)
        return JT.lm_head(cfg, prm, feats[:, -1:]), cache

    def reprefill(prm, t):
        feats, _ = JT.forward(cfg, prm, {"tokens": t}, mode="train")
        return JT.lm_head(cfg, prm, feats[:, -1:])

    def decode(prm, cache, t, pos):
        return JT.forward(cfg, prm, {"tokens": t}, mode="decode",
                          cache=cache, pos=pos)

    def run(fn, *args):
        return jax.jit(fn).lower(*args).compile(comp)(*args)

    _, cache = run(prefill, params, toks[:, :p])
    steps = []
    step = None
    for i in range(p, total):
        args = (params, cache, toks[:, i:i + 1], jnp.asarray(i, jnp.int32))
        if step is None:
            step = jax.jit(decode).lower(*args).compile(comp)
        logits, cache = step(*args)
        steps.append(np.asarray(logits[:, 0], np.float32))
    want = run(reprefill, params, toks)
    return np.stack(steps, 1), np.asarray(want[:, 0], np.float32)


def port_readings(cfg, model, tokens, p):
    """As ``jax_readings``, through the port on the CPU."""
    b, total = tokens.shape
    toks = torch.from_numpy(tokens)
    decode = TS.make_decode(cfg)
    with torch.no_grad():
        cache = TT.init_cache(cfg, b, total, device="cpu")
        _, cache, _ = TT.forward(cfg, model, {"tokens": toks[:, :p]},
                                 mode="prefill", cache=cache)
        steps = []
        for i in range(p, total):
            logits, cache = decode(model, cache, {"tokens": toks[:, i:i + 1]},
                                   i)
            steps.append(logits[:, 0].float().numpy())
        feats, _ = TT.forward(cfg, model, {"tokens": toks}, mode="train")
        want = TT.lm_head(cfg, model, feats[:, -1:])[:, 0].float().numpy()
    return np.stack(steps, 1), want


def draw(cfg, b, total, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (b, total)).astype(np.int32)


def test_chunked_wkv_bf16_decode_and_reprefill_match_jax():
    cfg = get_smoke_config("rwkv6-1.6b")
    b, p, total = 2, 64, 96                # 64 and 96: multiples of 32
    params = jax_params(cfg)
    tokens = draw(cfg, b, total)
    j_steps, j_want = jax_readings(cfg, params, tokens, p, PER_OP_ROUNDING)
    model = convert.params_to_torch(cfg, jax.tree.map(np.asarray, params))
    t_steps, t_want = port_readings(cfg, model, tokens, p)
    np.testing.assert_allclose(t_want, j_want, rtol=TOL_BF16, atol=TOL_BF16)
    np.testing.assert_allclose(t_steps, j_steps, rtol=TOL_BF16,
                               atol=TOL_BF16)
    j_gap = np.abs(j_steps[:, -1] - j_want).max()
    t_gap = np.abs(t_steps[:, -1] - t_want).max()
    assert abs(t_gap - j_gap) <= 2 * TOL_BF16, (t_gap, j_gap)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="rwkv6-1.6b")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt", type=int, default=64)
    ap.add_argument("--steps", type=int, default=32)
    args = ap.parse_args(argv)
    cfg = dataclasses.replace(get_config(args.arch), num_layers=args.layers)
    tokens = draw(cfg, args.batch, args.prompt + args.steps)
    params = jax_params(cfg)
    p32 = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    out = {"arch": args.arch, "layers": args.layers, "batch": args.batch,
           "prompt": args.prompt, "steps": args.steps}
    runs = {}
    for name, opts in (("jax_default", None), ("jax_per_op", PER_OP_ROUNDING)):
        runs[name] = {prec: jax_readings(cfg, prm, tokens, args.prompt, opts)
                      for prec, prm in (("bf16", params), ("f32", p32))}
    runs["port"] = {}
    for prec, prm in (("bf16", params), ("f32", p32)):
        model = convert.params_to_torch(cfg, jax.tree.map(np.asarray, prm))
        runs["port"][prec] = port_readings(cfg, model, tokens, args.prompt)
        del model
    for name, r in runs.items():
        out[name] = {
            "gap_bf16": float(np.abs(r["bf16"][0][:, -1] - r["bf16"][1]).max()),
            "gap_f32": float(np.abs(r["f32"][0][:, -1] - r["f32"][1]).max()),
            "noise_bf16": float(np.abs(r["bf16"][1] - r["f32"][1]).max()),
            "max_abs_logit_f32": float(np.abs(r["f32"][1]).max()),
            "std_logit_f32": float(r["f32"][1].std())}
    for name in ("jax_default", "jax_per_op"):
        out[f"port_vs_{name}_bf16"] = float(
            np.abs(runs["port"]["bf16"][1] - runs[name]["bf16"][1]).max())
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
