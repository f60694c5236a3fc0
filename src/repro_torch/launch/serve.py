"""Batched server: prefill + decode with a KV cache, PyTorch port of
``repro.launch.serve``.

A static-batch server: prefill a batch of prompts into a cache sized for
prompt plus new tokens, then decode-step all sequences in lockstep,
greedy-sampling until ``max_new_tokens``. Runs on the card unless the
caller passes ``device="cpu"``:

    python -m repro_torch.launch.serve [--device cpu]

runs the ``qwen3-0.6b`` smoke config as the JAX ``main`` does.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.models import transformer as TR
from repro_torch.models.config import ModelConfig
from repro_torch.sync.simulator import resolve_device
from repro_torch.train import steps as ST


@dataclasses.dataclass
class ServeRun:
    cfg: ModelConfig
    batch: int = 4
    prompt_len: int = 32
    max_new_tokens: int = 16
    seed: int = 0


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def generate(sr: ServeRun, params: Optional[TR.Decoder] = None, prompts=None,
             device="cuda"):
    """Returns (generated tokens [B, max_new_tokens] int32 on the device,
    stats dict). ``params`` defaults to weights drawn from ``sr.seed`` on
    ``device``; ``prompts`` ([B, prompt_len] tokens) to draws from a numpy
    generator seeded with ``sr.seed``, as in the JAX package. The stats'
    seconds are host time around a synchronised device."""
    cfg = sr.cfg
    if cfg.frontend is not None:
        raise ValueError("the server covers text archs (frontend "
                         f"{cfg.frontend!r})")
    dev = resolve_device(device)
    if params is None:
        params = TR.init_params(cfg, sr.seed, dev)
    if prompts is None:
        rng = np.random.default_rng(sr.seed)
        prompts = rng.integers(0, cfg.vocab_size, (sr.batch, sr.prompt_len))
    prompts = torch.as_tensor(prompts, dtype=torch.int32, device=dev)

    total_len = sr.prompt_len + sr.max_new_tokens
    decode = ST.make_decode(cfg)

    @torch.no_grad()
    def prefill_full(params, tokens):
        # prefill into a cache sized for the whole generation (positions
        # past the prompt are sentinel-masked until decode writes them)
        cache = TR.init_cache(cfg, sr.batch, total_len, device=dev)
        feats, cache, _ = TR.forward(cfg, params, {"tokens": tokens},
                                     mode="prefill", cache=cache)
        return TR.lm_head(cfg, params, feats[:, -1:]), cache

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill_full(params, prompts)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    out = []
    t0 = time.perf_counter()
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    for i in range(sr.max_new_tokens):
        out.append(tok)
        logits, cache = decode(params, cache, {"tokens": tok},
                               sr.prompt_len + i)
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    _sync(dev)
    t_decode = time.perf_counter() - t0

    gen = torch.cat(out, dim=1)
    stats = {
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "tokens_per_s": sr.batch * sr.max_new_tokens / max(t_decode, 1e-9),
    }
    return gen, stats


def main(argv=None):
    from repro_torch.configs import get_smoke_config

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: the card)")
    args = ap.parse_args(argv)
    cfg = get_smoke_config("qwen3-0.6b")
    sr = ServeRun(cfg=cfg, batch=4, prompt_len=16, max_new_tokens=8)
    gen, stats = generate(sr, device=args.device)
    print(f"generated {tuple(gen.shape)}: {gen.cpu().numpy()[0]}")
    print(f"prefill {stats['prefill_s']:.2f}s, "
          f"decode {stats['tokens_per_s']:.1f} tok/s")


if __name__ == "__main__":
    main()
