"""Architecture × shape registry (the 40-cell grid), PyTorch port of
``repro.configs.registry``.

Shapes (assignment):
  train_4k     seq_len=4096   global_batch=256   (training)
  prefill_32k  seq_len=32768  global_batch=32    (inference-prefill)
  decode_32k   seq_len=32768  global_batch=128   (inference-decode)
  long_500k    seq_len=524288 global_batch=1     (long-context-decode)

``long_500k`` requires sub-quadratic attention and is skipped for pure
full-attention archs (DESIGN.md §5): deepseek-coder-33b, qwen3-0.6b,
qwen2.5-14b, qwen3-moe-30b-a3b, musicgen-large, internvl2-26b. It runs for
gemma2-27b (local/global), mixtral-8x22b (SWA ring cache),
recurrentgemma-2b and rwkv6-1.6b (recurrent state).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

import torch

from repro_torch.models.config import ModelConfig

_MODULES = {
    "deepseek-coder-33b": "repro_torch.configs.deepseek_coder_33b",
    "gemma2-27b": "repro_torch.configs.gemma2_27b",
    "qwen3-0.6b": "repro_torch.configs.qwen3_0_6b",
    "qwen2.5-14b": "repro_torch.configs.qwen2_5_14b",
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
    "rwkv6-1.6b": "repro_torch.configs.rwkv6_1_6b",
    "musicgen-large": "repro_torch.configs.musicgen_large",
    "internvl2-26b": "repro_torch.configs.internvl2_26b",
}

ARCH_IDS = tuple(_MODULES)

SUBQUADRATIC = {
    "gemma2-27b",          # local/global alternation
    "mixtral-8x22b",       # SWA ring cache
    "recurrentgemma-2b",   # RG-LRU + local attn
    "rwkv6-1.6b",          # attention-free
}


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    mode: str             # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def get_config(arch: str) -> ModelConfig:
    return importlib.import_module(_MODULES[arch]).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return importlib.import_module(_MODULES[arch]).SMOKE


def shape_applicable(arch: str, shape: str) -> tuple[bool, str]:
    if shape == "long_500k" and arch not in SUBQUADRATIC:
        return False, "pure full attention — 500k context skipped (DESIGN.md §5)"
    return True, ""


def input_specs(cfg: ModelConfig, shape: ShapeSpec):
    """Stand-ins for every model input of this cell: tensors on the
    ``meta`` device (shape and dtype, no storage), where the JAX package
    returns ``ShapeDtypeStruct``s. Real data loaders must produce
    matching concrete tensors."""
    b, s = shape.global_batch, shape.seq_len
    f = cfg.frontend_len if cfg.frontend == "vision" else 0
    i32 = torch.int32

    def sds(shp, dt):
        return torch.empty(shp, dtype=dt, device="meta")

    if shape.mode == "decode":
        if cfg.frontend == "audio":
            batch = {"embeds": sds((b, 1, cfg.d_model), torch.bfloat16)}
        else:
            batch = {"tokens": sds((b, 1), i32)}
        return {"batch": batch, "pos": sds((), i32)}

    batch = {}
    if cfg.frontend == "audio":
        batch["embeds"] = sds((b, s, cfg.d_model), torch.bfloat16)
    elif cfg.frontend == "vision":
        batch["embeds"] = sds((b, f, cfg.d_model), torch.bfloat16)
        batch["tokens"] = sds((b, s - f), i32)
    else:
        batch["tokens"] = sds((b, s), i32)
    if shape.mode == "train":
        batch["labels"] = sds((b, s), i32)
        batch["loss_mask"] = sds((b, s), torch.bfloat16)
    return {"batch": batch}
