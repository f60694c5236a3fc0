"""Architecture registry: exact published configs + reduced smoke variants
(PyTorch port of ``repro.configs``; every ``CONFIG`` and ``SMOKE`` equals
the JAX package's field by field)."""

from repro_torch.configs.registry import (
    ARCH_IDS,
    SHAPES,
    get_config,
    get_smoke_config,
    input_specs,
    shape_applicable,
)

__all__ = [
    "ARCH_IDS",
    "SHAPES",
    "get_config",
    "get_smoke_config",
    "input_specs",
    "shape_applicable",
]
