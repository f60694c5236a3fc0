"""The port's model configurations, parameter trees and caches against the
JAX package's: every ``CONFIG`` and ``SMOKE`` equal field by field, the
``param_defs`` shapes, logical axes and inits, ``param_count``, the
``init_cache`` layouts and dtypes, and ``input_specs`` over every cell of
``SHAPES × ARCH_IDS``; and the port's own initialisation (deterministic
per seed and path, the JAX package's distributions)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.models import transformer as JT
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.models import params as TP
from repro_torch.models import transformer as TT

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "int32": torch.int32}


def tdtype(jax_dtype):
    return DTYPES[np.dtype(jax_dtype).name]


def test_registry_names_and_shapes():
    assert TC.ARCH_IDS == JC.ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in TC.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JC.SHAPES.items()}
    for arch in JC.ARCH_IDS:
        for shape in JC.SHAPES:
            assert TC.shape_applicable(arch, shape) == \
                JC.shape_applicable(arch, shape)


@pytest.mark.parametrize("arch", JC.ARCH_IDS)
def test_configs_equal_field_by_field(arch):
    for get in ("get_config", "get_smoke_config"):
        got, want = getattr(TC, get)(arch), getattr(JC, get)(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert type(got.moe).__name__ == type(want.moe).__name__
        for prop in ("pattern_len", "num_groups", "tail_pattern",
                     "layer_kinds", "rnn_width", "padded_vocab",
                     "attention_free", "max_cache_layers_window"):
            assert getattr(got, prop) == getattr(want, prop), prop
        assert got.param_count() == want.param_count()
        assert got.active_param_count() == want.active_param_count()


def flat(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flat(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flat(v, f"{path}/{i}")
    else:
        yield path, tree


@pytest.mark.parametrize("arch", JC.ARCH_IDS)
def test_param_defs_and_caches_equal(arch):
    for cfg, tcfg in ((JC.get_config(arch), TC.get_config(arch)),
                      (JC.get_smoke_config(arch), TC.get_smoke_config(arch))):
        want = dict(flat(JT.param_defs(cfg)))
        got = dict(flat(TT.param_defs(tcfg)))
        assert got.keys() == want.keys()
        for k, d in want.items():
            g = got[k]
            assert (g.shape, g.logical, g.init, g.dtype) == \
                (d.shape, d.logical, d.init, tdtype(d.dtype)), k
        # the port's per-layer trees: the JAX layer defs in stack order
        layers = TT.layer_param_defs(tcfg)["layers"]
        assert len(layers) == cfg.num_layers
        for kind, layer in zip(cfg.layer_kinds, layers):
            jl = JT._layer_defs(cfg, kind)
            assert {k: d.shape for k, d in layer.items()} == \
                {k: d.shape for k, d in jl.items()}
    # caches at the smoke size (the full size would allocate gigabytes)
    cfg, tcfg = JC.get_smoke_config(arch), TC.get_smoke_config(arch)
    want = convert._unstack(cfg, JT.init_cache(cfg, 2, 40))
    got = TT.init_cache(tcfg, 2, 40, device="cpu")
    assert len(got) == len(want) == cfg.num_layers
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert tuple(g[k].shape) == w[k].shape, k
            assert g[k].dtype == tdtype(w[k].dtype), k
            np.testing.assert_array_equal(g[k].float().numpy(),
                                          np.asarray(w[k], np.float32))


def test_input_specs_cover_every_cell():
    for arch in JC.ARCH_IDS:
        cfg, tcfg = JC.get_config(arch), TC.get_config(arch)
        for name, shape in JC.SHAPES.items():
            want = JC.input_specs(cfg, shape)
            got = TC.input_specs(tcfg, TC.SHAPES[name])
            wl = dict(flat(want))
            gl = dict(flat(got))
            assert gl.keys() == wl.keys(), (arch, name)
            for k, w in wl.items():
                assert isinstance(w, jax.ShapeDtypeStruct)
                assert gl[k].device.type == "meta"
                assert (tuple(gl[k].shape), gl[k].dtype) == \
                    (w.shape, tdtype(w.dtype)), (arch, name, k)


def test_init_is_deterministic_and_keyed_by_path():
    cfg = TC.get_smoke_config("recurrentgemma-2b")
    a = TT.init_params(cfg, seed=0, device="cpu").tensors()
    b = TT.init_params(cfg, seed=0, device="cpu").tensors()
    c = TT.init_params(cfg, seed=1, device="cpu").tensors()
    for (k, x), (_, y), (_, z) in zip(flat(a), flat(b), flat(c)):
        assert torch.equal(x, y), k
        if x.float().std() > 0:
            assert not torch.equal(x, z), k
    # two leaves of one shape draw differently
    assert not torch.equal(a["layers"][0]["w_x"], a["layers"][0]["w_g"])
    assert not torch.equal(a["layers"][0]["w_x"], a["layers"][1]["w_x"])


def test_init_distributions():
    defs = {
        "fan_in": TP.ParamDef((512, 256), (None, None)),
        "normal": TP.ParamDef((512, 256), (None, None), "normal"),
        "embed": TP.ParamDef((1024, 256), (None, None), "embed"),
        "zeros": TP.ParamDef((7,), (None,), "zeros"),
        "ones": TP.ParamDef((7,), (None,), "ones", torch.float32),
        "lam": TP.ParamDef((4096,), (None,), "rnn_lambda", torch.float32),
    }
    t = TP.init_tree(defs, seed=3, device="cpu")
    assert t["fan_in"].dtype == torch.bfloat16
    assert abs(t["fan_in"].float().std() - 512 ** -0.5) < 0.002
    assert abs(t["normal"].float().std() - 1.0) < 0.01
    assert abs(t["embed"].float().std() - 256 ** -0.5) < 0.002
    assert not t["zeros"].any() and bool((t["ones"] == 1).all())
    a = torch.sigmoid(t["lam"]) ** 8           # a = σ(Λ)^c lands in [0.9, 0.999]
    assert a.min() >= 0.9 - 1e-5 and a.max() <= 0.999 + 1e-5
    shapes = TP.tree_shapes(defs)
    assert shapes["embed"].device.type == "meta"
    assert tuple(shapes["embed"].shape) == (1024, 256)
