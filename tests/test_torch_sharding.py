"""The port's sharding specs equal the JAX package's, leaf by leaf, for all
ten architectures, train and serve, on ("data", "model") and
("pod", "data", "model"); placements, hints and the meshes.

The spec builders of both packages take a stand-in with the mesh's axis
names (no devices, no process group). The port's parameter and cache trees
hold one dict a layer where the JAX package stacks a pattern group's
layers: a layer's spec is the JAX ``blocks`` spec without its leading
``stack`` entry, or its ``tail`` spec."""

import dataclasses
import types

import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.configs import ARCH_IDS, SHAPES, get_config
from repro.configs import input_specs as jax_input_specs
from repro.models import params as JP
from repro.models import transformer as JTR
from repro.train import sharding as JSH
from repro_torch.configs import get_config as port_config
from repro_torch.configs import input_specs
from repro_torch.models import params as PP
from repro_torch.models import transformer as TR
from repro_torch.train import sharding as SH

MESHES = {"2d": ("data", "model"), "3d": ("pod", "data", "model")}


def stand_in(axes):
    return types.SimpleNamespace(axis_names=axes, mesh_dim_names=axes)


def flat(tree, path=""):
    """{path: leaf} of a dict/list tree whose leaves are specs."""
    if isinstance(tree, dict):
        return {k: v for name, sub in tree.items()
                for k, v in flat(sub, f"{path}/{name}").items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree)
                for k, v in flat(sub, f"{path}/{i}").items()}
    return {path: tuple(tree)}


def layer_view(cfg, jtree):
    """The JAX blocks/tail tree as the port's one dict a layer."""
    layers = []
    p = cfg.pattern_len
    for i in range(cfg.num_layers):
        if i < cfg.num_groups * p:
            d = jtree["blocks"][i % p]
            layers.append({k: tuple(v)[1:] for k, v in d.items()})
        else:
            layers.append({k: tuple(v) for k, v in
                           jtree["tail"][i - cfg.num_groups * p].items()})
    return layers


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("mode", ["train", "serve"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_the_jax_ones(arch, mode, mesh):
    axes = MESHES[mesh]
    jcfg, cfg = get_config(arch), port_config(arch)
    want = JSH.param_specs(jcfg, stand_in(axes), mode)
    # the JAX layout, leaf for leaf
    rules = SH._resolve_rules(PP.TRAIN_RULES if mode == "train"
                              else PP.SERVE_RULES, stand_in(axes))
    got_jax_layout = PP.tree_specs(TR.param_defs(cfg), rules, axes)
    assert flat(got_jax_layout) == flat(want)
    # the port's layout: one dict a layer
    got = SH.param_specs(cfg, stand_in(axes), mode)
    head = {k: tuple(v) for k, v in want.items()
            if k not in ("blocks", "tail")}
    assert flat(got) == flat(dict(head, layers=layer_view(cfg, want)))
    # the stack axis is never sharded, so dropping it loses nothing
    for d in want["blocks"]:
        assert all(tuple(v)[0] is None for v in d.values())
    # opt state mirrors the params
    jopt, opt = JSH.opt_state_specs(want), SH.opt_state_specs(got)
    assert tuple(opt.step) == tuple(jopt.step) == ()
    assert opt.master is got and opt.mu is got and opt.nu is got


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("seq_shard", ["model", "all"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_the_jax_ones(arch, seq_shard, mesh):
    axes = MESHES[mesh]
    cfg = port_config(arch)
    want = JSH.cache_specs(get_config(arch), stand_in(axes),
                           seq_shard=seq_shard)
    got = SH.cache_specs(cfg, stand_in(axes), seq_shard=seq_shard)
    assert flat(got) == flat(layer_view(cfg, want))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_specs_equal_the_jax_ones(arch, shape, mesh):
    axes = MESHES[mesh]
    jb = jax_input_specs(get_config(arch), SHAPES[shape])["batch"]
    from repro_torch.configs import SHAPES as PSHAPES
    pb = input_specs(port_config(arch), PSHAPES[shape])["batch"]
    for shard in (True, False):
        want = JSH.batch_specs(get_config(arch), stand_in(axes), jb,
                               shard_batch=shard)
        got = SH.batch_specs(port_config(arch), stand_in(axes), pb,
                             shard_batch=shard)
        assert flat(got) == flat(want)
    assert SH.data_axes_of(stand_in(axes)) == JSH.data_axes_of(
        stand_in(axes))


@pytest.mark.parametrize("logical", [
    ("fsdp", "tp"), ("tp", "fsdp"), ("expert", "fsdp", "tp"), (None,),
    ("stack", "fsdp", None), ("fsdp", None)])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_logical_to_spec_equals_the_jax_one(logical, mesh):
    axes = MESHES[mesh]
    for rules, jrules in ((PP.TRAIN_RULES, JP.TRAIN_RULES),
                          (PP.SERVE_RULES, JP.SERVE_RULES)):
        assert rules == jrules
        assert tuple(PP.logical_to_spec(logical, rules, axes)) == \
            tuple(JP.logical_to_spec(logical, jrules, axes))


def test_placements_shard_pod_major():
    mesh = stand_in(("pod", "data", "model"))
    spec = PP.Spec(("pod", "data"), "model")
    assert PP.placements(spec, mesh) == (Shard(0), Shard(0), Shard(1))
    assert PP.placements(PP.Spec(None, None), mesh) == (Replicate(),) * 3
    assert PP.placements(PP.Spec("data", None), mesh) == (
        Replicate(), Shard(0), Replicate())
    with pytest.raises(ValueError, match="order"):
        PP.placements(PP.Spec(("data", "pod")), mesh)
    with pytest.raises(ValueError, match="two dims"):
        PP.placements(PP.Spec("model", "model"), mesh)


def test_spec_is_one_leaf_and_compares_as_its_tuple():
    s = PP.Spec(("pod", "data"), None, "model")
    assert s == (("pod", "data"), None, "model") and len(s) == 3
    assert list(s) == [("pod", "data"), None, "model"] and s[2] == "model"
    assert s == PP.Spec(("pod", "data"), None, "model") != PP.Spec()
    from repro_torch.optim.adamw import tree_leaves
    assert tree_leaves({"a": [s, PP.Spec()]}) == [s, PP.Spec()]


def test_hints_are_the_identity_on_plain_tensors():
    x = torch.randn(2, 8, 4)
    hints = TR.ShardingHints(data_axes="data", model_axis="model",
                             seq_shard=True)
    for h in (hints, TR.NO_HINTS):
        assert h.residual(x) is x and h.batch_only(x) is x
    assert not TR.NO_HINTS.active and hints.active
    assert [f.name for f in dataclasses.fields(TR.ShardingHints)] == \
        [f.name for f in dataclasses.fields(JTR.ShardingHints)]
    with hints.context(), hints.context():     # nests
        pass


def test_meshes_raise_without_a_process_group():
    from repro_torch.launch import mesh as M

    with pytest.raises(RuntimeError, match="no process group"):
        M.make_mesh((2, 2), ("data", "model"), device_type="cpu")
    with pytest.raises(RuntimeError, match="no process group"):
        M.make_production_mesh()
    with pytest.raises(ValueError, match="rank"):
        M.make_mesh((2, 2), ("data",), device_type="cpu")
