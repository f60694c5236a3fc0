"""Multi-device dry-run of the model side, PyTorch port of
``repro.launch.dryrun``.

    python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k \\
        --mesh-shape 2,4 --no-save

Traces every (architecture × input shape × mesh) cell's step — train,
prefill or one decode step — on a mesh of placeholder devices: this process
is rank 0 of a ``"fake"`` process group of the mesh's size
(``launch.mesh.fake_process_group``), whose collectives move nothing, and
every tensor is a ``FakeTensor``, so nothing is allocated on any device and
no card is needed. The weights, optimizer state, cache and batch are
DTensors placed by ``train.sharding``'s specs, with the JAX package's
activation hints, ``grad_specs``, microbatches, per-cell overrides and bf16
moments, so the cells are the JAX dry-run's.

Per device it records the peak live memory (``torch.distributed._tools.
mem_tracker.MemTracker``, the counterpart of ``memory_analysis``; its one
use is :func:`_peak_memory`), the FLOPs and HBM bytes of the eager program
(``launch.op_cost``) and its collectives (``launch.collectives``), and
feeds them to the H100 ``Roofline``. The JAX dry-run's CPU-staging
estimate and "TPU-adjusted" fields have no counterpart: a fake tensor is
staged nowhere. Results go to ``build/dryrun/`` (with ``--no-save``,
nowhere); the exit code is 0 when no cell failed.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs import (ARCH_IDS, SHAPES, get_config, input_specs,
                                 shape_applicable)
from repro_torch.launch import op_cost, roofline
from repro_torch.launch.mesh import (fake_process_group, make_mesh,
                                     make_production_mesh)
from repro_torch.models import transformer as TR
from repro_torch.models.params import tree_map
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.adamw import tree_map as map_leaves
from repro_torch.optim.schedule import cosine_with_warmup
from repro_torch.train import sharding as SH
from repro_torch.train import steps as ST

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"
HBM_PER_DEVICE = 80 * 2 ** 30          # one H100 SXM

# Per-cell microbatch counts (the JAX dry-run's).
MICROBATCHES = {
    ("deepseek-coder-33b", "train_4k"): 4,
    ("gemma2-27b", "train_4k"): 8,
    ("qwen2.5-14b", "train_4k"): 4,
    ("internvl2-26b", "train_4k"): 4,
    ("mixtral-8x22b", "train_4k"): 16,
    ("qwen3-moe-30b-a3b", "train_4k"): 8,
    ("musicgen-large", "train_4k"): 2,
    ("recurrentgemma-2b", "train_4k"): 2,
}

# Archs whose bf16 weights exceed a TP-only serving budget serve with
# FSDP×TP shardings instead (per-layer weight gathers). The JAX package sets
# the budget at 16 chips × ~6 GB of 16 GB each; on 80 GB H100s the same
# share (~37% of a device's memory for weights) is 30 GB × 16.
FSDP_SERVE_BYTES = 30e9 * 16


def _serve_mode(cfg) -> str:
    return "train" if cfg.param_count() * 2 > FSDP_SERVE_BYTES else "serve"


# bf16 Adam moments (masters stay fp32) for the 100B+-scale cells.
MOMENTS_BF16 = {("mixtral-8x22b", "train_4k")}

# Per-cell ModelConfig overrides (the JAX dry-run's).
CELL_OVERRIDES = {
    ("mixtral-8x22b", "train_4k"): lambda mesh: {
        "seq_shard_activations": mesh.size() < 512,
        "attn_kv_chunk": 4096, "attn_q_chunk": 2048,
    },
    ("mixtral-8x22b", "prefill_32k"): {
        "attn_kv_chunk": 4096, "attn_q_chunk": 2048,
    },
    ("deepseek-coder-33b", "train_4k"): {
        "attn_kv_chunk": 4096, "attn_q_chunk": 2048,
    },
    ("qwen3-moe-30b-a3b", "prefill_32k"): {
        "attn_kv_chunk": 4096, "attn_q_chunk": 2048,
    },
    ("deepseek-coder-33b", "prefill_32k"): {
        "attn_kv_chunk": 4096, "attn_q_chunk": 2048,
    },
}


def _apply_overrides(cfg, arch, shape_name, mesh=None):
    ov = CELL_OVERRIDES.get((arch, shape_name))
    if callable(ov):
        ov = ov(mesh)
    if ov:
        cfg = dataclasses.replace(cfg, **ov)
    return cfg


@dataclasses.dataclass(frozen=True)
class _Shard:
    """A DTensor leaf's layout: its shard's shape and dtype, its mesh and
    placements, its global shape and stride."""
    local: tuple
    dtype: torch.dtype
    mesh: object
    placements: tuple
    shape: tuple
    stride: tuple


def _layout(full, specs, mesh):
    """The layout of ``full`` (global stand-ins) placed by ``specs``, taken
    before the memory tracker starts: a shard cut from a stand-in is a view
    of its global storage, which the tracker would count whole."""
    def one(d):
        return _Shard(tuple(d.to_local().shape), d.dtype, d.device_mesh,
                      tuple(d.placements), tuple(d.shape), d.stride())
    return map_leaves(one, SH.to_named(full, specs, mesh))


def _allocate(layout):
    """DTensors of ``layout``, each shard in storage of its own (allocated
    inside the caller's memory tracker)."""
    def one(t):
        if not isinstance(t, _Shard):
            return t
        return DTensor.from_local(torch.empty(t.local, dtype=t.dtype),
                                  t.mesh, t.placements, run_check=False,
                                  shape=t.shape, stride=t.stride)
    return map_leaves(one, layout)


def build_cell(arch: str, shape_name, mesh, *, microbatches=None):
    """Returns (fn, make_args, meta): ``make_args()`` distributes the
    cell's inputs onto ``mesh`` (call it under FakeTensorMode).
    ``shape_name`` names a registry shape, or is a ``ShapeSpec`` of its own
    (another batch); its name picks the per-cell settings."""
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    shape_name = shape.name
    cfg = _apply_overrides(get_config(arch), arch, shape_name, mesh)
    specs = input_specs(cfg, shape)
    da = SH.data_axes_of(mesh)
    hints = TR.ShardingHints(
        data_axes=da, model_axis="model",
        seq_shard=cfg.seq_shard_activations and shape.mode == "train",
    )
    defs = TR.layer_param_defs(cfg)
    meta = {"cfg": cfg, "shape": shape}

    def params(mode):
        layout = _layout(tree_map(lambda _, d: torch.empty(
            d.shape, dtype=d.dtype), defs), SH.param_specs(cfg, mesh, mode),
            mesh)

        def make():
            model = TR.Decoder(cfg, _allocate(layout))
            # MemTracker hooks the weights' gradients, so they must be
            # trainable; the serving steps run under no_grad all the same
            return model.requires_grad_(True)
        return make

    def batch_of(batch_specs, **kw):
        # the input specs' meta tensors as fake ones
        full = {k: torch.empty(v.shape, dtype=v.dtype)
                for k, v in batch_specs.items()}
        layout = _layout(full, SH.batch_specs(cfg, mesh, full, **kw), mesh)
        return lambda: _allocate(layout)

    if shape.mode == "train":
        mb = microbatches or MICROBATCHES.get((arch, shape_name), 1)
        mdt = (torch.bfloat16 if (arch, shape_name) in MOMENTS_BF16
               else torch.float32)
        optim = AdamW(lr=cosine_with_warmup(3e-4, 100, 10_000),
                      moments_dtype=mdt)
        p_sp = SH.param_specs(cfg, mesh, "train")
        step_fn = ST.make_train_step(cfg, optim, microbatches=mb, hints=hints,
                                     grad_specs=p_sp)
        make_params, make_batch = params("train"), batch_of(specs["batch"])

        def make_args():
            model = make_params()
            return (ST.init_train_state(cfg, optim, model), make_batch())
        return step_fn, make_args, dict(meta, microbatches=mb)

    make_params = params(_serve_mode(cfg))
    if shape.mode == "prefill":
        make_batch = batch_of(specs["batch"])
        return (ST.make_prefill(cfg, hints=hints),
                lambda: (make_params(), make_batch()), meta)

    # decode: flash-decoding layout — cache *sequence* shards over model
    # (long_500k: over data+model; batch 1 cannot shard)
    long_ctx = shape_name == "long_500k"
    cache = _layout(TR.init_cache(cfg, shape.global_batch, shape.seq_len,
                                  device="cpu"),
                    SH.cache_specs(cfg, mesh,
                                   seq_shard="all" if long_ctx else "model"),
                    mesh)
    make_batch = batch_of(specs["batch"], shard_batch=not long_ctx)

    def make_args():
        return (make_params(), _allocate(cache), make_batch(),
                shape.seq_len - 1)
    return ST.make_decode(cfg, hints=hints), make_args, meta


def _peak_memory():
    """A memory tracker (``MemTracker``, a private tool of
    ``torch.distributed``): enter it, then read ``peak(tracker)``."""
    from torch.distributed._tools.mem_tracker import MemTracker
    return MemTracker()


def _peak(tracker) -> dict:
    snap = tracker.get_tracker_snapshot("peak")
    dev = next(iter(snap.values()))
    return {str(getattr(k, "value", k)): int(v) for k, v in dev.items()}


def run_cell(arch: str, shape_name, mesh, mesh_name: str,
             *, microbatches=None, save=True, verbose=True):
    """Trace one cell (``shape_name``: a registry name or a ``ShapeSpec``)
    and return its result dict (status "ok", "skipped" or "error")."""
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    shape_name = shape.name
    applicable, why = shape_applicable(arch, shape_name)
    if not applicable:
        result = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                  "status": "skipped", "reason": why}
        if save:
            _save(result)
        return result

    t0 = time.time()
    try:
        from torch._subclasses.fake_tensor import FakeTensorMode

        with FakeTensorMode():
            fn, make_args, meta = build_cell(arch, shape, mesh,
                                             microbatches=microbatches)
            tracker = _peak_memory()
            with op_cost.hidden_meta_propagation(), tracker:
                args = make_args()
                _, cost = op_cost.analyze(fn, *args)
                del args
        t_trace = time.time() - t0
        mem = _peak(tracker)
        chips = mesh.size()
        cfg, shape = meta["cfg"], meta["shape"]
        rl = roofline.Roofline(
            arch=arch, shape=shape_name, mesh=mesh_name, chips=chips,
            hlo_flops_per_device=cost.flops,
            hlo_bytes_per_device=cost.hbm_bytes,
            collective_bytes_per_chip=cost.total_collective_chip_bytes,
            model_flops=roofline.model_flops(cfg, shape),
            memory_per_device=float(mem["Total"]),
        )
        result = {
            "arch": arch, "shape": shape_name, "mesh": mesh_name,
            "status": "ok", "chips": chips, "trace_s": round(t_trace, 1),
            "memory": dict(mem, peak_gb_per_device=mem["Total"] / 2**30,
                           fits_80gb=mem["Total"] < HBM_PER_DEVICE),
            "op_cost": dataclasses.asdict(cost),
            "roofline": rl.row(),
            "microbatches": meta.get("microbatches", 1),
        }
        if verbose:
            print(f"[{arch} × {shape_name} × {mesh_name}] OK "
                  f"trace={t_trace:.0f}s "
                  f"mem={rl.memory_per_device/2**30:.2f}GiB/dev "
                  f"flops/dev={rl.hlo_flops_per_device:.3e} "
                  f"bottleneck={rl.bottleneck} "
                  f"terms(c/m/n)=({rl.compute_s:.4f},{rl.memory_s:.4f},"
                  f"{rl.collective_s:.4f})s "
                  f"useful={rl.useful_flops_ratio:.2f}",
                  flush=True)
            print("  peak memory by kind:", mem)
            print("  collectives:", {k: v for k, v in
                                     cost.collective_counts.items() if v},
                  flush=True)
    except Exception as e:  # noqa: BLE001 — a cell failure is a finding
        result = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                  "status": "error", "error": f"{type(e).__name__}: {e}",
                  "traceback": traceback.format_exc()[-4000:]}
        if verbose:
            print(f"[{arch} × {shape_name} × {mesh_name}] FAILED: {e}",
                  flush=True)
    if save:
        _save(result)
    return result


def _save(result):
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    name = f"{result['arch']}__{result['shape']}__{result['mesh']}.json"
    (RESULTS_DIR / name).write_text(json.dumps(result, indent=2))


def _meshes(args):
    """(shape, axes, name) of each mesh the arguments ask for."""
    if args.mesh_shape:
        dims = tuple(int(x) for x in args.mesh_shape.split(","))
        return [(dims, ("pod", "data", "model")[-len(dims):],
                 f"mesh{args.mesh_shape}")]
    out = []
    if args.mesh in ("single", "both"):
        out.append(((16, 16), None, "pod16x16"))
    if args.mesh in ("multi", "both"):
        out.append(((2, 16, 16), None, "pod2x16x16"))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape name or 'all'")
    ap.add_argument("--mesh", default="single",
                    choices=("single", "multi", "both"))
    ap.add_argument("--mesh-shape", default=None,
                    help="override, e.g. '4,4' or '2,4,4' (testing)")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--no-save", action="store_true")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    n_ok = n_skip = n_fail = 0
    for dims, axes, mesh_name in _meshes(args):
        with fake_process_group(int(torch.tensor(dims).prod())):
            mesh = (make_mesh(dims, axes, device_type="cpu") if axes
                    else make_production_mesh(multi_pod=len(dims) == 3,
                                              device_type="cpu"))
            for arch in archs:
                for shape in shapes:
                    r = run_cell(arch, shape, mesh, mesh_name,
                                 microbatches=args.microbatches,
                                 save=not args.no_save)
                    n_ok += r["status"] == "ok"
                    n_skip += r["status"] == "skipped"
                    n_fail += r["status"] == "error"
    print(f"dry-run complete: {n_ok} ok, {n_skip} skipped, {n_fail} failed")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
