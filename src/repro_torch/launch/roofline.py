"""Three-term roofline model of a dry-run cell on the H100, PyTorch port of
``repro.launch.roofline``.

Target hardware: one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates):
989 TFLOP/s bf16 on the tensor cores, 3.35 TB/s of HBM3, and NVLink 4 at
900 GB/s a GPU to the other GPUs of its host, 450 GB/s in each direction.

    compute term    = FLOPs_per_device / peak_FLOPs
    memory term     = HBM_bytes_per_device / HBM_bw
    collective term = per-device modeled link bytes / link_bw

plus MODEL_FLOPS = 6·N·D (train) or 2·N·D (fwd-only), N = active params,
and the usefulness ratio MODEL_FLOPS / (FLOPs × devices). The link term
assumes every device reaches its collective peers over NVLink: true within
one 8-GPU HGX node, optimistic for a 16-wide mesh axis, which spans two
nodes and crosses the slower inter-node network. The fields keep the JAX
package's names: ``hlo_*_per_device`` are the per-device counts of the
traced program (``launch.op_cost``), not of an XLA module.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

PEAK_FLOPS = 989e12        # bf16 dense / H100 SXM
HBM_BW = 3.35e12           # bytes/s / H100 SXM (HBM3)
LINK_BW = 450e9            # bytes/s / GPU, one direction of NVLink 4


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops_per_device: float
    hlo_bytes_per_device: float
    collective_bytes_per_chip: float
    model_flops: float                 # semantic flops for the whole step
    memory_per_device: float           # bytes (peak live)

    @property
    def compute_s(self) -> float:
        return self.hlo_flops_per_device / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.hlo_bytes_per_device / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes_per_chip / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline step time = max of the three terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.hlo_flops_per_device * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def mfu(self) -> float:
        """Model FLOPs utilization at the roofline step time."""
        t = self.step_time_s
        if t == 0:
            return 0.0
        return self.model_flops / (t * self.chips * PEAK_FLOPS)

    def row(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "step_s": self.step_time_s,
            "model_flops": self.model_flops,
            "hlo_flops_per_device": self.hlo_flops_per_device,
            "useful_ratio": self.useful_flops_ratio,
            "mfu": self.mfu,
            "mem_gb_per_device": self.memory_per_device / 2**30,
        }


def model_flops(cfg, shape_spec) -> float:
    """Semantic FLOPs: 6·N_active·tokens for train, 2·N_active·tokens for
    prefill, 2·N_active·batch per decode step (+ attention KV read terms are
    memory, not FLOPs)."""
    n = cfg.active_param_count()
    b, s = shape_spec.global_batch, shape_spec.seq_len
    if shape_spec.mode == "train":
        return 6.0 * n * b * s
    if shape_spec.mode == "prefill":
        return 2.0 * n * b * s
    return 2.0 * n * b          # decode: one token per sequence
