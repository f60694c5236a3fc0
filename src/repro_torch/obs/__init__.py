"""Observability, PyTorch counterpart of ``repro.obs``: per-round telemetry
channels, delta provenance, convergence anomaly detection, trace export and
profiling labels.

``obs.telemetry`` computes the opt-in channels beside the round loop
(``simulate(..., telemetry=TelemetrySpec())``); ``obs.provenance`` the
per-element lineage record (``simulate(..., provenance=ProvenanceSpec())``);
``obs.anomaly`` the host-side stall detector over divergence-gap channels;
``obs.trace`` renders runs as Chrome-trace/Perfetto JSON and JSONL event
logs, and ``annotate`` labels regions in ``torch.profiler`` traces.
"""

from repro_torch.obs.anomaly import (FAULT_STALL, NON_CONVERGENCE,
                                     StallEvent, detect_stalls)
from repro_torch.obs.provenance import (ProvChannels, ProvenanceCarry,
                                        ProvenanceResult, ProvenanceSpec)
from repro_torch.obs.telemetry import (TelemetryCarry, TelemetryChannels,
                                       TelemetryResult, TelemetrySpec)
from repro_torch.obs.trace import TraceLog, annotate

__all__ = [
    "FAULT_STALL",
    "NON_CONVERGENCE",
    "ProvChannels",
    "ProvenanceCarry",
    "ProvenanceResult",
    "ProvenanceSpec",
    "StallEvent",
    "TelemetryCarry",
    "TelemetryChannels",
    "TelemetryResult",
    "TelemetrySpec",
    "TraceLog",
    "annotate",
    "detect_stalls",
]
