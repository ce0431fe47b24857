from repro_torch.serving.engine import SEEN_SHAPES, Request, ServeEngine
from repro_torch.serving.fleet import (
    AdmissionControl,
    BatchedProbe,
    ClassifierEngine,
    EvalRequest,
    FleetNode,
    FleetReport,
    HotReloader,
    ServingFleet,
)
from repro_torch.serving.loadgen import LoadGenConfig, LoadGenerator

__all__ = [
    "SEEN_SHAPES",
    "Request",
    "ServeEngine",
    "AdmissionControl",
    "BatchedProbe",
    "ClassifierEngine",
    "EvalRequest",
    "FleetNode",
    "FleetReport",
    "HotReloader",
    "ServingFleet",
    "LoadGenConfig",
    "LoadGenerator",
]
