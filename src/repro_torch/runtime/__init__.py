"""Serving runtime: continuous-batching engine (on one card or over a
mesh), observability, failover and restart, and the online autoscaler."""
from repro_torch.runtime.autoscale import (
    AutoscaleConfig,
    AutoscalePolicy,
    Autoscaler,
    ServePoint,
    ServeSpace,
    measured_accept_rate,
)
from repro_torch.runtime.compression import (
    compress_with_feedback,
    compressed_psum,
    dequantize,
    init_error_buffer,
    quantize,
)
from repro_torch.runtime.fault_tolerance import (
    ExecutorSupervisor,
    FailurePlan,
    SimulatedFailure,
    StragglerMonitor,
    TrainRunner,
    elastic_reshard,
)
from repro_torch.runtime.observability import (
    EventStream,
    Histogram,
    MetricsRegistry,
    Observability,
    TraceRecorder,
)
from repro_torch.runtime.serving import (
    EngineSnapshot,
    LocalExecutor,
    MeshExecutor,
    Request,
    ServingEngine,
    SLOPolicy,
    poisson_trace,
)
from repro_torch.runtime.speculative import SpecConfig, SpecTelemetry

__all__ = [
    "AutoscaleConfig",
    "AutoscalePolicy",
    "Autoscaler",
    "ServePoint",
    "ServeSpace",
    "measured_accept_rate",
    "EngineSnapshot",
    "EventStream",
    "Histogram",
    "MetricsRegistry",
    "Observability",
    "TraceRecorder",
    "ExecutorSupervisor",
    "LocalExecutor",
    "MeshExecutor",
    "Request",
    "ServingEngine",
    "SLOPolicy",
    "SpecConfig",
    "SpecTelemetry",
    "poisson_trace",
    "compress_with_feedback",
    "compressed_psum",
    "elastic_reshard",
    "dequantize",
    "init_error_buffer",
    "quantize",
    "FailurePlan",
    "SimulatedFailure",
    "StragglerMonitor",
    "TrainRunner",
]
