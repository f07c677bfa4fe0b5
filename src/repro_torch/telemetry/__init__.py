"""``repro_torch.telemetry`` — zero-cost-when-disabled tracing + metrics for
the whole stack (kernel plans, serve lifecycles, train steps), plus the
model-vs-measured report that joins planned GEMM decisions with measured
wall-clock (:mod:`repro_torch.telemetry.report`)."""

from repro_torch.telemetry.telemetry import (  # noqa: F401
    SCHEMA_VERSION,
    TRACK_TID_BASE,
    Counter,
    Gauge,
    Recorder,
    Span,
    complete_span,
    counter,
    disable,
    enable,
    enabled,
    event,
    export,
    export_report,
    gauge,
    recorder,
    snapshot,
    span,
)
