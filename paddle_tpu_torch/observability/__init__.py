"""paddle_tpu_torch.observability — tracing, metrics and logging, copied
from ``paddle_tpu.observability`` with the same metric names, so counters
such as ``serving.decode.steps`` read the same in both packages.

  - `tracing`: thread-safe span recorder -> chrome://tracing JSON
    (`span()`, `trace_export()`), near-zero cost when disabled.
  - `metrics`: always-on counter/gauge/histogram registry with dict
    snapshot + Prometheus text export.
  - `log`: the `paddle_tpu_torch.*` logger tree (PADDLE_TPU_LOG_LEVEL).
"""
from . import metrics, tracing  # noqa: F401
from .log import get_logger  # noqa: F401
from .metrics import (  # noqa: F401
    counter,
    gauge,
    histogram,
    prometheus_text,
    reset_all,
    reset_metrics,
    snapshot,
)
from .tracing import (  # noqa: F401
    span,
    trace_enable,
    trace_disable,
    trace_enabled,
    trace_events,
    trace_export,
    trace_reset,
)
