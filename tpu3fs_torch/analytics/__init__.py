"""Request tracing spans (``spans``): the port's own copy of
``tpu3fs/analytics/spans.py``. The columnar sink ``trace`` and
``assemble`` are not ported."""

from tpu3fs_torch.analytics.spans import (  # noqa: F401
    SpanEvent,
    TraceConfig,
    TraceContext,
    current_trace,
    root_span,
    tracer,
)
