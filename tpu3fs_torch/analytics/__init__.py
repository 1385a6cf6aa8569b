"""Request tracing (``spans``), its columnar sink (``trace``) and the
trace assembler (``assemble``): the port's own copies of those modules of
``tpu3fs/analytics/``."""

from tpu3fs_torch.analytics.trace import (  # noqa: F401
    SerdeObjectReader,
    SerdeObjectWriter,
    StructuredTraceLog,
    read_records,
    write_records,
)

from tpu3fs_torch.analytics.spans import (  # noqa: F401
    SpanEvent,
    TraceConfig,
    TraceContext,
    current_trace,
    root_span,
    tracer,
)
