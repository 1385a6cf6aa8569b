"""Metric recorders (``recorder``), the flight recorder (``flight``), the
process-memory gauges (``memory``) and the collector push sinks
(``collector``): the port's own copies of those modules of
``tpu3fs/monitor/``. ``agg``, ``slo`` and the collector service wait
(ROADMAP M6a-2b)."""
