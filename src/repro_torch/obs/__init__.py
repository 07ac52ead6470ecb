"""The observability plane: the structured event log, the trace recorder,
the metrics registry and the sim-vs-measured drift monitor.

- :class:`EventLog` -- a bounded ring of INFO/WARN/ERROR events; failure
  paths that must never take a job down emit WARN events here.
- :class:`TraceRecorder` -- a span/instant/counter stream tapped from the
  ``TelemetryHub``, ``MemoryEngine``, ``DmaChannel``, simulator, executor,
  serving and daemon hooks, exported as Chrome Trace Event Format JSON
  (loadable in ``chrome://tracing`` or Perfetto).
- :class:`MetricsRegistry` -- counters, gauges and histograms rendered as
  Prometheus text.
- :class:`DriftMonitor` -- compares predicted peak/EOR/safe-point placement
  against measured values per fingerprint, sets drift gauges, emits WARN
  events past a threshold and persists the history into the
  ``ExperienceStore``.

Every producer hook costs one ``is not None`` check when no recorder is
attached.
"""
from .drift import DriftMonitor, DriftSample
from .events import LEVELS, Event, EventLog
from .metrics import MetricsRegistry, parse_metrics_text
from .trace import (DMA_TID, EVENTS_TID, TRACE_SCHEMA_VERSION, TraceRecorder,
                    format_summary, load_trace, summarize_trace,
                    validate_chrome_trace)

__all__ = ["DMA_TID", "DriftMonitor", "DriftSample", "EVENTS_TID", "Event",
           "EventLog", "LEVELS", "MetricsRegistry", "TRACE_SCHEMA_VERSION",
           "TraceRecorder", "format_summary", "load_trace",
           "parse_metrics_text", "summarize_trace", "validate_chrome_trace"]
