"""The observability plane: the structured event log, the metrics
registry and the sim-vs-measured drift monitor.

- :class:`EventLog` -- a bounded ring of INFO/WARN/ERROR events; failure
  paths that must never take a job down emit WARN events here.
- :class:`MetricsRegistry` -- counters, gauges and histograms rendered as
  Prometheus text.
- :class:`DriftMonitor` -- compares predicted peak/EOR/safe-point placement
  against measured values per fingerprint, sets drift gauges, emits WARN
  events past a threshold and persists the history into the
  ``ExperienceStore``.

The JAX package's trace recorder is not ported yet (ROADMAP queue 1,
item 8).
"""
from .drift import DriftMonitor, DriftSample
from .events import LEVELS, Event, EventLog
from .metrics import MetricsRegistry, parse_metrics_text

__all__ = ["DriftMonitor", "DriftSample", "Event", "EventLog", "LEVELS",
           "MetricsRegistry", "parse_metrics_text"]
