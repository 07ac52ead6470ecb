"""The observability plane: the structured event log.

The JAX package's trace recorder, metrics registry and drift monitor are
not ported yet (ROADMAP queue 1, item 10).
"""
from .events import LEVELS, Event, EventLog

__all__ = ["Event", "EventLog", "LEVELS"]
