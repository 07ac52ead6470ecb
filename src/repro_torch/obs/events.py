"""Structured event log: the WARN-and-above channel of the controller.

A copy of the JAX package's ``obs/events.py`` (plain Python).  Failure paths
that must never take a job down (the controller's ``replan_failures`` and
``preempt_failures``) emit here beside their lists: a bounded ring buffer,
queryable by level and source, forwarded to an attached recorder as
instant events.
"""
from __future__ import annotations

import dataclasses
import threading
import time as _time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional

LEVELS = ("DEBUG", "INFO", "WARN", "ERROR")


@dataclasses.dataclass
class Event:
    t: float
    level: str
    source: str
    message: str
    args: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


class EventLog:
    """Thread-safe bounded event stream.

    ``clock`` defaults to wall time; pass the hub's ``now`` (or a
    virtual clock) so event instants line up with telemetry timestamps
    in an exported trace.
    """

    def __init__(self, maxlen: int = 1024,
                 clock: Optional[Callable[[], float]] = None):
        self._events: Deque[Event] = deque(maxlen=maxlen)
        self._lock = threading.Lock()
        self._clock = clock or _time.time
        self.recorder = None           # optional TraceRecorder forward
        self.dropped = 0

    def attach_recorder(self, recorder) -> None:
        self.recorder = recorder

    def emit(self, level: str, source: str, message: str,
             **args) -> Event:
        assert level in LEVELS, level
        ev = Event(self._clock(), level, source, message, args)
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self.dropped += 1
            self._events.append(ev)
        rec = self.recorder
        if rec is not None:
            # args may carry its own job_id (controller WARNs do) — route
            # it to the recorder's track selector instead of colliding
            # with the keyword
            fwd = {k: v for k, v in args.items() if k != "job_id"}
            rec.instant(f"{level}:{source}", ev.t,
                        job_id=args.get("job_id"), message=message, **fwd)
        return ev

    def warn(self, source: str, message: str, **args) -> Event:
        return self.emit("WARN", source, message, **args)

    def info(self, source: str, message: str, **args) -> Event:
        return self.emit("INFO", source, message, **args)

    def error(self, source: str, message: str, **args) -> Event:
        return self.emit("ERROR", source, message, **args)

    def events(self, level: Optional[str] = None,
               source: Optional[str] = None) -> List[Event]:
        with self._lock:
            evs = list(self._events)
        if level is not None:
            evs = [e for e in evs if e.level == level]
        if source is not None:
            evs = [e for e in evs if e.source == source]
        return evs

    def warnings(self) -> List[Event]:
        """WARN and ERROR events, the "something needs a human" slice."""
        with self._lock:
            return [e for e in self._events if e.level in ("WARN", "ERROR")]

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)
