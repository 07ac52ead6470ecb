"""Prometheus-style metrics: in-process registry + text exposition.

A copy of the JAX package's ``obs/metrics.py`` (plain Python).  The drift
monitor (``obs/drift.py``) sets its gauges here; ``write`` atomically
rewrites an exposition file that any scrape-by-file collector
(node_exporter's textfile collector) picks up.  ``parse_metrics_text`` is
the symmetric reader.

Naming convention: every metric is ``tensile_<noun>_<unit>`` (bytes,
seconds, total for counters, ratio for 0..1 gauges); labels identify
the job / state / fingerprint, never the metric meaning.
"""
from __future__ import annotations

import math
import os
import tempfile
import threading
from typing import Dict, Iterable, List, Optional, Tuple

LabelSet = Tuple[Tuple[str, str], ...]

DEFAULT_BUCKETS = (0.005, 0.025, 0.1, 0.5, 2.5, 10.0, 60.0)


def _labels(kw: Dict[str, object]) -> LabelSet:
    return tuple(sorted((k, str(v)) for k, v in kw.items()))


def _fmt_labels(ls: LabelSet, extra: Optional[Tuple[str, str]] = None) -> str:
    items = list(ls) + ([extra] if extra else [])
    if not items:
        return ""
    body = ",".join(f'{k}="{v}"' for k, v in items)
    return "{" + body + "}"


def _fmt_value(v: float) -> str:
    if v != v:
        return "NaN"
    if v in (math.inf, -math.inf):
        return "+Inf" if v > 0 else "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help_text: str = ""):
        self.name = name
        self.help = help_text
        self._lock = threading.Lock()


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name: str, help_text: str = ""):
        super().__init__(name, help_text)
        self._values: Dict[LabelSet, float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        ls = _labels(labels)
        with self._lock:
            self._values[ls] = self._values.get(ls, 0.0) + amount

    def value(self, **labels) -> float:
        return self._values.get(_labels(labels), 0.0)

    def samples(self) -> Iterable[Tuple[str, LabelSet, float]]:
        with self._lock:
            for ls, v in sorted(self._values.items()):
                yield self.name, ls, v


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name: str, help_text: str = ""):
        super().__init__(name, help_text)
        self._values: Dict[LabelSet, float] = {}

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[_labels(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        ls = _labels(labels)
        with self._lock:
            self._values[ls] = self._values.get(ls, 0.0) + amount

    def value(self, **labels) -> float:
        return self._values.get(_labels(labels), 0.0)

    def clear(self) -> None:
        """Drop every label set (per-job gauges on job departure)."""
        with self._lock:
            self._values.clear()

    def samples(self) -> Iterable[Tuple[str, LabelSet, float]]:
        with self._lock:
            for ls, v in sorted(self._values.items()):
                yield self.name, ls, v


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, help_text: str = "",
                 buckets: Tuple[float, ...] = DEFAULT_BUCKETS):
        super().__init__(name, help_text)
        self.buckets = tuple(sorted(buckets))
        self._counts: Dict[LabelSet, List[int]] = {}
        self._sum: Dict[LabelSet, float] = {}
        self._count: Dict[LabelSet, int] = {}

    def observe(self, value: float, **labels) -> None:
        ls = _labels(labels)
        with self._lock:
            counts = self._counts.setdefault(ls, [0] * len(self.buckets))
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
            self._sum[ls] = self._sum.get(ls, 0.0) + value
            self._count[ls] = self._count.get(ls, 0) + 1

    def count(self, **labels) -> int:
        return self._count.get(_labels(labels), 0)

    def sum(self, **labels) -> float:
        return self._sum.get(_labels(labels), 0.0)

    def samples(self) -> Iterable[Tuple[str, LabelSet, float]]:
        with self._lock:
            for ls in sorted(self._count):
                cum = 0
                for i, b in enumerate(self.buckets):
                    cum = self._counts[ls][i]
                    yield (f"{self.name}_bucket",
                           ls + (("le", _fmt_value(b)),), float(cum))
                yield (f"{self.name}_bucket", ls + (("le", "+Inf"),),
                       float(self._count[ls]))
                yield f"{self.name}_sum", ls, self._sum[ls]
                yield f"{self.name}_count", ls, float(self._count[ls])


class MetricsRegistry:
    """Idempotent factory + renderer for a process's metrics."""

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, help_text: str, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help_text, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{m.kind}")
            return m

    def counter(self, name: str, help_text: str = "") -> Counter:
        return self._get(Counter, name, help_text)

    def gauge(self, name: str, help_text: str = "") -> Gauge:
        return self._get(Gauge, name, help_text)

    def histogram(self, name: str, help_text: str = "",
                  buckets: Tuple[float, ...] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help_text, buckets=buckets)

    # -- exposition -----------------------------------------------------
    def render_text(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines: List[str] = []
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        for m in metrics:
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for name, ls, v in m.samples():
                # histogram sample names carry the le label inline
                le = None
                plain = []
                for k, val in ls:
                    if k == "le":
                        le = ("le", val)
                    else:
                        plain.append((k, val))
                lines.append(f"{name}{_fmt_labels(tuple(plain), le)} "
                             f"{_fmt_value(v)}")
        return "\n".join(lines) + "\n"

    def write(self, path: str) -> str:
        """Atomically write the exposition file (heartbeat cadence)."""
        text = self.render_text()
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                f.write(text)
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        return text


def parse_metrics_text(text: str) -> Dict[Tuple[str, LabelSet], float]:
    """Parse Prometheus text exposition back into ``{(name, labels):
    value}``.  Raises ``ValueError`` on a malformed sample line, so it
    doubles as the schema validator for CI artifacts."""
    out: Dict[Tuple[str, LabelSet], float] = {}
    for ln, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        name, labels, rest = line, (), ""
        if "{" in line:
            name, _, tail = line.partition("{")
            body, closed, rest = tail.partition("}")
            if not closed:
                raise ValueError(f"line {ln}: unterminated label set")
            parsed = []
            for item in filter(None, (p.strip()
                                      for p in body.split(","))):
                k, eq, v = item.partition("=")
                if not eq or not (v.startswith('"') and v.endswith('"')):
                    raise ValueError(f"line {ln}: bad label {item!r}")
                parsed.append((k.strip(), v[1:-1]))
            labels = tuple(sorted(parsed))
        else:
            name, _, rest = line.partition(" ")
        name = name.strip()
        if not name or not name.replace("_", "a").replace(":", "a") \
                .isalnum():
            raise ValueError(f"line {ln}: bad metric name {name!r}")
        val = rest.strip().split()[0] if rest.strip() else None
        if val is None:
            raise ValueError(f"line {ln}: missing value")
        try:
            fval = float(val)
        except ValueError as e:
            raise ValueError(f"line {ln}: bad value {val!r}") from e
        out[(name, labels)] = fval
    if not out:
        raise ValueError("no samples found")
    return out
