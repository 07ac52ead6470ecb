"""The job-submission surface: a frozen, serializable ``JobSpec``.

A copy of the JAX package's ``service/jobspec.py`` (plain Python), the one
wire format of ``GlobalController.submit(spec)``.  A spec names *what* to
run (a workload reference resolvable by ``service.workloads``, or an
in-process payload), *how much* (iterations), and the admission hints
(priority, budget hint, fingerprint).  It carries no live tensors on the
wire: ``payload`` is an in-process escape hatch excluded from
serialization.

Lifecycle states live here too, so every part of a service shares one
vocabulary.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, Optional, Tuple

# Wire-format schema version.  Bump on breaking field changes; readers treat a
# mismatched schema as absent (the skip-not-crash tolerance rule).
# Schema 2 added `kind` + `serve` (the serving plane); schema-1 specs are
# still readable — they default to kind="train".
SPEC_SCHEMA_VERSION = 2
_READABLE_SCHEMAS = (1, 2)


class JobState(str, enum.Enum):
    """Lifecycle of a job inside the scheduler service.

    QUEUED -> ADMITTED -> RUNNING -> DONE | FAILED
                   \\-> (REJECTED when it can never fit)
    """

    QUEUED = "QUEUED"
    ADMITTED = "ADMITTED"
    RUNNING = "RUNNING"
    DONE = "DONE"
    FAILED = "FAILED"
    REJECTED = "REJECTED"

    @property
    def terminal(self) -> bool:
        return self in (JobState.DONE, JobState.FAILED, JobState.REJECTED)


@dataclasses.dataclass(frozen=True)
class ServeParams:
    """Wire description of a serving job's workload shape.

    ``arch`` names the model config; ``trace`` names a deterministic
    request-arrival generator (``serving.traces.make_trace``) so the
    request mix crosses the wire as a recipe, not a request list.
    """

    arch: str = "tinyllama-1.1b"
    max_sequences: int = 4
    n_requests: int = 8
    prompt_len: int = 8
    gen_len: int = 8
    trace: str = "steady"
    mean_gap: float = 0.002
    block_tokens: int = 4
    seed: int = 0

    def __post_init__(self) -> None:
        for field in ("max_sequences", "n_requests", "prompt_len",
                      "gen_len", "block_tokens"):
            if getattr(self, field) < 1:
                raise ValueError(f"ServeParams.{field} must be >= 1")

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "ServeParams":
        if not isinstance(data, dict):
            raise ValueError("ServeParams wire form must be a JSON object")
        known = {f.name for f in dataclasses.fields(cls)}
        try:
            return cls(**{k: v for k, v in data.items() if k in known})
        except TypeError as exc:
            raise ValueError(f"malformed ServeParams: {exc}") from exc


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """Frozen, serializable description of one schedulable job.

    Fields
    ------
    job_id:
        Unique id; also the idempotency key at the daemon inbox (a duplicate
        submission of a known non-terminal job_id is ignored).
    kind:
        ``"train"`` (the default) or ``"serve"`` —
        a continuous-batching decode job whose KV-cache blocks are the
        schedulable tensors.  Serve jobs resolve their workload through
        :func:`service.workloads.resolve_serve_workload` and carry
        their shape in ``serve``.
    serve:
        :class:`ServeParams` for ``kind="serve"`` jobs (auto-filled with
        defaults when omitted); must be None for train jobs.
    workload:
        Reference the daemon can resolve to ``(step_fn, params, opt_state,
        batch)``: either a name registered via
        :func:`service.workloads.register_workload` (e.g. ``"mlp"``) or
        a ``"module:attr"`` import path to a zero-side-effect factory.
    workload_params:
        Keyword arguments forwarded to the workload factory (sizes, batch,
        seed ...).  Must be JSON-serializable.
    priority:
        Arbiter share weight.  ``None`` defers to the scheduler config
        (``SchedulerConfig.job_priorities`` or 1.0), matching the semantics
        of the deprecated ``launch(..., priority=None)``.
    iterations:
        Training iterations to run once admitted.
    budget_hint_bytes:
        Optional caller-supplied upper bound on peak memory; used by
        admission when no experience fingerprint matches.
    offset_frac:
        Arrival offset in mean-iteration units — used by the scenario suite's
        virtual-time replays; the live daemon ignores it (arrival is when the
        inbox file lands).
    fingerprint:
        Optional precomputed structural fingerprint (``ExperienceStore``
        key).  Normally the controller computes it from the captured
        sequence; a client that already knows it can pin it here.
    schedule:
        When False the job runs unscheduled (vanilla baseline) — used by
        benchmarks.
    payload:
        In-process only: a ``(step_fn, params, opt_state, batch)`` tuple that
        bypasses workload resolution.  Excluded from ``to_dict``; a spec that
        crossed the wire never has one.
    """

    job_id: str
    kind: str = "train"
    serve: Optional[ServeParams] = None
    workload: Optional[str] = None
    workload_params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    priority: Optional[float] = None
    iterations: int = 1
    budget_hint_bytes: Optional[int] = None
    offset_frac: float = 0.0
    fingerprint: Optional[str] = None
    schedule: bool = True
    payload: Optional[Tuple[Any, ...]] = dataclasses.field(
        default=None, repr=False, compare=False
    )

    def __post_init__(self) -> None:
        if not self.job_id or not isinstance(self.job_id, str):
            raise ValueError("JobSpec.job_id must be a non-empty string")
        if self.kind not in ("train", "serve"):
            raise ValueError(
                f"JobSpec.kind must be 'train' or 'serve', got {self.kind!r}")
        if isinstance(self.serve, dict):  # wire form straight off JSON
            object.__setattr__(self, "serve", ServeParams.from_dict(self.serve))
        if self.kind == "serve" and self.serve is None:
            object.__setattr__(self, "serve", ServeParams())
        if self.kind == "train" and self.serve is not None:
            raise ValueError("JobSpec.serve is only valid with kind='serve'")
        if self.iterations < 1:
            raise ValueError(f"JobSpec.iterations must be >= 1, got {self.iterations}")
        if self.priority is not None and self.priority <= 0:
            raise ValueError(f"JobSpec.priority must be > 0, got {self.priority}")
        if self.budget_hint_bytes is not None and self.budget_hint_bytes <= 0:
            raise ValueError("JobSpec.budget_hint_bytes must be > 0 when given")
        if self.payload is not None and len(self.payload) != 4:
            raise ValueError(
                "JobSpec.payload must be (step_fn, params, opt_state, batch)"
            )

    # -- wire format ---------------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        """JSON-safe wire form.  ``payload`` never crosses the wire."""
        return {
            "schema": SPEC_SCHEMA_VERSION,
            "job_id": self.job_id,
            "kind": self.kind,
            "serve": self.serve.to_dict() if self.serve else None,
            "workload": self.workload,
            "workload_params": dict(self.workload_params),
            "priority": self.priority,
            "iterations": self.iterations,
            "budget_hint_bytes": self.budget_hint_bytes,
            "offset_frac": self.offset_frac,
            "fingerprint": self.fingerprint,
            "schedule": self.schedule,
        }

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "JobSpec":
        """Inverse of :meth:`to_dict`.

        Unknown keys are ignored (forward compatibility); a schema mismatch
        or a malformed field raises ``ValueError`` so callers can apply the
        skip-not-crash tolerance rule.
        """
        if not isinstance(data, dict):
            raise ValueError("JobSpec wire form must be a JSON object")
        schema = data.get("schema", SPEC_SCHEMA_VERSION)
        if schema not in _READABLE_SCHEMAS:
            raise ValueError(f"unsupported JobSpec schema {schema!r}")
        known = {f.name for f in dataclasses.fields(cls)} - {"payload"}
        kwargs = {k: v for k, v in data.items() if k in known}
        try:
            return cls(**kwargs)
        except TypeError as exc:  # e.g. job_id missing entirely
            raise ValueError(f"malformed JobSpec: {exc}") from exc
