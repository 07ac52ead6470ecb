"""Durable JSON-lines job store for the scheduler daemon.

One file, ``<root>/jobs.jsonl``: a header line pinning the schema, then one
record per job (last record for a ``job_id`` wins, so both whole-file
snapshots and appends replay identically).  Every mutation rewrites the file
through a temp file + atomic ``os.replace`` — the same durability idiom as
``core/experience.py`` — and reads apply the same tolerance rules: corrupt
lines are skipped, a missing/mismatched header degrades to an empty store,
and the daemon never crashes on a damaged file.

Crash recovery (:meth:`JobStore.recover`):

* ``QUEUED`` records are replayed as-is.
* ``ADMITTED`` jobs fall back to ``QUEUED`` — admission is re-decided by the
  live queue against current capacity, never trusted across a crash.
* ``RUNNING`` jobs were orphaned by the dead daemon: re-queued **exactly
  once** (``requeues`` counter); a job orphaned a second time is marked
  ``FAILED`` instead of looping forever.
* Terminal states (``DONE``/``FAILED``/``REJECTED``) are untouched.

A copy of the JAX package's ``service/store.py`` (plain Python), kept in
step with it: ``jobs.jsonl`` has the same format, so a store either
package writes reads the same in the other.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Any, Dict, List, Optional, Tuple

from .jobspec import JobSpec, JobState

STORE_SCHEMA_VERSION = 1


@dataclasses.dataclass
class JobRecord:
    """One job's durable state: the spec plus lifecycle bookkeeping."""

    spec: JobSpec
    state: JobState = JobState.QUEUED
    submitted_at: float = 0.0
    updated_at: float = 0.0
    admitted_at: Optional[float] = None
    started_at: Optional[float] = None
    finished_at: Optional[float] = None
    predicted_peak_bytes: int = 0
    predicted_source: str = ""
    measured_peak_bytes: int = 0
    requeues: int = 0
    error: Optional[str] = None

    @property
    def job_id(self) -> str:
        return self.spec.job_id

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["spec"] = self.spec.to_dict()
        d["state"] = self.state.value
        d["kind"] = "job"
        return d

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "JobRecord":
        spec = JobSpec.from_dict(data["spec"])
        state = JobState(data["state"])
        known = {f.name for f in dataclasses.fields(cls)} - {"spec", "state"}
        kwargs = {k: v for k, v in data.items() if k in known}
        return cls(spec=spec, state=state, **kwargs)


class JobStore:
    """Durable, tolerant job store.  Thread-safe within one process."""

    SCHEMA = STORE_SCHEMA_VERSION

    def __init__(self, root: str):
        self.root = root
        self.path = os.path.join(root, "jobs.jsonl")
        self._lock = threading.RLock()
        self._tmp_serial = 0
        self._records: Dict[str, JobRecord] = self._load()

    # -- persistence ---------------------------------------------------------

    def _load(self) -> Dict[str, JobRecord]:
        try:
            with open(self.path, "r", encoding="utf-8") as f:
                lines = f.read().splitlines()
        except OSError:
            return {}
        parsed: List[Dict[str, Any]] = []
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except (ValueError, TypeError):
                continue
            if isinstance(rec, dict):
                parsed.append(rec)
        if not parsed:
            return {}
        header = parsed[0]
        if header.get("kind") != "header" or header.get("schema") != self.SCHEMA:
            return {}
        records: Dict[str, JobRecord] = {}
        for rec in parsed[1:]:
            if rec.get("kind") != "job":
                continue
            try:
                jr = JobRecord.from_dict(rec)
            except (ValueError, KeyError, TypeError):
                continue  # skip-not-crash: one bad record loses one job, not all
            records[jr.job_id] = jr
        return records

    def _flush_locked(self) -> None:
        os.makedirs(self.root, exist_ok=True)
        self._tmp_serial += 1
        tmp = (f"{self.path}.tmp.{os.getpid()}."
               f"{threading.get_ident()}.{self._tmp_serial}")
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(json.dumps({"kind": "header", "schema": self.SCHEMA},
                               sort_keys=True) + "\n")
            for jid in sorted(self._records):
                f.write(json.dumps(self._records[jid].to_dict(),
                                   sort_keys=True) + "\n")
        os.replace(tmp, self.path)

    # -- accessors -----------------------------------------------------------

    def get(self, job_id: str) -> Optional[JobRecord]:
        with self._lock:
            return self._records.get(job_id)

    def all(self) -> Dict[str, JobRecord]:
        with self._lock:
            return dict(self._records)

    def by_state(self, *states: JobState) -> List[JobRecord]:
        with self._lock:
            return [r for r in self._records.values() if r.state in states]

    def __contains__(self, job_id: str) -> bool:
        with self._lock:
            return job_id in self._records

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)

    # -- mutation ------------------------------------------------------------

    def put(self, record: JobRecord, now: float = 0.0) -> None:
        """Upsert ``record`` and durably persist the whole store."""
        with self._lock:
            record.updated_at = now
            self._records[record.job_id] = record
            self._flush_locked()

    def transition(self, job_id: str, state: JobState, now: float = 0.0,
                   **updates: Any) -> JobRecord:
        """Move a job to ``state``, stamping the matching timestamp field."""
        with self._lock:
            rec = self._records[job_id]
            rec.state = state
            rec.updated_at = now
            if state is JobState.ADMITTED:
                rec.admitted_at = now
            elif state is JobState.RUNNING:
                rec.started_at = now
            elif state.terminal:
                rec.finished_at = now
            for k, v in updates.items():
                setattr(rec, k, v)
            self._flush_locked()
            return rec

    # -- crash recovery ------------------------------------------------------

    def recover(self, now: float = 0.0) -> Tuple[List[str], List[str], List[str]]:
        """Apply the restart transition rules (see module docstring).

        Returns ``(replayed, requeued_orphans, failed_orphans)`` job-id
        lists: jobs back in QUEUED from QUEUED/ADMITTED, RUNNING orphans
        re-queued (once), and RUNNING orphans that had already burned their
        one re-queue and are now FAILED.
        """
        replayed: List[str] = []
        requeued: List[str] = []
        failed: List[str] = []
        with self._lock:
            for rec in self._records.values():
                if rec.state in (JobState.QUEUED, JobState.ADMITTED):
                    rec.state = JobState.QUEUED
                    rec.admitted_at = None
                    rec.updated_at = now
                    replayed.append(rec.job_id)
                elif rec.state is JobState.RUNNING:
                    if rec.requeues < 1:
                        rec.state = JobState.QUEUED
                        rec.requeues += 1
                        rec.admitted_at = None
                        rec.started_at = None
                        rec.updated_at = now
                        requeued.append(rec.job_id)
                    else:
                        rec.state = JobState.FAILED
                        rec.error = "orphaned while RUNNING after re-queue"
                        rec.finished_at = now
                        rec.updated_at = now
                        failed.append(rec.job_id)
            if replayed or requeued or failed:
                self._flush_locked()
        return replayed, requeued, failed
