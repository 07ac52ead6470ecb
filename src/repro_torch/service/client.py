"""Client side of the scheduler service: filesystem-inbox submission.

``ServiceClient`` lives in a *different* process from the daemon and shares
only the service root directory.  Submission is an atomic rename into
``<root>/inbox/`` (write ``<name>.json.tmp.<pid>``, ``os.replace`` to
``<name>.json``) so the daemon never observes a half-written spec; status
reads the durable job store read-only through the same tolerant parser the
daemon uses.

A copy of the JAX package's ``service/client.py`` (plain Python): a client
of either package submits to a daemon of the other.
"""

from __future__ import annotations

import json
import os
import time as _time
from typing import Dict, List, Optional

from .daemon import CONTROL_PREFIX, HEARTBEAT_FILE, INBOX_DIR
from .jobspec import JobSpec
from .store import JobRecord, JobStore


class ServiceClient:
    def __init__(self, root: str):
        self.root = root
        self.inbox = os.path.join(root, INBOX_DIR)

    # -- submission ----------------------------------------------------------

    def _drop(self, name: str, data: dict) -> None:
        os.makedirs(self.inbox, exist_ok=True)
        final = os.path.join(self.inbox, name + ".json")
        tmp = f"{final}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(data, f, sort_keys=True)
        os.replace(tmp, final)

    def submit(self, spec: JobSpec) -> str:
        """Drop a spec into the daemon's inbox; returns the job_id."""
        if spec.payload is not None:
            raise ValueError(
                "a JobSpec with an in-process payload cannot cross the "
                "inbox — submit a workload reference instead")
        if not spec.workload and spec.kind != "serve":
            # serve specs may omit the workload — resolution falls back to
            # the builtin "lm" serve factory on the daemon side
            raise ValueError("wire submission requires spec.workload")
        self._drop(spec.job_id, spec.to_dict())
        return spec.job_id

    def drain(self) -> None:
        """Ask the daemon to finish queued work and exit its loop."""
        self._drop(f"{CONTROL_PREFIX}drain-{os.getpid()}-{_time.time_ns()}",
                   {"control": "drain"})

    # -- status --------------------------------------------------------------

    def _store(self) -> JobStore:
        return JobStore(self.root)  # re-reads the file; tolerant parser

    def status(self, job_id: Optional[str] = None
               ) -> Dict[str, JobRecord]:
        records = self._store().all()
        if job_id is not None:
            records = {k: v for k, v in records.items() if k == job_id}
        return records

    def states(self) -> Dict[str, str]:
        return {jid: rec.state.value
                for jid, rec in self._store().all().items()}

    def heartbeat(self) -> Optional[dict]:
        try:
            with open(os.path.join(self.root, HEARTBEAT_FILE),
                      "r", encoding="utf-8") as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def daemon_alive(self, stale_after: float = 5.0) -> bool:
        hb = self.heartbeat()
        if hb is None or hb.get("state") == "stopped":
            return False
        return (_time.time() - float(hb.get("updated_at", 0.0))) < stale_after

    # -- blocking helpers ----------------------------------------------------

    def wait(self, job_ids: Optional[List[str]] = None,
             timeout: float = 300.0, poll: float = 0.1
             ) -> Dict[str, JobRecord]:
        """Block until the given jobs (default: all known) are terminal.
        Returns their records; raises TimeoutError when time runs out."""
        deadline = _time.time() + timeout
        while True:
            records = self._store().all()
            targets = {jid: rec for jid, rec in records.items()
                       if job_ids is None or jid in job_ids}
            missing = set(job_ids or []) - set(targets)
            if not missing and targets \
                    and all(r.state.terminal for r in targets.values()):
                return targets
            if _time.time() >= deadline:
                raise TimeoutError(
                    f"jobs not terminal after {timeout}s: "
                    f"{sorted(missing) or [j for j, r in targets.items() if not r.state.terminal]}")
            _time.sleep(poll)
