"""BlockTable: per-sequence KV-cache blocks as schedulable ledger storages.

The serving plane's memory unit is the *KV block*: ``block_tokens`` worth of
one sequence's cache, named ``kv/<rid>/b<i>`` and registered in the shared
:class:`~repro_torch.core.engine.DeviceLedger` under the serving job's id.
That makes a sequence's cache footprint visible to everything the training
plane already has — per-job accounting, the global peak, OOM counting, the
BudgetArbiter's slices — without a parallel bookkeeping world.

Residency invariants the table maintains:

* bytes are conserved: ``device_bytes(rid) + host_bytes(rid)`` equals the
  total allocated for the sequence across any evict/prefetch interleaving;
* eviction is idempotent per block (ledger keying makes double-free a
  no-op) and every evicted block has exactly one host entry;
* ``release(rid)`` on sequence finish leaks nothing: no ledger residency,
  no host entry, no table row survives it.

All device-byte mutations go through one :class:`JobLedgerView`, so the
cross-job invariants (global peak, capacity OOM events) cannot be bypassed
from the serving side.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

from ..core.engine import EngineTrace, JobLedgerView


class BlockTable:
    """Maps live sequences to their KV-cache blocks in the device ledger."""

    def __init__(self, view: JobLedgerView, bytes_per_token: int,
                 block_tokens: int = 4,
                 trace: Optional[EngineTrace] = None):
        if bytes_per_token <= 0 or block_tokens <= 0:
            raise ValueError("bytes_per_token and block_tokens must be > 0")
        self.view = view
        self.bytes_per_token = int(bytes_per_token)
        self.block_tokens = int(block_tokens)
        self.block_bytes = self.bytes_per_token * self.block_tokens
        self.trace = trace
        # rid -> ordered block storage ids; parallel host-residency set
        self._blocks: Dict[str, List[str]] = {}
        self._tokens: Dict[str, int] = {}
        self._host: set = set()
        # lifetime counters the session's report distills
        self.swapped_out_bytes = 0
        self.swapped_in_bytes = 0

    # -- naming ---------------------------------------------------------

    @staticmethod
    def storage_id(rid: str, i: int) -> str:
        return f"kv/{rid}/b{i}"

    def blocks_of(self, rid: str) -> List[str]:
        return list(self._blocks.get(rid, ()))

    def n_blocks(self, rid: str) -> int:
        return len(self._blocks.get(rid, ()))

    def blocks_for_tokens(self, n_tokens: int) -> int:
        return int(math.ceil(n_tokens / self.block_tokens)) if n_tokens else 0

    def footprint(self, n_tokens: int) -> int:
        """Device bytes a ``n_tokens``-deep cache occupies (whole blocks —
        the page granularity the ledger accounts at)."""
        return self.blocks_for_tokens(n_tokens) * self.block_bytes

    # -- queries --------------------------------------------------------

    def sequences(self) -> List[str]:
        return sorted(self._blocks)

    def device_bytes(self, rid: str) -> int:
        return sum(self.block_bytes for st in self._blocks.get(rid, ())
                   if self.view.ledger.is_resident(self.view.job_id, st))

    def host_bytes(self, rid: str) -> int:
        return sum(self.block_bytes for st in self._blocks.get(rid, ())
                   if st in self._host)

    def total_bytes(self, rid: str) -> int:
        return len(self._blocks.get(rid, ())) * self.block_bytes

    def is_resident(self, rid: str) -> bool:
        """True when every block of ``rid`` is on the device."""
        blocks = self._blocks.get(rid, ())
        led = self.view.ledger
        return all(led.is_resident(self.view.job_id, st) for st in blocks)

    def host_blocks(self, rid: str) -> List[str]:
        return [st for st in self._blocks.get(rid, ()) if st in self._host]

    # -- mutations ------------------------------------------------------

    def grow(self, rid: str, n_tokens: int,
             t: Optional[float] = None) -> List[str]:
        """Ensure ``rid`` owns blocks covering ``n_tokens`` tokens; newly
        created blocks are allocated device-resident.  Returns the new
        block storage ids (empty when the last block still has room)."""
        blocks = self._blocks.setdefault(rid, [])
        self._tokens[rid] = max(self._tokens.get(rid, 0), int(n_tokens))
        need = self.blocks_for_tokens(n_tokens)
        new: List[str] = []
        while len(blocks) < need:
            st = self.storage_id(rid, len(blocks))
            blocks.append(st)
            self.view.alloc(st, self.block_bytes, t)
            new.append(st)
        return new

    def evict(self, rid: str, t: Optional[float] = None) -> int:
        """Swap every device-resident block of ``rid`` out to host.
        Returns the bytes freed on device."""
        freed = 0
        for st in self._blocks.get(rid, ()):
            if not self.view.ledger.is_resident(self.view.job_id, st):
                continue
            if self.trace is not None:
                self.trace.record("swap_out", self.view.job_id, st)
            freed += self.view.free(st, t)
            self._host.add(st)
        self.swapped_out_bytes += freed
        return freed

    def prefetch(self, rid: str, t: Optional[float] = None) -> int:
        """Swap every host-parked block of ``rid`` back in.  Returns the
        bytes restored to device."""
        restored = 0
        for st in self._blocks.get(rid, ()):
            if st not in self._host:
                continue
            if self.trace is not None:
                self.trace.record("swap_in", self.view.job_id, st)
            self.view.alloc(st, self.block_bytes, t)
            self._host.discard(st)
            restored += self.block_bytes
        self.swapped_in_bytes += restored
        return restored

    def evict_many(self, rids: List[str],
                   t: Optional[float] = None) -> int:
        """Swap several sequences out as one cohort (a single coalesced
        channel booking on the caller's side).  Per-block ledger motion
        and trace records are identical to sequential ``evict`` calls in
        rid order — batching changes the transfer *timing*, never the
        residency decisions.  Returns total device bytes freed."""
        return sum(self.evict(rid, t) for rid in rids)

    def prefetch_many(self, rids: List[str],
                      t: Optional[float] = None) -> int:
        """Swap several sequences' host-parked blocks back in as one
        cohort; trace/ledger-identical to sequential ``prefetch`` calls.
        Returns total bytes restored to device."""
        return sum(self.prefetch(rid, t) for rid in rids)

    def release(self, rid: str, t: Optional[float] = None) -> int:
        """Sequence finished: free device blocks, drop host copies, forget
        the row.  Returns the device bytes freed; afterwards no trace of
        ``rid`` remains anywhere (the no-leak invariant)."""
        freed = 0
        for st in self._blocks.pop(rid, ()):
            freed += self.view.free(st, t)
            self._host.discard(st)
            if self.trace is not None:
                self.trace.record("release", self.view.job_id, st)
        self._tokens.pop(rid, None)
        return freed
