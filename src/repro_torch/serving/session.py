"""ServeSession: the continuous-batching decode loop, virtual- or real-time.

One loop serves both runtimes (the training plane's sim/executor split,
re-done for serving):

* run it bare and it is the **virtual-time simulator** — KV blocks move
  through the shared ``DeviceLedger``/``DmaChannel`` on a virtual clock,
  producing tokens/sec, TTFT percentiles, OOM counts and an engine trace
  without touching a model;
* hand it :class:`ServeHooks` and every decision additionally drives the
  real :class:`~repro_torch.serving.engine.ServingEngine` — actual prefill,
  cohort decode steps, and physical cache-block copies to host and back.

Because all residency decisions (cohort choice, evictions, fetches,
prefetches) are made *here*, from ledger state the two runtimes share by
construction, the sim and the real engine replay identical decision
traces.  This module is a copy of the JAX package's
``serving/session.py``, so the port makes the same decisions as the
reference for the same inputs.

The loop per tick:

1. arrivals land in the prefill **admission queue**
   (``AdmissionQueue``) — a prefill burst is admitted the way a training
   job is: predicted KV footprint reserved against the serving capacity,
   priority order with greedy backfill;
2. admitted requests take free slots: prefill runs (a compute burst),
   the prompt's blocks are allocated, TTFT is the first token out;
3. :class:`~repro_torch.serving.residency.KvResidencyPass` plans the next
   decode turn against the rolling horizon; the session executes it —
   evictions and fetches serialize on the DMA channel before the turn,
   lookahead prefetches overlap the turn's compute;
4. finished sequences release every block (no leak) and free their slot
   and admission reservation, which can admit waiting prefills.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

from ..core.engine import MemoryEngine
from ..service.queue import AdmissionQueue
from .blocks import BlockTable
from .residency import KvResidencyPass, SeqView
from .traces import Request


@dataclasses.dataclass
class SeqState:
    """One live sequence: a request bound to a batch slot."""

    rid: str
    slot: int
    prompt_len: int
    gen_len: int
    priority: float
    arrival: float
    pos: int = 0              # tokens in the cache
    generated: int = 0
    remaining: int = 0        # generation tokens still wanted
    ready_at: float = 0.0     # earliest turn start (prefetch completion)
    last_served: float = -1.0
    ttft: Optional[float] = None


@dataclasses.dataclass
class ServeHooks:
    """Side-effect callbacks the real engine wires in.  All optional; the
    bare virtual session passes none."""

    on_insert: Optional[Callable[[SeqState], None]] = None
    on_decode: Optional[Callable[[List[SeqState], int, int], None]] = None
    on_evict: Optional[Callable[[str], None]] = None
    on_prefetch: Optional[Callable[[str], None]] = None
    on_finish: Optional[Callable[[SeqState], None]] = None


@dataclasses.dataclass
class ServeReport:
    """What one served mix measured."""

    job_id: str
    n_requests: int
    served: int
    rejected: List[str]
    tokens_generated: int
    total_time: float
    tokens_per_s: float
    ttft: Dict[str, float]
    ttft_mean: float
    ttft_p99: float
    queue_wait: Dict[str, float]
    admission_order: List[str]
    peak_bytes: int           # serving job's ledger peak
    oom_events: int           # device-wide OOM events during the run
    stall_time: float         # decode turns delayed by late swap-ins
    evictions: int
    prefetches: int
    swapped_out_bytes: int
    swapped_in_bytes: int
    turns: int
    stats: List[dict] = dataclasses.field(default_factory=list)
    # coalesced-transfer accounting (0 for a non-batching session)
    batched_transfers: int = 0
    saved_fixup_s: float = 0.0


def _quantile(xs: Sequence[float], q: float) -> float:
    if not xs:
        return float("inf")
    s = sorted(xs)
    if len(s) == 1:
        return s[0]
    i = q * (len(s) - 1)
    lo = int(i)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (i - lo)


class ServeSession:
    def __init__(self, requests: Sequence[Request], *,
                 engine: MemoryEngine,
                 job_id: str = "serve",
                 max_sequences: int = 4,
                 bytes_per_token: int = 1024,
                 block_tokens: int = 4,
                 budget_bytes: Optional[int] = None,
                 schedule: bool = True,
                 oversubscription: float = 2.5,
                 decode_round_time: float = 1e-3,
                 prefill_token_time: float = 1e-4,
                 batch_transfers: bool = False,
                 hooks: Optional[ServeHooks] = None,
                 progress: Optional[Callable[[dict], None]] = None):
        self.requests = sorted(requests, key=lambda r: (r.arrival, r.rid))
        self.engine = engine
        self.job_id = job_id
        self.max_sequences = max_sequences
        self.view = engine.ledger.view(job_id, budget_bytes)
        self.table = BlockTable(self.view, bytes_per_token,
                                block_tokens, trace=engine.trace)
        self.budget = budget_bytes if schedule else None
        self.schedule = schedule
        self.resident_pass = KvResidencyPass(self.table, self.budget)
        # prefill-burst admission: reservations are full KV footprints
        # against the serving capacity; the residency scheduler is what
        # makes oversubscription (> 1x device slice live at once) safe
        self.admission: Optional[AdmissionQueue] = None
        if schedule and budget_bytes is not None:
            cap = int(budget_bytes * oversubscription)
            self.admission = AdmissionQueue(cap)
        self.decode_round_time = decode_round_time
        self.prefill_token_time = prefill_token_time
        # batched data path: direction-grouped cohorts book ONE coalesced
        # channel slot (single fixup latency + dma_batch_overhead per
        # extra member) instead of one full transfer setup per rid.
        # Off by default — the per-rid path's timing is pinned by the
        # committed serving-scenario baselines.
        self.batch_transfers = bool(batch_transfers)
        self.batched_transfers = 0
        self.saved_fixup_s = 0.0
        self.hooks = hooks or ServeHooks()
        self.progress = progress
        self._bw = max(engine.profile.host_link_bw, 1.0)

    # -- helpers --------------------------------------------------------

    def _call(self, fn: Optional[Callable], *args) -> None:
        if fn is not None:
            fn(*args)

    def _xfer(self, nbytes: int) -> float:
        return nbytes / self._bw + self.engine.profile.host_link_latency

    def _acquire_group(self, t: float, pairs, direction: str):
        """Book one coalesced channel slot for a same-direction cohort of
        (rid, nbytes) transfers.  Returns the batch (start, end)."""
        if not pairs:
            return t, t
        prof = self.engine.profile
        start, end = self.engine.channel.acquire_batch(
            t, [nb / self._bw for _, nb in pairs],
            fixup=prof.host_link_latency, direction=direction,
            member_overhead=prof.dma_batch_overhead)
        if len(pairs) > 1:
            self.batched_transfers += 1
            self.saved_fixup_s += (len(pairs) - 1) * max(
                prof.host_link_latency - prof.dma_batch_overhead, 0.0)
        return start, end

    # -- the loop -------------------------------------------------------

    def run(self) -> ServeReport:
        t = 0.0
        pending = deque(self.requests)
        by_rid = {r.rid: r for r in self.requests}
        admitted: deque = deque()
        live: Dict[str, SeqState] = {}
        free_slots = list(range(self.max_sequences))
        ttft: Dict[str, float] = {}
        queue_wait: Dict[str, float] = {}
        admission_order: List[str] = []
        rejected: List[str] = []
        in_queue: set = set()
        tokens = 0
        stall = 0.0
        evictions = prefetches = turns = 0
        stats: List[dict] = []

        def arrive(now: float) -> None:
            while pending and pending[0].arrival <= now + 1e-12:
                r = pending.popleft()
                if self.admission is None:
                    admitted.append(r.rid)
                    queue_wait[r.rid] = 0.0
                    continue
                predicted = self.table.footprint(r.total_tokens)
                try:
                    self.admission.push(r.rid, predicted,
                                        priority=r.priority, source="serve",
                                        enqueued_at=r.arrival)
                    in_queue.add(r.rid)
                except ValueError:
                    # a request that can NEVER fit the serving capacity:
                    # rejected, same tolerance as the daemon's inbox
                    rejected.append(r.rid)

        def admit(now: float) -> None:
            if self.admission is None:
                return
            for qj in self.admission.pop_admissible(now):
                admitted.append(qj.job_id)
                admission_order.append(qj.job_id)
                in_queue.discard(qj.job_id)
                queue_wait[qj.job_id] = now - by_rid[qj.job_id].arrival

        def finish(s: SeqState, now: float) -> None:
            self.table.release(s.rid, now)
            if self.admission is not None:
                self.admission.release(s.rid)
            live.pop(s.rid, None)
            free_slots.append(s.slot)
            free_slots.sort()
            self._call(self.hooks.on_finish, s)

        while pending or in_queue or admitted or live:
            arrive(t)
            admit(t)

            # slot assignment + prefill bursts (serialized compute)
            while admitted and free_slots:
                rid = admitted.popleft()
                r = by_rid[rid]
                slot = free_slots.pop(0)
                burst = r.prompt_len * self.prefill_token_time
                if self.budget is not None and self.batch_transfers:
                    # batched path: the SAME victims the per-rid loop
                    # picks, but their copies-out coalesce into one
                    # booking that overlaps the prefill compute burst —
                    # the prompt's blocks are grown only after both the
                    # burst AND the batch end, so the ledger frees always
                    # precede the allocation they make room for
                    need = self.table.footprint(r.prompt_len)
                    victims = []
                    projected = self.view.used
                    for v in sorted(live.values(),
                                    key=lambda s: s.last_served):
                        if projected + need <= self.budget:
                            break
                        nbytes = self.table.device_bytes(v.rid)
                        if nbytes <= 0:
                            continue
                        victims.append((v.rid, nbytes))
                        projected -= nbytes
                    if victims:
                        _, end = self._acquire_group(t, victims, "out")
                        self.table.evict_many([v for v, _ in victims], end)
                        for vrid, _ in victims:
                            self._call(self.hooks.on_evict, vrid)
                        evictions += len(victims)
                        t = max(t + burst, end)
                    else:
                        t += burst
                elif self.budget is not None:
                    # make room for the prompt's blocks BEFORE the burst:
                    # admission oversubscribes the budget on purpose, so a
                    # prefill landing between decode turns must push the
                    # coldest resident sequences to host first (the decode
                    # path's eviction planning only runs per turn)
                    need = self.table.footprint(r.prompt_len)
                    for v in sorted(live.values(),
                                    key=lambda s: s.last_served):
                        if self.view.used + need <= self.budget:
                            break
                        nbytes = self.table.device_bytes(v.rid)
                        if nbytes <= 0:
                            continue
                        _, end = self.engine.channel.acquire(
                            t, self._xfer(nbytes))
                        self.table.evict(v.rid, end)
                        self._call(self.hooks.on_evict, v.rid)
                        evictions += 1
                        t = max(t, end)
                    t += burst
                else:
                    t += burst
                s = SeqState(rid=rid, slot=slot, prompt_len=r.prompt_len,
                             gen_len=r.gen_len, priority=r.priority,
                             arrival=r.arrival, pos=r.prompt_len,
                             generated=1, remaining=r.gen_len - 1,
                             last_served=t)
                self.table.grow(rid, r.prompt_len, t)
                ttft[rid] = t - r.arrival   # first token: end of prefill
                tokens += 1
                live[rid] = s
                self._call(self.hooks.on_insert, s)
                if s.remaining <= 0:
                    finish(s, t)

            if not live:
                if pending:
                    t = max(t, pending[0].arrival)
                    continue
                if admitted or in_queue:
                    # waiting on reservations that only free on finish —
                    # with nothing live this cannot progress; bail rather
                    # than spin (callers see the shortfall in `served`)
                    break
                continue

            plan = self.resident_pass.plan_turn(
                [SeqView(rid=s.rid, slot=s.slot, pos=s.pos,
                         remaining=s.remaining, last_served=s.last_served)
                 for s in live.values()])
            if plan is None:
                break
            cohort = [live[v.rid] for v in plan.cohort]

            # evictions serialize on the channel before the turn; device
            # bytes are freed when the copy-out completes
            turn_start = t
            cohorts = (self.resident_pass.transfer_cohorts(plan)
                       if self.batch_transfers else None)
            if cohorts is not None:
                ev = cohorts["evict"]
                if ev:
                    _, end = self._acquire_group(t, ev, "out")
                    self.table.evict_many([r for r, _ in ev], end)
                    for erid, _ in ev:
                        self._call(self.hooks.on_evict, erid)
                    evictions += len(ev)
                    turn_start = max(turn_start, end)
                fe = cohorts["fetch"]
                if fe:
                    start, end = self._acquire_group(turn_start, fe, "in")
                    self.table.prefetch_many([r for r, _ in fe], start)
                    for frid, _ in fe:
                        self._call(self.hooks.on_prefetch, frid)
                    prefetches += len(fe)
                    turn_start = max(turn_start, end)
            else:
                for rid in plan.evict:
                    nbytes = self.table.device_bytes(rid)
                    _, end = self.engine.channel.acquire(
                        t, self._xfer(nbytes))
                    self.table.evict(rid, end)
                    self._call(self.hooks.on_evict, rid)
                    evictions += 1
                    turn_start = max(turn_start, end)
                # mandatory fetches: the cohort's turn came while its
                # blocks were parked on host — a late prefetch is a stall
                for rid in plan.fetch:
                    nbytes = self.table.host_bytes(rid)
                    start, end = self.engine.channel.acquire(
                        turn_start, self._xfer(nbytes))
                    self.table.prefetch(rid, start)
                    self._call(self.hooks.on_prefetch, rid)
                    prefetches += 1
                    turn_start = max(turn_start, end)
            ready = max((s.ready_at for s in cohort), default=0.0)
            turn_start = max(turn_start, ready)
            stall += turn_start - t

            # the decode turn: grow blocks, step the cohort
            chunk = plan.chunk
            start_pos = cohort[0].pos
            for s in cohort:
                self.table.grow(s.rid, s.pos + chunk, turn_start)
            self._call(self.hooks.on_decode, cohort, start_pos, chunk)
            turn_end = turn_start + chunk * self.decode_round_time
            for s in cohort:
                s.pos += chunk
                s.generated += chunk
                s.remaining -= chunk
                s.last_served = turn_start
            tokens += chunk * len(cohort)
            turns += 1
            rec = self.engine.recorder
            if rec is not None:
                # observability tap: the decode turn as a span on the
                # serve job's track plus the KV residency counter — the
                # block-level transfers already flow through the hub
                rec.span("decode_turn", turn_start,
                         turn_end - turn_start, job_id=self.job_id,
                         cat="serve", cohort=len(cohort), chunk=chunk,
                         start_pos=start_pos)
                rec.counter(f"kv_resident:{self.job_id}", turn_end,
                            self.engine.ledger.job_bytes(self.job_id))

            # lookahead prefetches overlap the turn's compute: book the
            # channel now so the next group's blocks land before its turn
            if cohorts is not None:
                pf = cohorts["prefetch"]
                if pf:
                    start, end = self._acquire_group(turn_start, pf, "in")
                    self.table.prefetch_many([r for r, _ in pf], start)
                    for prid, _ in pf:
                        if prid in live:
                            live[prid].ready_at = max(
                                live[prid].ready_at, end)
                        self._call(self.hooks.on_prefetch, prid)
                    prefetches += len(pf)
            else:
                for rid in plan.prefetch:
                    nbytes = self.table.host_bytes(rid)
                    start, end = self.engine.channel.acquire(
                        turn_start, self._xfer(nbytes))
                    self.table.prefetch(rid, start)
                    if rid in live:
                        live[rid].ready_at = max(live[rid].ready_at, end)
                    self._call(self.hooks.on_prefetch, rid)
                    prefetches += 1

            for s in list(cohort):
                if s.remaining <= 0:
                    finish(s, turn_end)
            t = turn_end
            row = {"t": t, "cohort": len(cohort), "chunk": chunk,
                   "used": self.view.used, "peak": self.view.peak,
                   "oom_events": self.engine.ledger.oom_events,
                   "live": len(live)}
            stats.append(row)
            if self.progress is not None:
                self.progress(row)
            arrive(t)
            admit(t)

        waits = list(ttft.values())
        return ServeReport(
            job_id=self.job_id, n_requests=len(self.requests),
            served=len(ttft), rejected=rejected,
            tokens_generated=tokens, total_time=t,
            tokens_per_s=tokens / t if t > 0 else 0.0,
            ttft=ttft,
            ttft_mean=sum(waits) / len(waits) if waits else float("inf"),
            ttft_p99=_quantile(waits, 0.99),
            queue_wait=queue_wait, admission_order=admission_order,
            peak_bytes=self.view.peak,
            oom_events=self.engine.ledger.oom_events,
            stall_time=stall, evictions=evictions, prefetches=prefetches,
            swapped_out_bytes=self.table.swapped_out_bytes,
            swapped_in_bytes=self.table.swapped_in_bytes,
            turns=turns, stats=stats,
            batched_transfers=self.batched_transfers,
            saved_fixup_s=self.saved_fixup_s)
