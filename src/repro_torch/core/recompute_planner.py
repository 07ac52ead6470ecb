"""Recomputation scheduling (paper §IV-D).

Driven by ``passes.RecomputePass`` under the Pipeline's convergence loop:
runs after swapping is exhausted (pass order) and only if the predicted peak
still exceeds the memory budget (the pass's gate).  Candidates are restricted to tensors that have **never
been released or swapped** (so a recomputation never cascades into further
swap-ins/recomputes), whose producer's inputs are still resident at the
recompute instant.  Candidates are ranked by Capuchin's MSPS metric:

    MSPS = memory_saving / recomputation_time

A copy of the JAX package's ``core/recompute_planner.py`` (which imports no JAX),
kept in step with it; the port's tests hold the two to the same
results.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from .access import AccessSequence, AccessType, TensorKind
from .peak_analysis import PERSISTENT_KINDS, PeakReport, storage_of
from .plan import EventType, ScheduleEvent, SchedulingPlan


@dataclasses.dataclass
class RecomputeCandidate:
    tensor_id: str
    job_id: str
    size_bytes: int
    recompute_time: float
    release_after_op: int   # TUA after which the tensor is dropped
    target_op: int          # TUA needing the regenerated value
    producer_op: int

    @property
    def msps(self) -> float:
        return self.size_bytes / max(self.recompute_time, 1e-12)


class RecomputePlanner:
    def __init__(self, seq: AccessSequence, plan: SchedulingPlan,
                 experience=None):
        self.seq = seq
        self.plan = plan
        self.recomputed: set = {
            e.tensor_id for e in plan.events
            if e.event_type is EventType.RECOMPUTE}
        # per-fingerprint memo of the MSPS statics (ExperienceStore
        # attached): identical candidate stream, skips the per-call
        # re-derivation of TGA/TUA structure for every tensor
        self._ps = None
        if experience is not None:
            try:
                self._ps = experience.pass_state(seq)
            except Exception:   # noqa: BLE001 - corrupt store: cold path
                self._ps = None
        if self._ps is None:
            from .pass_state import default_pass_state
            self._ps = default_pass_state(seq)

    # ------------------------------------------------------------------
    def _touched(self) -> set:
        """Tensors already scheduled (swap or early release) — recomputing
        them could cascade (paper: apply only to never-released accesses)."""
        touched = set(self.plan.release_after_op)
        for e in self.plan.events:
            touched.add(e.tensor_id)
        return touched

    def _inputs_resident_at(self, op_idx: int, when: float,
                            touched: set) -> bool:
        """All producer inputs must still be resident at the recompute
        instant: persistent, or activations and inputs whose last use is
        later and which are untouched by the plan.  (The JAX package counts
        every INPUT as resident, but the engine frees an input after its
        last use like an activation; a recompute planned past that point
        finds its producer's input gone.)"""
        op = self.seq.operators[op_idx]
        for tid in op.inputs:
            spec = self.seq.tensors.get(tid)
            if spec is None:
                continue
            if spec.kind in PERSISTENT_KINDS:
                if tid in touched:
                    return False
                continue
            last = self.seq.last_access(tid)
            if last is None or last.end_time <= when or tid in touched:
                return False
        return True

    def _eligible(self) -> List[tuple]:
        """(tid, spec, tga, TUAs, recompute_time) for every activation
        with a producer and at least one use, in ``seq.tensors`` order —
        from the per-fingerprint memo when available."""
        seq = self.seq
        if self._ps is not None:
            return self._ps.recompute_statics(seq)
        out = []
        for tid, spec in seq.tensors.items():
            if spec.kind is not TensorKind.ACTIVATION:
                continue
            accs = seq.tensor_accesses(tid)
            tuas = [a for a in accs if a.access_type is AccessType.TUA]
            tga = seq.tga(tid)
            if tga is None or len(tuas) < 1:
                continue
            out.append((tid, spec, tga, tuas,
                        max(seq.operators[tga.op_idx].latency, 1e-12)))
        return out

    # ------------------------------------------------------------------
    def candidates(self, report: PeakReport) -> List[RecomputeCandidate]:
        seq = self.seq
        touched = self._touched()
        out: List[RecomputeCandidate] = []
        peak_ids = {sid for sid, j, _ in report.peak_tensors
                    if j == seq.job_id}
        for tid, spec, tga, tuas, rec_time in self._eligible():
            if (tid in touched or tid in self.recomputed
                    or storage_of(spec) not in peak_ids):
                continue
            # the release/recompute gap must cover the peak instant
            prev_end, target = None, None
            cursor = tga
            for a in tuas:
                if cursor.end_time <= report.peak_time <= a.time:
                    prev_end, target = cursor, a
                    break
                cursor = a
            if target is None:
                continue
            if not self._inputs_resident_at(tga.op_idx, target.time, touched):
                continue
            out.append(RecomputeCandidate(
                tensor_id=tid, job_id=seq.job_id, size_bytes=spec.size_bytes,
                recompute_time=rec_time,
                release_after_op=cursor.op_idx, target_op=target.op_idx,
                producer_op=tga.op_idx))
        out.sort(key=lambda c: -c.msps)
        return out

    def apply(self, cand: RecomputeCandidate) -> ScheduleEvent:
        seq = self.seq
        rel_time = seq.op_end[cand.release_after_op]
        tgt_time = seq.op_start[cand.target_op]
        rel = ScheduleEvent(
            event_type=EventType.RELEASE, tensor_id=cand.tensor_id,
            job_id=seq.job_id, trigger_op=cand.release_after_op, delta=0.0,
            start=rel_time, end=rel_time, size_bytes=cand.size_bytes)
        rec = ScheduleEvent(
            event_type=EventType.RECOMPUTE, tensor_id=cand.tensor_id,
            job_id=seq.job_id, trigger_op=max(cand.target_op - 1, 0),
            delta=0.0, start=max(tgt_time - cand.recompute_time, rel_time),
            end=tgt_time, size_bytes=cand.size_bytes,
            target_op=cand.target_op, recompute_ops=[cand.producer_op])
        self.plan.add(rel)
        self.plan.add(rec)
        self.recomputed.add(cand.tensor_id)
        return rec


def plan_one_recompute(planners: Dict[str, RecomputePlanner],
                       report: PeakReport) -> bool:
    best: Optional[Tuple[float, RecomputePlanner, RecomputeCandidate]] = None
    for pl in planners.values():
        for cand in pl.candidates(report):
            if best is None or cand.msps > best[0]:
                best = (cand.msps, pl, cand)
            break  # candidates are sorted; first is this job's best
    if best is None:
        return False
    _, pl, cand = best
    pl.apply(cand)
    return True
