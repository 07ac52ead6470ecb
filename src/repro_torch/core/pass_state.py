"""Per-sequence planning memo: the structural inputs every
``SwapPlanner``/``RecomputePlanner`` construction re-derives (storage alias
candidates, swappable count, activity analysis, MSPS statics), built once
per sequence.

A copy of the pass-state part of the JAX package's ``core/experience.py``.
The planners read it through ``default_pass_state`` or, with an
experience store attached, ``ExperienceStore.pass_state``
(``core/experience.py``), which keys the same memo by the job's
fingerprint.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from .access import AccessSequence

# ----------------------------------------------------------------------
# Per-fingerprint pass state (in-memory planner memoization)
# ----------------------------------------------------------------------
@dataclasses.dataclass
class JobPassState:
    """In-memory per-fingerprint planning state.

    Every SwapPlanner/RecomputePlanner construction re-derives the same
    structural inputs — storage alias candidates, the swappable-tensor
    count, activity analysis, the recompute-eligibility statics behind
    the MSPS ranking — and every analyze call needs the job's base event
    arrays.  Replans of a known job hit this memo instead (the raw-speed
    tentpole's warm path); all fields are read-only to consumers.
    Timeline-scoped members (base arrays, recompute statics) are keyed by
    (sequence serial, timeline version) and drop automatically when the
    timeline is rebuilt."""

    fingerprint: str
    alias_candidates: Dict[str, List[str]]
    swappable_total: int
    release_ops: Dict[str, int]
    _tv_key: Optional[Tuple[int, int]] = None
    _bases: Dict[bool, object] = dataclasses.field(default_factory=dict)
    _recompute_statics: Optional[List[tuple]] = None

    def _roll(self, seq: AccessSequence) -> None:
        key = (seq.serial, seq._timeline_version)
        if self._tv_key != key:
            self._tv_key = key
            self._bases = {}
            self._recompute_statics = None

    def job_base(self, seq: AccessSequence,
                 free_at_last_use: bool = True):
        """The job's cached SoA base event buffers, pinned here so a
        warm job survives the global base-cache's eviction sweeps."""
        from .peak_analysis import _job_base
        self._roll(seq)
        b = self._bases.get(free_at_last_use)
        if b is None:
            b = self._bases[free_at_last_use] = _job_base(
                seq, free_at_last_use)
        return b

    def recompute_statics(self, seq: AccessSequence) -> List[tuple]:
        """Per-tensor statics of the MSPS ranking — (tid, spec, tga,
        TUAs, recompute_time) for every activation with a producer and at
        least one use — in ``seq.tensors`` iteration order, so consuming
        them reproduces the uncached candidate order exactly."""
        from .access import AccessType, TensorKind
        self._roll(seq)
        if self._recompute_statics is None:
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
            self._recompute_statics = out
        return self._recompute_statics


def build_pass_state(seq: AccessSequence, fp: str) -> JobPassState:
    from .peak_analysis import storage_of
    alias: Dict[str, List[str]] = {}
    for t in seq.tensors.values():
        alias.setdefault(storage_of(t), []).append(t.tid)
    for cands in alias.values():
        cands.sort(key=lambda tid: seq.tensors[tid].updates is None)
    swappable = max(1, sum(1 for t in seq.tensors.values()
                           if len(seq.tensor_accesses(t.tid)) >= 1))
    return JobPassState(fingerprint=fp, alias_candidates=alias,
                        swappable_total=swappable,
                        release_ops=dict(seq.activity_analysis()))


# storeless fallback: pipelines without an ExperienceStore get the same
# structural memo, keyed by sequence serial (the structural members only
# depend on the graph, which is fixed for a sequence's lifetime; the
# timeline-scoped members roll themselves via JobPassState._roll).  No
# fingerprint hash is computed on this path.
_DEFAULT_PASS_STATE: Dict[int, JobPassState] = {}


def default_pass_state(seq: AccessSequence) -> JobPassState:
    serial = getattr(seq, "serial", None)
    if serial is None:
        return build_pass_state(seq, "")
    ps = _DEFAULT_PASS_STATE.get(serial)
    if ps is None:
        if len(_DEFAULT_PASS_STATE) > 256:
            _DEFAULT_PASS_STATE.clear()
        ps = _DEFAULT_PASS_STATE[serial] = build_pass_state(seq, "")
    return ps
