"""GPU memory peak analysis (paper §IV-B, Algorithm 2).

Sweeps the merged event timeline of one or more jobs — tensor accesses plus
already-scheduled swap events — and reports the memory footprint peak (MP),
the tensors resident at the peak (MPT), the last input access before the peak
(LUA) and the peak instant (MPTime).

Memory changes at exactly five situations (paper §IV-B):
  1. iteration beginning   — inputs + parameters not swapped out last iteration
  2. TGA                   — footprint increases (updated parameters alias the
                             old parameter's storage: no increase; the buffer
                             is reserved when the producing op launches)
  3. swap-in end           — footprint increases
  4. swap-out end          — footprint decreases (or at the end of the
                             overlapping TUA if that ends later)
  5. tensor release        — footprint decreases after the last access

Performance: the scheduler calls analyze() once per greedy iteration, so
the sweep is vectorized end to end.  Base events (accesses +
activity-analysis releases — O(10⁴) on real nets) are cached per timeline
version as structure-of-arrays buffers (times / tie-orders / signed deltas
/ storage-key ids), PRE-SORTED by (time, order); per call the handful of
plan events is merged into the sorted buffers by binary search, residency
comes from a cumulative sum over "effective" events (a per-key sign-change
mask reproduces the idempotent alloc/free semantics exactly), and the peak
/ MPT / LUA fall out of argmax + scatter operations.  The per-event
implementation is kept verbatim as ``_reference_sweep`` — the equivalence
tests assert the vectorized path is byte-identical to it, which is what
keeps the golden seed plans stable.

A copy of the JAX package's ``core/peak_analysis.py`` (which imports no JAX),
kept in step with it; the port's tests hold the two to the same
results.
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .access import AccessSequence, AccessType, TensorKind, TensorSpec
from .plan import EventType, SchedulingPlan

# Tensor kinds that persist across iterations unless explicitly swapped out.
PERSISTENT_KINDS = (TensorKind.PARAM, TensorKind.OPT_STATE)


def storage_of(spec: TensorSpec) -> str:
    """Updated parameters reuse the old parameter's storage (paper §IV-B 2))."""
    return spec.updates if spec.updates is not None else spec.tid


@dataclasses.dataclass
class MemEvent:
    time: float
    delta: int               # signed bytes
    storage: str
    job_id: str
    kind: str                # "init" | "tga" | "swap_in" | "swap_out" | "release"
    order: int = 0           # tie-break: frees before allocs at equal time


class PeakReport:
    """Algorithm-2 output.  ``peak_tensors`` (the MPT: (storage_id,
    job_id, size_bytes) resident at the peak, largest first) and
    ``timeline`` may be handed in as thunks and are then materialized on
    first attribute access — replans run full-iteration sweeps whose MPT
    and timeline nobody reads, and at 100k ops building those Python
    lists dominates the sweep itself."""

    def __init__(self, peak_bytes: int, peak_time: float,
                 peak_tensors: Optional[List[Tuple[str, str, int]]] = None,
                 last_input_access: Optional[Dict[str, float]] = None,
                 timeline: Optional[List[Tuple[float, int]]] = None,
                 per_job_peak: Optional[Dict[str, int]] = None,
                 peak_tensors_fn=None, timeline_fn=None):
        self.peak_bytes = peak_bytes
        self.peak_time = peak_time
        self.last_input_access = last_input_access or {}
        self.per_job_peak = per_job_peak or {}
        self._peak_tensors = peak_tensors
        self._peak_tensors_fn = peak_tensors_fn
        self._timeline = timeline
        self._timeline_fn = timeline_fn

    @property
    def peak_tensors(self) -> List[Tuple[str, str, int]]:
        if self._peak_tensors is None:
            self._peak_tensors = (self._peak_tensors_fn()
                                  if self._peak_tensors_fn else [])
            self._peak_tensors_fn = None
        return self._peak_tensors

    @property
    def timeline(self) -> List[Tuple[float, int]]:
        if self._timeline is None:
            self._timeline = self._timeline_fn() if self._timeline_fn else []
            self._timeline_fn = None
        return self._timeline

    def mpt_ids(self) -> List[str]:
        return [t[0] for t in self.peak_tensors]

    def __repr__(self) -> str:  # pragma: no cover
        return (f"PeakReport(peak_bytes={self.peak_bytes}, "
                f"peak_time={self.peak_time}, "
                f"per_job_peak={self.per_job_peak})")


# ----------------------------------------------------------------------
# Event construction (cached base + per-plan deltas)
# ----------------------------------------------------------------------
class _JobBase:
    """Timeline-version-keyed per-job static data."""

    def __init__(self, seq: AccessSequence, free_at_last_use: bool):
        self.sizes: Dict[str, int] = {}
        for spec in seq.tensors.values():
            st = storage_of(spec)
            self.sizes[st] = max(self.sizes.get(st, 0), spec.size_bytes)

        self.persistent: set = set()
        last_end: Dict[str, float] = {}
        for tid, accs in seq.accesses_by_tensor.items():
            spec = seq.tensors[tid]
            st = storage_of(spec)
            last_end[st] = max(last_end.get(st, 0.0),
                               max(a.end_time for a in accs))
            if spec.kind in PERSISTENT_KINDS or spec.updates is not None:
                self.persistent.add(st)
        self.last_end = last_end

        fixed: List[MemEvent] = []
        seen_init = set()
        for tid in seq.initial_resident:
            spec = seq.tensors.get(tid)
            if spec is None:
                continue
            st = storage_of(spec)
            if st in seen_init:
                continue
            seen_init.add(st)
            fixed.append(MemEvent(0.0, +self.sizes[st], st, seq.job_id,
                                  "init", order=0))
        alloc_seen = set(seen_init)
        for a in seq.accesses:
            if a.access_type is not AccessType.TGA:
                continue
            spec = seq.tensors[a.tensor_id]
            st = storage_of(spec)
            if spec.updates is not None or st in alloc_seen:
                continue
            alloc_seen.add(st)
            alloc_t = seq.op_start[a.op_idx] \
                if 0 <= a.op_idx < len(seq.op_start) else a.time
            fixed.append(MemEvent(alloc_t, +self.sizes[st], st, seq.job_id,
                                  "tga", order=1))
        fixed.sort(key=_ekey)
        self.fixed = fixed

        rel: List[MemEvent] = []
        for st, t_end in last_end.items():
            if st in self.persistent:
                continue
            t = t_end if free_at_last_use else seq.iteration_time
            rel.append(MemEvent(t, -self.sizes[st], st, seq.job_id,
                                "release", order=-1))
        rel.sort(key=_ekey)
        self.releases = rel

        tuas = sorted((a.time for a in seq.accesses
                       if a.access_type is AccessType.TUA))
        self.tua_times = tuas
        self.tua_arr = np.asarray(tuas, dtype=np.float64)

        # ---- structure-of-arrays mirror of fixed+releases, pre-sorted ----
        # Local key ids index `key_names`/`key_sizes`; the merged-sort order
        # reproduces heapq.merge([fixed, releases]) exactly: stable lexsort
        # of the concatenation keeps fixed before releases at equal
        # (time, order), matching stream priority.
        self.key_index: Dict[str, int] = {}
        self.key_names: List[str] = []
        for st in self.sizes:
            self.key_index[st] = len(self.key_names)
            self.key_names.append(st)
        self.key_sizes = np.asarray(
            [self.sizes[st] for st in self.key_names], dtype=np.int64)
        evs = list(fixed) + list(rel)
        t = np.asarray([e.time for e in evs], dtype=np.float64)
        o = np.asarray([e.order for e in evs], dtype=np.int64)
        d = np.asarray([e.delta for e in evs], dtype=np.int64)
        k = np.asarray([self.key_index[e.storage] for e in evs],
                       dtype=np.int64)
        is_rel = np.zeros(len(evs), dtype=bool)
        is_rel[len(fixed):] = True
        order = np.lexsort((o, t)) if len(evs) else np.empty(0, np.int64)
        self.arr_t = t[order]
        self.arr_o = o[order]
        self.arr_d = d[order]
        self.arr_k = k[order]
        self.arr_is_rel = is_rel[order]


def _ekey(e: MemEvent):
    return (e.time, e.order)


_BASE_CACHE: Dict[Tuple[int, int, bool], _JobBase] = {}

# whole-report memo (see analyze): a report's lazy thunks pin the sweep's
# event arrays, so the LRU is deliberately tiny — it only needs to cover
# the replan pattern of re-analyzing an unchanged (seqs, plans) pair
_REPORT_CACHE: "collections.OrderedDict[tuple, PeakReport]" = \
    collections.OrderedDict()
_REPORT_CACHE_CAP = 4


def _report_cache_put(ck: Optional[tuple], rep: PeakReport) -> PeakReport:
    if ck is not None:
        while len(_REPORT_CACHE) >= _REPORT_CACHE_CAP:
            _REPORT_CACHE.popitem(last=False)
        _REPORT_CACHE[ck] = rep
    return rep


def _job_base(seq: AccessSequence, free_at_last_use: bool) -> _JobBase:
    key = (getattr(seq, "serial", id(seq)),
           getattr(seq, "_timeline_version", 0), free_at_last_use)
    hit = _BASE_CACHE.get(key)
    if hit is None:
        if len(_BASE_CACHE) > 256:
            _BASE_CACHE.clear()
        hit = _JobBase(seq, free_at_last_use)
        _BASE_CACHE[key] = hit
    return hit


def _schedule_event_list(seq: AccessSequence, base: _JobBase,
                         sched_events) -> Tuple[List[MemEvent], set]:
    """MemEvents for a list of ScheduleEvents (unsorted), plus the storages
    whose base release a swap-out supersedes."""
    events: List[MemEvent] = []
    touched: set = set()
    sizes = base.sizes
    for ev in sched_events:
        spec = seq.tensors.get(ev.tensor_id)
        if spec is None:
            continue
        st = storage_of(spec)
        if ev.event_type is EventType.SWAP_OUT:
            free_t = ev.end
            for a in seq.tensor_accesses(ev.tensor_id):
                if a.time <= ev.end and a.end_time > free_t:
                    free_t = a.end_time
            touched.add(st)
            events.append(MemEvent(free_t, -sizes[st], st, seq.job_id,
                                   "swap_out", order=-1))
        elif ev.event_type in (EventType.SWAP_IN, EventType.RECOMPUTE):
            events.append(MemEvent(ev.end, +sizes[st], st, seq.job_id,
                                   "swap_in", order=1))
        elif ev.event_type is EventType.RELEASE:
            events.append(MemEvent(ev.end, -sizes[st], st, seq.job_id,
                                   "release", order=-1))
    return events, touched


def _plan_events(seq: AccessSequence, plan: SchedulingPlan,
                 base: _JobBase) -> Tuple[List[MemEvent], set]:
    """Dynamic events from a plan + the storages whose base release is
    superseded (swapped-out or override-released)."""
    events, touched = _schedule_event_list(seq, base, plan.events)
    sizes = base.sizes
    for tid, op_idx in plan.release_after_op.items():
        spec = seq.tensors.get(tid)
        if spec is None or not (0 <= op_idx < len(seq.op_end)):
            continue
        st = storage_of(spec)
        t = min(base.last_end.get(st, float("inf")), seq.op_end[op_idx])
        touched.add(st)
        events.append(MemEvent(t, -sizes[st], st, seq.job_id,
                               "release", order=-1))
    events.sort(key=_ekey)
    return events, touched


# ----------------------------------------------------------------------
# Vectorized structure-of-arrays sweep
# ----------------------------------------------------------------------
def _events_to_arrays(evs: List[MemEvent], base: _JobBase):
    """SoA buffers for a (sorted) MemEvent list, local key ids."""
    t = np.asarray([e.time for e in evs], dtype=np.float64)
    o = np.asarray([e.order for e in evs], dtype=np.int64)
    d = np.asarray([e.delta for e in evs], dtype=np.int64)
    k = np.asarray([base.key_index[e.storage] for e in evs], dtype=np.int64)
    return t, o, d, k


def _insert_positions(bt: np.ndarray, bo: np.ndarray,
                      dt: np.ndarray, do: np.ndarray) -> np.ndarray:
    """For each (time, order)-sorted dyn event, the number of base events
    with key <= its key — i.e. the np.insert position that lands dyn
    events AFTER equal-key base events (heapq.merge stream priority:
    [fixed, releases, dyn])."""
    lo = np.searchsorted(bt, dt, side="left")
    hi = np.searchsorted(bt, dt, side="right")
    pos = lo.copy()
    for j in np.flatnonzero(hi > lo):
        a, b = int(lo[j]), int(hi[j])
        pos[j] = a + int(np.searchsorted(bo[a:b], do[j], side="right"))
    return pos


def _merge_seq_arrays(base: _JobBase, dyn: List[MemEvent],
                      filt: Optional[set]):
    """One job's merged (time, order)-sorted event buffers:
    (times, orders, deltas, local key ids, is_base_release).

    Byte-order-identical to ``heapq.merge`` over the reference streams
    [fixed, releases-filtered-by-``filt``, dyn]: the cached base buffers
    are pre-sorted with fixed-before-releases tie priority, and dyn events
    are binary-search inserted after equal-(time, order) base rows."""
    bt, bo, bd, bk = base.arr_t, base.arr_o, base.arr_d, base.arr_k
    brel = base.arr_is_rel
    if filt:
        present = [base.key_index[st] for st in filt
                   if st in base.key_index]
        if present:
            tbl = np.zeros(len(base.key_names), dtype=bool)
            tbl[present] = True
            keep = ~(brel & tbl[bk])
            bt, bo, bd, bk, brel = (bt[keep], bo[keep], bd[keep], bk[keep],
                                    brel[keep])
    if not dyn:
        return bt, bo, bd, bk, brel
    dt, do, dd, dk = _events_to_arrays(dyn, base)
    pos = _insert_positions(bt, bo, dt, do)
    return (np.insert(bt, pos, dt), np.insert(bo, pos, do),
            np.insert(bd, pos, dd), np.insert(bk, pos, dk),
            np.insert(brel, pos, False))


def _seq_arrays(seq: AccessSequence, plan: Optional[SchedulingPlan],
                free_at_last_use: bool):
    """Single-job merged event buffers with the job's OWN touched-release
    filter (the semantics ``build_events`` / ``find_safe_points`` use)."""
    base = _job_base(seq, free_at_last_use)
    if plan is not None and (plan.events or plan.release_after_op):
        dyn, touched = _plan_events(seq, plan, base)
    else:
        dyn, touched = [], set()
    t, o, d, k, brel = _merge_seq_arrays(base, dyn, touched or None)
    return t, o, d, k, brel, base


def _effective_mask(k: np.ndarray, d: np.ndarray,
                    init_sign: Optional[np.ndarray] = None,
                    n_keys: int = 0) -> np.ndarray:
    """The idempotent alloc/free semantics as a per-key sign-change mask.

    State after ANY event equals (delta > 0) — an alloc is effective iff
    the key was not resident, a free iff it was — so an event is effective
    exactly when its sign differs from the key's previous event's sign
    (initially: from ``init_sign``, default not-resident)."""
    n = len(k)
    if n == 0:
        return np.zeros(0, dtype=bool)
    sign = d > 0
    g = np.argsort(k, kind="stable")
    gk, gs = k[g], sign[g]
    first = np.empty(n, dtype=bool)
    first[0] = True
    first[1:] = gk[1:] != gk[:-1]
    prev = np.empty(n, dtype=bool)
    prev[1:] = gs[:-1]
    if init_sign is None:
        prev[first] = False
    else:
        prev[first] = init_sign[gk[first]]
    eff = np.empty(n, dtype=bool)
    eff[g] = gs != prev
    return eff


def _offset_iter(events: Iterable[MemEvent], offset: float
                 ) -> Iterator[MemEvent]:
    if not offset:
        yield from events
        return
    for e in events:
        yield dataclasses.replace(e, time=e.time + offset)


def build_events(seq: AccessSequence,
                 plan: Optional[SchedulingPlan] = None,
                 offset: float = 0.0,
                 free_at_last_use: bool = True) -> List[MemEvent]:
    """All memory events for one job (compat API; used by tests)."""
    base = _JobBase(seq, free_at_last_use)
    dyn, touched = (_plan_events(seq, plan, base) if plan is not None
                    else ([], set()))
    evs = list(base.fixed) \
        + [e for e in base.releases if e.storage not in touched] + dyn
    if offset:
        evs = [dataclasses.replace(e, time=e.time + offset) for e in evs]
    return evs


def analyze(seqs: Sequence[AccessSequence],
            plans: Optional[Dict[str, SchedulingPlan]] = None,
            offsets: Optional[Dict[str, float]] = None,
            window: Optional[Tuple[float, float]] = None,
            free_at_last_use: bool = True) -> PeakReport:
    """Algorithm 2 over the merged timeline of several jobs.

    `offsets[job_id]` shifts a job's timeline (jobs run asynchronously).
    `window` restricts peak detection to [lo, hi).

    Vectorized numpy sweep over structure-of-arrays event buffers;
    byte-identical to the per-event ``_reference_sweep`` (the equivalence
    tests pin this, which is what keeps golden plans stable).

    Whole reports are memoized on (sequence serial + timeline version,
    plan uid + version, offset, window, semantics): the incremental-replan
    path re-analyzes the same prior plans on every call, and plan
    mutations are visible through the plan's monotone version counter.
    """
    plans = plans or {}
    offsets = offsets or {}
    ck: Optional[tuple] = None
    if all(getattr(s, "serial", None) is not None for s in seqs):
        ck = (free_at_last_use, window) + tuple(
            (s.serial, s._timeline_version, offsets.get(s.job_id, 0.0),
             ((p.uid, p.version) if (p := plans.get(s.job_id)) is not None
              else None))
            for s in seqs)
        hit = _REPORT_CACHE.get(ck)
        if hit is not None:
            _REPORT_CACHE.move_to_end(ck)
            return hit

    # ---- merged SoA buffers (global key id = (job slot, storage)) ------
    parts = []          # per-seq (t, o, d, gk, seq_idx array)
    key_names: List[str] = []
    key_jobs: List[str] = []
    key_size_parts: List[np.ndarray] = []
    dup_jobs = len({s.job_id for s in seqs}) != len(list(seqs))
    gid_by_job: Dict[str, Dict[str, int]] = {}
    bases = []
    # Phase A: per-seq dyn events + touched sets.  The reference merge
    # builds its release-filter as a generator expression closing over the
    # loop variable `touched` and only consumes it AFTER the loop, so every
    # seq whose own touched set was non-empty is actually filtered by the
    # LAST seq's touched set.  Golden plans pin that behaviour, so the
    # vectorized sweep reproduces it here (single-seq calls are
    # unaffected: own == last).
    pre = []
    for seq in seqs:
        base = _job_base(seq, free_at_last_use)
        plan = plans.get(seq.job_id)
        if plan is not None and (plan.events or plan.release_after_op):
            dyn, touched = _plan_events(seq, plan, base)
        else:
            dyn, touched = [], set()
        pre.append((seq, base, dyn, touched))
    touched_last = pre[-1][3] if pre else set()
    for si, (seq, base, dyn, touched) in enumerate(pre):
        off = offsets.get(seq.job_id, 0.0)
        t, o, d, k, _rel = _merge_seq_arrays(
            base, dyn, touched_last if touched else None)
        bases.append((seq, off, base))
        if dup_jobs:
            # two seqs sharing a job_id share (job, storage) key identity,
            # exactly like the reference's resident dict
            jmap = gid_by_job.setdefault(seq.job_id, {})
            remap = np.empty(len(base.key_names), dtype=np.int64)
            for li, st in enumerate(base.key_names):
                gid = jmap.get(st)
                if gid is None:
                    gid = jmap[st] = len(key_names)
                    key_names.append(st)
                    key_jobs.append(seq.job_id)
                    key_size_parts.append(base.key_sizes[li:li + 1])
                remap[li] = gid
            gk = remap[k]
        else:
            base_off = len(key_names)
            key_names.extend(base.key_names)
            key_jobs.extend([seq.job_id] * len(base.key_names))
            key_size_parts.append(base.key_sizes)
            gk = k + base_off
        tt = t + off if off else t
        parts.append((tt, o, d, gk,
                      np.full(len(t), si, dtype=np.int64)))

    if not parts or sum(len(p[0]) for p in parts) == 0:
        return _report_cache_put(ck, PeakReport(
            peak_bytes=0, peak_time=0.0, peak_tensors=[],
            last_input_access={s.job_id: 0.0 for s in seqs},
            timeline=[], per_job_peak={}))
    if len(parts) == 1:
        t, o, d, gk, sx = parts[0]     # single job: already sorted
    else:
        t = np.concatenate([p[0] for p in parts])
        o = np.concatenate([p[1] for p in parts])
        d = np.concatenate([p[2] for p in parts])
        gk = np.concatenate([p[3] for p in parts])
        sx = np.concatenate([p[4] for p in parts])
        srt = np.lexsort((o, t))       # stable: ties keep stream order
        t, o, d, gk, sx = t[srt], o[srt], d[srt], gk[srt], sx[srt]
    key_sizes_g = (np.concatenate(key_size_parts) if key_size_parts
                   else np.empty(0, np.int64))

    # ---- pass 1: effective events, residency cumsum, windowed peak -----
    eff = _effective_mask(gk, d)
    mem = np.cumsum(np.where(eff, d, 0))
    sign = d > 0
    if window is None:
        cand = eff
    else:
        cand = eff & (t >= window[0]) & (t < window[1])
    peak, peak_time, peak_idx = 0, 0.0, -1
    ci = np.flatnonzero(cand)
    if len(ci):
        cm = mem[ci]
        pmax = int(cm.max())
        if pmax > 0:              # strict `mem > peak` with peak starting 0
            j = int(ci[int(np.argmax(cm))])   # first occurrence of the max
            peak, peak_time, peak_idx = pmax, float(t[j]), j
    def timeline_fn(t=t, eff=eff, mem=mem):
        return list(zip(t[eff].tolist(), mem[eff].tolist()))

    # ---- per-job running peaks (updated at effective allocs only) ------
    per_job: Dict[str, int] = {}
    seq_list = list(seqs)
    seen_jobs: Dict[str, List[int]] = {}
    for si, seq in enumerate(seq_list):
        seen_jobs.setdefault(seq.job_id, []).append(si)
    for job_id, sis in seen_jobs.items():
        jmask = np.isin(sx, sis) if len(sis) > 1 else (sx == sis[0])
        am = jmask & eff & sign
        if am.any():
            jm = np.cumsum(np.where(jmask & eff, d, 0))
            per_job[job_id] = int(jm[am].max())

    # ---- pass 2: MPT at the peak index + LUA ---------------------------
    def peak_tensors_fn(gk=gk, sign=sign, eff=eff, peak_idx=peak_idx,
                        key_names=key_names, key_jobs=key_jobs,
                        key_sizes_g=key_sizes_g):
        if peak_idx < 0:
            return []
        P = peak_idx + 1
        kk, ss = gk[:P], sign[:P]
        last_sign = np.zeros(len(key_names), dtype=bool)
        last_sign[kk] = ss                       # last assignment wins
        ap = np.full(len(key_names), -1, dtype=np.int64)
        ii = np.flatnonzero(eff[:P] & ss)
        ap[kk[ii]] = ii                          # last effective alloc pos
        res = np.flatnonzero(last_sign)
        res = res[np.argsort(ap[res], kind="stable")]   # dict insert order
        res = res[np.argsort(-key_sizes_g[res], kind="stable")]
        return [(key_names[i], key_jobs[i], int(key_sizes_g[i]))
                for i in res.tolist()]

    lua: Dict[str, float] = {s.job_id: 0.0 for s in seqs}
    lua_found: set = set()
    for seq, off, base in bases:
        shifted = base.tua_arr + off if off else base.tua_arr
        i = int(np.searchsorted(shifted, peak_time, side="right"))
        if i:
            v = float(shifted[i - 1])
            lua[seq.job_id] = (max(lua[seq.job_id], v)
                               if seq.job_id in lua_found else v)
            lua_found.add(seq.job_id)
    return _report_cache_put(ck, PeakReport(
        peak_bytes=peak, peak_time=peak_time,
        peak_tensors_fn=peak_tensors_fn, last_input_access=lua,
        timeline_fn=timeline_fn, per_job_peak=per_job))


class WindowSweep:
    """Incremental windowed Algorithm-2 sweep for one job.

    ``PreemptiveReplanPass`` re-analyzes the remainder window
    ``[t_safe, T)`` after every candidate swap/recompute action.  Every
    event such an action adds starts at or after ``t_safe`` (the
    SwapPlanner's ``not_before`` pin), so the merged timeline's prefix
    before ``t_safe`` is invariant across steps: this class freezes the
    prefix aggregates once — per-key residency signs, running byte sum,
    effective-event timeline, MPT scatter state — and re-sweeps only the
    suffix rows per call.  Any precondition break (sequence timeline
    rebuilt, different window start, a prefix dyn event changed, a newly
    touched storage whose base release lies in the prefix) triggers a
    transparent re-freeze, so the result equals a full single-job
    ``analyze`` call byte-for-byte (the equivalence tests pin this).
    """

    def __init__(self, free_at_last_use: bool = True):
        self.falu = free_at_last_use
        self._frozen: Optional[dict] = None

    # -- prefix freeze -------------------------------------------------
    def _freeze(self, base: _JobBase, dyn: List[MemEvent], touched: set,
                dyn_pre: List[MemEvent], t0: float) -> dict:
        t, o, d, k, _rel = _merge_seq_arrays(base, dyn, touched or None)
        cut = int(np.searchsorted(t, t0, side="left"))
        n_keys = len(base.key_names)
        kp, dp = k[:cut], d[:cut]
        eff = _effective_mask(kp, dp)
        sign = dp > 0
        memcum = np.cumsum(np.where(eff, dp, 0))
        resident = np.zeros(n_keys, dtype=bool)
        resident[kp] = sign                     # last assignment wins
        ap = np.full(n_keys, -1, dtype=np.int64)
        ii = np.flatnonzero(eff & sign)
        ap[kp[ii]] = ii
        am = eff & sign
        rel_pre = base.arr_is_rel & (base.arr_t < t0)
        bidx = int(np.searchsorted(base.arr_t, t0, side="left"))
        self._frozen = {
            "base": base, "t0": t0,
            "dyn_pre": dyn_pre, "touched": set(touched),
            "cut": cut, "mem0": int(memcum[-1]) if cut else 0,
            "timeline": list(zip(t[:cut][eff].tolist(),
                                 memcum[eff].tolist())),
            "resident": resident, "ap": ap,
            "pj_max": int(memcum[am].max()) if am.any() else None,
            # storages whose base release sits in the prefix: a touched-set
            # change involving one of these rewrites the prefix
            "rel_pre": {base.key_names[i]
                        for i in np.unique(base.arr_k[rel_pre]).tolist()},
            # unfiltered base suffix rows (filtered per call)
            "bsuf": (base.arr_t[bidx:], base.arr_o[bidx:],
                     base.arr_d[bidx:], base.arr_k[bidx:],
                     base.arr_is_rel[bidx:]),
        }
        return self._frozen

    # -- per-call sweep ------------------------------------------------
    def report(self, seq: AccessSequence, plan: Optional[SchedulingPlan],
               t0: float, hi: float) -> PeakReport:
        base = _job_base(seq, self.falu)
        if plan is not None and (plan.events or plan.release_after_op):
            dyn, touched = _plan_events(seq, plan, base)
        else:
            dyn, touched = [], set()
        ncut = 0
        while ncut < len(dyn) and dyn[ncut].time < t0:
            ncut += 1
        dyn_pre, dyn_suf = dyn[:ncut], dyn[ncut:]
        fz = self._frozen
        if (fz is None or fz["base"] is not base or fz["t0"] != t0
                or fz["dyn_pre"] != dyn_pre
                or (touched != fz["touched"]
                    and (touched ^ fz["touched"]) & fz["rel_pre"])):
            fz = self._freeze(base, dyn, touched, dyn_pre, t0)

        # suffix = (touched-filtered base rows >= t0) + dyn rows >= t0,
        # merged with the same tie rules as the full sweep
        bt, bo, bd, bk, brel = fz["bsuf"]
        n_keys = len(base.key_names)
        if touched:
            tbl = np.zeros(n_keys, dtype=bool)
            tbl[[base.key_index[st] for st in touched
                 if st in base.key_index]] = True
            keep = ~(brel & tbl[bk])
            bt, bo, bd, bk = bt[keep], bo[keep], bd[keep], bk[keep]
        if dyn_suf:
            dt, do, dd, dk = _events_to_arrays(dyn_suf, base)
            pos = _insert_positions(bt, bo, dt, do)
            ts, ds = np.insert(bt, pos, dt), np.insert(bd, pos, dd)
            ks = np.insert(bk, pos, dk)
        else:
            ts, ds, ks = bt, bd, bk

        eff = _effective_mask(ks, ds, init_sign=fz["resident"],
                              n_keys=n_keys)
        sign = ds > 0
        mem = fz["mem0"] + np.cumsum(np.where(eff, ds, 0))

        def timeline_fn(fz=fz, ts=ts, eff=eff, mem=mem):
            return fz["timeline"] + list(zip(ts[eff].tolist(),
                                             mem[eff].tolist()))

        cand = eff & (ts >= t0) & (ts < hi)
        peak, peak_time, peak_loc = 0, 0.0, -1
        ci = np.flatnonzero(cand)
        if len(ci):
            cm = mem[ci]
            pmax = int(cm.max())
            if pmax > 0:
                j = int(ci[int(np.argmax(cm))])
                peak, peak_time, peak_loc = pmax, float(ts[j]), j

        def peak_tensors_fn(fz=fz, ks=ks, sign=sign, eff=eff,
                            peak_loc=peak_loc, base=base, seq=seq):
            if peak_loc < 0:
                return []
            P = peak_loc + 1
            ls = fz["resident"].copy()
            ls[ks[:P]] = sign[:P]
            ap = fz["ap"].copy()
            ii = np.flatnonzero(eff[:P] & sign[:P])
            ap[ks[ii]] = fz["cut"] + ii
            res = np.flatnonzero(ls)
            res = res[np.argsort(ap[res], kind="stable")]
            res = res[np.argsort(-base.key_sizes[res], kind="stable")]
            return [(base.key_names[i], seq.job_id,
                     int(base.key_sizes[i])) for i in res.tolist()]

        am = eff & sign
        pj: Dict[str, int] = {}
        vals = [v for v in (fz["pj_max"],
                            int(mem[am].max()) if am.any() else None)
                if v is not None]
        if vals:
            pj[seq.job_id] = max(vals)

        lua = {seq.job_id: 0.0}
        i = int(np.searchsorted(base.tua_arr, peak_time, side="right"))
        if i:
            lua[seq.job_id] = float(base.tua_arr[i - 1])
        return PeakReport(peak_bytes=peak, peak_time=peak_time,
                          peak_tensors_fn=peak_tensors_fn,
                          last_input_access=lua, timeline_fn=timeline_fn,
                          per_job_peak=pj)


def _reference_sweep(seqs: Sequence[AccessSequence],
                     plans: Optional[Dict[str, SchedulingPlan]] = None,
                     offsets: Optional[Dict[str, float]] = None,
                     window: Optional[Tuple[float, float]] = None,
                     free_at_last_use: bool = True) -> PeakReport:
    """The original per-event Algorithm-2 sweep, kept verbatim as the
    semantic reference: the equivalence tests assert ``analyze`` (the
    vectorized sweep) reproduces every PeakReport field byte-identically.
    Not on any hot path."""
    plans = plans or {}
    offsets = offsets or {}
    streams = []
    tuas: List[Tuple[float, str]] = []
    for seq in seqs:
        off = offsets.get(seq.job_id, 0.0)
        base = _job_base(seq, free_at_last_use)
        plan = plans.get(seq.job_id)
        if plan is not None and (plan.events or plan.release_after_op):
            dyn, touched = _plan_events(seq, plan, base)
        else:
            dyn, touched = [], set()
        streams.append(_offset_iter(base.fixed, off))
        if touched:
            streams.append(_offset_iter(
                (e for e in base.releases if e.storage not in touched), off))
        else:
            streams.append(_offset_iter(base.releases, off))
        if dyn:
            streams.append(_offset_iter(dyn, off))
        tuas.extend((t + off, seq.job_id) for t in base.tua_times)
    events = list(heapq.merge(*streams, key=_ekey))
    tuas.sort()

    # --- pass 1: find the peak index (no snapshots: snapshotting/sorting
    # the resident set at every running peak was O(n²) and dominated the
    # scheduler's runtime on DenseNet-scale graphs) -----------------------
    resident: Dict[Tuple[str, str], int] = {}
    mem = 0
    peak, peak_time, peak_idx = 0, 0.0, -1
    timeline: List[Tuple[float, int]] = []
    per_job: Dict[str, int] = {}
    job_mem: Dict[str, int] = {}

    for i, ev in enumerate(events):
        key = (ev.job_id, ev.storage)
        if ev.delta > 0:
            if key in resident:
                continue  # already resident (idempotent alloc)
            resident[key] = ev.delta
            mem += ev.delta
            jm = job_mem.get(ev.job_id, 0) + ev.delta
            job_mem[ev.job_id] = jm
            if jm > per_job.get(ev.job_id, 0):
                per_job[ev.job_id] = jm
        else:
            if key not in resident:
                continue  # already freed (idempotent free)
            sz = resident.pop(key)
            mem -= sz
            job_mem[ev.job_id] = job_mem.get(ev.job_id, 0) - sz
        timeline.append((ev.time, mem))
        in_window = window is None or (window[0] <= ev.time < window[1])
        if in_window and mem > peak:
            peak, peak_time, peak_idx = mem, ev.time, i

    # --- pass 2: replay to the peak index, reconstruct MPT + LUA once ----
    resident.clear()
    for ev in events[:peak_idx + 1]:
        key = (ev.job_id, ev.storage)
        if ev.delta > 0:
            resident.setdefault(key, ev.delta)
        else:
            resident.pop(key, None)
    peak_resident = sorted(
        ((st, j, sz) for (j, st), sz in resident.items()),
        key=lambda x: -x[2])
    lua: Dict[str, float] = {s.job_id: 0.0 for s in seqs}
    for t, j in tuas:
        if t > peak_time:
            break
        lua[j] = t
    return PeakReport(peak_bytes=peak, peak_time=peak_time,
                      peak_tensors=peak_resident, last_input_access=lua,
                      timeline=timeline, per_job_peak=per_job)


def vanilla_peak(seq: AccessSequence, free_at_last_use: bool = False) -> int:
    """Peak with no scheduling at all — the paper's vanilla group (VMP):
    on the paper's platform nothing is freed until the iteration ends."""
    return analyze([seq], free_at_last_use=free_at_last_use).peak_bytes


def unroll(seq: AccessSequence, n_iters: int = 2) -> AccessSequence:
    """Unroll `n_iters` iterations of a job into one sequence.

    Persistent tensors (params, optimizer state, and updated-parameter
    aliases) keep their identity across iterations; activations, gradients
    and inputs become per-iteration instances (``tid~k``).
    """
    from .access import Operator  # local import to avoid cycles

    def persists(spec: TensorSpec) -> bool:
        return spec.kind in PERSISTENT_KINDS or spec.updates is not None

    ops: List[Operator] = []
    tensors: Dict[str, TensorSpec] = {}
    n_ops = len(seq.operators)

    def rename(tid: str, k: int) -> str:
        spec = seq.tensors.get(tid)
        if spec is None or persists(spec):
            return tid
        return f"{tid}~{k}"

    for k in range(n_iters):
        for op in seq.operators:
            ops.append(Operator(
                idx=k * n_ops + op.idx, name=op.name,
                inputs=tuple(rename(t, k) for t in op.inputs),
                outputs=tuple(rename(t, k) for t in op.outputs),
                latency=op.latency, flops=op.flops,
                bytes_accessed=op.bytes_accessed, phase=op.phase,
                params=op.params, job_id=op.job_id))
        for tid, spec in seq.tensors.items():
            new_id = rename(tid, k)
            if new_id in tensors:
                continue
            tensors[new_id] = dataclasses.replace(spec, tid=new_id)
    initial = [rename(t, 0) for t in seq.initial_resident]
    out = AccessSequence(seq.job_id, ops, tensors, initial_resident=initial)
    return out
