"""Tensor-access data model (paper §III).

A *job* is a static compute graph G(V, E): operators V manipulating tensors E.
A *workload* / *Tensor Access Sequence* (TAS) is the topologically ordered
sequence of tensor accesses; each operator contributes Tensor Using Accesses
(TUA) for its inputs at its start and Tensor Generating Accesses (TGA) for its
outputs at its end.  Times on the sequence come from the cost model and are
re-estimated as measured latencies drift (paper §IV-E).

A copy of the JAX package's ``core/access.py`` (which imports no JAX),
kept in step with it; the port's tests hold the two to the same
results.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


class AccessType(enum.Enum):
    TGA = "TGA"  # tensor generating access (producer finishes -> tensor exists)
    TUA = "TUA"  # tensor using access (consumer starts -> tensor must be resident)


class Phase(enum.Enum):
    FB = "fb"    # forward/backward propagation phase
    OPT = "opt"  # optimizer phase (paper Fig. 1)


class TensorKind(enum.Enum):
    INPUT = "input"            # model inputs (placeholder TGA, paper §III-A)
    PARAM = "param"            # trainable parameter
    OPT_STATE = "opt_state"    # optimizer interim tensors (Adam moments)
    ACTIVATION = "activation"  # interim results of the F/B phase
    GRAD = "grad"
    OUTPUT = "output"          # job outputs (loss, new params...)


@dataclasses.dataclass
class TensorSpec:
    """A tensor in E, identified by the producing var name."""

    tid: str
    size_bytes: int
    shape: Tuple[int, ...] = ()
    dtype: str = "float32"
    kind: TensorKind = TensorKind.ACTIVATION
    job_id: str = "job0"
    # The paper treats an updated parameter as a logically-new tensor that
    # aliases the old parameter's storage; `updates` names the tensor whose
    # storage this one reuses (new_param.updates == old_param.tid).
    updates: Optional[str] = None

    def __post_init__(self):
        self.size_bytes = int(self.size_bytes)

    @property
    def is_updated_param(self) -> bool:
        return self.updates is not None


@dataclasses.dataclass
class Operator:
    """A node in V.  `latency` is (re-)estimated by the cost model."""

    idx: int
    name: str
    inputs: Tuple[str, ...]
    outputs: Tuple[str, ...]
    latency: float = 0.0
    flops: float = 0.0
    bytes_accessed: float = 0.0
    phase: Phase = Phase.FB
    params: Dict[str, object] = dataclasses.field(default_factory=dict)
    job_id: str = "job0"


@dataclasses.dataclass
class TensorAccess:
    """One access a_j^i on the sequence (paper §III-A)."""

    tensor_id: str
    op_idx: int
    access_type: AccessType
    time: float = 0.0       # trigger instant (TUA: op start; TGA: op end)
    end_time: float = 0.0   # when the access stops pinning the tensor
    job_id: str = "job0"
    # ordinal of this access among the tensor's accesses (0 == its TGA)
    seq_index: int = 0

    @property
    def is_tga(self) -> bool:
        return self.access_type is AccessType.TGA


_SEQ_SERIAL = [0]


class AccessSequence:
    """A workload: operators in topological order + derived access timeline."""

    def __init__(self, job_id: str, operators: Sequence[Operator],
                 tensors: Dict[str, TensorSpec],
                 initial_resident: Optional[Iterable[str]] = None):
        _SEQ_SERIAL[0] += 1
        self.serial = _SEQ_SERIAL[0]   # unique cache identity (id() recycles)
        self.job_id = job_id
        self.operators: List[Operator] = list(operators)
        self.tensors: Dict[str, TensorSpec] = dict(tensors)
        # Tensors in device memory at iteration start (paper Alg 2 line 1):
        # model inputs + parameters not swapped out from the last iteration.
        if initial_resident is None:
            initial_resident = [t.tid for t in tensors.values()
                                if t.kind in (TensorKind.INPUT, TensorKind.PARAM,
                                              TensorKind.OPT_STATE)]
        self.initial_resident: List[str] = list(initial_resident)
        self.accesses: List[TensorAccess] = []
        self.accesses_by_tensor: Dict[str, List[TensorAccess]] = {}
        self.op_start: List[float] = []
        self.op_end: List[float] = []
        self.iteration_time: float = 0.0
        self.rebuild_timeline()

    # ------------------------------------------------------------------
    _timeline_version: int = 0

    def rebuild_timeline(self, start_time: float = 0.0) -> None:
        """Recompute op start/end instants and the TAS from `Operator.latency`.

        Jobs execute their operators sequentially in topological order
        (paper §III-A: "the framework executes the operators of W_j in
        topological order").
        """
        self.op_start, self.op_end = [], []
        t = start_time
        for op in self.operators:
            self.op_start.append(t)
            t += max(op.latency, 0.0)
            self.op_end.append(t)
        self.iteration_time = t - start_time

        accesses: List[TensorAccess] = []
        for op in self.operators:
            for tid in op.inputs:
                if tid in self.tensors:
                    accesses.append(TensorAccess(
                        tensor_id=tid, op_idx=op.idx, access_type=AccessType.TUA,
                        time=self.op_start[op.idx], end_time=self.op_end[op.idx],
                        job_id=self.job_id))
            for tid in op.outputs:
                if tid in self.tensors:
                    accesses.append(TensorAccess(
                        tensor_id=tid, op_idx=op.idx, access_type=AccessType.TGA,
                        time=self.op_end[op.idx], end_time=self.op_end[op.idx],
                        job_id=self.job_id))
        accesses.sort(key=lambda a: (a.time, a.access_type is AccessType.TUA,
                                     a.op_idx))
        by_tensor: Dict[str, List[TensorAccess]] = {}
        for a in accesses:
            by_tensor.setdefault(a.tensor_id, []).append(a)
        for tid, accs in by_tensor.items():
            accs.sort(key=lambda a: (a.time, not a.is_tga))
            for i, a in enumerate(accs):
                a.seq_index = i
        self.accesses = accesses
        self.accesses_by_tensor = by_tensor
        self._timeline_version = getattr(self, "_timeline_version", 0) + 1

    # ------------------------------------------------------------------
    def set_latencies(self, latencies: Sequence[float]) -> None:
        assert len(latencies) == len(self.operators)
        for op, lat in zip(self.operators, latencies):
            op.latency = float(lat)
        self.rebuild_timeline()

    def tensor_accesses(self, tid: str) -> List[TensorAccess]:
        return self.accesses_by_tensor.get(tid, [])

    def last_access(self, tid: str) -> Optional[TensorAccess]:
        accs = self.tensor_accesses(tid)
        return accs[-1] if accs else None

    def first_tua(self, tid: str) -> Optional[TensorAccess]:
        for a in self.tensor_accesses(tid):
            if not a.is_tga:
                return a
        return None

    def first_tua_after(self, tid: str, time: float) -> Optional[TensorAccess]:
        for a in self.tensor_accesses(tid):
            if not a.is_tga and a.time >= time - 1e-12:
                return a
        return None

    def tga(self, tid: str) -> Optional[TensorAccess]:
        for a in self.tensor_accesses(tid):
            if a.is_tga:
                return a
        return None

    # ------------------------------------------------------------------
    def clone(self, job_id: str) -> "AccessSequence":
        """Deep-enough copy under a new job id (multi-job benchmarks reuse
        one traced workload without re-tracing)."""
        ops = [dataclasses.replace(op, job_id=job_id)
               for op in self.operators]
        tensors = {tid: dataclasses.replace(t, job_id=job_id)
                   for tid, t in self.tensors.items()}
        return AccessSequence(job_id, ops, tensors,
                              initial_resident=list(self.initial_resident))

    # ------------------------------------------------------------------
    def total_tensor_bytes(self) -> int:
        return sum(t.size_bytes for t in self.tensors.values())

    def activity_analysis(self) -> Dict[str, int]:
        """Last-use op index per tensor (release point; paper Alg 3 line 2).

        Cached per timeline version — the engine's JobContext and the
        planning passes each re-derive it on every (re)plan, and the
        result only changes when the timeline is rebuilt.  Callers treat
        the returned dict as read-only."""
        cached = getattr(self, "_activity_cache", None)
        if cached is not None and cached[0] == self._timeline_version:
            return cached[1]
        last_use: Dict[str, int] = {}
        for a in self.accesses:
            last_use[a.tensor_id] = max(last_use.get(a.tensor_id, -1), a.op_idx)
        self._activity_cache = (self._timeline_version, last_use)
        return last_use

    def __len__(self) -> int:
        return len(self.operators)

    def __repr__(self) -> str:  # pragma: no cover
        return (f"AccessSequence({self.job_id}, ops={len(self.operators)}, "
                f"tensors={len(self.tensors)}, "
                f"iter={self.iteration_time * 1e3:.2f}ms, "
                f"bytes={self.total_tensor_bytes() / 2**20:.1f}MiB)")


def format_bytes(n: float) -> str:
    if n <= 0:
        return "0B"
    units = ["B", "KiB", "MiB", "GiB", "TiB"]
    k = min(int(math.log(n, 1024)), len(units) - 1)
    return f"{n / 1024 ** k:.2f}{units[k]}"
