"""Interpreting Executor (paper §III-D: Executor + Swap Executor) for
captured aten graphs.

The counterpart of the JAX package's ``JaxprExecutor``: runs a graph from
``core.graph_capture.capture`` node by node against the shared
MemoryEngine.  The engine's DeviceLedger does the byte-exact residency
accounting, its DmaChannel serializes transfers, and its JobContext supplies
every residency *decision* (when a planned event applies, when an operand
needs a passive swap-in or a recompute, when a tensor auto-releases) -- the
rules the discrete-event simulator runs, so a simulated and a real run of a
plan agree by construction (peak bytes and decision trace in sync mode).

The data path is real: a swapped-out storage is copied to pinned host
memory and dropped from the device store; a swap-in copies it back; a
recompute replays the producer node.  Compressed events go through the
quantize/dequantize kernels (``kernels/offload_quant``): a swap-out is one
quantize launch that writes the int8 rows and scales into one packed pinned
host buffer, a swap-in one dequantize launch that reads them from it into
the device value (no staging on the card, no separate copies; a packed
buffer above ``ZERO_COPY_MAX_BYTES`` is first copied to the card whole,
since the copy engine moves large buffers faster than a kernel reads
them).  A host buffer that leaves the store is kept alive until every
launch queued before it left has completed (``_hold``): PyTorch's caching
host allocator sees copies, not kernels.  Both stores are keyed by
**storage id**: an updated parameter aliases the old parameter's storage
(paper §IV-B situation 2).  A view is rebuilt from its base at each use
(the TAS names only storage owners).

Two swap modes:
  * sync  -- each swap runs inline at its trigger, on the compute stream
             (parity with ``simulate(transfer_mode="sync")``).
  * async -- swaps go onto one CUDA copy stream, the channel (paper
             Fig. 4).  The transfers one operator triggers are issued
             together after its events, same-direction runs of up to
             ``MAX_BATCH`` as one channel hold; the copy stream first waits
             for the compute stream, so a transfer starts when its trigger
             op has finished.  A swap-out's device copy is retired (ledger
             free, dropped) at the first poll point where its event has
             completed, never before; one that leaves the store earlier
             (released, or replaced by an update) stays booked under
             ``ON_WIRE`` until then.  A prefetch is awaited on the device
             (``wait_event``) before its consumer.  The host thread runs at
             most ``RUN_AHEAD`` operators ahead of the card, so poll points
             see completions near the time the plan expects them.
On a CPU device the copy "stream" is the host itself: async transfers run
at issue and complete at once.  Several executors may share one copy stream
(``copy_stream``; the multi-job ``GlobalController`` gives every job the
device channel's stream), so the card orders all jobs' transfers as the
one channel books them.

Mid-iteration plan hot-swap (preemptive arbitration): ``request_plan``
hands a plan and its eligible safe points to a running executor; the run
splices it in right after the plan events of the first eligible operator,
when none of its prefetches is on the wire (queued prefetches not yet
issued to the copy stream are cancelled, ``cancel_unstarted``, and their
consumers swap in passively) and its own swap-outs have landed.

Budget guard (``budget_bytes``: the job's slice, which the multi-job
controller passes when built with ``hold_slices=True``): the planner can
return a plan above the slice, a plan is certified by the planner's model,
whose clock is the operators' estimated latencies, and a first iteration
starts with every input on the device where the plan's steady state parks
some.  Before any booking that would take the job over its slice (an
operator's inputs and results, with the producers' inputs of what it
recomputes; a planned prefetch or recompute; an input, a constant or an
output brought back), the executor waits for its swap-outs already on the
wire to land, then swaps out resident storages itself, the one read again
last first (a storage whose prefetch has been issued is waited for first);
their readers swap them in passively.  A planned prefetch or recompute
that still does not fit is left to its reader; what an operator must hold
at once that does not fit raises ``BudgetExceededError``.  Swaps copy, so
the values never change; without a budget nothing of this runs.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import operator
import statistics
import threading
import time as _time
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import torch
import torch.utils._pytree as pytree
from torch.fx.node import map_arg

from ..device import resolve_device
from ..kernels.offload_quant import (dequantize_blocked, packed_bytes,
                                     packed_views, quantize_blocked)
from .access import AccessSequence
from .engine import (INPUT_AWAIT_PREFETCH, INPUT_PASSIVE_SWAP_IN,
                     INPUT_RESIDENT, DeviceLedger, DmaChannel, MemoryEngine,
                     ResidencyView)
from .cost_model import CostModel
from .graph_capture import capture, graph_layout
from .plan import EventType, SchedulingPlan
from .telemetry import TelemetryHub


@dataclasses.dataclass
class ExecutionStats:
    peak_bytes: int = 0
    wall_time_s: float = 0.0
    swap_out_count: int = 0
    swap_in_count: int = 0
    passive_swap_ins: int = 0
    recompute_count: int = 0
    compressed_swaps: int = 0
    op_latencies: Optional[List[float]] = None
    stall_time_s: float = 0.0
    # mid-iteration plan hot-swaps applied at a safe point
    hot_swaps: int = 0
    # queued (never issued) prefetches cancelled when a hot-swap revised
    # the swap-ins already booked on the channel
    canceled_swap_ins: int = 0
    # measured per-job residency timeline of THIS iteration, (t, bytes)
    # in hub time -- filled from the TelemetryHub when one is attached
    residency_timeline: Optional[List[tuple]] = None
    # budget guard: times the run waited for its swap-outs on the wire so
    # that a booking kept within ``budget_bytes``, the seconds waited, and
    # the storages it swapped out itself (counted in swap_out_count too)
    budget_waits: int = 0
    budget_wait_s: float = 0.0
    budget_evictions: int = 0
    # planned prefetches and recomputes the guard left to their readers
    # because they did not fit the budget
    budget_skips: int = 0


class BudgetExceededError(RuntimeError):
    """The budget guard cannot keep a job within ``budget_bytes``: what
    one operator must hold at once does not fit, even with everything
    else swapped out."""


# A compressed swap-in whose packed buffer holds at most this many bytes
# is read over the link by the dequantize kernel itself; a larger one is
# first copied to the card by the copy engine, whose rate per byte is
# higher and steadier (on the H100 the routes cross between 1.06 and
# 2.1 MB of packed buffer: PERF.md, section 6).
ZERO_COPY_MAX_BYTES = 1 << 20
# the ledger key of a device copy that left the store (released, or
# replaced by an aliased update) while its swap-out was still on the wire
ON_WIRE = "on-wire:"


def empty_unfilled(size, stride, dtype: torch.dtype,
                   device: Any = "cpu", pin: bool = False) -> torch.Tensor:
    """Memory (pinned with ``pin``) for a swap that writes every byte of it
    before anything reads it (a ``copy_``, or the quantize kernel filling
    a packed buffer).  Under deterministic algorithms ``torch.empty``
    fills new memory with NaN: on the host at memset speed (milliseconds
    for tens of MB), on a card as one more kernel.  Nothing would read
    that fill, so it is switched off for this one allocation."""
    det = torch.utils.deterministic
    fill = det.fill_uninitialized_memory
    det.fill_uninitialized_memory = False
    try:
        return torch.empty_strided(size, stride, dtype=dtype, device=device,
                                   pin_memory=pin)
    finally:
        det.fill_uninitialized_memory = fill


def fetch_packed(q: torch.Tensor, s: torch.Tensor, meta,
                 out: torch.Tensor, copy: Optional[bool] = None
                 ) -> torch.Tensor:
    """Dequantize a compressed host copy (``q``, ``s``: views of one
    pinned packed buffer) into ``out`` on a card, on the current stream:
    one kernel reading the buffer over the link, or, for a buffer of more
    than ZERO_COPY_MAX_BYTES, one copy of it to the card and then the
    kernel.  ``copy`` forces a route (to measure the rule)."""
    nbytes = q.numel() + 4 * s.numel()
    if copy is None:
        copy = nbytes > ZERO_COPY_MAX_BYTES
    if copy:
        card = empty_unfilled((nbytes,), (1,), torch.int8, out.device)
        card.copy_(q.as_strided((nbytes,), (1,)), non_blocking=True)
        q, s = packed_views(card, q.shape[0])
    return dequantize_blocked(q, s, meta, out=out)


@dataclasses.dataclass
class HostCopy:
    """A storage parked on the host: the tensor itself (same shape and
    strides), or its int8 rows, scales and quantize meta (the rows and
    scales as views of one packed buffer)."""
    data: Any
    size: Tuple[int, ...]
    stride: Tuple[int, ...]
    dtype: torch.dtype
    compressed: bool


class Transfer:
    """One queued or issued copy; ``event`` marks its end on the copy
    stream (None on a CPU device, where it completes at issue)."""

    def __init__(self, key: str, fn: Callable[[], None]):
        self.key = key
        self.fn = fn
        self.issued = False
        self.event: Optional[torch.cuda.Event] = None

    def done(self) -> bool:
        return self.issued and (self.event is None or self.event.query())


class AsyncSwapExecutor:
    """Paper Fig. 4 on a CUDA card: one copy stream is the channel.
    ``submit`` queues a transfer; ``flush`` issues the queue onto the
    stream behind an event of the compute stream, each same-direction run
    of up to ``MAX_BATCH`` as one ``channel.transfer_batch`` hold, and
    records ``batches`` (the keys of each launch).  ``stream`` is the copy
    stream to issue on (a new one by default)."""

    MAX_BATCH = 8

    def __init__(self, channel: DmaChannel, device: torch.device,
                 stream: Optional["torch.cuda.Stream"] = None):
        self.channel = channel
        self.device = device
        self.stream = None
        if device.type == "cuda":
            self.stream = stream or torch.cuda.Stream(device)
        self.queue: List[Transfer] = []
        self.inflight: Dict[str, Transfer] = {}
        self.batches: List[List[str]] = []

    @staticmethod
    def _direction(key: str) -> str:
        return key.split(":", 1)[0]

    def submit(self, key: str, fn: Callable[[], None]) -> Transfer:
        t = Transfer(key, fn)
        self.queue.append(t)
        self.inflight[key] = t
        return t

    def _issue(self, t: Transfer, ready) -> None:
        if self.stream is None:
            t.fn()
        else:
            with torch.cuda.stream(self.stream):
                self.stream.wait_event(ready)
                t.fn()
                t.event = self.stream.record_event()
        t.issued = True

    def flush(self) -> None:
        if not self.queue:
            return
        ready = (torch.cuda.current_stream(self.device).record_event()
                 if self.stream is not None else None)
        queue, self.queue = self.queue, []
        i = 0
        while i < len(queue):
            d = self._direction(queue[i].key)
            j = i + 1
            while (j < len(queue) and j - i < self.MAX_BATCH
                   and self._direction(queue[j].key) == d):
                j += 1
            batch = queue[i:j]
            if len(batch) == 1:
                self.channel.transfer(lambda t=batch[0]: self._issue(t, ready))
            else:
                self.channel.transfer_batch(
                    [lambda t=t: self._issue(t, ready) for t in batch])
            self.batches.append([t.key for t in batch])
            i = j

    def cancel_unstarted(self, prefix: str = "") -> Optional[List[str]]:
        """Cancel every transfer whose key starts with ``prefix`` that has
        not started: still in the queue, never issued to the copy stream.
        Returns None, cancelling nothing, when a matching transfer is on
        the wire (issued, its event not yet reached: the caller must
        defer), else the cancelled keys.  A consumer of a cancelled
        prefetch finds no transfer in flight and swaps in passively
        (``FxExecutor._ensure_input``)."""
        if any(t.issued and not t.done() for k, t in self.inflight.items()
               if k.startswith(prefix)):
            return None
        cancelled = [t.key for t in self.queue if t.key.startswith(prefix)]
        self.queue = [t for t in self.queue
                      if not t.key.startswith(prefix)]
        for k in cancelled:
            self.inflight.pop(k, None)
        return cancelled

    def wait(self, key: str) -> None:
        """Order the compute stream after transfer ``key`` (device-side;
        the host does not block) and forget it."""
        t = self.inflight.pop(key, None)
        if t is None:
            return
        if not t.issued:
            self.flush()
        if t.event is not None:
            torch.cuda.current_stream(self.device).wait_event(t.event)

    def drain(self) -> None:
        """Issue everything queued and block until every copy has landed."""
        self.flush()
        for t in self.inflight.values():
            if t.event is not None:
                t.event.synchronize()
        self.inflight.clear()


class FxExecutor:
    RUN_AHEAD = 8

    def __init__(self, graph_module: torch.fx.GraphModule,
                 seq: AccessSequence,
                 plan: Optional[SchedulingPlan] = None,
                 accountant: Optional[DeviceLedger] = None,
                 channel: Optional[DmaChannel] = None,
                 async_swap: bool = False,
                 measure_latency: bool = False,
                 host_resident_inputs: Optional[Set[str]] = None,
                 engine: Optional[MemoryEngine] = None,
                 telemetry: Optional[TelemetryHub] = None,
                 copy_stream: Optional["torch.cuda.Stream"] = None,
                 budget_bytes: Optional[int] = None):
        self.gm = graph_module
        self.layout = graph_layout(graph_module)
        self.seq = seq
        self.plan = plan
        if len(self.layout.ops) != len(seq.operators):
            raise ValueError(f"graph has {len(self.layout.ops)} operators, "
                             f"sequence {len(seq.operators)}")
        self.engine = engine or MemoryEngine(ledger=accountant,
                                             channel=channel)
        if telemetry is not None:
            self.engine.attach_telemetry(telemetry)
        self.telemetry = self.engine.telemetry
        self.ctx = self.engine.add_job(seq, plan)
        self.accountant = self.engine.ledger
        self.channel = self.engine.channel
        self.async_swap = async_swap
        self.async_exec: Optional[AsyncSwapExecutor] = None
        self.copy_stream = copy_stream
        # the job's slice of the device: before a booking would take the
        # job over it, the swap-outs already on the wire are waited for,
        # then resident storages swapped out (``_hold_budget``); None (the
        # default) never waits and never swaps out what the plan keeps
        self.budget_bytes = budget_bytes
        # storages the guard swapped out: their host copies go stale when
        # the value is written again or dies (``_forget_evicted``)
        self._evicted: Set[str] = set()
        self._reads: Optional[Dict[str, List[int]]] = None
        self.measure_latency = measure_latency
        # storages whose *input* value starts on host (previous iteration's
        # cross-iteration swap-out; paper Fig. 1(c) steady state)
        self.host_resident_inputs: Set[str] = set(host_resident_inputs or ())

        self.device: Dict[str, torch.Tensor] = {}
        self.host: Dict[str, HostCopy] = {}
        # async swap-outs not yet retired: storage -> (transfer,
        # compressed, the device tensor being copied)
        self._pending_out: Dict[str, Tuple[Transfer, bool,
                                           torch.Tensor]] = {}
        # host copies gone from the store that a queued launch may still
        # read or write: (events marking the streams' queues, the copy)
        self._held: List[Tuple[List[torch.cuda.Event], Any]] = []
        # decisions consult THIS iteration's value store
        self.resident = ResidencyView(self.device)
        self.producer: Dict[str, int] = {}
        for i, node in enumerate(self.layout.ops):
            for _, o in self.layout.results[node]:
                self.producer[self.layout.tid[o]] = i
        self.stats = ExecutionStats(
            op_latencies=[] if measure_latency else None)
        self._cur_idx = -1
        self._borrowed: Set[int] = set()
        self.dev: Optional[torch.device] = None
        self._compute = None          # the compute stream on a CUDA card
        # pending mid-iteration plan hot-swap: (plan, eligible safe ops),
        # set by the controller's thread, consumed at a safe point in run
        self._plan_lock = threading.Lock()
        self._pending_plan: Optional[Tuple[SchedulingPlan,
                                           frozenset]] = None

    # ------------------------------------------------------------------
    @property
    def current_op_index(self) -> int:
        """Index of the operator being executed (-1 before the first): the
        controller reads it to pick a safe point still ahead of the run
        when it requests a plan hot-swap."""
        return self._cur_idx

    def request_plan(self, plan: SchedulingPlan, safe_ops) -> None:
        """Thread-safe mid-iteration plan hot-swap request.  The plan is
        spliced in at the next operator in ``safe_ops`` the run reaches
        with no transfer of this job on the wire.  A later request
        supersedes an unapplied earlier one; if no listed safe point
        remains this iteration, the request never fires (the controller's
        boundary plan covers it)."""
        with self._plan_lock:
            self._pending_plan = (plan, frozenset(safe_ops))

    def _maybe_hot_swap(self, idx: int) -> None:
        """Splice the pending plan in if operator ``idx`` is an eligible
        safe point: on the executor's thread, right after the operator's
        plan events and before its transfers are issued, the simulator's
        splice instant.  Prefetches this job queued and has not issued are
        cancelled (the new plan books again what it needs; a consumer of a
        cancelled prefetch swaps in passively); one on the wire defers the
        splice to the next safe point and cancels nothing.  The job's own
        swap-outs are then issued and waited for, so the plan changes over
        a quiescent job."""
        if self._pending_plan is None:
            return
        with self._plan_lock:
            if self._pending_plan is None:
                return
            plan, safe_ops = self._pending_plan
            if idx not in safe_ops:
                return
            cancelled: List[str] = []
            if self.async_exec is not None:
                cancelled = self.async_exec.cancel_unstarted("in:")
                if cancelled is None:
                    return
            self._poll_swap_outs(block=True)
            self.stats.canceled_swap_ins += len(cancelled)
            self.plan = plan
            self.ctx.set_plan(plan)
            self.stats.hot_swaps += 1
            self._pending_plan = None
            rec = self.engine.recorder
            if rec is not None:
                t = self.telemetry.now() if self.telemetry is not None \
                    else 0.0
                rec.instant("hot_swap", t, job_id=self.ctx.job_id,
                            site="safe-point", op_idx=idx)

    # ------------------------------------------------------------------
    def _st(self, tid: str) -> str:
        return self.ctx.st(tid)

    def _put_device(self, tid: str, val: torch.Tensor) -> None:
        st = self._st(tid)
        if st in self.device:
            if self.device[st] is not val:
                self._book_on_wire(st)
            self.device[st] = val  # in-place overwrite (aliased update)
            return
        self.device[st] = val
        self.accountant.alloc(self.ctx.job_id, st, self.ctx.sizes.get(
            st, val.numel() * val.element_size()))

    def _drop_storage(self, st: str) -> None:
        if st in self.device:
            if self.async_exec is not None:
                # a prefetch into this storage may still be on the wire
                self.async_exec.wait("in:" + st)
            self._book_on_wire(st)
            self.device.pop(st)
            self.accountant.free(self.ctx.job_id, st)

    def _book_on_wire(self, st: str) -> None:
        """The device value of ``st`` leaves the store while its swap-out
        reads it on the copy stream: the pending swap-out holds that memory
        until its copy lands, so the ledger keeps its bytes (under
        ``ON_WIRE``) until ``_retire_out``."""
        pending = self._pending_out.get(st)
        if pending is not None and pending[2] is self.device[st]:
            self.accountant.alloc(self.ctx.job_id, ON_WIRE + st,
                                  self.accountant.resident_bytes(
                                      self.ctx.job_id, st))

    def _value(self, n: torch.fx.Node) -> Any:
        """The value of graph node ``n``: an owner's from the device store,
        a view's rebuilt from its base."""
        lay = self.layout
        o = lay.owner[n]
        if o is n:
            st = self._st(lay.tid[n])
            if st not in self.device:
                raise KeyError(f"{n.name} ({st}) is not on the device")
            return self.device[st]
        if n.target is operator.getitem:
            return self._value(n.args[0])[n.args[1]]
        return n.target(*map_arg(n.args, self._value),
                        **map_arg(n.kwargs, self._value))

    def _eval(self, node: torch.fx.Node) -> Any:
        return node.target(*map_arg(node.args, self._value),
                           **map_arg(node.kwargs, self._value))

    def _eval_into(self, node: torch.fx.Node, idx: int) -> Any:
        """Run a compute node.  A single result that updates a storage in
        place (an aliased parameter or moment) is written through the op's
        ``out`` form into the device tensor it replaces, when the op reads
        no view of that storage and no copy is in flight on it: the old
        and the new value then never coexist, as the ledger counts them
        (JAX's donated buffers).  Tensors given to ``run`` (not donated)
        are never written."""
        res = self.layout.results[node]
        if len(res) == 1 and res[0][0] is None:
            tid = self.layout.tid[res[0][1]]
            st = self._st(tid)
            old = self.device.get(st)
            out_op = _out_overload(node.target) if st != tid else None
            if (out_op is not None and old is not None
                    and id(old) not in self._borrowed
                    and st not in self._pending_out
                    and not (self.async_exec is not None
                             and "in:" + st in self.async_exec.inflight)
                    and self._may_overwrite(node, idx, st)):
                val = node.meta.get("val")
                if (isinstance(val, torch.Tensor) and old.shape == val.shape
                        and old.dtype == val.dtype and old.is_contiguous()):
                    op, pos, kw = out_op
                    bound = _bind(node, map_arg(node.args, self._value),
                                  map_arg(node.kwargs, self._value))
                    return op(*(bound[n] for n in pos if n in bound),
                              **{n: bound[n] for n in kw if n in bound},
                              out=old)
        return self._eval(node)

    def _may_overwrite(self, node: torch.fx.Node, idx: int, st: str) -> bool:
        """The op may write storage ``st`` while reading it only if it is
        pointwise and reads ``st`` as the very tensor it writes (no view:
        the same element is read, then written)."""
        if all(self._st(t) != st for t in self.seq.operators[idx].inputs):
            return True
        if torch.Tag.pointwise not in getattr(node.target, "tags", ()):
            return False
        lay = self.layout
        return all(lay.owner[a] is a for a in node.all_input_nodes
                   if a in lay.owner
                   and self._st(lay.tid[lay.owner[a]]) == st)

    # ------------------------------------------------------------------
    def _host_put(self, st: str, copy: HostCopy) -> None:
        self._hold(self.host.get(st))
        self.host[st] = copy
        self.ctx.host.add(st)
        if copy.compressed:
            self.ctx.host_compressed.add(st)
        else:
            self.ctx.host_compressed.discard(st)

    def _hold(self, rec: Optional[HostCopy]) -> None:
        """Keep ``rec``, just dropped from the host store, alive until what
        the compute and copy streams have queued so far has run: a kernel
        may still read or write its pinned memory, and the caching host
        allocator would hand that memory out again at once."""
        if rec is None or not self._pinned():
            return
        streams = [self._compute]
        if self.async_exec is not None:
            streams.append(self.async_exec.stream)
        self._held.append(([s.record_event() for s in streams], rec))

    def _release_held(self) -> None:
        self._held = [h for h in self._held
                      if not all(e.query() for e in h[0])]

    def _pinned(self) -> bool:
        return self.dev is not None and self.dev.type == "cuda"

    def _to_host(self, val: torch.Tensor, compressed: bool) -> HostCopy:
        """Copy a device tensor to new host memory, on the current stream
        (pinned and without blocking on a CUDA card).  A compressed copy is
        one quantize launch into a packed buffer."""
        pin = self._pinned()
        if compressed:
            buf = empty_unfilled((packed_bytes(val.numel()),), (1,),
                                 torch.int8, pin=pin)
            data: Any = quantize_blocked(val, out=buf)
        else:
            data = empty_unfilled(val.size(), val.stride(), val.dtype,
                                  pin=pin)
            data.copy_(val, non_blocking=pin)
        return HostCopy(data, tuple(val.size()), tuple(val.stride()),
                        val.dtype, compressed)

    def _host_input(self, val: torch.Tensor) -> HostCopy:
        """A host-resident input as a host copy: a host tensor as it is
        (pinned first on a CUDA card), a device tensor copied."""
        if val.device.type != "cpu":
            return self._to_host(val, compressed=False)
        if self._pinned() and not val.is_pinned():
            val = val.pin_memory()
        return HostCopy(val, tuple(val.size()), tuple(val.stride()),
                        val.dtype, False)

    def _host_fetch(self, st: str) -> torch.Tensor:
        """Materialize a device value from the host store on the current
        stream, into memory allocated on the compute stream (a compressed
        copy through the dequantize kernel, ``fetch_packed`` on a card)."""
        rec = self.host[st]
        pending = self._pending_out.get(st)
        if pending is not None and pending[0].event is not None:
            # the swap-out's copy to the host may still be on the copy
            # stream (the device copy was released before it landed): a
            # passive fetch on the compute stream must read after it
            torch.cuda.current_stream(self.dev).wait_event(pending[0].event)
        if self._compute is not None:
            with torch.cuda.stream(self._compute):
                dst = torch.empty_strided(rec.size, rec.stride,
                                          dtype=rec.dtype, device=self.dev)
            cur = torch.cuda.current_stream(self.dev)
            if cur != self._compute:
                # written on the copy stream: however the store drops it,
                # the allocator must not hand it out before the write
                dst.record_stream(cur)
                # and the write must land after whatever the allocation
                # queued on the compute stream: under deterministic
                # algorithms ``empty_strided`` fills the new memory with
                # NaN there, and a fill that ran after the copy would
                # overwrite the fetched value
                cur.wait_stream(self._compute)
        else:
            dst = torch.empty_strided(rec.size, rec.stride, dtype=rec.dtype,
                                      device=self.dev)
        if not rec.compressed:
            return dst.copy_(rec.data, non_blocking=self._pinned())
        q, s, meta = rec.data
        out = dst if dst.is_contiguous() else torch.empty(
            rec.size, dtype=rec.dtype, device=self.dev)
        if self._pinned():
            fetch_packed(q, s, meta, out)
        else:
            dequantize_blocked(q, s, meta, out=out)
        return dst if out is dst else dst.copy_(out)

    def _swap_out(self, tid: str, compressed: bool = False,
                  sync: bool = False) -> None:
        st = self._st(tid)
        if st not in self.device or st in self._pending_out:
            return
        val = self.device[st]
        # int8 blocks would destroy an integer tensor (token ids, indices):
        # only floating tensors take the compressed path
        compressed = compressed and val.is_floating_point()

        def do():
            hub = self.telemetry
            ts = hub.now() if hub is not None else 0.0
            t0 = _time.perf_counter()
            self._host_put(st, self._to_host(val, compressed))
            if hub is not None:
                hub.record_transfer(
                    self.ctx.job_id, st, "out", self.ctx.size_of(st),
                    _time.perf_counter() - t0, compressed=compressed, t=ts)

        if self.async_exec is not None and not sync:
            if self.async_exec.stream is not None:
                # read on the copy stream: the allocator must not hand the
                # block out again before that read, whenever it is freed
                val.record_stream(self.async_exec.stream)
            t = self.async_exec.submit("out:" + st, do)
            self._pending_out[st] = (t, compressed, val)
            return
        self.channel.transfer(do)
        self._retire_out(st, compressed)

    def _retire_out(self, st: str, compressed: bool,
                    val: Optional[torch.Tensor] = None) -> None:
        """A swap-out's copy has landed: record, free the device copy,
        count.  If an aliased update replaced the device value while the
        copy was on the wire, the host copy is stale: it is dropped and
        the new value stays."""
        self.accountant.free(self.ctx.job_id, ON_WIRE + st)
        if val is not None and st in self.device \
                and self.device[st] is not val:
            self._hold(self.host.pop(st, None))
            self.ctx.host.discard(st)
            self.ctx.host_compressed.discard(st)
            return
        self.engine.record("swap_out", self.ctx, st)
        self._drop_storage(st)
        self.stats.swap_out_count += 1
        if compressed:
            self.stats.compressed_swaps += 1

    def _poll_swap_outs(self, block: bool = False) -> None:
        """Retire every swap-out whose copy has landed; with ``block`` wait
        for all of them first."""
        if block and self.async_exec is not None:
            self.async_exec.flush()
        for st, (t, compressed, val) in list(self._pending_out.items()):
            if block and t.event is not None:
                t.event.synchronize()
            if t.done():
                del self._pending_out[st]
                self.async_exec.inflight.pop(t.key, None)
                self._retire_out(st, compressed, val)

    def _hold_budget(self, incoming: int, keep=(),
                     required: bool = True) -> bool:
        """Budget guard: keep the job's booked bytes plus ``incoming``
        within ``budget_bytes``; True when they fit.  First wait for the
        swap-outs already issued to land and retire them: the plan's model
        frees those copies by its own clock, and a copy slower than that
        clock (operator latencies are estimates) would otherwise hold a
        tensor's device copy while the next allocation lands.  If that is
        not enough (a plan whose own peak exceeds the slice, or a prefetch
        due before its bytes are), swap out resident storages, the one
        read again last first, never one of ``keep``; their next readers
        swap them in passively.  Values never change: a swap copies.
        Where even that is not enough, a ``required`` booking (what the
        current operator must hold at once) raises BudgetExceededError;
        an optional one (a planned prefetch or recompute, which its reader
        can do itself later) returns False and is not made."""
        if self.budget_bytes is None or not self._over(incoming):
            return True
        issued = [t for t, _, _ in self._pending_out.values() if t.issued]
        if issued:
            t0 = _time.perf_counter()
            for t in issued:
                if t.event is not None:
                    t.event.synchronize()
            self._poll_swap_outs()
            stall = _time.perf_counter() - t0
            self.stats.budget_waits += 1
            self.stats.budget_wait_s += stall
            self.stats.stall_time_s += stall
            if self.telemetry is not None:
                self.telemetry.record_stall(self.ctx.job_id, self._cur_idx,
                                            stall, "budget")
        if self._over(incoming):
            self._evict(incoming, set(keep))
        if not self._over(incoming):
            return True
        if not required:
            return False
        booked = self.accountant.job_bytes(self.ctx.job_id)
        raise BudgetExceededError(
            f"job {self.ctx.job_id} at operator {self._cur_idx}: "
            f"{booked} B booked + {incoming} B incoming > budget "
            f"{self.budget_bytes} B, with "
            f"{sum(self.ctx.size_of(st) for st in keep if st in self.device)}"
            f" B of it held by the operator's own tensors")

    def _over(self, incoming: int) -> bool:
        return (self.accountant.job_bytes(self.ctx.job_id) + incoming
                > self.budget_bytes)

    def _next_read(self, st: str) -> int:
        """The next operator after the current one that reads ``st`` (one
        past the last operator when none does)."""
        if self._reads is None:
            self._reads = {}
            for i, op in enumerate(self.seq.operators):
                for tid in op.inputs:
                    self._reads.setdefault(self._st(tid), []).append(i)
        reads = self._reads.get(st, ())
        k = bisect.bisect_right(reads, self._cur_idx)
        return reads[k] if k < len(reads) else len(self.seq.operators)

    def _evict(self, incoming: int, keep: Set[str]) -> None:
        """Swap out resident storages, the one read again last first,
        until ``incoming`` more bytes fit the budget or none is left.  A
        storage whose prefetch has been issued is waited for first (the
        swap-out then reads the fetched value); one with a swap-out under
        way is retiring already."""
        inflight = self.async_exec.inflight if self.async_exec else {}
        queued = {k[3:] for k, t in inflight.items()
                  if k.startswith("in:") and not t.issued}
        for st in sorted((st for st in self.device
                          if st not in keep and st not in self._pending_out
                          and st not in queued),
                         key=lambda st: (-self._next_read(st), st)):
            if not self._over(incoming):
                return
            if "in:" + st in inflight:
                self.async_exec.wait("in:" + st)
            self._swap_out(st, sync=True)
            self._evicted.add(st)
            self.stats.budget_evictions += 1

    def _forget_evicted(self, st: str) -> None:
        """A storage the guard swapped out is written again, or dies: its
        host copy is stale, and must be neither fetched nor carried into
        the next iteration.  (A planned release keeps it: the plan may
        fetch the value back from it.)"""
        if st in self._evicted and st not in self._pending_out:
            self._evicted.discard(st)
            self._hold(self.host.pop(st, None))
            self.ctx.host.discard(st)
            self.ctx.host_compressed.discard(st)

    def _demand(self, inputs, outputs=()) -> Tuple[int, Set[str]]:
        """What reading ``inputs`` and writing ``outputs`` books, and the
        storages that must stay on the device meanwhile: each one not on
        the device, and, for an input that will be recomputed (no host
        copy, no prefetch in flight), its producer's inputs in turn."""
        inflight = self.async_exec.inflight if self.async_exec else {}
        need, keep = 0, set()
        todo = [(t, True) for t in inputs] + [(t, False) for t in outputs]
        while todo:
            tid, read = todo.pop()
            st = self._st(tid)
            if st in keep:
                continue
            keep.add(st)
            if st in self.device:
                continue
            need += self.ctx.size_of(st)
            if (read and st not in self.host and tid in self.producer
                    and "in:" + st not in inflight):
                todo += [(t, True) for t in
                         self.seq.operators[self.producer[tid]].inputs]
        return need, keep

    def operator_floor(self) -> int:
        """The most bytes one operator must hold on the device at once:
        its inputs and results, with the producers' inputs of what the
        running plan recomputes for it, each storage once.  A budget
        below it makes the guard raise at that operator."""
        recomputed = ({e.tensor_id for e in self.plan.recomputes()}
                      if self.plan is not None else set())
        floor = 0
        for op in self.seq.operators:
            keep: Set[str] = set()
            todo = list(op.inputs) + list(op.outputs)
            while todo:
                tid = todo.pop()
                st = self._st(tid)
                if st in keep:
                    continue
                keep.add(st)
                if tid in recomputed and tid in self.producer:
                    todo += self.seq.operators[self.producer[tid]].inputs
            floor = max(floor, sum(self.ctx.size_of(st) for st in keep))
        return floor

    def _queued_in_bytes(self) -> int:
        """Bytes the queued (not yet issued) prefetches book at issue."""
        return sum(self.ctx.size_of(t.key[3:])
                   for t in self.async_exec.queue
                   if t.key.startswith("in:") and t.key[3:] not in self.device)

    def _hold_prefetches(self) -> None:
        """Before the queued prefetches issue: evict for them, and leave
        out the last queued ones that still do not fit (their readers swap
        them in passively, under the guard)."""
        q = self.async_exec.queue
        while not self._hold_budget(self._queued_in_bytes(), required=False):
            ins = [t for t in q if t.key.startswith("in:")]
            if not ins:
                # over the budget with nothing left to leave out: raises
                self._hold_budget(0)
                return
            q.remove(ins[-1])
            self.async_exec.inflight.pop(ins[-1].key, None)
            self.stats.budget_skips += 1

    def _swap_in(self, st: str, passive: bool) -> bool:
        """Prefetch from host; returns False when there is nothing to fetch
        (e.g. iteration-0 cold start of a cross-iteration plan)."""
        if st in self.device:
            return True
        if st not in self.host:
            return False
        compressed = st in self.ctx.host_compressed

        def do():
            hub = self.telemetry
            ts = hub.now() if hub is not None else 0.0
            t0 = _time.perf_counter()
            self._put_device(st, self._host_fetch(st))
            if hub is not None:
                hub.record_transfer(
                    self.ctx.job_id, st, "in", self.ctx.size_of(st),
                    _time.perf_counter() - t0, compressed=compressed,
                    passive=passive, t=ts)

        self.engine.record("passive_in" if passive else "swap_in",
                           self.ctx, st)
        if self.async_exec is not None and not passive:
            self.async_exec.submit("in:" + st, do)
        else:
            t0 = _time.perf_counter()
            self.channel.transfer(do)
            if passive:
                self.stats.passive_swap_ins += 1
                stall = _time.perf_counter() - t0
                self.stats.stall_time_s += stall
                if self.telemetry is not None:
                    self.telemetry.record_stall(
                        self.ctx.job_id, self._cur_idx, stall, "passive_in")
        self.stats.swap_in_count += 1
        return True

    def _ensure_input(self, tid: str) -> None:
        """An operator needs ``tid`` now: prefetch-wait, passive swap-in, or
        recompute from the producer node (engine decision rules)."""
        st = self._st(tid)
        key = "in:" + st
        inflight = bool(self.async_exec is not None
                        and key in self.async_exec.inflight)
        action = self.ctx.input_action(self.resident, tid,
                                       prefetch_inflight=inflight)
        if inflight:
            # the prefetch's copy may still be on the wire even when its
            # destination is already in the store: order the consumer
            # after it (on the device; the host does not block)
            ts = _time.perf_counter()
            self.async_exec.wait(key)
            stall = _time.perf_counter() - ts
            self.stats.stall_time_s += stall
            if self.telemetry is not None:
                self.telemetry.record_stall(
                    self.ctx.job_id, self._cur_idx, stall, "await_prefetch")
            if st in self.device:
                return
            action = self.ctx.input_action(self.resident, tid)
        if action is INPUT_RESIDENT:
            return
        if action is INPUT_PASSIVE_SWAP_IN and self._swap_in(st, passive=True):
            return
        self._recompute(tid)

    def _recompute(self, tid: str) -> None:
        """Replay the producer node of ``tid`` and keep that result."""
        idx = self.producer.get(tid)
        if idx is None:
            raise KeyError(f"tensor {tid} unavailable and has no producer")
        node = self.layout.ops[idx]
        for t in self.seq.operators[idx].inputs:
            self._ensure_input(t)
        outs = self._eval(node)
        for k, o in self.layout.results[node]:
            if self.layout.tid[o] == tid:
                self._put_device(tid, outs if k is None else outs[k])
        self.stats.recompute_count += 1

    # ------------------------------------------------------------------
    def run(self, *args: Any) -> List[Any]:
        """One iteration on ``args`` (the step's pytrees of tensors).
        Returns the flat list of output leaves: a storage left on the
        device is returned as its device tensor, one parked on the host as
        a host tensor (dequantized if its copy was compressed), so the next
        iteration can take it as a host-resident input."""
        flat = pytree.tree_leaves(args)
        # the caller keeps these: never written in place
        self._borrowed = {id(v) for v in flat}
        return self._run(flat)

    def run_donated(self, args: List[Any]) -> List[Any]:
        """``run`` on the pytrees in the list ``args``, which it empties:
        the executor then holds the only references to the inputs, so a
        device copy the plan frees (an input swapped out, an old parameter
        replaced by its update) returns to the allocator as the ledger says
        (JAX's donated buffers).  The caller must keep no other reference."""
        flat = pytree.tree_leaves(args)
        args.clear()
        return self._run(flat)

    def _run(self, flat: List[Any]) -> List[Any]:
        t_start = _time.perf_counter()
        res_start = 0
        if self.telemetry is not None:
            res_start = len(
                self.telemetry.residency.get(self.ctx.job_id, ()))
        lay = self.layout
        if len(flat) != len(lay.inputs):
            raise ValueError(f"expected {len(lay.inputs)} leaves, got "
                             f"{len(flat)}")
        stores = [(lay.tid[n], self._st(lay.tid[n]), v)
                  for n, v in zip(lay.inputs, flat)]
        # the card when any input is on one (a storage parked on the host by
        # the previous iteration may come first), else the inputs' device
        devices = [v.device for _, st, v in stores
                   if st not in self.host_resident_inputs] or [flat[0].device]
        self.dev = next((d for d in devices if d.type == "cuda"), devices[0])
        if self.dev.type == "cuda":
            self._compute = torch.cuda.current_stream(self.dev)
        if self.async_swap:
            self.async_exec = AsyncSwapExecutor(self.channel, self.dev,
                                                self.copy_stream)
        # absorb host values preloaded between iterations
        self.ctx.host |= set(self.host)
        for tid, st, val in stores:
            if st in self.host_resident_inputs:
                # previous iteration parked this storage on host; it enters
                # the device only via its planned swap-in (or passively).
                # A host copy carried over with it (preloaded into
                # ``self.host``: the value came from it) is kept as it is
                if st not in self.host:
                    self._host_put(st, self._host_input(val))
            else:
                if self.budget_bytes is not None:
                    # a first iteration starts with every input on the
                    # device; the plan's steady state may park some
                    self._hold_budget(*self._demand((), (tid,)))
                self._put_device(tid, val if val.device == self.dev
                                 else val.to(self.dev))
        # drop this frame's references: the stores now hold the inputs
        stores.clear()
        flat.clear()
        val = None
        for n in lay.consts:
            if self.budget_bytes is not None:
                self._hold_budget(*self._demand((), (lay.tid[n],)))
            self._put_device(lay.tid[n], getattr(self.gm, n.target))

        measure = self.measure_latency or self.telemetry is not None
        if self.telemetry is not None:
            self.telemetry.begin_buffering()
        throttle = (collections.deque() if self.async_exec is not None
                    and self._compute is not None else None)
        for idx, node in enumerate(lay.ops):
            self._cur_idx = idx
            op = self.seq.operators[idx]
            if throttle is not None and len(throttle) >= self.RUN_AHEAD:
                throttle.popleft().synchronize()
            # retire any swap-out whose copy landed while we computed
            if self._pending_out:
                self._poll_swap_outs()
            if self._held:
                self._release_held()
            if self.budget_bytes is not None:
                self._hold_budget(*self._demand(op.inputs, op.outputs))
            t0 = _time.perf_counter()
            for tid in op.inputs:
                self._ensure_input(tid)
            t1 = _time.perf_counter()
            outs = self._eval_into(node, idx)
            if measure:
                if self._compute is not None:
                    self._compute.synchronize()
                t2 = _time.perf_counter()
                if self.measure_latency:
                    self.stats.op_latencies.append(t2 - t0)
                if self.telemetry is not None:
                    # compute-only latency: input-ensure time is reported
                    # separately as stall records
                    self.telemetry.record_op(
                        self.ctx.job_id, idx, t2 - t1, prim=op.name,
                        flops=op.flops, bytes_accessed=op.bytes_accessed)
            for k, o in lay.results[node]:
                if self._evicted:
                    self._forget_evicted(self._st(lay.tid[o]))
                self._put_device(lay.tid[o], outs if k is None else outs[k])
            del outs

            # releases: plan overrides, then free-at-last-use (engine rule)
            for tid in op.inputs + op.outputs:
                if self.ctx.should_auto_release(tid, idx):
                    self.engine.record("release", self.ctx, self._st(tid))
                    self._drop_storage(self._st(tid))
                    if self._evicted and self._next_read(
                            self._st(tid)) >= len(lay.ops):
                        # dead for the rest of the iteration
                        self._forget_evicted(self._st(tid))

            # plan events triggered by this op (engine skip rules)
            for ev in self.ctx.events_triggered_by(idx):
                st = self._st(ev.tensor_id)
                if not self.ctx.event_applies(self.resident, ev):
                    continue
                if ev.event_type is EventType.SWAP_OUT:
                    self._swap_out(ev.tensor_id, compressed=ev.compressed)
                elif ev.event_type is EventType.SWAP_IN:
                    if (self.budget_bytes is not None
                            and self.async_exec is None
                            and not self._hold_budget(
                                *self._demand((ev.tensor_id,)),
                                required=False)):
                        # a synchronous prefetch books at once; one that
                        # does not fit is left to its reader
                        self.stats.budget_skips += 1
                        continue
                    self._swap_in(st, passive=False)
                elif ev.event_type is EventType.RELEASE:
                    self.engine.record("release", self.ctx, st)
                    self._drop_storage(st)
                elif ev.event_type is EventType.RECOMPUTE:
                    if (self.budget_bytes is not None
                            and not self._hold_budget(
                                *self._demand((ev.tensor_id,)),
                                required=False)):
                        self.stats.budget_skips += 1
                        continue
                    self.engine.record("recompute", self.ctx, st)
                    self._recompute(ev.tensor_id)
            # preemptive arbitration: splice a pending plan in at a safe
            # point (after this op's events, before its transfers issue)
            self._maybe_hot_swap(idx)
            if self.async_exec is not None:
                if self.budget_bytes is not None and self.async_exec.queue:
                    self._hold_prefetches()
                self.async_exec.flush()
            if throttle is not None:
                throttle.append(self._compute.record_event())
            if self.telemetry is not None:
                self.telemetry.flush()

        if self.async_exec is not None:
            self.async_exec.drain()
        self._poll_swap_outs(block=True)
        if self.telemetry is not None:
            self.telemetry.end_buffering()
        # fetching outputs back to Python is harness work, not part of the
        # modeled iteration -- pause the trace (and telemetry) for it
        if self.engine.trace is not None:
            self.engine.trace.paused = True
        if self.telemetry is not None:
            self.telemetry.paused = True
        outs = [self._output(v) for v in lay.out_leaves]
        if self.engine.trace is not None:
            self.engine.trace.paused = False
        if self.telemetry is not None:
            self.telemetry.paused = False
            self.stats.residency_timeline = [
                (r.t, r.resident_bytes)
                for r in self.telemetry.residency.get(
                    self.ctx.job_id, [])[res_start:]]
            self.telemetry.end_iteration(self.ctx.job_id)
        if self._compute is not None:
            self._compute.synchronize()
        self._held.clear()
        self.stats.wall_time_s = _time.perf_counter() - t_start
        self.stats.peak_bytes = self.accountant.peak
        return outs

    def _output(self, v: Any) -> Any:
        if not isinstance(v, torch.fx.Node):
            return v
        o = self.layout.owner[v]
        st = self._st(self.layout.tid[o])
        if st not in self.device and st in self.host and o is v:
            rec = self.host[st]
            if not rec.compressed:
                return rec.data
            # dequantize on the device, then park the result on the host
            return self._to_host(self._host_fetch(st), compressed=False).data
        if st not in self.device:
            if self.budget_bytes is not None:
                self._hold_budget(*self._demand((self.layout.tid[o],)))
            self._ensure_input(self.layout.tid[o])
        return self._value(v)

    # ------------------------------------------------------------------
    def ending_host_storages(self) -> Set[str]:
        """Storages left parked on host at iteration end (their device copy
        dropped) -- the next iteration's ``host_resident_inputs``."""
        return {st for st in self.host if st not in self.device}

    def close(self) -> None:
        if self.async_exec is not None:
            self.async_exec.drain()


# executor_floor: the chain of small elementwise operators it times, and
# the runs of it (the last one is read)
FLOOR_OPS = 64
FLOOR_REPS = 3


def executor_floor(device=None) -> float:
    """The seconds ``FxExecutor`` spends on one small operator when it
    times each (under telemetry: the aten node interpreted from Python,
    then the compute stream synchronised): the median over a chain of
    FLOOR_OPS small products and sums on ``device`` (default ``cuda``), the
    last of FLOOR_REPS runs.  On a card this host cost, not the device's
    rates, bounds most of a train step's thousands of small operators; a
    caller that wants the analytic model to price it puts it into
    ``DeviceCalibration.overhead_s``."""
    dev = resolve_device(device)

    def chain(x):
        for _ in range(FLOOR_OPS // 2):
            x = x * 0.5 + 1.0
        return x

    x = torch.zeros(1024, device=dev)
    seq, gm = capture(chain, x, cost_model=CostModel())
    for _ in range(FLOOR_REPS):
        ex = FxExecutor(gm, seq, None, measure_latency=True)
        ex.run(x)
    return statistics.median(ex.stats.op_latencies)


_OUT_FORMS: Dict[Any, Any] = {}


def _out_overload(target):
    """``(overload, positional names, keyword names)`` of the ``out`` form
    of an aten op whose arguments are a subset of the op's, with the same
    types (the output's dtype comes from ``out``); None if it has none."""
    if target in _OUT_FORMS:
        return _OUT_FORMS[target]
    found = None
    sch = getattr(target, "_schema", None)
    packet = getattr(target, "overloadpacket", None)
    if sch is not None and packet is not None:
        types = {a.name: str(a.type) for a in sch.arguments}
        for name in packet.overloads():
            cand = getattr(packet, name)._schema
            args = [a for a in cand.arguments if not a.is_out]
            outs = [a for a in cand.arguments if a.is_out]
            if (len(outs) == 1 and outs[0].name == "out"
                    and all(types.get(a.name) == str(a.type)
                            for a in args)):
                found = (getattr(packet, name),
                         [a.name for a in args if not a.kwarg_only],
                         [a.name for a in args if a.kwarg_only])
                break
    _OUT_FORMS[target] = found
    return found


def _bind(node: torch.fx.Node, args, kwargs) -> Dict[str, Any]:
    """The node's arguments by schema name."""
    names = [a.name for a in node.target._schema.arguments]
    bound = dict(zip(names, args))
    bound.update(kwargs)
    return bound


def reference_outputs(graph_module: torch.fx.GraphModule,
                      *args: Any) -> List[Any]:
    """The captured graph run as it is, unscheduled: its flat outputs."""
    return pytree.tree_leaves(graph_module(*args))
