"""Fault tolerance: the restart loop, preemption handling, and failure
injection for tests (the JAX package's ``runtime/fault_tolerance.py``).

`resilient_train_loop` wraps a step function with:
  * periodic async checkpoints (CheckpointManager),
  * automatic restore-and-continue on step failure (up to max_restarts) —
    a crashed host on a real pod surfaces exactly like this: the
    coordinator restarts the job and every host resumes from the last
    committed step,
  * SIGTERM/preemption → synchronous checkpoint then clean exit
    (maintenance events on TPU pods send exactly this),
  * straggler hooks (runtime.stragglers) fed with per-step host timings.

The port's step updates its state in place, so a restore copies the
checkpoint into the tensors the step holds (``CheckpointManager.restore``
with the live state as template); a failure inside a step with no
checkpoint to go back to resumes from the state as the failure left it.
On a mesh of several ranks every rank resumes from the step the mesh's
first rank saw committed (``latest_step`` with the state as template).
A step's end is a synchronisation of its metrics' device; a failure is a
``RuntimeError`` (which covers ``torch.cuda.OutOfMemoryError``).  After a
restore the data resumes at the restored step: ``data_iter.seek`` (a
``Prefetcher``'s) when it has one, else the stream's ``load_state_dict``.
"""
from __future__ import annotations

import dataclasses
import os
import signal
import tempfile
import time
from typing import Any, Callable, Dict, Optional

import torch

from ..checkpoint.manager import CheckpointManager
from .stragglers import StragglerMonitor


@dataclasses.dataclass
class FTConfig:
    ckpt_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ckpt_every: int = 50
    keep: int = 3
    max_restarts: int = 3
    async_save: bool = True


class Preempted(Exception):
    pass


@dataclasses.dataclass
class TrainResult:
    final_step: int
    restarts: int
    preempted: bool
    metrics_history: list


def resilient_train_loop(step_fn: Callable, state: Any, data_iter,
                         n_steps: int, ft: Optional[FTConfig] = None,
                         data_stream=None,
                         monitor: Optional[StragglerMonitor] = None,
                         fail_at: Optional[Dict[int, int]] = None,
                         install_signal_handler: bool = False) -> TrainResult:
    """state = (params, opt_state).  step_fn(params, opt, batch) ->
    (params, opt, metrics).

    `fail_at` maps step -> how many times to raise there (failure
    injection for the integration tests).
    """
    ft = ft or FTConfig()
    mgr = CheckpointManager(ft.ckpt_dir, keep=ft.keep)
    monitor = monitor or StragglerMonitor(n_hosts=1)
    preempt = {"flag": False}
    if install_signal_handler:
        def _on_term(signum, frame):
            preempt["flag"] = True
        signal.signal(signal.SIGTERM, _on_term)

    def resume(data_state) -> None:
        seek = getattr(data_iter, "seek", None)
        if seek is not None:
            seek(data_state)
        elif data_stream is not None:
            data_stream.load_state_dict(data_state)

    start = 0
    latest = mgr.latest_step(state)
    if latest is not None:
        state, meta = mgr.restore(latest, template=state)
        start = int(meta["step"]) + 1
        if data_stream is not None and "data_state" in meta:
            resume(meta["data_state"])

    restarts = 0
    fail_budget = dict(fail_at or {})
    history = []
    step = start
    while step < n_steps:
        try:
            if preempt["flag"]:
                mgr.wait()
                mgr.save(step - 1, state, _extra(data_stream, step - 1))
                return TrainResult(step - 1, restarts, True, history)
            batch = next(data_iter)
            if fail_budget.get(step, 0) > 0:
                fail_budget[step] -= 1
                raise RuntimeError(f"injected failure at step {step}")
            t0 = time.perf_counter()
            params, opt, metrics = step_fn(state[0], state[1], batch)
            _synchronize(metrics)
            monitor.record(host=0, step=step,
                           seconds=time.perf_counter() - t0)
            state = (params, opt)
            history.append({k: float(v) for k, v in metrics.items()})
            if ft.ckpt_every and step % ft.ckpt_every == 0 and step > start:
                payload = _extra(data_stream, step)
                if ft.async_save:
                    mgr.save_async(step, state, payload)
                else:
                    mgr.save(step, state, payload)
            step += 1
        except RuntimeError:
            restarts += 1
            if restarts > ft.max_restarts:
                raise
            mgr.wait()
            latest = mgr.latest_step(state)
            if latest is not None:
                state, meta = mgr.restore(latest, template=state)
                step = int(meta["step"]) + 1
                if data_stream is not None and "data_state" in meta:
                    resume(meta["data_state"])
            else:
                step = start
    mgr.wait()
    mgr.save(n_steps - 1, state, _extra(data_stream, n_steps - 1))
    return TrainResult(n_steps - 1, restarts, False, history)


def _synchronize(metrics: Dict[str, Any]) -> None:
    """Wait for the step: the devices its metrics live on."""
    for v in metrics.values():
        if isinstance(v, torch.Tensor) and v.is_cuda:
            torch.cuda.synchronize(v.device)


def _extra(data_stream, step: int) -> Dict:
    out: Dict[str, Any] = {}
    if data_stream is not None:
        ds = data_stream.state_dict()
        ds["step"] = step + 1
        out["data_state"] = ds
    return out
