"""A training cell: one job's train step captured, planned by TENSILE and
executed step after step under its plan.

Set-up (timed as ``setup_s``, from the process's start to the first timed
step): the step ``launch.steps.build_functional_train_step`` builds is
captured on fake tensors (``core.graph_capture.capture_train_step``); the
weights and the batch pool are made from the seed on the device; each
operator takes the latency the cell's latency table records for its key
(``op_key``: the operator, what it reads and writes, its counted work),
measured on the card once (``derive_budget.py``, as TENSILE's loop
measures them: the median of ``MEASURE_TIMES`` unscheduled steps
synchronised per operator, after a warm-up step); an operator the table
does not know (a changed capture) is measured so in set-up.  Latencies
measured anew in every run made the plan, and the step, wander from run
to run (``PERF.md``), so a run reads the table where it can;
``core.scheduler.MemoryScheduler`` plans the step
under the cell's rule; the state is made again from the seed and driven
through its first ``checked_steps`` steps by the window's own call, on
batches whose rows all differ, and what the comparison needs is read from
it.  The window then runs the same call back to back on that same state
for ``--seconds`` and ends in a synchronisation; each call is one
``FxExecutor.run_donated`` under the plan, the storages parked on the host
at one step's end entering the next as host-resident inputs.

After the window (and, with ``--trace 1``, a profiled run of a few more
steps) the allocator's peak is read, the program's state is freed, and
the plain reference (``bench/reference``) runs the checked steps from the
same weights on the same batches in float32.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import gc
import math
import statistics
import time
from typing import Dict, List, Optional

import torch

from harness import compare, devtrace, flops, weights
from harness.cells import Cell, read_per_layer
from reference.common import Adam, train_steps

PEAK_BF16_FLOPS = 989e12          # H100 SXM data sheet, dense bf16
B1 = 0.9                          # AdamW's first-moment decay (the step's)
# unscheduled steps whose per-operator medians the plan is made from; the
# process's first step, which is cold, runs before them and is not counted
MEASURE_TIMES = 3


def model_config(config: dict):
    """The program's ``ModelConfig`` of a configuration file: its base
    config with each mapped key set from the file."""
    from repro_torch.configs import get_config
    prog = config["program"]
    cfg = dataclasses.replace(
        get_config(prog["base"]),
        **{f: config[k] for f, k in prog["fields"].items()}, **prog["set"])
    if cfg.padded_vocab != config["padded_vocab_size"]:
        raise ValueError(f"the program's table has {cfg.padded_vocab} rows, "
                         f"the file says {config['padded_vocab_size']}")
    return cfg


@dataclasses.dataclass
class Job:
    cell: Cell
    device: torch.device
    seed: int
    gm: object = None
    seq: object = None
    plan: object = None
    profile: object = None
    guard: Optional[int] = None
    specs: list = None
    names: List[str] = None
    batches: list = None
    state: list = None
    host_inputs: set = dataclasses.field(default_factory=set)
    copy_stream: object = None
    rec: dict = dataclasses.field(default_factory=dict)

    @property
    def n_p(self) -> int:
        return len(self.names)

    @property
    def n_state(self) -> int:
        return 1 + 4 * self.n_p       # params, step, mu, nu, masters


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def fresh_state(job: Job) -> list:
    """The seed's weights, zero moments and float32 masters, flat in the
    step's argument order."""
    from repro_torch.optim.adam import adamw_init
    dtype = getattr(torch, job.cell.config["program"]["set"]["dtype"])
    params = weights.make_params(job.specs, job.seed, job.device, dtype)
    opt = adamw_init(params, use_master=True)
    return list(params.values()) + [opt.step] + list(opt.mu.values()) + \
        list(opt.nu.values()) + list(opt.master.values())


def run_step(job: Job, batch):
    """One step of the window's call on ``job.state``: returns the
    executor (its stats) and the step's loss tensor."""
    from repro_torch.core import FxExecutor, MemoryEngine
    tokens, labels = batch
    ex = FxExecutor(job.gm, job.seq, job.plan, async_swap=True,
                    host_resident_inputs=job.host_inputs,
                    engine=MemoryEngine(job.profile),
                    copy_stream=job.copy_stream, budget_bytes=job.guard)
    args = job.state + [tokens, labels]
    job.state = None
    outs = ex.run_donated(args)
    job.host_inputs = ex.ending_host_storages()
    job.state, loss = outs[:job.n_state], outs[job.n_state]
    return ex, loss


def _norm(t: torch.Tensor, device) -> float:
    return float(t.to(device).float().norm())


def prepare(cell: Cell, device: torch.device, seed: int) -> Job:
    """Capture the step on fake tensors and make the batch pool."""
    from repro_torch.core import MachineProfile, capture_train_step
    from repro_torch.launch.steps import (TrainStepConfig,
                                          build_functional_train_step)
    from repro_torch.models.registry import get_model
    from repro_torch.optim.adam import adamw_init

    job = Job(cell=cell, device=device, seed=seed)
    cfg = model_config(cell.config)
    api = get_model(cfg, device)
    job.specs = cell.reference.param_specs(cell.config)
    shell = {k: (tuple(p.shape), p.dtype)
             for k, p in api.shell().named_parameters()}
    mine = {s.name: (tuple(s.shape), getattr(torch, cfg.dtype))
            for s in job.specs}
    if shell != mine:
        raise ValueError(f"the program's parameters differ from the "
                         f"reference's: {sorted(set(shell) ^ set(mine))}")
    job.names = [s.name for s in job.specs]
    step = build_functional_train_step(
        api, TrainStepConfig(**cell.cell["train_step"]))
    tr = cell.traffic
    b, s = tr["batch"], tr["seq"]

    # ---- capture on fake tensors: only shapes, dtypes and the device ----
    t0 = time.perf_counter()
    shapes = {k: torch.empty(sh, dtype=dt, device=device)
              for k, (sh, dt) in mine.items()}
    args = (shapes, adamw_init(shapes, use_master=True),
            {"tokens": torch.empty((b, s), dtype=torch.int32, device=device),
             "labels": torch.empty((b, s), dtype=torch.int32,
                                   device=device)})
    job.seq, job.gm = capture_train_step(step, *args)
    del shapes, args
    job.rec["capture_s"] = time.perf_counter() - t0
    job.rec["operators"] = len(job.seq.operators)
    if device.type == "cuda":
        torch.cuda.empty_cache()
        job.copy_stream = torch.cuda.Stream(device)

    job.profile = MachineProfile(**cell.cell["link"])
    job.batches = weights.make_batches(seed, tr["pool"], b, s,
                                       cell.config["vocab_size"], device)
    _sync(device)
    job.rec["base_bytes"] = (torch.cuda.memory_allocated(device)
                             if device.type == "cuda" else 0)
    return job


def measure(job: Job, times: int = MEASURE_TIMES) -> List[float]:
    """One unscheduled warm-up step, then ``times`` unscheduled steps from
    the seed's state, each synchronised per operator (TENSILE's measured
    latencies): each operator's median seconds over the ``times``.
    Records the measured steps' wall times and the largest peaks."""
    from repro_torch.core import FxExecutor, MemoryEngine
    device = job.device
    runs, walls, peak, ledger = [], [], 0, 0
    for n in range(times + 1):
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        ex = FxExecutor(job.gm, job.seq, None,
                        engine=MemoryEngine(job.profile),
                        measure_latency=True)
        t0 = time.perf_counter()
        tokens, labels = job.batches[0]
        outs = ex.run_donated(fresh_state(job) + [tokens, labels])
        wall = time.perf_counter() - t0
        if n:
            walls.append(wall)
            runs.append(ex.stats.op_latencies)
        else:
            job.rec["warmup_s"] = wall
        if device.type == "cuda":
            peak = max(peak, torch.cuda.max_memory_allocated(device)
                       - job.rec["base_bytes"])
        ledger = max(ledger, ex.stats.peak_bytes)
        del ex, outs
        if device.type == "cuda":
            torch.cuda.empty_cache()
    job.rec.update({"unscheduled_measured_s": walls,
                    "unscheduled_peak_bytes": peak,
                    "unscheduled_ledger_bytes": ledger})
    return [statistics.median(x) for x in zip(*runs)]


def op_key(seq, op) -> str:
    """What an operator's latency is recorded under: its operator, the
    dtypes and shapes it reads and writes, and its counted FLOPs and
    bytes.  Operators alike share a key wherever they stand in the step,
    so a change to some of a capture's operators leaves the others'
    latencies as recorded."""
    def spec(t):
        return f"{seq.tensors[t].dtype}{list(seq.tensors[t].shape)}"
    return (f"{op.name} {','.join(map(spec, op.inputs))} -> "
            f"{','.join(map(spec, op.outputs))} {op.flops:.0f} "
            f"{op.bytes_accessed:.0f}")


def latency_table(seq, latencies: List[float]) -> Dict[str, float]:
    """Each key's median latency over the operators that have it, to 4
    significant digits: a cell's latency table."""
    by = collections.defaultdict(list)
    for op, sec in zip(seq.operators, latencies):
        by[op_key(seq, op)].append(sec)
    return {k: float(f"{statistics.median(v):.4g}")
            for k, v in sorted(by.items())}


def set_latencies(job: Job, table: Optional[Dict[str, float]]) -> None:
    """Each operator's latency from ``table``; the operators it lacks (all
    of them without a table) measured now (``measure``)."""
    keys = [op_key(job.seq, op) for op in job.seq.operators]
    missing = [i for i, k in enumerate(keys) if k not in (table or {})]
    measured = measure(job) if missing else None
    job.seq.set_latencies([measured[i] if k not in (table or {}) else table[k]
                           for i, k in enumerate(keys)])
    job.rec["measured_operators"] = len(missing)
    job.rec["iteration_time_s"] = job.seq.iteration_time


def make_plan(job: Job, asked_bytes: int, pipeline: str,
              patience_iters: int):
    """``MemoryScheduler`` over the job's sequence, asked for
    ``asked_bytes``; sets the job's plan and records its peak, events and
    seconds.  Returns the scheduler's result."""
    from repro_torch.core import (MemoryScheduler, SchedulerConfig,
                                  build_pipeline)
    conf = SchedulerConfig(memory_budget_bytes=asked_bytes,
                           patience_iters=patience_iters)
    ms = MemoryScheduler(job.profile, conf, pipeline=build_pipeline(
        pipeline, job.profile, conf))
    ms.register_job(job.seq)
    t0 = time.perf_counter()
    res = ms.schedule()
    job.rec["plan_s"] = time.perf_counter() - t0
    job.plan = res.plans[job.seq.job_id]
    job.rec["plan_peak_bytes"] = res.final_report.peak_bytes
    job.rec["plan_initial_peak_bytes"] = res.initial_report.peak_bytes
    job.rec["planner_iterations"] = res.iterations
    counts: Dict[str, int] = {}
    for e in job.plan.events:
        k = e.event_type.value
        counts[k] = counts.get(k, 0) + 1
        if e.crosses_iteration:
            counts["across_iteration"] = counts.get("across_iteration",
                                                    0) + 1
    job.rec["plan_events"] = counts
    return res


def setup(cell: Cell, device: torch.device, seed: int) -> Job:
    """``prepare``, the operators' latencies (``set_latencies``, from the
    cell's latency table), then the plan under the cell's rule (the bytes
    its file gives); a budget cell's executor holds the job to its
    budget."""
    job = prepare(cell, device, seed)
    set_latencies(job, cell.latencies)
    plan = cell.cell["plan"]
    make_plan(job, plan["asked_bytes"], plan["pipeline"],
              plan["patience_iters"])
    job.guard = plan.get("executor_budget_bytes")
    return job


def checked_steps(job: Job) -> dict:
    """The first ``checked_steps`` steps from the seed's state through the
    window's call: each step's loss, each leaf's first clipped gradient
    norm (from the first moment after step 1, ``mu = (1 - b1) g``), and
    each leaf's change of its float32 master after the last step."""
    n = job.cell.traffic["checked_steps"]
    job.state, job.host_inputs = fresh_state(job), set()
    out = {"losses": []}
    for k in range(n):
        ex, loss = run_step(job, job.batches[k])
        out["losses"].append(float(loss))
        if k == 0:
            out["grad_norms"] = {
                name: _norm(job.state[1 + job.n_p + i], job.device) / (1 - B1)
                for i, name in enumerate(job.names)}
        del ex, loss
    dtype = getattr(torch, job.cell.config["program"]["set"]["dtype"])
    p0 = weights.make_params(job.specs, job.seed, job.device, dtype)
    out["delta_norms"] = {
        name: float((job.state[1 + 3 * job.n_p + i].to(job.device)
                     - p0[name].float()).norm())
        for i, name in enumerate(job.names)}
    del p0
    return out


def reference_steps(cell: Cell, seed: int, device: torch.device,
                    fp8: bool = False, half_batch: bool = False) -> dict:
    """The plain reference's checked steps in float32 (TF32 off) from the
    seed's weights on the seed's batches; ``fp8`` computes in fp8 what the
    program computes in bf16 (the control, ``Numerics``), ``half_batch``
    takes the mean over the first half of each batch's rows (a fault)."""
    from reference.common import Numerics
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = cell.reference
    specs = ref.param_specs(cell.config)
    dtype = getattr(torch, cell.config["program"]["set"]["dtype"])
    params = weights.make_params(specs, seed, device, dtype)
    for k in list(params):
        params[k] = params[k].float()
    tr = cell.traffic
    batches = weights.make_batches(seed, tr["pool"], tr["batch"], tr["seq"],
                                   cell.config["vocab_size"], device)
    batches = batches[:tr["checked_steps"]]
    if half_batch:
        batches = [(t[:t.shape[0] // 2], l[:l.shape[0] // 2])
                   for t, l in batches]
    ts = cell.cell["train_step"]
    return train_steps(
        params, batches,
        functools.partial(ref.loss_sum, c=cell.config, num=Numerics(fp8)),
        Adam(ts["learning_rate"], ts["weight_decay"], ts["grad_clip_norm"]),
        rows=tr["reference_rows"])


def run(cell: Cell, seed: int, seconds: float, trace: bool,
        t_start: float, device: torch.device) -> dict:
    """One run of a training cell; returns the result's fields and the
    run's record (``"record"``)."""
    job = setup(cell, device, seed)
    prog = checked_steps(job)
    tr = cell.traffic
    pool = job.batches
    # the captured graph and the plan live for the whole run: the
    # collector need not walk them again at every collection
    gc.freeze()
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    # ---- the window -----------------------------------------------------
    t_first = time.perf_counter()
    setup_s = t_first - t_start
    steps, stall_s, passive, finite = 0, 0.0, 0, 0
    swaps_out, swaps_in, recomputes = 0, 0, 0
    # each step's end on the host's clock, from the window's start (the
    # steps are dispatched back to back: a record, not a metric)
    ends = []
    k = tr["checked_steps"]
    while True:
        ex, loss = run_step(job, pool[k % len(pool)])
        k += 1
        steps += 1
        finite += int(math.isfinite(float(loss)))
        # the executor's stalls, its budget guard's waits among them
        stall_s += ex.stats.stall_time_s
        passive += ex.stats.passive_swap_ins
        swaps_out += ex.stats.swap_out_count
        swaps_in += ex.stats.swap_in_count
        recomputes += ex.stats.recompute_count
        ledger = ex.stats.peak_bytes
        del ex, loss
        ends.append(time.perf_counter() - t_first)
        if ends[-1] >= seconds:
            break
    _sync(device)
    window_s = time.perf_counter() - t_first
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    rec = job.rec
    base = rec["base_bytes"]
    step_flops = flops.train_step_flops(cell.config["family"], cell.config,
                                        tr["batch"], tr["seq"])
    step_s = window_s / steps
    rec.update({
        "window_steps": steps, "window_s": window_s, "step_s": step_s,
        "step_ends_s": [round(t, 4) for t in ends],
        # against the unscheduled step, synchronised per operator, whose
        # latencies the plan was made from
        "measured_eor": step_s / rec["iteration_time_s"] - 1,
        "ledger_peak_bytes": ledger, "allocator_peak_bytes": peak - base,
        "swap_outs_per_step": swaps_out / steps,
        "swap_ins_per_step": swaps_in / steps,
        "recomputes_per_step": recomputes / steps,
        "step_flops": step_flops, "budget_bytes": job.guard,
        "asked_bytes": cell.cell["plan"]["asked_bytes"]})
    readings = dict(rec)
    readings.update({
        "exec_stall_s_per_step": stall_s / steps,
        "passive_swap_ins_per_step": passive / steps,
        "mfu": step_flops / step_s / PEAK_BF16_FLOPS})

    result = {"attempted": steps, "failed": steps - finite}
    tokens_per_s = steps * tr["batch"] * tr["seq"] / window_s
    e2e = {"train_tokens_per_s": tokens_per_s, "setup_s": setup_s,
           "peak_mem_gb": (peak - base) / 1e9}
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
                   "count": 1, "memory_peak_bytes": peak}
    if trace:
        def traced():
            nonlocal k
            for _ in range(tr["trace_steps"]):
                ex, _ = run_step(job, pool[k % len(pool)])
                k += 1
                del ex
        prof = devtrace.profile(traced)
        readings.update({"trace_busy_s": prof["busy_s"],
                         "trace_copy_s": prof["copy_s"],
                         "trace_window_s": prof["window_s"]})
        device_info.update({"busy_s": prof["busy_s"],
                            "window_s": prof["window_s"]})
        rec["trace"] = {k2: v for k2, v in prof.items()
                        if k2 not in ("top_ops", "idle_gaps")}
        result["breakdown"] = {"device_ops": prof["top_ops"],
                               "idle_gaps": prof["idle_gaps"]}
        result["metrics"] = read_per_layer(cell, readings)
    else:
        result["metrics"] = {
            m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end}
    result["device"] = device_info

    # ---- the comparison, after the program's state is freed -------------
    job.state = None
    job.gm = job.seq = job.plan = None
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = reference_steps(cell, seed, device)
    rec["reference_s"] = time.perf_counter() - t0
    values = compare.gaps(prog, ref)
    rec["gaps"] = dict(values)
    guarantee = cell.cell["guarantee"]
    values[guarantee["name"]] = (peak - base) / rec[guarantee["of"]] - 1 \
        if device.type == "cuda" else 0.0
    rec["losses"] = {"program": prog["losses"], "reference": ref["losses"]}
    checks = compare.judge(values, cell.cell["checks"])
    result["correct"] = (all(c["ok"] for c in checks.values())
                         and result["failed"] == 0)
    result["checks"] = checks
    result["record"] = rec
    return result
