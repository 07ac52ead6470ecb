"""Operator latency estimation (paper §IV-C) for captured aten graphs, and
the cold-start predictor.

Three layers, used in this order:
  1. **Analytic model** -- per-node FLOPs / bytes from the aten node's
     shapes, latency = overhead + max(flops/peak_flops, bytes/mem_bw) scaled
     by a utilization factor.  Available before anything has ever run.
  2. **MLP predictor** -- ``LatencyMLP``, the paper's light 3-layer MLP
     mapping <log flops, log bytes, device utilization> -> log latency,
     trained on measured samples; once attached (``CostModel.mlp``) its
     prediction is blended 50/50 with the analytic one.
  3. **EWMA correction** -- at runtime, measured latencies are folded in with
     an exponentially weighted moving average (paper §IV-E).

The JAX package's ``core/cost_model.py`` prices jaxpr equations; here
``node_cost`` prices ``torch.fx`` nodes of aten ops with the same rules
(matrix products 2*M*N*K, the convolution rule, reductions by input size,
the same elementwise table keyed by the aten op's base name).
``offload_quant_latency``/``offload_quant_bandwidth``,
``recalibrate``/``calibration_report`` and the warm boot from an
``ExperienceStore`` are copies; ``LatencyMLP`` is an ``nn.Module`` with the
reference's network, features and training rule (Adam, weight decay 0,
through ``optim/adam.py``), initialised from a seeded ``torch.Generator``
(``convert.latency_mlp_from_jax`` loads the reference's weights).
"""
from __future__ import annotations

import dataclasses
import math
import statistics
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device

# row-block width of the quantize-on-offload kernel
# (kernels/offload_quant.BLOCK; duplicated so this module stays kernel-free)
OFFLOAD_QUANT_BLOCK = 512

# the reference's table; keys are aten base names (the reference's
# logistic / select_n / and / or / xor / not / is_finite / max / min become
# sigmoid / where / bitwise_* / isfinite / maximum / minimum)
ELEMENTWISE_FLOPS = {
    "add": 1, "sub": 1, "mul": 1, "div": 1, "maximum": 1, "minimum": 1,
    "neg": 1, "exp": 8, "log": 8, "tanh": 10, "sigmoid": 10, "erf": 10,
    "rsqrt": 4, "sqrt": 4, "pow": 10, "abs": 1, "sign": 1, "floor": 1,
    "ceil": 1, "round": 1, "isfinite": 1, "bitwise_and": 1, "bitwise_or": 1,
    "bitwise_xor": 1, "bitwise_not": 1, "where": 1, "clamp": 2, "cos": 8,
    "sin": 8, "eq": 1, "ne": 1, "ge": 1, "gt": 1, "le": 1, "lt": 1,
}
MATMULS = {"mm", "addmm", "bmm", "baddbmm"}
REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "prod", "argmax",
              "argmin", "cumsum", "logcumsumexp", "cummax", "logsumexp"}


def op_name(target) -> str:
    """The aten op's base name (``aten.mm.default`` -> ``mm``)."""
    packet = getattr(target, "overloadpacket", None)
    if packet is not None:
        return packet.__name__
    return getattr(target, "__name__", str(target))


def _tensors(val):
    if isinstance(val, torch.Tensor):
        return [val]
    if isinstance(val, (list, tuple)):
        return [t for v in val for t in _tensors(v)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _arg_tensors(node) -> list:
    out = []

    def visit(a):
        if isinstance(a, torch.fx.Node):
            out.extend(_tensors(a.meta.get("val")))
        elif isinstance(a, (list, tuple)):
            for x in a:
                visit(x)

    visit(node.args)
    visit(tuple(node.kwargs.values()))
    return out


@dataclasses.dataclass
class DeviceCalibration:
    """Effective throughput of the executing device.  The defaults are one
    NVIDIA H100 SXM's data-sheet peaks (dense bf16 tensor cores, HBM3);
    ``calibrate_cuda`` measures the card in hand, and
    ``CostModel.recalibrate`` folds measured telemetry in online."""
    flops: float = 989e12
    mem_bw: float = 3.35e12
    overhead_s: float = 2e-6


@dataclasses.dataclass
class CalibrationReport:
    """How well the (re)calibrated analytic model predicts the measured
    latencies in a TelemetryHub: mean relative error overall and per
    primitive."""

    overall: float                       # mean |pred - measured| / measured
    per_primitive: Dict[str, float]
    samples: int


def _clamped(estimate: float, current: float, limit: float = 16.0) -> float:
    """Bound a single-sample throughput point-estimate to within
    ``limit``x of the current constant: one outlier must not move the
    calibration by orders of magnitude."""
    return min(max(estimate, current / limit), current * limit)


class CostModel:
    def __init__(self, calib: Optional[DeviceCalibration] = None,
                 experience=None):
        # warm boot (experience plane): with no explicit calibration, an
        # attached ExperienceStore supplies the constants persisted by a
        # prior run's recalibration.  An explicit `calib` always wins.
        if calib is None and experience is not None:
            try:
                calib = experience.device_calibration()
            except Exception:   # noqa: BLE001 - corrupt store: cold boot
                calib = None
        self.calib = calib or DeviceCalibration()
        self.experience = experience
        self.mlp: Optional["LatencyMLP"] = None
        self.utilization: float = 0.0  # 0..1, "GPU usage" analogue
        # recalibration cursor per job: only hub samples newer than this
        # are folded in on the next recalibrate() call
        self._recal_cursor: Dict[str, int] = {}

    # ------------------------------------------------------------------
    def node_cost(self, node) -> Tuple[float, float]:
        """(flops, bytes) for one ``call_function`` node of an aten graph:
        bytes are its tensor arguments read once and its results written
        once (shapes from ``node.meta["val"]``)."""
        name = op_name(node.target)
        ins = _arg_tensors(node)
        outs = _tensors(node.meta.get("val"))
        out_n = sum(t.numel() for t in outs)
        bts = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        if name in MATMULS:
            # out (.., M, N) and the contraction K of the first product arg
            a = ins[1] if name in ("addmm", "baddbmm") else ins[0]
            flops = 2.0 * out_n * a.shape[-1]
        elif name == "convolution":
            # the reference's rule with aten's (O, I/groups, kh, kw) weight
            w = ins[1]
            flops = 2.0 * out_n * w.numel() / max(w.shape[0], 1)
        elif name in REDUCTIONS:
            flops = float(ins[0].numel()) if ins else 0.0
        else:
            flops = float(out_n) * ELEMENTWISE_FLOPS.get(name, 1)
        return flops, float(bts)

    # ------------------------------------------------------------------
    def offload_quant_latency(self, size_bytes: int) -> float:
        """Latency of the quantize-on-offload kernel (csrc/offload_quant.cu:
        per 512-element row, absmax -> scale -> int8 pack).

        The kernel is bandwidth-bound: it reads the source tensor once and
        writes int8 + one fp32 scale per block (about 1.25x the source bytes
        moved for fp32 input), plus a small per-block issue overhead."""
        c = self.calib
        block_bytes = 4 * OFFLOAD_QUANT_BLOCK
        blocks = max(1, math.ceil(size_bytes / block_bytes))
        moved = size_bytes * (1.0 + 0.25 + 4.0 / block_bytes)
        return c.overhead_s + moved / c.mem_bw + blocks * 2e-9

    def offload_quant_bandwidth(self, probe_bytes: int = 16 << 20) -> float:
        """Effective source-bytes/s of the quantize path -- plug into
        MachineProfile.offload_quant_bw so the planner's compressed swap
        times match this device."""
        return probe_bytes / max(self.offload_quant_latency(probe_bytes),
                                 1e-12)

    # ------------------------------------------------------------------
    def latency(self, flops: float, bytes_accessed: float,
                prim_name: str = "") -> float:
        """Roofline latency under current utilization; with a trained
        ``mlp`` attached, the mean of the two (the cold-start path, paper
        §IV-C)."""
        c = self.calib
        slowdown = 1.0 + self.utilization  # contended device runs slower
        base = c.overhead_s + slowdown * max(flops / c.flops,
                                             bytes_accessed / c.mem_bw)
        if self.mlp is not None:
            pred = self.mlp.predict_one(flops, bytes_accessed,
                                        self.utilization)
            if pred > 0:
                return float(0.5 * base + 0.5 * pred)
        return float(base)

    # ------------------------------------------------------------------
    # Online recalibration from measured telemetry
    # ------------------------------------------------------------------
    def recalibrate(self, hub, alpha: float = 0.5,
                    report: bool = True) -> Optional["CalibrationReport"]:
        """Fold every NEW TelemetryHub op sample into the calibration:
        each measured (flops, bytes, latency) triple yields a point
        estimate of the constant its roofline term is bound by.  Samples
        already consumed (per-job cursor) are skipped.  Returns the
        post-update ``calibration_report`` unless ``report=False``."""
        c = self.calib
        for job_id in hub.jobs():
            samples = hub.ops.get(job_id, ())
            start = self._recal_cursor.get(job_id, 0)
            for s in samples[start:]:
                eff = s.latency_s - c.overhead_s
                if eff <= 0 or (s.flops <= 0 and s.bytes_accessed <= 0):
                    continue
                if eff < 0.25 * s.latency_s:
                    # overhead-dominated sample: no signal, skip it
                    continue
                if s.flops / c.flops >= s.bytes_accessed / c.mem_bw:
                    est = _clamped(s.flops / eff, c.flops)
                    c.flops = (1 - alpha) * c.flops + alpha * est
                else:
                    est = _clamped(s.bytes_accessed / eff, c.mem_bw)
                    c.mem_bw = (1 - alpha) * c.mem_bw + alpha * est
            self._recal_cursor[job_id] = len(samples)
        return self.calibration_report(hub) if report else None

    def calibration_report(self, hub) -> "CalibrationReport":
        """Per-primitive relative error of the analytic model against the
        hub's measured latencies (utilization-free prediction)."""
        util, self.utilization = self.utilization, 0.0
        try:
            errs: Dict[str, list] = {}
            for job_id in hub.jobs():
                for s in hub.ops.get(job_id, ()):
                    if s.latency_s <= 0 or (s.flops <= 0
                                            and s.bytes_accessed <= 0):
                        continue
                    pred = self.latency(s.flops, s.bytes_accessed, s.prim)
                    rel = abs(pred - s.latency_s) / s.latency_s
                    errs.setdefault(s.prim or "?", []).append(rel)
        finally:
            self.utilization = util
        per_prim = {p: sum(v) / len(v) for p, v in errs.items()}
        n = sum(len(v) for v in errs.values())
        overall = (sum(sum(v) for v in errs.values()) / n) if n else 0.0
        return CalibrationReport(overall=overall, per_primitive=per_prim,
                                 samples=n)


# ======================================================================
# The paper's 3-layer MLP latency predictor
# ======================================================================
def _r2(pred: np.ndarray, y: np.ndarray) -> float:
    ss_res = float(np.sum((pred - y) ** 2))
    ss_tot = float(np.sum((y - y.mean()) ** 2)) or 1e-12
    return 1.0 - ss_res / ss_tot


class LatencyMLP(torch.nn.Module):
    """Predicts log-latency from <log flops, log bytes, utilization>.

    The paper feeds raw input dims and op params; flops/bytes are a
    sufficient statistic of those for roofline-dominated ops and keep the
    model op-agnostic.  3 -> hidden -> hidden -> 1 with tanh, fp32 on
    ``device`` (default ``cuda``); the initial weights are drawn on the CPU
    from a ``torch.Generator`` seeded ``seed`` (the reference's scales), so
    they do not depend on the device.
    """

    def __init__(self, hidden: int = 32, seed: int = 0, device=None):
        super().__init__()
        self.device = resolve_device(device)
        gen = torch.Generator(device="cpu").manual_seed(seed)

        def normal(shape, scale: float) -> torch.nn.Parameter:
            w = torch.randn(shape, generator=gen) * scale
            return torch.nn.Parameter(w.to(self.device))

        def zeros(n: int) -> torch.nn.Parameter:
            return torch.nn.Parameter(torch.zeros(n, device=self.device))

        self.w1 = normal((3, hidden), 1 / math.sqrt(3))
        self.b1 = zeros(hidden)
        self.w2 = normal((hidden, hidden), 1 / math.sqrt(hidden))
        self.b2 = zeros(hidden)
        self.w3 = normal((hidden, 1), 1 / math.sqrt(hidden))
        self.b3 = zeros(1)

    @staticmethod
    def featurize(flops: np.ndarray, bytes_: np.ndarray,
                  util: np.ndarray) -> np.ndarray:
        return np.stack([np.log1p(flops) / 30.0, np.log1p(bytes_) / 30.0,
                         util], axis=-1).astype(np.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.tanh(x @ self.w1 + self.b1)
        h = torch.tanh(h @ self.w2 + self.b2)
        return (h @ self.w3 + self.b3)[..., 0]

    def _features(self, flops, bytes_, util) -> torch.Tensor:
        return torch.from_numpy(self.featurize(
            np.asarray(flops), np.asarray(bytes_),
            np.asarray(util))).to(self.device)

    def fit(self, flops: np.ndarray, bytes_: np.ndarray, util: np.ndarray,
            latency_s: np.ndarray, steps: int = 2000,
            lr: float = 3e-3) -> float:
        """Train on measured samples (full batch, AdamW with weight decay
        0); returns training R² on log-latency."""
        from ..optim.adam import adamw_init, adamw_update
        x = self._features(flops, bytes_, util)
        y = torch.from_numpy(np.log(np.maximum(
            np.asarray(latency_s), 1e-9)).astype(np.float32)).to(self.device)
        params = dict(self.named_parameters())
        state = adamw_init(params)
        for _ in range(steps):
            with torch.enable_grad():
                loss = torch.mean((self(x) - y) ** 2)
                grads = torch.autograd.grad(loss, list(params.values()))
            _, state = adamw_update(params, dict(zip(params, grads)), state,
                                    lr=lr, weight_decay=0.0)
        with torch.no_grad():
            pred = self(x).cpu().numpy()
        return _r2(pred, y.cpu().numpy())

    @torch.no_grad()
    def predict_one(self, flops: float, bytes_: float, util: float) -> float:
        x = self._features([flops], [bytes_], [util])
        return float(torch.exp(self(x))[0])

    @torch.no_grad()
    def r2(self, flops, bytes_, util, latency_s) -> float:
        pred = self(self._features(flops, bytes_, util)).cpu().numpy()
        y = np.log(np.maximum(np.asarray(latency_s), 1e-9))
        return _r2(pred, y)


class EWMATracker:
    """Runtime latency correction (paper §IV-E)."""

    def __init__(self, alpha: float = 0.3):
        self.alpha = alpha
        self.values: Dict[int, float] = {}
        self._hub_cursor: Dict[str, int] = {}

    def update(self, op_idx: int, measured: float) -> float:
        old = self.values.get(op_idx)
        new = measured if old is None else (
            self.alpha * measured + (1 - self.alpha) * old)
        self.values[op_idx] = new
        return new

    def ingest(self, hub, job_id: str) -> int:
        """Fold every NEW TelemetryHub op sample of the job into the
        tracker (per-job cursor); returns how many were consumed."""
        samples = hub.ops.get(job_id, ())
        start = self._hub_cursor.get(job_id, 0)
        for s in samples[start:]:
            self.update(s.op_idx, s.latency_s)
        self._hub_cursor[job_id] = len(samples)
        return len(samples) - start

    def drift_ratio(self, baseline_sum: float) -> float:
        s = sum(self.values.values())
        if baseline_sum <= 0:
            return float("inf")
        return abs(s - baseline_sum) / baseline_sum


def calibrate_cuda(n: int = 8192, copy_bytes: int = 1 << 30,
                   device=None) -> DeviceCalibration:
    """Measure the card's effective bf16 matmul rate (one n x n x n
    product) and device-memory rate (one device-to-device copy of
    ``copy_bytes``, read plus write), by CUDA events: the medians of 5
    timed calls after 2 warm-up calls.  Raises without a CUDA card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("calibrate_cuda needs a CUDA card")
    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((n, n), generator=gen, device=dev).to(torch.bfloat16)
    b = torch.randn((n, n), generator=gen, device=dev).to(torch.bfloat16)
    src = torch.empty(copy_bytes, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)

    def timed(fn) -> float:
        for _ in range(2):
            fn()
        out = []
        for _ in range(5):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            out.append(e0.elapsed_time(e1) * 1e-3)
        return statistics.median(out)

    with torch.cuda.device(dev):
        mm_s = timed(lambda: a @ b)
        copy_s = timed(lambda: dst.copy_(src))
    return DeviceCalibration(flops=2.0 * n ** 3 / mm_s,
                             mem_bw=2.0 * copy_bytes / copy_s)
