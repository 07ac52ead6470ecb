"""TENSILE core in PyTorch: tensor-granularity memory scheduling (Zhang et
al., 2021) for captured aten graphs on a CUDA card.

    capture / capture_train_step  -- PyTorch step -> aten graph -> Tensor
                                     Access Sequence (make_fx, fake mode)
    Pipeline / build_pipeline / PIPELINES -- composable planning passes
    MemoryScheduler / schedule_single -- Algorithm 3 (tensile pipeline)
    analyze                       -- Algorithm 2 (peak analysis)
    MemoryEngine / DeviceLedger / DmaChannel -- the shared memory-event
                                     engine the simulator, the executor and
                                     the serving session run against
    TelemetryHub                  -- one sink for op/transfer/stall/residency
                                     records from both runtimes
    ExperienceStore / fingerprint -- the experience plane: persistent
                                     cross-run store (distilled telemetry,
                                     recalibrated calibration, verified plan
                                     cache per job fingerprint) so recurring
                                     jobs warm-boot instead of cold-start
    LatencyMLP                    -- the cold-start latency predictor
    simulate / evaluate           -- discrete-event metrics (MSR/EOR/CBR)
    FxExecutor                    -- interpreting executor with real swaps to
                                     pinned host memory, plan hot-swap at
                                     safe points
    GlobalController / BudgetArbiter -- the multi-job runtime: one device
                                     budget split across live jobs, each
                                     on its own thread and stream
    baselines                     -- vanilla / vDNN_conv / Capuchin wrappers
    schedule_for_budget / make_remat_policy -- TENSILE decisions as a
                                     train-step policy (selective
                                     checkpointing, moments on the host)

The planner modules are copies of the JAX package's; capture, the cost
model's node rules, the executor and the controller's runtime are this
package's own.
"""
from .access import (AccessSequence, AccessType, Operator, Phase, TensorKind,
                     TensorSpec, format_bytes)
from .baselines import capuchin_plan, vanilla_plan, vdnn_conv_plan
from .cost_model import (CalibrationReport, CostModel, DeviceCalibration,
                         EWMATracker, LatencyMLP, calibrate_cuda)
from .engine import (DeviceLedger, DmaChannel, EngineTrace, JobContext,
                     JobLedgerView, MemoryEngine, SafePoint, TraceRecord,
                     find_safe_points)
from .executor import (AsyncSwapExecutor, BudgetExceededError,
                       ExecutionStats, FxExecutor, executor_floor,
                       reference_outputs)
from .experience import (CalibrationRecord, ExperienceEntry, ExperienceStore,
                         PlanRecord, TelemetrySummary, budget_bucket,
                         device_identity, fingerprint, sequence_signature)
from .graph_capture import CaptureSpec, capture, capture_train_step
from .integration import (RematPolicy, TensileDecisions, checkpoint_name,
                          make_remat_policy, opt_state_placement,
                          plan_decisions, schedule_for_budget)
from .multiplexer import (ARBITER_MODES, ARBITER_POLICIES, BudgetArbiter,
                          CapturedJob, GlobalController, JobFailedError,
                          JobHandle)
from .passes import (PIPELINES, BudgetAutoscalePass, CompressedOffloadPass,
                     PassiveProfilePass, Pipeline, PlanningPass,
                     PreemptiveReplanPass, PriorityPass, RecomputePass,
                     SwapPass, VdnnSwapPass, build_pipeline)
from .peak_analysis import PeakReport, analyze, unroll, vanilla_peak
from .plan import (ChannelReservation, EventType, MachineProfile,
                   ScheduleEvent, SchedulingPlan)
from .recompute_planner import RecomputePlanner
from .scheduler import (MemoryScheduler, ScheduleResult, SchedulerConfig,
                        schedule_single)
from .simulator import PlanUpdate, SimResult, evaluate, simulate
from .swap_planner import PeriodicChannel, SwapPlanner
from .telemetry import (IterationView, OpSample, ResidencySample,
                        StallSample, TelemetryHub, TransferSample,
                        record_schemas)

__all__ = [n for n in dir() if not n.startswith("_")]
