"""The job-submission surface (``JobSpec``, ``ServeParams``, ``JobState``),
the workload registry that resolves a spec to a payload, the train-step
workloads TENSILE schedules, and the admission control shared by the
serving session."""
from .jobspec import SPEC_SCHEMA_VERSION, JobSpec, JobState, ServeParams
from .queue import AdmissionQueue, QueuedJob
from .workloads import (MLP_SIZE_PRESETS, make_lm_serving, make_mlp,
                        mlp_numpy, register_serve_workload,
                        register_workload, registered_serve_workloads,
                        registered_workloads, resolve_serve_workload,
                        resolve_workload)

__all__ = ["AdmissionQueue", "JobSpec", "JobState", "MLP_SIZE_PRESETS",
           "QueuedJob", "SPEC_SCHEMA_VERSION", "ServeParams",
           "make_lm_serving", "make_mlp", "mlp_numpy",
           "register_serve_workload", "register_workload",
           "registered_serve_workloads", "registered_workloads",
           "resolve_serve_workload", "resolve_workload"]
