"""Scheduler-as-a-service: daemon, admission queue, durable store, client.

The service plane turns the in-process ``GlobalController`` into a
long-lived device owner that independent clients submit jobs to:

    ``jobspec``   -- the frozen, serializable ``JobSpec`` wire format and the
                    ``JobState`` lifecycle vocabulary
    ``workloads`` -- registry resolving ``spec.workload`` references to
                    ``(step_fn, params, opt_state, batch)`` payloads, and the
                    train-step workloads TENSILE schedules
    ``queue``     -- priority admission by predicted peak vs device capacity
    ``store``     -- durable JSON-lines job store with crash recovery
    ``daemon``    -- the event loop wrapping ``GlobalController``
    ``client``    -- filesystem-inbox submission + status from another process

The JAX package's ``service`` plane, module for module.
"""
from .client import ServiceClient
from .daemon import SchedulerDaemon
from .jobspec import SPEC_SCHEMA_VERSION, JobSpec, JobState, ServeParams
from .queue import AdmissionQueue, QueuedJob
from .store import STORE_SCHEMA_VERSION, JobRecord, JobStore
from .workloads import (MLP_SIZE_PRESETS, make_lm_serving, make_mlp,
                        mlp_numpy, register_serve_workload,
                        register_workload, registered_serve_workloads,
                        registered_workloads, resolve_serve_workload,
                        resolve_workload)

__all__ = ["AdmissionQueue", "JobRecord", "JobSpec", "JobState", "JobStore",
           "MLP_SIZE_PRESETS", "QueuedJob", "SPEC_SCHEMA_VERSION",
           "STORE_SCHEMA_VERSION", "SchedulerDaemon", "ServeParams",
           "ServiceClient", "make_lm_serving", "make_mlp", "mlp_numpy",
           "register_serve_workload", "register_workload",
           "registered_serve_workloads", "registered_workloads",
           "resolve_serve_workload", "resolve_workload"]
