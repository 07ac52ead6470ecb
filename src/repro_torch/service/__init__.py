"""Admission control shared by the serving session, and the train-step
workloads TENSILE schedules."""
from .queue import AdmissionQueue, QueuedJob
from .workloads import MLP_SIZE_PRESETS, make_mlp, mlp_numpy

__all__ = ["AdmissionQueue", "MLP_SIZE_PRESETS", "QueuedJob", "make_mlp",
           "mlp_numpy"]
