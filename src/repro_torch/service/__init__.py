"""Admission control shared by the serving session."""
from .queue import AdmissionQueue, QueuedJob

__all__ = ["AdmissionQueue", "QueuedJob"]
