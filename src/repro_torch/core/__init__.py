"""The memory model the serving session books against: residency ledger,
DMA channel, decision trace and machine profile."""
from .engine import (DeviceLedger, DmaChannel, EngineTrace, JobLedgerView,
                     MemoryEngine, TraceRecord)
from .plan import MachineProfile

__all__ = ["DeviceLedger", "DmaChannel", "EngineTrace", "JobLedgerView",
           "MachineProfile", "MemoryEngine", "TraceRecord"]
