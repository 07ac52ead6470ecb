"""The serving plane: continuous-batching LM decode with KV-cache
residency scheduling.

Per-sequence KV-cache blocks are schedulable tensors in the shared
``DeviceLedger``/``DmaChannel`` machinery (``BlockTable``), planned per
decode turn against a rolling request-driven horizon (``KvResidencyPass``)
by one loop (``ServeSession``) that runs either in virtual time or, through
hooks, drives the real :class:`ServingEngine`.
"""

from .blocks import BlockTable
from .engine import PrefillResult, ServingEngine
from .residency import (DecodeHorizon, DecodeTurn, KvResidencyPass, SeqView,
                        TurnPlan, build_horizon)
from .session import SeqState, ServeHooks, ServeReport, ServeSession
from .traces import Request, TRACE_NAMES, make_trace

__all__ = [
    "BlockTable", "DecodeHorizon", "DecodeTurn", "KvResidencyPass",
    "PrefillResult", "Request", "SeqState", "SeqView", "ServeHooks",
    "ServeReport", "ServeSession", "ServingEngine", "TRACE_NAMES",
    "TurnPlan", "build_horizon", "make_trace",
]
