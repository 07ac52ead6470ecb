"""Seconds of ``MemoryScheduler.schedule()`` in set-up: the wall time
around the call."""
LAYER = ("planner (core/scheduler.py, passes.py, swap_planner.py, "
         "recompute_planner.py)")
SOURCE = "host_clock"
MOVES = "setup_s"
UNIT = "s"
BETTER = "lower"
WORKLOADS = ["qwen2.5-14b.l4.train.budget"]


def read(r: dict):
    return r.get("plan_s")
