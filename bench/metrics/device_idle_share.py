"""The share of the profiled window of whole steps in which no device
operation ran, in %."""
LAYER = "device"
SOURCE = "device_trace"
MOVES = "train_tokens_per_s"
UNIT = "%"
BETTER = "lower"
WORKLOADS = ["qwen2.5-14b.l4.train.budget"]


def read(r: dict):
    busy, window = r.get("trace_busy_s"), r.get("trace_window_s")
    if not busy or not window:
        return None
    return 100 * (1 - busy / window)
