"""The share of the profiled window of whole steps in which a host-to-device
or device-to-host copy ran, in %."""
LAYER = "device"
SOURCE = "device_trace"
MOVES = "train_tokens_per_s"
UNIT = "%"
BETTER = "lower"
WORKLOADS = ["qwen2.5-14b.l4.train.budget"]


def read(r: dict):
    copy, window = r.get("trace_copy_s"), r.get("trace_window_s")
    if copy is None or not r.get("trace_busy_s") or not window:
        return None
    return 100 * copy / window
