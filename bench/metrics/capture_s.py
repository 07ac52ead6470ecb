"""Seconds of ``capture_train_step`` on fake tensors in set-up: the wall
time around the call."""
LAYER = "capture (core/graph_capture.py)"
SOURCE = "host_clock"
MOVES = "setup_s"
UNIT = "s"
BETTER = "lower"
WORKLOADS = ["qwen2.5-14b.l4.train.budget"]


def read(r: dict):
    return r.get("capture_s")
