"""Model FLOPs of a step (``harness.flops``; recomputation not counted)
over the window's seconds a step and the H100's 989 TFLOP/s of dense
bf16, in %."""
LAYER = "model step (models/*, launch/steps.py, optim/adam.py)"
SOURCE = "host_clock"
MOVES = "train_tokens_per_s"
UNIT = "%"
BETTER = "higher"
WORKLOADS = ["qwen2.5-14b.l4.train.budget"]


def read(r: dict):
    v = r.get("mfu")
    return None if v is None or v <= 0 else 100 * v
