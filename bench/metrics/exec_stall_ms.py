"""The executor's stall seconds (``stats.stall_time_s``, which holds its
budget guard's waits, ``stats.budget_wait_s``, too) a window step, in ms."""
LAYER = "executor (core/executor.py)"
SOURCE = "program_counter"
MOVES = "train_tokens_per_s"
UNIT = "ms/step"
BETTER = "lower"
WORKLOADS = ["qwen2.5-14b.l4.train.budget"]


def read(r: dict):
    v = r.get("exec_stall_s_per_step")
    return None if v is None else v * 1e3
