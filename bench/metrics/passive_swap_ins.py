"""Passive swap-ins (prefetch misses, ``stats.passive_swap_ins``) a window
step."""
LAYER = "executor (core/executor.py)"
SOURCE = "program_counter"
MOVES = "train_tokens_per_s"
UNIT = "1/step"
BETTER = "lower"
WORKLOADS = ["qwen2.5-14b.l4.train.budget"]


def read(r: dict):
    return r.get("passive_swap_ins_per_step")
