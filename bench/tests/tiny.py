"""Tiny copies of the benchmark's cells, for the CPU tests: every width,
the depth and the batch cut down, the rest of each file as it stands.

A tiny cell is the training cell ``CELLS[0]`` run on one of the
configurations in ``CONFIGS``: the Mamba-2 configuration has no cell of
its own yet, and its reference is held to the port here all the same."""
from __future__ import annotations

import copy
import pathlib
import sys

BENCH = pathlib.Path(__file__).resolve().parents[1]
for p in (str(BENCH), str(BENCH.parent / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness.cells import load_cell, load_json  # noqa: E402

CELLS = ("qwen2.5-14b.l4.train.budget",)
CONFIGS = ("qwen2.5-14b.l4", "mamba2-780m.l12")
SMALL = {
    "qwen2": {"hidden_size": 64, "intermediate_size": 96,
              "num_attention_heads": 4, "num_key_value_heads": 2,
              "head_dim": 16, "num_hidden_layers": 2, "vocab_size": 256,
              "padded_vocab_size": 256},
    "mamba2": {"d_model": 32, "n_layer": 2, "vocab_size": 250,
               "padded_vocab_size": 256, "d_state": 8, "headdim": 8,
               "chunk_size": 16},
}
TRAFFIC = {"batch": 4, "seq": 32, "pool": 6}


def tiny_cell(config: str, dtype: str = "bfloat16"):
    """The cell ``CELLS[0]`` on the configuration ``config``, at a tiny
    size: a budget of 0.6 of the tiny step's planned peak is set by the
    caller (``plan_for``)."""
    cell = copy.deepcopy(load_cell(CELLS[0]))
    cell.config = load_json(BENCH / "configs" / f"{config}.json")
    cell.config.update(SMALL[cell.config["family"]])
    cell.config["program"]["set"]["dtype"] = dtype
    cell.traffic.update(TRAFFIC)
    return cell


def plan_for(cell, share: float = 0.6):
    """Sets the tiny cell's asked bytes and, for a budget cell, its
    executor budget, at ``share`` of the tiny step's unscheduled planned
    peak."""
    import torch
    from runners import train
    from repro_torch.core import simulate
    job = train.prepare(cell, torch.device("cpu"), 0)
    peak = simulate([job.seq], None, job.profile, iterations=1,
                    transfer_mode="sync").peak_bytes
    cell.cell["plan"]["asked_bytes"] = int(share * peak)
    if "executor_budget_bytes" in cell.cell["plan"]:
        cell.cell["plan"]["executor_budget_bytes"] = int(share * peak)
    return peak
