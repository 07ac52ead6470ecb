"""The benchmark's command on a card: each cell runs, and its last line is
a result with ``correct`` true.  Skipped without a CUDA card (decided in
the test).  On the card: ``python -m pytest -m cuda bench/tests``."""
import json
import subprocess
import sys

import pytest
import torch

import tiny


@pytest.mark.cuda
@pytest.mark.parametrize("name", tiny.CELLS)
def test_cell_runs_correct_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", name, "--seed",
         "4294967311", "--seconds", "5", "--trace", "0"],
        capture_output=True, text=True, timeout=900,
        cwd=str(tiny.BENCH.parent))
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["metrics"]["train_tokens_per_s"]["value"] > 0


def test_without_a_card_the_command_exits_nonzero_and_prints_nothing():
    code = ("import torch, sys, runpy; "
            "torch.cuda.is_available = lambda: False; "
            "sys.argv = ['run.py', '--workload', %r, '--seed', '1', "
            "'--seconds', '1']; "
            "runpy.run_path('bench/run.py', run_name='__main__')"
            % tiny.CELLS[0])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(tiny.BENCH.parent))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
