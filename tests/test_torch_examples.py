"""The port's quickstart and serving examples run on the CPU with
``--device cpu``, as ``test_torch_multiplexer.py::
test_example_runs_on_the_cpu`` runs the multi-workload one."""
import os
import runpy
import sys

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _run_example(name, args, monkeypatch):
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *args])
    with pytest.raises(SystemExit) as done:
        runpy.run_path(os.path.join(ROOT, "examples", f"{name}.py"),
                       run_name="__main__")
    return done.value.code


def test_quickstart_runs_on_the_cpu(capsys, monkeypatch):
    """Captured, planned and executed: the outputs equal the unscheduled
    run's and the executed peak falls (the example exits 1 otherwise)."""
    assert _run_example("quickstart_torch", ["--device", "cpu"],
                        monkeypatch) == 0
    out = capsys.readouterr().out
    assert "executed on cpu: outputs match the unscheduled run = True" in out
    assert "swaps" in out and "MSR" in out


def test_serve_lm_runs_on_the_cpu(capsys, monkeypatch):
    """The reduced TinyLlama serve under a KV budget: every request
    served, no OOM, evictions."""
    assert _run_example("serve_lm_torch", [
        "--device", "cpu", "--max-sequences", "4", "--prompt-len", "8",
        "--gen", "8", "--trace", "burst", "--budget-kb", "24"],
        monkeypatch) in (0, None)
    out = capsys.readouterr().out
    assert "device=cpu requests=8 served=8" in out
    assert "oom_events=0" in out and "evictions=0" not in out
