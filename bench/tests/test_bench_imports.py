"""What the benchmark loads: no JAX and no JAX package anywhere, and no
code of the program in the plain references.  Each check runs in a fresh
interpreter and compares top-level module names whole."""
import json
import subprocess
import sys

import tiny

RUN_MODULES = """
import sys, json
sys.path[:0] = [{bench!r}, {src!r}]
sys.argv = ["run.py"]
import run
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _loaded(body: str) -> set:
    code = RUN_MODULES.format(bench=str(tiny.BENCH),
                              src=str(tiny.BENCH.parent / "src"), body=body)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(tiny.BENCH.parent))
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_run_loads_no_jax_and_no_jax_package():
    """Everything ``bench/run.py`` imports, the runner and the program
    included, and a tiny run of the cell's set-up on the CPU on each
    configuration."""
    loaded = _loaded("""
import torch
sys.path.insert(0, run.BENCH.joinpath("tests").as_posix())
import tiny
from runners import train
from harness import compare, devtrace, flops, weights
for name in tiny.CONFIGS:
    cell = tiny.tiny_cell(name)
    tiny.plan_for(cell)
    job = train.setup(cell, torch.device("cpu"), 3)
    job.state = train.fresh_state(job)
    train.run_step(job, job.batches[0])
assert not run.loaded_forbidden(), run.loaded_forbidden()
""")
    assert "repro_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def test_reference_imports_nothing_of_the_program():
    loaded = _loaded("""
import reference.common, reference.qwen2, reference.mamba2
import harness.weights, harness.flops, harness.compare
""")
    assert not loaded & {"repro_torch", "repro", "jax", "jaxlib", "flax",
                         "benchmarks", "runners"}


def test_forbidden_names_are_compared_whole():
    code = f"""
import sys
sys.path[:0] = [{str(tiny.BENCH)!r}]
sys.argv = ["run.py"]
import run, types
sys.modules["repro_torch_like"] = types.ModuleType("repro_torch_like")
assert run.loaded_forbidden() == []
sys.modules["repro.sub"] = types.ModuleType("repro.sub")
assert run.loaded_forbidden() == ["repro"]
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
