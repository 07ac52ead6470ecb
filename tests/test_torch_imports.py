"""The port stands alone: no module of ``repro_torch``, not
``chip_smoke.py`` and not ``tools/experience_torch.py`` loads JAX or the
JAX package; and its entry points
refuse to run on a missing card instead of falling back to the CPU."""
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.models.registry import get_model

ROOT = os.path.join(os.path.dirname(__file__), "..")
# the TENSILE loop's, the SSM slice's, the multi-job runtime's, the
# experience plane's, the training launcher's, the MoE slice's and the
# whisper slice's modules:
# each must be among those walked and checked
TENSILE_MODULES = [f"repro_torch.{m}" for m in (
    "core.access", "core.plan", "core.telemetry", "core.peak_analysis",
    "core.pass_state", "core.engine", "core.swap_planner",
    "core.recompute_planner", "core.passes", "core.scheduler",
    "core.simulator", "core.baselines", "core.cost_model",
    "core.graph_capture", "core.executor", "kernels.offload_quant",
    "service.workloads", "optim.adam", "models.ssm", "kernels.ssd_scan",
    "core.multiplexer", "service.jobspec", "obs.events", "core.experience",
    "obs.metrics", "obs.drift", "core.integration", "optim.compression",
    "data.pipeline", "checkpoint.manager", "runtime.stragglers",
    "runtime.fault_tolerance", "launch.train", "models.moe",
    "models.whisper")]


def test_port_and_chip_smoke_import_no_jax():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        import importlib.util
        tool = importlib.util.spec_from_file_location(
            "experience_torch", "tools/experience_torch.py")
        tool.loader.exec_module(importlib.util.module_from_spec(tool))
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        missing = sorted(set(TENSILE) - set(names))
        print(len(names), bad, missing)
        sys.exit(1 if bad or missing or len(names) < 20 else 0)
    """).replace("TENSILE", repr(TENSILE_MODULES))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), ROOT]))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_resolve_device(monkeypatch):
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")) == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device() == torch.device("cuda")
    assert resolve_device("cuda:0") == torch.device("cuda:0")


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda:0")
    with pytest.raises(RuntimeError):
        get_model(get_config("tinyllama-1.1b").reduced())


def test_serving_engine_without_device_raises_without_cuda(no_cuda):
    from repro_torch.serving import ServingEngine
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine()


def test_tensile_entry_points_raise_without_cuda(no_cuda):
    from repro_torch.core import calibrate_cuda
    from repro_torch.service.workloads import make_mlp
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mlp()
    with pytest.raises(RuntimeError):
        calibrate_cuda()


def test_mamba2_entry_points_raise_without_cuda(no_cuda):
    from repro_torch.serving import ServingEngine
    cfg = get_config("mamba2-780m").reduced()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine("mamba2-780m")
    assert get_model(cfg, "cpu").device == torch.device("cpu")
