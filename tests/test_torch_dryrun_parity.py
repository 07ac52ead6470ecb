"""The port's dry run held to the reference's counts, on the CPU.

TinyLlama-1.1B's and Moonlight-16B-A3B's ``train_4k`` cells on the 16 x 16
mesh: the reference's ``run_cell`` on 512 XLA host devices (its
``memory_analysis()`` and cost analysis) and the port's on rank 0 of a
512-rank ``fake`` world, each side in a subprocess, side by side.  The
port's per-device peak is at most 1.5 x the reference's in both cells (the
CE loss on the vocabulary's shards, the scatter MoE on the tokens' data
shards; before them, 2.7 x and 5.0 x), and Moonlight's counted FLOPs are
at most 5 x the reference's (before, 212 x: every rank ran every expert on
every token).  These are counts of the same sharded programs; nothing is
timed.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
CELLS = (("tinyllama-1.1b", "train_4k"), ("moonshot-v1-16b-a3b", "train_4k"))
PEAK_RATIO = 1.5
MOE_FLOPS_RATIO = 5.0

RUN = """
    import json, sys
    from {package}.launch import dryrun
    out = {{}}
    for arch, shape in json.loads(sys.argv[2]):
        rec = dryrun.run_cell(arch, shape, False)
        out[arch + ":" + shape] = {{
            "peak": rec["per_device_peak_bytes"],
            "flops": rec["cost"]["flops"], "mesh": rec["mesh"]}}
    with open(sys.argv[1], "w") as f:
        json.dump(out, f)
"""


@pytest.fixture(scope="module")
def counts(tmp_path_factory):
    d = tmp_path_factory.mktemp("parity")
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    procs = {}
    for package in ("repro", "repro_torch"):
        procs[package] = subprocess.Popen(
            [sys.executable, "-c",
             textwrap.dedent(RUN.format(package=package)),
             str(d / f"{package}.json"), json.dumps(CELLS)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)
    out = {}
    for package, proc in procs.items():
        try:
            _, err = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for p in procs.values():
                p.kill()
            pytest.fail(f"{package}'s dry run timed out after 600 s")
        assert proc.returncode == 0, err[-8000:]
        out[package] = json.loads((d / f"{package}.json").read_text())
    return out["repro"], out["repro_torch"]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_peak_within_the_reference(counts, arch, shape):
    ref, port = (c[f"{arch}:{shape}"] for c in counts)
    assert port["mesh"] == ref["mesh"] == {"data": 16, "model": 16}
    assert 0 < port["peak"] <= PEAK_RATIO * ref["peak"], (port, ref)


def test_moe_flops_within_the_reference(counts):
    ref, port = (c["moonshot-v1-16b-a3b:train_4k"] for c in counts)
    assert 0 < port["flops"] <= MOE_FLOPS_RATIO * ref["flops"], (port, ref)
