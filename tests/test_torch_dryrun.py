"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's (``repro.launch.dryrun``), on the CPU.

Held to the reference: ``model_flops_for`` on every config and shape,
``shapes_for``/``skipped_shapes_for``, and the collective tally against
``parse_collectives`` on HLO text written from the same records (the
reference's ``tests/test_launch.py`` cases and the ``-done`` rule).
Three full-width TinyLlama-1.1B cells run through ``main`` on rank 0 of a
512-rank ``fake`` world, each in its own process; their per-device
argument bytes are held to the bytes of the reference's
``NamedSharding.shard_shape`` of the same trees on 512 XLA host devices
(nothing compiled).  The accounting itself: on ``meta`` tensors it counts
what it counts on real CPU tensors, exactly, and a (1, 1) mesh counts the
meshless FLOPs and no collective.
"""
import ast
import inspect
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import shapes_for as jax_shapes_for
from repro.configs import skipped_shapes_for as jax_skipped_shapes_for
from repro_torch.configs import (ALL_SHAPES, get_config, list_configs,
                                 shapes_for, skipped_shapes_for)
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun
from repro_torch.launch.steps import (TrainStepConfig, build_train_step,
                                      opt_state_for)
from repro_torch.models.registry import get_model

# the reference's module sets XLA_FLAGS for 512 host devices when it is
# imported: keep this process's flags as they were
_flags = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as jax_dryrun  # noqa: E402
if _flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
ARCH = "tinyllama-1.1b"
CELLS = ("train_4k", "prefill_32k", "decode_32k")


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


# ----------------------------------------------------------------------
# 1: model FLOPs and the shape sets
# ----------------------------------------------------------------------
@pytest.mark.parametrize("shape", [s.name for s in ALL_SHAPES])
@pytest.mark.parametrize("name", list_configs())
def test_model_flops_for(name, shape):
    port = {s.name: s for s in ALL_SHAPES}[shape]
    ref = {s.name: s for s in jax_dryrun.ALL_SHAPES}[shape]
    assert dryrun.model_flops_for(get_config(name), port) == \
        jax_dryrun.model_flops_for(jax_config(name), ref)


@pytest.mark.parametrize("name", list_configs())
def test_shapes_and_skips(name):
    got = [s.name for s in shapes_for(get_config(name))]
    assert got == [s.name for s in jax_shapes_for(jax_config(name))]
    got = [(s.name, why) for s, why in skipped_shapes_for(get_config(name))]
    assert got == [(s.name, why)
                   for s, why in jax_skipped_shapes_for(jax_config(name))]


# ----------------------------------------------------------------------
# 2: the collective tally against parse_collectives
# ----------------------------------------------------------------------
_DTYPES = {"f32": 4, "bf16": 2, "s8": 1, "s32": 4}


def _hlo(records, async_pairs=False):
    """HLO text of ``(kind, dtype, dims, group_extent)`` records, one
    instruction each (a ``-start``/``-done`` pair with ``async_pairs``);
    an extent of ``None`` writes no replica groups."""
    lines = []
    for i, (kind, dtype, dims, n) in enumerate(records):
        shape = f"{dtype}[{','.join(map(str, dims))}]"
        groups = ("" if n is None else ", replica_groups={{"
                  + ",".join(map(str, range(n))) + "}}")
        if async_pairs:
            lines.append(f"  %s{i} = {shape}{{1,0}} {kind}-start({shape} "
                         f"%x{i}){groups}")
            lines.append(f"  %d{i} = {shape} {kind}-done({shape} %s{i})")
        else:
            lines.append(f"  %c{i} = {shape} {kind}({shape} %x{i}){groups}")
    return "\n".join(lines)


def _records(records):
    return [(kind, int(np.prod(dims)) * _DTYPES[dtype],
             2 if n is None else n) for kind, dtype, dims, n in records]


# the four instructions of tests/test_launch.py's SAMPLE_HLO
SAMPLE = [("all-gather", "bf16", (8, 128, 256), 16),
          ("all-reduce", "f32", (1024,), 4),
          ("collective-permute", "bf16", (64, 64), None),
          ("all-to-all", "f32", (16, 32), 8)]


def _random_records(seed):
    rng = np.random.default_rng(seed)
    kinds = ["all-gather", "all-reduce", "reduce-scatter", "all-to-all",
             "collective-permute"]
    return [(kinds[rng.integers(len(kinds))],
             ["f32", "bf16", "s8", "s32"][rng.integers(4)],
             tuple(int(d) for d in rng.integers(1, 64, rng.integers(1, 4))),
             [None, 1, 2, 4, 16, 256][rng.integers(6)])
            for _ in range(40)]


@pytest.mark.parametrize("case", ["sample", "random0", "random1"])
@pytest.mark.parametrize("async_pairs", [False, True])
def test_tally_matches_parse_collectives(case, async_pairs):
    """The tally of the records equals ``parse_collectives`` of their HLO,
    ``-done`` instructions skipped (counted at their ``-start``)."""
    records = SAMPLE if case == "sample" else _random_records(int(case[-1]))
    want = jax_dryrun.parse_collectives(_hlo(records, async_pairs))
    got = dryrun.tally_collectives(_records(records))
    assert set(got) == set(want)
    for kind in want:
        assert got[kind]["count"] == want[kind]["count"], kind
        assert got[kind]["bytes"] == want[kind]["bytes"], kind
        assert got[kind]["wire_bytes"] == pytest.approx(
            want[kind]["wire_bytes"], rel=1e-12), kind


def test_done_alone_is_not_counted():
    """The reference's ``test_parse_collectives_ignores_done_ops``."""
    assert jax_dryrun.parse_collectives(
        "%d = f32[8] all-reduce-done(f32[8] %s)") == {}
    assert dryrun.tally_collectives([]) == {}


# ----------------------------------------------------------------------
# 3: the accounting, meta against real tensors
# ----------------------------------------------------------------------
def _reduced_train(device):
    cfg = get_config(ARCH).reduced(n_layers=2)
    api = get_model(cfg, "cpu")
    shape = ShapeSpec("t", 64, 2, "train")
    if device == "meta":
        params = api.shell()
        opt = opt_state_for(params, abstract=True)
        batch = api.input_specs(shape, abstract=True)
    else:
        params = api.init(torch.Generator().manual_seed(0))
        opt = opt_state_for(params)
        batch = api.input_specs(shape, abstract=False)
    return build_train_step(api, TrainStepConfig()), (params, opt, batch)


def test_meta_accounting_equals_the_cpu_run():
    """A reduced train step's FLOPs (per op too), ledger peak, argument
    bytes and bytes accessed are the same on ``meta`` tensors as on real
    CPU tensors, exactly; the ledger's peak is above the arguments.  Each
    step runs once before it is accounted, as on the card: the first
    uploads the rope table to the device (once a process)."""
    got = {}
    for device in ("meta", "cpu"):
        step, args = _reduced_train(device)
        step(*args)
        _, acc, _ = dryrun.account(step, args)
        got[device] = (acc.flops, dict(acc.flops_by_op), acc.peak_bytes,
                       acc.arg_bytes, acc.bytes_accessed, acc.collectives)
    assert got["meta"] == got["cpu"]
    flops, by_op, peak, args, _, colls = got["cpu"]
    assert flops > 0 and set(by_op) >= {"aten.bmm"}
    assert peak > args > 0 and colls == []


# ----------------------------------------------------------------------
# 4: full-width cells on a 512-rank fake world
# ----------------------------------------------------------------------
REFERENCE_ARGS = """
    import json, math, sys
    import jax
    from repro.configs import ALL_SHAPES, get_config
    from repro.launch.mesh import make_production_mesh
    from repro.launch.sharding import MeshRules
    from repro.launch.steps import opt_state_for, opt_state_shardings
    from repro.models.registry import get_model

    cfg = get_config(sys.argv[2])
    api = get_model(cfg)
    rules = MeshRules(make_production_mesh(multi_pod=False), cfg=cfg)
    params, axes = api.abstract_params()
    p_shard = rules.param_shardings(axes)

    def shard_bytes(tree, shardings):
        return sum(jax.tree.leaves(jax.tree.map(
            lambda x, s: math.prod(s.shard_shape(x.shape))
            * x.dtype.itemsize, tree, shardings)))

    out = {}
    for shape in ALL_SHAPES:
        if shape.name not in sys.argv[3:]:
            continue
        total = shard_bytes(params, p_shard)
        if shape.kind == "train":
            opt = opt_state_for(params, abstract=True)
            total += shard_bytes(opt, opt_state_shardings(rules, p_shard))
            batch = api.input_specs(shape, abstract=True)
        elif shape.kind == "prefill":
            batch = api.input_specs(shape, abstract=True)
        else:
            cache, cache_axes = api.abstract_cache(shape.global_batch,
                                                   shape.seq_len)
            total += shard_bytes(cache, rules.shardings_for(cache_axes,
                                                            cache))
            batch = api.decode_input_specs(shape, abstract=True)
        total += shard_bytes(batch, rules.batch_sharding(batch))
        out[shape.name] = total
    with open(sys.argv[1], "w") as f:
        json.dump(out, f)
"""

ONE_DEVICE_MESH = """
    import json, sys
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import init_world, make_host_mesh
    from repro_torch.launch.sharding import MeshRules, shard_params
    from repro_torch.launch.steps import (TrainStepConfig, build_prefill_step,
                                          build_serve_step, build_train_step,
                                          opt_state_for)
    from repro_torch.models.registry import get_model

    init_world("cpu")
    cfg = get_config(sys.argv[2]).reduced(n_layers=2)
    api = get_model(cfg, "cpu")
    rules = MeshRules(make_host_mesh(device="cpu"), cfg=cfg)
    out = {}
    for tag, mesh_rules in (("meshless", None), ("mesh", rules)):
        params = api.init(torch.Generator().manual_seed(0))
        batch = api.input_specs(ShapeSpec("t", 64, 2, "train"),
                                abstract=False)
        step = build_train_step(api, TrainStepConfig(), rules=mesh_rules)
        pb = api.input_specs(ShapeSpec("p", 64, 2, "prefill"),
                             abstract=False)
        if mesh_rules is not None:
            # placed before the step, as the reference's in_shardings
            shard_params(params, mesh_rules)
            batch = dryrun.place_batch(mesh_rules, batch)
            pb = dryrun.place_batch(mesh_rules, pb)
        _, train, _ = dryrun.account(step, (params, opt_state_for(params),
                                            batch))
        _, prefill, _ = dryrun.account(
            build_prefill_step(api, rules=mesh_rules), (params, pb))
        serve = build_serve_step(api, rules=mesh_rules)
        cache = api.init_cache(2, 8)
        db = api.decode_input_specs(ShapeSpec("d", 8, 2, "decode"),
                                    abstract=False)
        _, decode, _ = dryrun.account(serve, (params, cache, db, 3))
        out[tag] = {k: {"flops": a.flops, "collectives": a.collectives}
                    for k, a in (("train", train), ("prefill", prefill),
                                 ("decode", decode))}
    with open(sys.argv[1], "w") as f:
        json.dump(out, f)
"""


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """``main --arch tinyllama-1.1b --shape S --multi-pod 0`` for each of
    the three cells, each in a fresh process with its own artifact
    directory; the reference's shard bytes; the (1, 1) mesh's counts.
    All run side by side."""
    d = tmp_path_factory.mktemp("dryrun")
    procs = {}
    for shape in CELLS:
        out = d / shape
        out.mkdir()
        code = (f"import sys; from repro_torch.launch import dryrun; "
                f"sys.exit(dryrun.main(['--arch', '{ARCH}', '--shape', "
                f"'{shape}', '--multi-pod', '0', '--artifact-dir', "
                f"{str(out)!r}]))")
        procs[shape] = subprocess.Popen(
            [sys.executable, "-c", code], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=_env())
    procs["reference"] = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REFERENCE_ARGS),
         str(d / "ref.json"), ARCH, *CELLS], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=512",
                 JAX_PLATFORMS="cpu"))
    procs["one"] = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(ONE_DEVICE_MESH),
         str(d / "one.json"), ARCH], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=_env())
    results = {}
    for name, proc in procs.items():
        try:
            out, err = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for p in procs.values():
                p.kill()
            pytest.fail(f"{name} timed out after 600 s")
        results[name] = (proc.returncode, out, err)
    def load(name):
        path = d / name
        return json.loads(path.read_text()) if path.exists() else {}
    return d, results, load("ref.json"), load("one.json")


def _reference_record_keys():
    """The keys of the record the reference's ``run_cell`` builds, read
    from its source: top level, ``roofline`` and ``cost``."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(jax_dryrun.run_cell)))
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and getattr(
                node.targets[0], "id", None) == "record":
            top = {k.value: v for k, v in zip(node.value.keys,
                                              node.value.values)}
            return (set(top), {k.value for k in top["roofline"].keys},
                    {k.value for k in top["cost"].keys})
    raise AssertionError("no record in the reference's run_cell")


@pytest.mark.parametrize("shape", CELLS)
def test_main_writes_the_cell(cells, shape):
    """``main`` returns 0 and writes one artifact; the record has the
    reference's keys (``fits_hbm_16g`` replaced by ``fits_device_memory``
    against the named capacity); its per-device argument bytes are the
    reference's shard bytes of the same trees; its counts are finite and
    the train cell's collectives include the FSDP gathers."""
    d, results, ref, _ = cells
    rc, out, err = results[shape]
    assert rc == 0, out[-4000:] + err[-8000:]
    assert f"[ok] {ARCH} × {shape} × 1pod(256)" in out
    files = os.listdir(d / shape)
    assert files == [f"{ARCH}__{shape}__pod1.json"]
    with open(d / shape / files[0]) as f:
        rec = json.load(f)
    top, roofline, cost = _reference_record_keys()
    assert set(rec) == (top - {"fits_hbm_16g"}) | {
        "fits_device_memory", "device_memory_bytes", "hardware"}
    assert set(rec["roofline"]) >= roofline
    assert set(rec["cost"]) >= cost
    assert set(rec["per_device"]) == {"arguments", "outputs", "temps",
                                      "aliased", "generated_code"}
    assert rec["mesh"] == {"data": 16, "model": 16} and rec["chips"] == 256
    assert rec["device_memory_bytes"] == 80 * 10 ** 9
    assert rec["hardware"] == "H100 SXM5 80GB, 700 W, data sheet"
    assert rec["per_device"]["arguments"] == ref[shape]
    assert rec["per_device_peak_bytes"] >= rec["per_device"]["arguments"]
    assert np.isfinite(rec["cost"]["flops"]) and rec["cost"]["flops"] > 0
    assert rec["roofline"]["dominant"] in ("compute", "memory",
                                           "collective")
    if shape == "train_4k":
        assert rec["collectives"]["all-gather"]["count"] > 0
        assert rec["tensile_host_offload_bytes_per_device"] > 0


def test_one_device_mesh_counts_the_meshless_flops(cells):
    """On a (1, 1) mesh of a gloo world of one, the reduced train step,
    prefill and decode step count the meshless FLOPs exactly and issue no
    collective."""
    _, results, _, one = cells
    rc, out, err = results["one"]
    assert rc == 0, out[-4000:] + err[-8000:]
    for kind in ("train", "prefill", "decode"):
        assert one["mesh"][kind]["flops"] == one["meshless"][kind]["flops"]
        assert one["mesh"][kind]["flops"] > 0
        assert one["mesh"][kind]["collectives"] == []


def test_reference_shard_bytes_ran(cells):
    _, results, ref, _ = cells
    rc, out, err = results["reference"]
    assert rc == 0, out[-4000:] + err[-8000:]
    assert set(ref) == set(CELLS)
