"""The port's distribution against the JAX package's, on the CPU.

``launch.mesh``, ``launch.sharding`` (``MeshRules``), ``runtime.elastic``,
the step builders under ``rules``, ``moe_apply_a2a`` and
``compressed_psum_mean`` run on several ranks of a gloo world: the rank
bodies are ``tests/torch_dist_workers.py``, spawned in a subprocess under
a time limit (a dead rank fails a test instead of hanging the run), with
``init_process_group(timeout=60 s)`` over a ``FileStore``.  The JAX side
runs once, in a subprocess with ``XLA_FLAGS`` forcing four host devices
(as ``tests/test_distribution.py`` does); it draws the weights and inputs
from seeds and writes them with its outputs as numpy, which the port's
ranks read (weights through ``convert.params_from_jax``).  The rule table
and the shard shapes on the full-width (1, 16), (16, 16) and (2, 16, 16)
meshes come from a one-process world of 512 ranks on torch's ``fake``
backend, held to the reference's ``NamedSharding`` on an ``AbstractMesh``.

Tolerances: the sharded step against the meshless one, fp32, rtol 1e-5
(a sharded reduction sums in another order); against the reference's
sharded step, that test's step tolerance (rtol 2e-2, atol 2e-4); the
sharded prefill and ``moe_apply_a2a`` (output and gradients) against one
device, fp32, rtol 1e-5 and an atol of 4e-6 of the largest magnitude
(``_fp32_close``: a reordered fp32 sum moves the last bits of an element by
its neighbours' size; measured here, 1.2e-6 of the largest logit and
2.2e-7 of the largest weight gradient, which reaches 2.4e3, where one
ulp is 2.4e-4); against the reference, its prefill tolerance (rtol
3e-2, atol 3e-3); ``compressed_psum_mean`` bit for bit; the (1, 1) mesh
bit for bit.
"""
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config as jax_config
from repro.launch.sharding import MeshRules as JaxMeshRules
from repro.models.registry import get_model as jax_get_model
from repro.runtime.elastic import plan_elastic_mesh as jax_plan
from repro_torch.configs import get_config, list_configs
from repro_torch.models.registry import get_model
from repro_torch.runtime.elastic import plan_elastic_mesh

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
WORKERS = os.path.join(HERE, "torch_dist_workers.py")
MESHES = {(1, 16): ("data", "model"), (16, 16): ("data", "model"),
          (2, 16, 16): ("pod", "data", "model")}
STEP_TOL = dict(rtol=2e-2, atol=2e-4)
PREFILL_TOL = dict(rtol=3e-2, atol=3e-3)


def _fp32_close(got, want, **kw):
    """fp32 summed in another order: rtol 1e-5, atol 4e-6 of max|want|."""
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=4e-6 * np.abs(want).max(), **kw)


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


def _start(args, **env):
    return subprocess.Popen(args, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            env=_env(**env))


def _wait(proc, timeout):
    """The output of a process started by ``_start``; killed (and the test
    failed) when it outlives ``timeout`` seconds or exits non-zero."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        pytest.fail(f"timed out after {timeout} s:\n{err[-8000:]}")
    assert proc.returncode == 0, (f"STDOUT:\n{out[-4000:]}\n"
                                  f"STDERR:\n{err[-8000:]}")
    return out


def _run(args, timeout, **env):
    return _wait(_start(args, **env), timeout)


# ----------------------------------------------------------------------
# the reference's side: weights, inputs and outputs on four XLA devices
# ----------------------------------------------------------------------
REFERENCE = """
    import pickle, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.configs import get_config
    from repro.launch.mesh import make_mesh
    from repro.launch.sharding import MeshRules, use_rules
    from repro.launch.steps import TrainStepConfig, build_train_step
    from repro.models.layers import ParamBuilder
    from repro.models.moe import init_moe, moe_apply_a2a
    from repro.models.registry import get_model
    from repro.optim.adam import adamw_init
    from repro.optim.compression import compressed_psum_mean

    out = {}
    npt = lambda t: jax.tree.map(np.asarray, t)
    cfg = get_config("tinyllama-1.1b").reduced()
    api = get_model(cfg)
    params, axes = api.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, cfg.vocab_size, (8, 64), dtype=np.int32)
             for k in ("tokens", "labels")}
    out["train_params"] = npt(params)
    out["train_batch"] = batch
    mesh = make_mesh((2, 2), ("data", "model"))
    rules = MeshRules(mesh, cfg=cfg)
    for tag, comp in (("plain", None), ("int8", "int8")):
        p = jax.tree.map(jax.device_put, params, rules.param_shardings(axes))
        opt = adamw_init(p, grad_compression=comp is not None)
        step = jax.jit(build_train_step(
            api, rules, TrainStepConfig(grad_compression=comp)))
        losses = []
        for _ in range(2):
            p, opt, m = step(p, opt, batch)
            losses.append(float(m["loss"]))
        out["ref_train_" + tag] = {"loss": losses, "params": npt(p)}

    x = np.random.default_rng(1).standard_normal((4, 4096), np.float32)
    m4 = make_mesh((4,), ("pod",))
    y = jax.jit(jax.shard_map(lambda xs: compressed_psum_mean(xs, "pod"),
                              mesh=m4, in_specs=P("pod"),
                              out_specs=P("pod")))(jnp.asarray(x))
    out["psum_x"], out["psum_y"] = x, np.asarray(y)

    mcfg = get_config("moonshot-v1-16b-a3b").reduced()
    mcfg.capacity_factor = 8.0
    b = ParamBuilder(jax.random.PRNGKey(2), jnp.float32)
    init_moe(b, mcfg.d_model, mcfg.n_experts, mcfg.moe_d_ff, mcfg.mlp_act,
             mcfg.n_shared_experts)
    xm = np.random.default_rng(3).standard_normal((4, 16, mcfg.d_model),
                                                  np.float32)
    out["moe_params"], out["moe_x"] = npt(b.params), xm
    out["moe_dy"] = np.random.default_rng(4).standard_normal(xm.shape,
                                                             np.float32)
    kw = dict(top_k=mcfg.top_k, n_experts=mcfg.n_experts,
              capacity_factor=mcfg.capacity_factor, act=mcfg.mlp_act)
    for shape in ((1, 4), (2, 2)):
        r = MeshRules(make_mesh(shape, ("data", "model")), cfg=mcfg)
        with use_rules(r):
            ya, aux = jax.jit(lambda p, xx: moe_apply_a2a(p, xx, **kw))(
                b.params, jnp.asarray(xm))
        out[f"a2a_{shape[0]}x{shape[1]}"] = (np.asarray(ya), float(aux))
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)
    print("REF_OK")
"""


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Both sides' results: the reference's pickle, and the npz files the
    ranks of ``mesh4`` (four) and ``world1`` (one) wrote."""
    d = str(tmp_path_factory.mktemp("dist"))
    ref = os.path.join(d, "ref.pkl")
    one = os.path.join(d, "one")
    os.makedirs(one)
    # the one-rank world needs nothing of the reference: side by side
    world1 = _start([sys.executable, WORKERS, "world1", "1", one])
    # the limits leave room for a loaded host (unloaded: about 25, 70 and
    # 35 s)
    _run([sys.executable, "-c", textwrap.dedent(REFERENCE), ref], 480,
         XLA_FLAGS="--xla_force_host_platform_device_count=4",
         JAX_PLATFORMS="cpu")
    _run([sys.executable, WORKERS, "mesh4", "4", d], 900)
    _wait(world1, 300)
    with open(ref, "rb") as f:
        data = pickle.load(f)

    def load(name, rank=0, sub=""):
        with np.load(os.path.join(d, sub, f"{name}_r{rank}.npz")) as z:
            return {k: z[k] for k in z.files}
    return data, load


def _flat(tree, prefix="", leaf=np.asarray):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}.", leaf))
        else:
            out[f"{prefix}{k}"] = leaf(v)
    return out


def _prefixed(res, prefix):
    return {k[len(prefix):]: v for k, v in res.items()
            if k.startswith(prefix)}


# ----------------------------------------------------------------------
# 1-2: the rule table, the shard shapes and the axes tree
# ----------------------------------------------------------------------
FAKE_WORLD = """
    import pickle, sys, math
    import torch, torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    from repro_torch.configs import get_config, list_configs
    from repro_torch.launch.mesh import (data_axes, make_mesh,
                                         make_production_mesh)
    from repro_torch.launch.sharding import MeshRules
    from repro_torch.models.registry import get_model

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512)
    meshes = {(1, 16): make_mesh((1, 16), ("data", "model")),
              (16, 16): make_production_mesh(multi_pod=False),
              (2, 16, 16): make_production_mesh(multi_pod=True)}
    out = {"mesh_shapes": {k: (tuple(m.shape), tuple(m.mesh_dim_names),
                               data_axes(m)) for k, m in meshes.items()}}
    for name in list_configs():
        api = get_model(get_config(name), "cpu")
        shell = api.shell()
        shapes = {k: tuple(p.shape) for k, p in shell.named_parameters()}
        axes = shell.named_param_axes()
        for key, mesh in meshes.items():
            rules = MeshRules(mesh, cfg=api.cfg)
            assert all(p.is_replicate() for p in rules.replicated().placements)
            local = {}
            for k, shape in shapes.items():
                s = rules.shardings_for(axes[k], torch.Size(shape))
                local[k] = tuple(compute_local_shape_and_global_offset(
                    shape, mesh, s.placements)[0])
            out[(name, key)] = {"table": rules.table, "local": local,
                                "spec": {k: rules.spec(a)
                                         for k, a in axes.items()}}
    dist.destroy_process_group()
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def fake_world(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("fake") / "rules.pkl")
    _run([sys.executable, "-c", textwrap.dedent(FAKE_WORLD), path], 480)
    with open(path, "rb") as f:
        return pickle.load(f)


def test_production_mesh_shapes(fake_world):
    """The reference's ``test_production_mesh_shapes``, and the batch axes
    of each mesh (``data_axes``)."""
    shapes = fake_world["mesh_shapes"]
    assert shapes[(16, 16)] == ((16, 16), ("data", "model"), ("data",))
    assert shapes[(2, 16, 16)] == ((2, 16, 16), ("pod", "data", "model"),
                                   ("pod", "data"))


@pytest.mark.parametrize("mesh_shape", list(MESHES))
@pytest.mark.parametrize("name", list_configs())
def test_rule_table_and_shard_shapes(fake_world, name, mesh_shape):
    """The table, each parameter's spec, and each full-width parameter's
    local shard shape equal the reference's ``NamedSharding.shard_shape``
    (divisibility fallback included: qwen's 40 heads, kimi's 8 KV heads)."""
    ref_rules = JaxMeshRules(AbstractMesh(mesh_shape, MESHES[mesh_shape]),
                             cfg=jax_config(name))
    port = fake_world[(name, mesh_shape)]
    assert port["table"] == ref_rules.table
    params, axes = jax_get_model(jax_config(name)).abstract_params()
    shard = _flat(jax.tree.map(
        lambda s, p: s.shard_shape(p.shape),
        ref_rules.shardings_for(axes, params), params,
        is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding)))
    assert port["local"] == {k: tuple(v) for k, v in shard.items()}
    ref_spec = _flat(axes, leaf=lambda a: tuple(ref_rules.spec(a)))
    # a PartitionSpec writes a one-axis tuple as the axis
    one = lambda m: m[0] if isinstance(m, tuple) and len(m) == 1 else m  # noqa: E731
    assert ref_spec == {k: tuple(map(one, v))
                        for k, v in port["spec"].items()}


def test_head_divisibility_fallback(fake_world):
    """The reference's ``test_mesh_rules_head_divisibility_fallback``."""
    qwen = fake_world[("qwen2.5-14b", (16, 16))]["table"]
    kimi = fake_world[("kimi-k2-1t-a32b", (16, 16))]["table"]
    assert qwen["heads"] is None and qwen["kv_heads"] is None
    assert kimi["heads"] == "model" and kimi["kv_heads"] is None
    assert kimi["tp_kv"] is None and kimi["act_heads"] == "model"


@pytest.mark.parametrize("name", list_configs())
def test_param_axes_tree(name):
    """``api.param_axes()`` is the reference's axes tree, leaf by leaf."""
    _, want = jax_get_model(jax_config(name)).abstract_params()
    got = get_model(get_config(name), "cpu").param_axes()
    same = lambda a: a  # noqa: E731
    got, want = _flat(got, leaf=same), _flat(want, leaf=same)
    assert set(got) == set(want)
    for k in want:
        assert got[k] == want[k], k


# ----------------------------------------------------------------------
# 3: the sharded train step
# ----------------------------------------------------------------------
@pytest.mark.parametrize("tag", ["plain", "int8", "microbatch"])
def test_sharded_train_step(world, tag):
    """Reduced TinyLlama on (2, 2), four ranks, two steps: the loss and
    parameters equal the meshless port's on every rank, and the
    reference's sharded step's; the loss does not blow up (the
    reference's ``test_sharded_train_step_runs``).

    Against meshless, fp32: the loss at rtol 1e-5; the parameters at rtol
    1e-5 and atol 1e-6, a hundredth of the learning rate (AdamW's update of
    an element whose gradient is near zero moves by up to the learning
    rate as the gradient's last bits change: one element in 65536 moves
    3.3e-7 here).  With int8 gradients the parameters are held at the
    step tolerance: the quantizer's rounding is discontinuous, and a
    last-bit difference in a reduced gradient can carry an element across
    a rounding boundary, moving its update by up to a whole step (1.3e-4
    here, in two elements of 32768); ``test_int8_quantizes_whole_leaf_
    blocks`` holds the quantizer itself bit for bit.  Two microbatches
    (gradient accumulation of the reduced gradients) against meshless
    only: the reference's sharded step is not run with them."""
    data, load = world
    ref = data.get("ref_train_" + tag)
    for rank in range(4):
        res = load(f"train_{tag}", rank)
        loss, want = res["loss"], res["want_loss"]
        assert np.isfinite(loss).all()
        assert loss[1] < loss[0] * 1.2
        np.testing.assert_allclose(loss, want, rtol=1e-5)
        got = _prefixed(res, "p:")
        plain = _prefixed(res, "w:")
        assert set(got) == set(plain)
        tol = STEP_TOL if tag == "int8" else dict(rtol=1e-5, atol=1e-6)
        for k in got:
            np.testing.assert_allclose(got[k], plain[k], **tol, err_msg=k)
        if ref is None:
            continue
        np.testing.assert_allclose(loss, ref["loss"], **STEP_TOL)
        ref_p = _flat(ref["params"])
        assert set(got) == set(ref_p)
        for k in got:
            np.testing.assert_allclose(got[k], ref_p[k], **STEP_TOL,
                                       err_msg=k)
    # the parameters really were sharded, FSDP over "data" included
    placements = " ".join(load(f"train_{tag}")["placements"])
    assert "Shard(dim=0), Shard(dim=1)" in placements
    assert "Shard(dim=1), Replicate()" in placements


def test_int8_quantizes_whole_leaf_blocks(world):
    """Under a mesh ``ef_compress_grads`` quantizes the 2048-element blocks
    of the whole flattened leaf, as the reference's reduced gradient, bit
    for bit, not each shard's own flattening (which differs here)."""
    _, load = world
    for rank in range(4):
        res = load("blocks", rank)
        np.testing.assert_array_equal(res["got"], res["want"])
        np.testing.assert_array_equal(res["ef"], res["want_ef"])
        assert not np.array_equal(res["own"], res["local"])


# ----------------------------------------------------------------------
# 4: the sharded prefill
# ----------------------------------------------------------------------
@pytest.mark.parametrize("tag", ["moe", "moe_flash", "gqa_flash"])
def test_sharded_prefill(world, tag):
    """Reduced Moonlight (scatter, capacity factor 8) on (2, 2), with and
    without the flash kernel, and reduced TinyLlama (4 query heads, 2 KV
    heads) with the kernel on (1, 4), where each rank's one query head
    meets its group's KV head: the logits equal the meshless forward's
    (fp32, ``_fp32_close``).  The kernel's plain version got plain tensors:
    the rank's local heads."""
    _, load = world
    res = load("prefill", 1)
    _fp32_close(res[tag], res[tag + ":want"])
    seen = list(res[tag + ":seen"])
    if tag == "moe":
        assert seen == [""]
        return
    assert seen and all(s.startswith("('Tensor', 'Tensor', 'Tensor'")
                        for s in seen)
    if tag == "gqa_flash":
        # (B, S, 1 of 4 heads, Dh) and (B, S, 1 of 2 KV heads, Dh)
        assert all(", 1, 32), (4, 64, 1, 32))" in s for s in seen)
    else:
        assert all(", 2, 32), (2, 64, 1, 32))" in s for s in seen)


# ----------------------------------------------------------------------
# 5: compressed_psum_mean
# ----------------------------------------------------------------------
def test_compressed_psum_mean(world):
    """Four ranks against the reference's ``shard_map`` over four devices:
    bit for bit, and within its error bound ``max|x| / 127 * 2``."""
    data, load = world
    x, want = data["psum_x"], data["psum_y"]
    got = np.concatenate([load("psum", r)["y"] for r in range(4)])
    np.testing.assert_array_equal(got, want)
    mean = np.broadcast_to(x.mean(0, keepdims=True), x.shape)
    assert np.abs(got - mean).max() <= np.abs(x).max() / 127 * 2


# ----------------------------------------------------------------------
# 6: moe_apply_a2a
# ----------------------------------------------------------------------
def _scatter_one_device(data):
    from repro_torch.configs import get_config as port_config
    from repro_torch.models import moe
    cfg = port_config("moonshot-v1-16b-a3b").reduced()
    p = {k: torch.from_numpy(v).requires_grad_(True)
         for k, v in data["moe_params"].items()}
    x = torch.from_numpy(data["moe_x"]).requires_grad_(True)
    y, aux = moe.moe_apply_scatter(
        p, x, top_k=cfg.top_k, n_experts=cfg.n_experts, capacity_factor=8.0,
        act=cfg.mlp_act)
    dy = torch.from_numpy(data["moe_dy"])
    grads = torch.autograd.grad((y * dy).sum(), [x] + list(p.values()))
    return (y.detach().numpy(), float(aux.detach()), grads[0].numpy(),
            {k: g.numpy() for k, g in zip(p, grads[1:])})


@pytest.mark.parametrize("shape", ["1x4", "2x2"])
def test_a2a_moe(world, shape):
    """``moe_apply_a2a`` at capacity factor 8 (nothing dropped): its output
    and its input and weight gradients equal ``moe_apply_scatter``'s on
    one device (fp32, ``_fp32_close``), and its output the reference's
    ``moe_apply_a2a`` on the same XLA mesh at the reference's prefill
    tolerance."""
    data, load = world
    y1, aux1, gx1, gw1 = _scatter_one_device(data)
    ref_y, ref_aux = data["a2a_" + shape]
    for rank in range(4):
        res = load("a2a", rank)
        y = res[shape + ":y"]
        _fp32_close(y, y1)
        np.testing.assert_allclose(y, ref_y, **PREFILL_TOL)
        np.testing.assert_allclose(res[shape + ":aux"], ref_aux, rtol=1e-5)
        _fp32_close(res[shape + ":gx"], gx1)
        for k, g in gw1.items():
            _fp32_close(res[f"{shape}:g:{k}"], g, err_msg=k)


def test_a2a_moe_fallback(world):
    """A model extent of 1 (a (4, 1) mesh) takes the scatter path: the
    reference's ``test_a2a_moe_single_device_fallback``."""
    data, load = world
    y1, aux1, gx1, _ = _scatter_one_device(data)
    res = load("a2a", 2)
    np.testing.assert_allclose(res["4x1:y"], y1, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(res["4x1:aux"], aux1, rtol=1e-6)
    np.testing.assert_allclose(res["4x1:gx"], gx1, rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------------------
# 7-8: elastic planning, resharding and restore
# ----------------------------------------------------------------------
@pytest.mark.parametrize("prev_tp", [1, 2, 4, 8, 16])
def test_plan_elastic_mesh(prev_tp):
    for n in range(1, 65):
        got, want = plan_elastic_mesh(n, prev_tp), jax_plan(n, prev_tp)
        assert (got.mesh_shape, got.axes, got.kept_model_degree,
                got.dp_degree, got.tp_degree) == (
            want.mesh_shape, want.axes, want.kept_model_degree,
            want.dp_degree, want.tp_degree), n


def test_elastic_reshard_4_to_2(world):
    """Parameters on (2, 2) over four ranks, resharded onto (1, 2) over two
    of them, keep every value (the reference's
    ``test_elastic_reshard_8_to_4``); the ranks outside hold nothing."""
    _, load = world
    whole = _prefixed(load("elastic", 0), "w:")
    for rank in range(4):
        res = load("elastic", rank)
        if rank >= 2:
            assert not res["inside"] and res["none"]
            continue
        assert res["inside"]
        for k, v in whole.items():
            np.testing.assert_array_equal(res["rw:" + k], v, err_msg=k)
            place = str(res["rp:" + k])
            if "Shard(dim=" in place:
                assert res["r:" + k].size < v.size, k


def test_elastic_checkpoint_restore(world):
    """A checkpoint saved on (2, 2) restores into a (1, 2) template with
    equal leaves."""
    _, load = world
    whole = _prefixed(load("elastic", 0), "w:")
    for rank in (0, 1):
        got = _prefixed(load("elastic", rank), "c:")
        assert set(got) == set(whole)
        for k, v in whole.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)


# ----------------------------------------------------------------------
# 9: the launcher
# ----------------------------------------------------------------------
def test_launcher_on_four_ranks(world):
    """``launch.train.main(["--mesh", "2,2", ...])`` on four ranks returns
    0 on each, with the same losses on every rank."""
    _, load = world
    logs = []
    for rank in range(4):
        res = load("launcher", rank)
        assert int(res["rc"]) == 0
        log = str(res["log"])
        assert "mesh={'data': 2, 'model': 2}" in log
        logs.append([ln.split("(")[0] for ln in log.splitlines()
                     if ln.startswith("  step")])
    assert len(logs[0]) == 3
    assert all(lg == logs[0] for lg in logs)


def test_restart_resumes_every_rank_at_one_step(world):
    """The restart loop on four ranks under (2, 2), as the launcher runs it
    (asynchronous checkpoints every 2 steps), with a failure injected at
    step 3 right after step 2's save, the first: every rank restarts
    once, resumes from the step the first rank committed, and ends bit
    for bit where the run without the failure ends (the same losses step
    by step, the same parameters)."""
    _, load = world
    first = load("restart", 0)
    for rank in range(4):
        res = load("restart", rank)
        assert int(res["restarts"]) == 1 and int(res["final"]) == 4
        np.testing.assert_array_equal(res["losses"], res["want_losses"])
        np.testing.assert_array_equal(res["losses"], first["losses"])
        got, want = _prefixed(res, "p:"), _prefixed(res, "w:")
        assert got and set(got) == set(want)
        for k in got:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ----------------------------------------------------------------------
# 10: a one-device mesh, bit for bit
# ----------------------------------------------------------------------
def test_checkpoint_name_on_a_dtensor(world):
    """The remat tag runs on a DTensor's local shard, gives a DTensor and
    passes the gradient through."""
    _, load = world
    res = load("tag", 0, "one")
    assert str(res["kind"]) == "DTensor"
    np.testing.assert_array_equal(res["value"], np.arange(6.0))
    np.testing.assert_array_equal(res["grad"], np.full(6, 2.0))


def test_one_device_mesh_bit_for_bit(world):
    """A (1, 1) mesh over a gloo world of one: two train steps (loss,
    parameters, both moments) and the prefill equal meshless bit for
    bit."""
    _, load = world
    res = load("one", 0, "one")
    assert tuple(res["shape"]) == (1, 1)
    np.testing.assert_array_equal(res["loss"], res["want_loss"])
    np.testing.assert_array_equal(res["logits"], res["want"])
    for a, b in (("p:", "w:"), ("mu:", "wmu:"), ("nu:", "wnu:")):
        got, want = _prefixed(res, a), _prefixed(res, b)
        assert got and set(got) == set(want)
        for k in got:
            np.testing.assert_array_equal(got[k], want[k], err_msg=a + k)


def test_one_device_mesh_decode_bit_for_bit(world):
    """``build_serve_step(rules=)`` on a (1, 1) mesh: three decode steps
    from an empty cache, the logits and the cache equal the meshless
    step's bit for bit (on one device the decode step runs on the
    parameters' local shards, the whole tensors)."""
    _, load = world
    res = load("decode", 0, "one")
    assert res["dec"].shape[0] == 3
    np.testing.assert_array_equal(res["dec"], res["want"])
    got, want = _prefixed(res, "c:"), _prefixed(res, "wc:")
    assert got and set(got) == set(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
