"""Optimizer moments in host memory under a mesh, on the CPU: the port's
``offload_opt_state`` under ``rules`` against the JAX package's
``opt_state_shardings(offload=True)`` and sharded step.

The reference runs once, in a subprocess with ``XLA_FLAGS`` forcing four
host devices: reduced TinyLlama's weights and batch from seeds, two of its
sharded train steps on (2, 2) and (1, 4), without and with fp32 master
copies, the shard shape of every moment and master leaf under
``opt_state_shardings(rules, ..., offload=True)`` and its
``offloaded_bytes``.  Its CPU backend has no memory kinds, so its
``offload=True`` shardings are its device shardings.  The port runs on
four gloo ranks (``tests/torch_dist_workers.py host4``) and on a world of
one (``host1``), the (1, 1) mesh that the card runs.

Tolerances: the host-state step under a mesh against the same step with
the state on the device, bit for bit (the same operations on the same
values); against the meshless step with host moments, fp32, rtol 1e-5 and
atol 1e-6 (``test_sharded_train_step``'s: a sharded reduction sums in
another order); against the reference's sharded step, ``STEP_TOL``.
Shard shapes, byte counts, checkpoints and reshards are held exactly.
"""
import os
import pickle
import sys
import textwrap

import numpy as np
import pytest
import torch

from test_torch_distribution import (STEP_TOL, WORKERS, _flat, _prefixed,
                                     _run, _start, _wait)
from repro_torch.launch.sharding import HostShard, host_empty

RUNS = [(shape, master) for shape in ("2x2", "1x4")
        for master in ("plain", "master")]

REFERENCE = """
    import pickle, sys
    import jax, numpy as np
    from repro.configs import get_config
    from repro.launch.mesh import make_mesh
    from repro.launch.sharding import MeshRules
    from repro.launch.steps import (TrainStepConfig, build_train_step,
                                    offloaded_bytes, opt_state_shardings)
    from repro.models.registry import get_model
    from repro.optim.adam import adamw_init

    npt = lambda t: jax.tree.map(np.asarray, t)
    cfg = get_config("tinyllama-1.1b").reduced()
    api = get_model(cfg)
    params, axes = api.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, cfg.vocab_size, (8, 64), dtype=np.int32)
             for k in ("tokens", "labels")}
    out = {"params": npt(params), "batch": batch}
    for shape in ((2, 2), (1, 4)):
        rules = MeshRules(make_mesh(shape, ("data", "model")), cfg=cfg)
        p_shard = rules.shardings_for(axes, params)
        for master in (False, True):
            p = jax.tree.map(jax.device_put, params, p_shard)
            opt = adamw_init(p, use_master=master)
            o_shard = opt_state_shardings(rules, p_shard, use_master=master,
                                          offload=True)
            shard_shapes = {}
            for tree in ("mu", "nu", "master") if master else ("mu", "nu"):
                shard_shapes[tree] = jax.tree.map(
                    lambda s, x: tuple(s.shard_shape(x.shape)),
                    getattr(o_shard, tree), getattr(opt, tree))
            step = jax.jit(build_train_step(
                api, rules, TrainStepConfig(use_master=master)))
            losses = []
            for _ in range(2):
                p, opt, m = step(p, opt, batch)
                losses.append(float(m["loss"]))
            tag = f"{shape[0]}x{shape[1]}:{'master' if master else 'plain'}"
            out[tag] = {"loss": losses, "params": npt(p),
                        "shard_shapes": shard_shapes,
                        "offloaded_bytes": offloaded_bytes(opt)}
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The reference's pickle, and the npz files the ranks of ``host4``
    (four) and ``host1`` (one) wrote from its weights and batch."""
    d = str(tmp_path_factory.mktemp("host"))
    one = os.path.join(d, "one")
    os.makedirs(one)
    _run([sys.executable, "-c", textwrap.dedent(REFERENCE),
          os.path.join(d, "host.pkl")], 480,
         XLA_FLAGS="--xla_force_host_platform_device_count=4",
         JAX_PLATFORMS="cpu")
    os.symlink(os.path.join(d, "host.pkl"), os.path.join(one, "host.pkl"))
    # the one-rank world beside the four
    host1 = _start([sys.executable, WORKERS, "host1", "1", one])
    _run([sys.executable, WORKERS, "host4", "4", d], 900)
    _wait(host1, 300)
    with open(os.path.join(d, "host.pkl"), "rb") as f:
        data = pickle.load(f)

    def load(name, rank=0, sub=""):
        with np.load(os.path.join(d, sub, f"{name}_r{rank}.npz")) as z:
            return {k: z[k] for k in z.files}
    return data, load


def _equal_trees(got, want, what):
    assert got and set(got) == set(want), what
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=what + k)


def _hold_runs(res, ref):
    """The host run against the device run bit for bit, the meshless host
    run at rtol 1e-5 / atol 1e-6 and the reference at ``STEP_TOL``."""
    host = _prefixed(res, "host:")
    device = _prefixed(res, "device:")
    meshless = _prefixed(res, "meshless:")
    assert set(host) == set(device) == set(meshless)
    for k in host:
        np.testing.assert_array_equal(host[k], device[k], err_msg=k)
        if k == "loss":
            np.testing.assert_allclose(host[k], meshless[k], rtol=1e-5)
        else:
            np.testing.assert_allclose(host[k], meshless[k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)
    assert np.isfinite(host["loss"]).all()
    np.testing.assert_allclose(host["loss"], ref["loss"], **STEP_TOL)
    ref_p = _flat(ref["params"])
    got_p = _prefixed(host, "p:")
    assert set(got_p) == set(ref_p)
    for k in got_p:
        np.testing.assert_allclose(got_p[k], ref_p[k], **STEP_TOL, err_msg=k)


def _ref_shard_shapes(ref):
    return {f"{tree}:{k}": tuple(v) for tree, shapes in
            ref["shard_shapes"].items()
            for k, v in _flat(shapes, leaf=tuple).items()}


@pytest.mark.parametrize("shape,master", RUNS)
def test_host_state_step(world, shape, master):
    """Two steps of reduced TinyLlama with the moments (and masters) in
    host memory under the rules, on every rank: bit for bit the same steps
    with the state on the device, within fp32 reordering of the meshless
    host step, and within the step tolerance of the reference's sharded
    step."""
    data, load = world
    for rank in range(4):
        res = _prefixed(load("host_state", rank), f"{shape}:{master}:")
        _hold_runs(res, data[f"{shape}:{master}"])


@pytest.mark.parametrize("shape,master", RUNS)
def test_host_shards_are_the_reference_shards(world, shape, master):
    """Between steps every moment and master leaf is a ``HostShard`` whose
    local shape is the reference's ``NamedSharding.shard_shape`` of the
    leaf under ``opt_state_shardings(offload=True)``; no rank holds a
    whole leaf that the reference shards, and the ranks' shards of each
    leaf add up to its whole."""
    data, load = world
    want = _ref_shard_shapes(data[f"{shape}:{master}"])
    assert {k.split(":")[0] for k in want} == (
        {"mu", "nu", "master"} if master == "master" else {"mu", "nu"})
    whole = {k: v.shape for k, v in _prefixed(
        load("host_state", 0), f"{shape}:{master}:host:").items()
        if k.split(":")[0] in ("mu", "nu", "master")}
    assert set(whole) == set(want)
    sharded = [k for k in want if want[k] != whole[k]]
    assert sharded
    for rank in range(4):
        res = _prefixed(load("host_state", rank), f"{shape}:{master}:")
        types = _prefixed(res, "type:")
        local = {k: tuple(v) for k, v in _prefixed(res, "local:").items()}
        assert set(types) == set(local) == set(want)
        assert {str(t) for t in types.values()} == {"HostShard"}
        assert local == want
        for k in sharded:
            assert np.prod(local[k]) < np.prod(whole[k]), k


@pytest.mark.parametrize("shape,master", RUNS)
def test_offloaded_bytes_are_the_reference(world, shape, master):
    """``offloaded_bytes`` of the host shards counts each leaf by its
    global shape: the reference's count, and the device state's."""
    data, load = world
    ref = data[f"{shape}:{master}"]["offloaded_bytes"]
    for rank in range(4):
        res = load("host_state", rank)
        assert int(res[f"{shape}:{master}:offloaded"]) == ref
        assert int(res[f"{shape}:{master}:device_offloaded"]) == ref


def test_host_state_checkpoint_resumes(world):
    """A save of (parameters, host-shard state) after step 1 restored into
    a template of other values whose state is host shards: the template
    keeps its host shards, and step 2 from it is step 2 of the saved run
    bit for bit (loss, parameters, both moments)."""
    _, load = world
    for rank in range(4):
        res = load("host_checkpoint", rank)
        assert bool(res["same_objects"])
        assert list(res["types"]) == ["HostShard"]
        assert int(res["step"]) == 2
        np.testing.assert_array_equal(res["loss"], res["want_loss"])
        _equal_trees(_prefixed(res, "p:"), _prefixed(res, "w:"), "p:")
        _equal_trees(_prefixed(res, "s:"), _prefixed(res, "ws:"), "s:")


def test_host_state_reshard_4_to_2(world):
    """The host-shard moments of (2, 2) resharded onto (1, 2) over ranks 0
    and 1: host shards again, placed and holding the values of the
    resharded device state bit for bit; the ranks outside hold nothing."""
    _, load = world
    for rank in range(4):
        res = _prefixed(load("host_state", rank), "reshard:")
        if rank >= 2:
            assert bool(res["host:none"]) and bool(res["device:none"])
            continue
        host, device = _prefixed(res, "host:"), _prefixed(res, "device:")
        assert host and set(host) == set(device)
        for k in host:
            if k.endswith(":type"):
                assert str(host[k]) == "HostShard"
                assert str(device[k]) == "DTensor"
            else:
                np.testing.assert_array_equal(host[k], device[k], err_msg=k)
        assert any("Shard(dim=" in str(v) for k, v in host.items()
                   if k.endswith(":placements"))


def test_host_state_restart_resumes(world):
    """The restart loop on (2, 2) with the moments in host memory and a
    failure injected at step 3, right after the first asynchronous save:
    every rank restarts once and ends bit for bit where the run without
    the failure ends (losses step by step, parameters, both moments)."""
    _, load = world
    for rank in range(4):
        res = load("host_restart", rank)
        assert int(res["restarts"]) == 1 and int(res["final"]) == 4
        assert list(res["types"]) == ["HostShard"]
        np.testing.assert_array_equal(res["losses"], res["want_losses"])
        _equal_trees(_prefixed(res, "p:"), _prefixed(res, "w:"), "p:")
        _equal_trees(_prefixed(res, "s:"), _prefixed(res, "ws:"), "s:")


@pytest.mark.parametrize("master", ["plain", "master"])
def test_one_device_mesh_host_state(world, master):
    """The (1, 1) mesh over a world of one, the path the card runs: the
    host-state step is bit for bit the device step under the mesh and the
    meshless host step; each leaf is a ``HostShard`` holding the whole
    tensor; ``offloaded_bytes`` is the reference's on one device."""
    data, load = world
    res = load("host_one", 0, "one")
    assert tuple(res["shape"]) == (1, 1)
    res = _prefixed(res, master + ":")
    host = _prefixed(res, "host:")
    for run in ("device:", "meshless:"):
        _equal_trees(host, _prefixed(res, run), run)
    types = _prefixed(res, "type:")
    assert types and {str(t) for t in types.values()} == {"HostShard"}
    for k, v in _prefixed(res, "local:").items():
        assert tuple(v) == host[k].shape, k
    assert int(res["offloaded"]) == sum(
        host[k].nbytes for k in types)


def test_host_shard_on_a_card_needs_the_card():
    """A host shard of a mesh on a card is pinned: without a card its
    buffer raises instead of falling back to plain host memory; a CPU
    mesh's is plain."""
    with pytest.raises(RuntimeError):
        host_empty((4,), torch.float32, "cuda")
    buf = host_empty((4,), torch.float32, "cpu")
    assert buf.device.type == "cpu" and not isinstance(buf, HostShard)
