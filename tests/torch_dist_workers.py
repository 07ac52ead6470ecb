"""Rank bodies of ``tests/test_torch_distribution.py``: the port's
distribution (``launch.mesh``, ``launch.sharding``, ``runtime.elastic``,
the step builders under ``rules``, ``moe_apply_a2a``,
``compressed_psum_mean``) on several ranks of a gloo world on the CPU.

    python tests/torch_dist_workers.py GROUP WORLD DIR

spawns WORLD processes over a ``FileStore`` in DIR; each runs the checks
of GROUP (``mesh4`` on four ranks, ``world1`` on one, or check names
joined by commas, ``train,psum``) and writes its
results to ``DIR/<check>_r<rank>.npz``.  Inputs made by the JAX package's
side (weights, batches, its outputs) are read from ``DIR/ref.pkl`` where a
check needs them.  Nothing here imports JAX.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ARCH = "tinyllama-1.1b"
MOE_ARCH = "moonshot-v1-16b-a3b"
TRAIN_B, TRAIN_S = 8, 64
PREFILL_B, PREFILL_S = 4, 64


def _save(d, name, rank, **arrays):
    np.savez(os.path.join(d, f"{name}_r{rank}.npz"),
             **{k: np.asarray(v) for k, v in arrays.items()})


def _np(t):
    from repro_torch.device import is_dtensor
    if is_dtensor(t):
        t = t.full_tensor()
    return t.detach().cpu().numpy()


def _flat_tree(tree):
    """``{path: leaf}`` of a pytree of tensors."""
    import torch.utils._pytree as pytree
    flat, _ = pytree.tree_flatten_with_path(tree)
    return {"/".join(str(p) for p in path): t for path, t in flat}


def _flat_params(model):
    return {k: _np(p) for k, p in model.named_parameters()}


def _tiny_cfg():
    from repro_torch.configs import get_config
    return get_config(ARCH).reduced()


def _train_batch(cfg):
    rng = np.random.default_rng(0)
    return {k: torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                             (TRAIN_B, TRAIN_S),
                                             dtype=np.int32))
            for k in ("tokens", "labels")}


def _ref(d):
    with open(os.path.join(d, "ref.pkl"), "rb") as f:
        return pickle.load(f)


def _two_steps(cfg, model, batch, rules=None, **tcfg_kw):
    """Two train steps from ``model`` (updated in place); the losses."""
    from repro_torch.launch.steps import (TrainStepConfig, build_train_step,
                                          opt_state_for)
    from repro_torch.launch.sharding import shard_params
    from repro_torch.models.registry import get_model
    from repro_torch.optim.adam import adamw_init
    api = get_model(cfg, "cpu")
    tcfg = TrainStepConfig(**tcfg_kw)
    if rules is not None:
        shard_params(model, rules)
    if tcfg.grad_compression:
        opt = adamw_init(dict(model.named_parameters()),
                         grad_compression=True)
    else:
        opt = opt_state_for(model)
    step = build_train_step(api, tcfg, rules=rules)
    losses = []
    for _ in range(2):
        model, opt, m = step(model, opt, batch)
        losses.append(float(m["loss"]))
    return losses, opt


# ----------------------------------------------------------------------
# four ranks
# ----------------------------------------------------------------------
def check_train(rank, d):
    """Reduced TinyLlama on (2, 2): two steps against two meshless ones
    and the reference's; then int8 gradients with the rules' FSDP on, and
    two microbatches."""
    from repro_torch.convert import params_from_jax
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import MeshRules
    ref = _ref(d)
    cfg = _tiny_cfg()
    batch = {k: torch.from_numpy(v) for k, v in ref["train_batch"].items()}
    mesh = make_mesh((2, 2), ("data", "model"))
    for tag, kw in (("plain", {}), ("int8", {"grad_compression": "int8"}),
                    ("microbatch", {"microbatches": 2})):
        plain = params_from_jax(ref["train_params"], cfg, "cpu")
        want_loss, _ = _two_steps(cfg, plain, batch, **kw)
        model = params_from_jax(ref["train_params"], cfg, "cpu")
        rules = MeshRules(mesh, cfg=cfg)
        assert rules.fsdp
        loss, opt = _two_steps(cfg, model, batch, rules=rules, **kw)
        placements = sorted({str(p.placements)
                             for p in model.parameters()})
        _save(d, f"train_{tag}", rank, loss=loss, want_loss=want_loss,
              placements=np.array(placements),
              **{"p:" + k: v for k, v in _flat_params(model).items()},
              **{"w:" + k: v for k, v in _flat_params(plain).items()},
              **{"mu:" + k: _np(v) for k, v in opt.mu.items()})


def check_prefill(rank, d):
    """Reduced Moonlight (scatter, capacity factor 8) on (2, 2) against the
    meshless forward; with the flash kernel on (2, 2), and TinyLlama's
    GQA on (1, 4), where the KV heads stay whole."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels import flash_attention
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import MeshRules
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models.registry import get_model

    seen = []
    plain_ref = flash_attention.flash_attention_ref

    def spy(q, k, v, **kw):
        seen.append(tuple(type(t).__name__ for t in (q, k, v))
                    + (tuple(q.shape), tuple(k.shape)))
        return plain_ref(q, k, v, **kw)

    flash_attention.flash_attention_ref = spy
    moe = get_config(MOE_ARCH).reduced()
    moe.moe_impl = "scatter"
    moe.capacity_factor = 8.0
    cases = {
        "moe": (moe, (2, 2)),
        "moe_flash": (dataclasses.replace(moe, use_flash_kernel=True),
                      (2, 2)),
        "gqa_flash": (dataclasses.replace(_tiny_cfg(), use_flash_kernel=True),
                      (1, 4)),
    }
    out = {}
    for tag, (cfg, shape) in cases.items():
        api = get_model(cfg, "cpu")
        batch = api.input_specs(ShapeSpec("s", PREFILL_S, PREFILL_B,
                                          "prefill"), abstract=False)
        want = build_prefill_step(api)(api.init(torch.Generator()
                                                .manual_seed(0)), batch)
        seen.clear()
        mesh = make_mesh(shape, ("data", "model"))
        rules = MeshRules(mesh, cfg=cfg)
        params = api.init(torch.Generator().manual_seed(0))
        got = build_prefill_step(api, rules=rules)(params, batch)
        out[tag] = _np(got)
        out[tag + ":want"] = _np(want)
        out[tag + ":seen"] = np.array([repr(s) for s in seen] or [""])
    flash_attention.flash_attention_ref = plain_ref
    _save(d, "prefill", rank, **out)


def check_psum(rank, d):
    """``compressed_psum_mean`` of row ``rank`` of the reference's input."""
    from repro_torch.optim.compression import compressed_psum_mean
    x = torch.from_numpy(_ref(d)["psum_x"][rank:rank + 1])
    _save(d, "psum", rank, y=compressed_psum_mean(x).numpy())


def check_int8_blocks(rank, d):
    """``ef_compress_grads`` of a DTensor gradient sharded across its
    2048-element blocks, beside the plain gradient's and each shard's own
    quantization."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.adam import AdamState
    from repro_torch.optim.compression import (ef_compress_grads,
                                               quantize_dequantize)
    from torch.distributed.tensor import Shard, distribute_tensor
    g = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (48, 96), np.float32))
    mesh = make_mesh((2, 2), ("data", "model"))
    dg = distribute_tensor(g, mesh, [Shard(1), Shard(0)], src_data_rank=None)
    state = AdamState(step=torch.zeros((), dtype=torch.int32), mu={}, nu={},
                      master=())
    got, st = ef_compress_grads({"g": dg}, state)
    want, wst = ef_compress_grads({"g": g}, state)
    own = quantize_dequantize(dg.to_local())
    _save(d, "blocks", rank, got=_np(got["g"]), want=want["g"].numpy(),
          ef=_np(st.ef["g"]), want_ef=wst.ef["g"].numpy(),
          own=own.numpy(), mine=dg.to_local().numpy(),
          local=got["g"].to_local().numpy())


def _moe_setup(d):
    from repro_torch.configs import get_config
    from repro_torch.models.moe import MoE
    ref = _ref(d)
    cfg = get_config(MOE_ARCH).reduced()
    cfg.capacity_factor = 8.0
    p = MoE(cfg.d_model, cfg.n_experts, cfg.moe_d_ff, cfg.mlp_act,
            cfg.n_shared_experts, dtype=torch.float32, device="meta")
    p.load_state_dict({k: torch.from_numpy(v)
                       for k, v in ref["moe_params"].items()},
                      strict=True, assign=True)
    return cfg, p, torch.from_numpy(ref["moe_x"])


def check_a2a(rank, d):
    """``moe_apply_a2a`` on (1, 4) and (2, 2), its output and the
    gradients of its input and weights, beside the scatter path on one
    rank; and its fallback on a (4, 1) mesh."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import MeshRules, shard_params, use_rules
    from repro_torch.models import moe
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import implicit_replication
    cfg = _moe_setup(d)[0]
    kw = dict(top_k=cfg.top_k, n_experts=cfg.n_experts,
              capacity_factor=cfg.capacity_factor, act=cfg.mlp_act)
    out = {}
    for shape in ((1, 4), (2, 2), (4, 1)):
        _, p, x = _moe_setup(d)
        mesh = make_mesh(shape, ("data", "model"))
        rules = MeshRules(mesh, cfg=cfg)
        shard_params(p, rules)
        for w in p.parameters():
            w.requires_grad_(True)
        xd = DTensor.from_local(x.clone().requires_grad_(True), mesh,
                                [Replicate(), Replicate()], run_check=False)
        with use_rules(rules), implicit_replication():
            y, aux = moe.moe_apply_a2a(p, xd, **kw)
            loss = (y * torch.from_numpy(_ref(d)["moe_dy"])).sum()
            grads = torch.autograd.grad(loss, [xd] + list(p.parameters()))
        names = [k for k, _ in p.named_parameters()]
        tag = f"{shape[0]}x{shape[1]}"
        out[tag + ":y"] = _np(y)
        out[tag + ":aux"] = _np(aux)
        out[tag + ":gx"] = _np(grads[0])
        for k, g in zip(names, grads[1:]):
            out[f"{tag}:g:{k}"] = _np(g)
    _save(d, "a2a", rank, **out)


def check_elastic(rank, d):
    """Parameters on (2, 2) over four ranks resharded onto (1, 2) over two
    of them; a checkpoint saved on (2, 2) restored into a (1, 2)
    template."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import MeshRules, shard_params
    from repro_torch.models.registry import get_model
    from repro_torch.runtime.elastic import reshard_state
    cfg = _tiny_cfg()
    api = get_model(cfg, "cpu")
    whole = _flat_params(api.init(torch.Generator().manual_seed(3)))
    model = api.init(torch.Generator().manual_seed(3))
    mesh4 = make_mesh((2, 2), ("data", "model"))
    shard_params(model, MeshRules(mesh4, cfg=cfg))
    state = dict(model.named_parameters())
    axes = model.named_param_axes()
    axes = {k: axes[k] for k in state}
    mesh2 = make_mesh((1, 2), ("data", "model"))
    new, rules = reshard_state(state, axes, mesh2, cfg=cfg)
    out = {"inside": np.array(mesh2 is not None)}
    if mesh2 is not None:
        for k, t in new.items():
            out["r:" + k] = t.to_local().numpy()
            out["rp:" + k] = np.array(str(t.placements))
            # the whole value, gathered over the two ranks of the new mesh
            out["rw:" + k] = t.full_tensor().numpy()
    else:
        out["none"] = np.array(all(t is None for t in new.values())
                               and rules is None)
    ckpt = os.path.join(d, "ckpt")
    mgr = CheckpointManager(ckpt)
    # save returns on every rank once the step is committed
    mgr.save(0, model)
    if mesh2 is not None:
        template = api.init(torch.Generator().manual_seed(4))
        shard_params(template, MeshRules(mesh2, cfg=cfg))
        restored, _ = mgr.restore(0, template=template)
        for k, p in restored.named_parameters():
            out["c:" + k] = p.full_tensor().numpy()
    dist.barrier()
    _save(d, "elastic", rank, **out,
          **{"w:" + k: v for k, v in whole.items()})


def check_launcher(rank, d):
    """``launch.train.main`` on the four ranks under ``--mesh 2,2``."""
    import contextlib
    import io
    from repro_torch.launch import train
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = train.main(["--device", "cpu", "--reduced", "--steps", "3",
                         "--batch", "4", "--seq", "32", "--log-every", "1",
                         "--mesh", "2,2", "--ckpt-dir",
                         os.path.join(d, "launcher_ckpt")])
    _save(d, "launcher", rank, rc=rc, log=np.array(buf.getvalue()))


def _resilient_run(d, tag, fail_at):
    """Five steps of reduced TinyLlama on (2, 2) through the restart loop,
    as the launcher runs it (async checkpoints, here every 2 steps): the
    losses and the final parameters."""
    from repro_torch.data.pipeline import (DataConfig, Prefetcher,
                                           TokenStream, to_device)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import MeshRules, shard_params
    from repro_torch.launch.steps import (TrainStepConfig, build_train_step,
                                          opt_state_for)
    from repro_torch.models.registry import get_model
    from repro_torch.runtime.fault_tolerance import (FTConfig,
                                                     resilient_train_loop)
    cfg = _tiny_cfg()
    api = get_model(cfg, "cpu")
    rules = MeshRules(make_mesh((2, 2), ("data", "model")), cfg=cfg)
    model = shard_params(api.init(torch.Generator().manual_seed(0)), rules)
    step = build_train_step(api, TrainStepConfig(), rules=rules)
    stream = TokenStream(DataConfig(seq_len=32, global_batch=4,
                                    vocab_size=cfg.vocab_size))
    prefetch = Prefetcher(stream, to_device=to_device(torch.device("cpu")))
    try:
        result = resilient_train_loop(
            step, (model, opt_state_for(model)), prefetch, 5,
            ft=FTConfig(ckpt_dir=os.path.join(d, tag), ckpt_every=2),
            data_stream=stream, fail_at=fail_at)
    finally:
        prefetch.close()
    return result, [m["loss"] for m in result.metrics_history], model


def check_restart(rank, d):
    """The restart loop on four ranks: a failure injected at step 3, right
    after step 2's asynchronous save (the first), against the same run
    without it."""
    got, losses, model = _resilient_run(d, "restart_fail", {3: 1})
    want, want_losses, plain = _resilient_run(d, "restart_plain", None)
    _save(d, "restart", rank, restarts=got.restarts,
          final=got.final_step, losses=losses, want_losses=want_losses,
          **{"p:" + k: v for k, v in _flat_params(model).items()},
          **{"w:" + k: v for k, v in _flat_params(plain).items()})


DECODE_ARCHS = (ARCH, "mamba2-780m", "whisper-base", MOE_ARCH)
DECODE_B, DECODE_LEN, DECODE_STEPS = 4, 8, 4


def check_sharded_decode(rank, d):
    """``build_serve_step(rules=)`` on (2, 2) and (1, 4) for reduced
    TinyLlama, Mamba-2, whisper and Moonlight at two layers: four steps
    from an empty cache beside the meshless step; the logits, and each
    rank's local cache shards with their global offsets."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import MeshRules
    from repro_torch.launch.steps import build_serve_step
    from repro_torch.models.registry import get_model
    out = {}
    for arch in DECODE_ARCHS:
        cfg = get_config(arch).reduced(n_layers=2)
        api = get_model(cfg, "cpu")
        shape = ShapeSpec("d", DECODE_LEN, DECODE_B, "decode")
        plain_step = build_serve_step(api)
        plain = api.init(torch.Generator().manual_seed(0))
        want_cache = api.init_cache(DECODE_B, DECODE_LEN)
        wants = []
        batches = [api.decode_input_specs(shape, abstract=False, seed=i)
                   for i in range(DECODE_STEPS)]
        for i, b in enumerate(batches):
            lg, want_cache = plain_step(plain, want_cache, b, i)
            wants.append(_np(lg))
        for mshape in ((2, 2), (1, 4)):
            tag = f"{arch}:{mshape[0]}x{mshape[1]}"
            rules = MeshRules(make_mesh(mshape, ("data", "model")), cfg=cfg)
            step = build_serve_step(api, rules=rules)
            model = api.init(torch.Generator().manual_seed(0))
            cache = api.init_cache(DECODE_B, DECODE_LEN)
            got = []
            for i, b in enumerate(batches):
                lg, cache = step(model, cache, b, i)
                got.append(_np(lg))
            out[tag + ":logits"] = np.stack(got)
            out[tag + ":want"] = np.stack(wants)
            for k, t in _flat_tree(cache).items():
                off = compute_local_shape_and_global_offset(
                    t.shape, t.device_mesh, t.placements)[1]
                out[f"{tag}:c:{k}"] = t.to_local().numpy()
                out[f"{tag}:o:{k}"] = np.array(off)
                out[f"{tag}:p:{k}"] = np.array(str(t.placements))
            for k, t in _flat_tree(want_cache).items():
                out[f"{tag}:w:{k}"] = t.numpy()
    _save(d, "sharded_decode", rank, **out)


# ----------------------------------------------------------------------
# one rank
# ----------------------------------------------------------------------
def check_one_device(rank, d):
    """A (1, 1) mesh over a world of one: the train step, the prefill and
    the decode step bit for bit against meshless."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import MeshRules
    from repro_torch.launch.steps import build_prefill_step, build_serve_step
    from repro_torch.models.registry import get_model
    cfg = _tiny_cfg()
    api = get_model(cfg, "cpu")
    batch = _train_batch(cfg)
    mesh = make_host_mesh()
    rules = MeshRules(mesh, cfg=cfg)
    plain = api.init(torch.Generator().manual_seed(0))
    want_loss, want_opt = _two_steps(cfg, plain, batch)
    model = api.init(torch.Generator().manual_seed(0))
    loss, opt = _two_steps(cfg, model, batch, rules=rules)
    pb = api.input_specs(ShapeSpec("s", PREFILL_S, PREFILL_B, "prefill"),
                         abstract=False)
    want = build_prefill_step(api)(plain, pb)
    got = build_prefill_step(api, rules=rules)(model, pb)
    # three decode steps from empty caches, the mesh's step on the DTensor
    # parameters' local shards
    plain_step = build_serve_step(api)
    mesh_step = build_serve_step(api, rules=rules)
    want_cache, cache = api.init_cache(PREFILL_B, 8), api.init_cache(
        PREFILL_B, 8)
    tok = torch.Generator().manual_seed(5)
    dec, want_dec = [], []
    for i in range(3):
        b = {"tokens": torch.randint(0, cfg.vocab_size, (PREFILL_B, 1),
                                     generator=tok, dtype=torch.int32)}
        lg, want_cache = plain_step(plain, want_cache, b, i)
        want_dec.append(_np(lg))
        lg, cache = mesh_step(model, cache, b, i)
        dec.append(_np(lg))
    _save(d, "decode", rank, dec=dec, want=want_dec,
          **{"c:" + k: _np(v) for k, v in _flat_tree(cache).items()},
          **{"wc:" + k: _np(v) for k, v in _flat_tree(want_cache).items()})
    # the remat tag on a DTensor: the op on the local shard, its gradient
    # through
    from repro_torch.core.integration import checkpoint_name
    from torch.distributed.tensor import DTensor, Replicate
    x = DTensor.from_local(torch.arange(6.0).requires_grad_(True), mesh,
                           [Replicate(), Replicate()], run_check=False)
    tagged = checkpoint_name(x, "h")
    (grad,) = torch.autograd.grad((tagged * 2).sum(), [x])
    _save(d, "tag", rank, kind=np.array(type(tagged).__name__),
          value=_np(tagged), grad=_np(grad))
    _save(d, "one", rank, shape=np.array(tuple(mesh.shape)),
          loss=loss, want_loss=want_loss, logits=_np(got), want=_np(want),
          **{"p:" + k: v for k, v in _flat_params(model).items()},
          **{"w:" + k: v for k, v in _flat_params(plain).items()},
          **{"mu:" + k: _np(v) for k, v in opt.mu.items()},
          **{"wmu:" + k: _np(v) for k, v in want_opt.mu.items()},
          **{"nu:" + k: _np(v) for k, v in opt.nu.items()},
          **{"wnu:" + k: _np(v) for k, v in want_opt.nu.items()})


GROUPS = {
    "mesh4": (check_train, check_int8_blocks, check_prefill, check_psum,
              check_a2a,
              check_elastic, check_launcher, check_restart),
    "world1": (check_one_device,),
    "decode4": (check_sharded_decode,),
}


def _rank(rank, group, world, d, store):
    torch.manual_seed(0)
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=60))
    try:
        checks = GROUPS.get(group) or [globals()["check_" + c]
                                       for c in group.split(",")]
        for check in checks:
            check(rank, d)
            dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    group, world, d = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    store = os.path.join(d, f"store.{os.getpid()}")
    mp.spawn(_rank, args=(group, world, d, store), nprocs=world)
