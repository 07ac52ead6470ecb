"""End-to-end training driver (the JAX package's ``launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
        --reduced --steps 200 --batch 8 --seq 128 --device cpu

Composes: config → model → TENSILE memory planning (the train step
captured on fake tensors, planned under a device budget, its decisions as
a remat policy) → data pipeline with prefetch → resilient train loop
(async checkpoints, restart-on-failure, straggler monitor).  Random
weights from seed 0; the card unless ``--device`` names another.

Under ``torchrun`` with ``WORLD_SIZE > 1`` the launcher builds
``make_host_mesh()`` over the world, as the reference does, and trains
under ``MeshRules`` (parameters and moments DTensors, the batch sharded
over the data axis); ``--mesh DATA,MODEL`` names the grid, and on a world
of one builds that mesh too:

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --device cpu \
        --reduced --mesh 2,2

A world of one without ``--mesh`` stays meshless: the arithmetic of the
reference's one-device host mesh.  A TENSILE budget is planned on the
step as one device runs it, before the parameters are sharded.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import numpy as np
import torch

from ..configs import get_config
from ..data.pipeline import DataConfig, Prefetcher, TokenStream, to_device
from ..device import resolve_device
from ..models.registry import get_model
from ..optim.adam import adamw_init
from ..runtime.fault_tolerance import FTConfig, resilient_train_loop
from ..runtime.stragglers import StragglerMonitor
from .sharding import shard_params
from .steps import TrainStepConfig, build_train_step, opt_state_for


def _mesh_rules(spec, dev: torch.device, cfg):
    """``MeshRules`` over the world for ``--mesh DATA,MODEL``, or under
    ``torchrun`` with more than one rank; None for a meshless run."""
    if spec is None and int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return None
    from .mesh import init_world, make_host_mesh, make_mesh
    from .sharding import MeshRules
    world = init_world(dev)
    if spec is None:
        mesh = make_host_mesh(device=dev.type)
    else:
        shape = tuple(int(n) for n in spec.split(","))
        if len(shape) != 2 or shape[0] * shape[1] != world:
            raise ValueError(f"--mesh {spec}: need DATA,MODEL with "
                             f"DATA x MODEL = {world} ranks")
        mesh = make_mesh(shape, ("data", "model"), device=dev.type)
    return MeshRules(mesh, cfg=cfg)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--tensile-budget-mb", type=float, default=0.0,
                    help="device memory budget; >0 runs the TENSILE "
                         "planner and applies its remat decisions")
    ap.add_argument("--grad-compression", choices=["none", "int8"],
                    default="none")
    ap.add_argument("--d-model", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--mesh", default=None, metavar="DATA,MODEL",
                    help="train on a (data, model) mesh over the world "
                         "(default under torchrun: make_host_mesh())")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
        if cfg.n_experts:
            cfg.moe_impl = "dense" if cfg.n_experts <= 8 else "scatter"
    if args.d_model:
        cfg.d_model = args.d_model
    api = get_model(cfg, dev)
    # a process group this run starts, it also ends
    own_world = not torch.distributed.is_initialized()
    rules = _mesh_rules(args.mesh, dev, cfg)
    where = "" if rules is None else \
        f" mesh={dict(zip(rules.mesh.mesh_dim_names, rules.mesh.shape))}"
    print(f"[train] arch={cfg.name} params≈{cfg.param_count()/1e6:.1f}M "
          f"device={dev}{where}")

    params = api.init(torch.Generator(device=dev).manual_seed(0))
    use_comp = args.grad_compression == "int8"

    def new_opt():
        if use_comp:
            return adamw_init(dict(params.named_parameters()),
                              grad_compression=True)
        return opt_state_for(params)

    opt = new_opt()

    dcfg = DataConfig(seq_len=args.seq, global_batch=args.batch,
                      vocab_size=cfg.vocab_size, frontend=cfg.frontend,
                      n_patches=cfg.n_patches, d_model=cfg.d_model,
                      enc_dec=cfg.enc_dec)
    move = to_device(dev)

    # ---- TENSILE planning (optional) ---------------------------------
    remat_policy = None
    if args.tensile_budget_mb > 0:
        from ..core import (capture_train_step, make_remat_policy,
                            schedule_for_budget)
        from .steps import build_functional_train_step

        # the step without remat, as the planner sees it: which of its
        # activations to keep is what it decides
        probe_api = get_model(dataclasses.replace(cfg, remat="none"), dev)
        probe_step = build_functional_train_step(
            probe_api, TrainStepConfig(learning_rate=args.lr))
        sample = move(TokenStream(dcfg).batch_at(0))
        seq, _ = capture_train_step(
            probe_step, dict(params.named_parameters()), opt, sample)
        decisions = schedule_for_budget(
            seq, int(args.tensile_budget_mb * 2**20))
        print(f"[tensile] {decisions.summary()}")
        remat_policy = make_remat_policy(decisions)

    if rules is not None:
        shard_params(params, rules)
        opt = new_opt()
    tcfg = TrainStepConfig(
        learning_rate=args.lr,
        grad_compression=("int8" if use_comp else None),
        remat_policy=remat_policy)
    step_fn = build_train_step(api, tcfg, rules=rules)

    stream = TokenStream(dcfg)
    prefetch = Prefetcher(stream, to_device=move)

    monitor = StragglerMonitor(n_hosts=1)
    ft = FTConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)

    t0 = time.time()
    losses = []

    def logging_step(p, o, batch):
        p, o, m = step_fn(p, o, batch)
        losses.append(float(m["loss"]))
        if len(losses) % args.log_every == 0:
            dt = time.time() - t0
            print(f"  step {len(losses):5d} loss {losses[-1]:.4f} "
                  f"({len(losses)/dt:.2f} it/s)")
        return p, o, m

    try:
        result = resilient_train_loop(
            logging_step, (params, opt), prefetch, args.steps,
            ft=ft, data_stream=stream, monitor=monitor)
    finally:
        prefetch.close()
    first = np.mean(losses[:10]) if len(losses) >= 10 else losses[0]
    last = np.mean(losses[-10:])
    print(f"[train] done: steps={result.final_step + 1} "
          f"restarts={result.restarts} loss {first:.4f} -> {last:.4f}")
    assert np.isfinite(last), "training diverged"
    if rules is not None and own_world:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
