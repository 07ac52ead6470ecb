"""The port's sharded steps as the reference shards them, on the CPU: the
vocab-parallel CE loss, the scatter MoE on the data shards of the tokens
and ``ServingEngine`` under a mesh.

The reference runs once, in a subprocess with ``XLA_FLAGS`` forcing four
host devices: it draws the inputs and weights from seeds and writes them
with its outputs (its jitted ``softmax_cross_entropy``,
``fused_unembed_cross_entropy`` and ``moe_apply_scatter`` under
``use_rules`` on the (2, 2) and (4, 1) meshes, and its ``ServingEngine``,
which serves on its host mesh, (2, 2)).  The port runs on four gloo
ranks (``tests/torch_dist_workers.py gaps4``), reading those inputs; its
meshless counterparts run here.  Tolerances are ``_fp32_close``'s (fp32
summed in another order; ``tests/test_torch_distribution.py``); tokens,
decision traces and byte counts are held exactly.
"""
import dataclasses
import os
import pickle
import sys
import textwrap

import numpy as np
import pytest
import torch

from test_torch_distribution import (WORKERS, _fp32_close, _prefixed, _run,
                                     _start, _wait)
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.engine import MemoryEngine
from repro_torch.core.plan import MachineProfile
from repro_torch.models import layers, moe
from repro_torch.serving import ServingEngine, make_trace

MESHES = ("2x2", "4x1")

REFERENCE = """
    import dataclasses, pickle, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import get_config
    from repro.core.engine import MemoryEngine
    from repro.core.plan import MachineProfile
    from repro.launch.mesh import make_mesh
    from repro.launch.sharding import MeshRules, use_rules
    from repro.models.layers import (ParamBuilder, fused_unembed_cross_entropy,
                                     init_embedding, softmax_cross_entropy)
    from repro.models.moe import init_moe, moe_apply_a2a, moe_apply_scatter
    from repro.serving import ServingEngine, make_trace

    npt = lambda t: jax.tree.map(np.asarray, t)
    meshes = {f"{a}x{b}": make_mesh((a, b), ("data", "model"))
              for a, b in ((2, 2), (4, 1))}
    out = {}

    # (a) the CE loss: logits with masked labels and a z-loss; a tied table
    # through the fused loss
    cfg = get_config("tinyllama-1.1b").reduced()
    gcfg = get_config("gemma-2b").reduced()
    rng = np.random.default_rng(10)
    ce = {"z": 1e-3, "chunk": 8,
          "logits": rng.standard_normal((4, 16, cfg.padded_vocab),
                                        np.float32) * 3,
          "labels": rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32),
          "x": rng.standard_normal((4, 24, gcfg.d_model), np.float32),
          "tied_labels": rng.integers(0, gcfg.vocab_size,
                                      (4, 24)).astype(np.int32)}
    ce["labels"][0, :5] = -1
    ce["labels"][3, 7] = -1
    ce["tied_labels"][1, 3:9] = -1
    b = ParamBuilder(jax.random.PRNGKey(11), jnp.float32)
    init_embedding(b, gcfg.padded_vocab, gcfg.d_model, True)
    ce["tok"] = np.asarray(b.params["tok"])
    for tag, mesh in meshes.items():
        rules = MeshRules(mesh, cfg=cfg)
        with use_rules(rules):
            f = jax.jit(jax.value_and_grad(
                lambda lg: softmax_cross_entropy(lg, ce["labels"],
                                                 z_loss=ce["z"])),
                in_shardings=(NamedSharding(mesh, P("data", None, "model")),))
            loss, g = f(ce["logits"])
        grules = MeshRules(mesh, cfg=gcfg)
        p = jax.tree.map(jax.device_put, b.params,
                         grules.param_shardings(b.axes))
        with use_rules(grules):
            f = jax.jit(jax.value_and_grad(
                lambda pp, xx: fused_unembed_cross_entropy(
                    pp, xx, ce["tied_labels"], True, chunk=ce["chunk"]),
                argnums=(0, 1)))
            tl, (gp, gx) = f(p, jax.device_put(
                ce["x"], NamedSharding(mesh, P("data", None, None))))
        ce[tag] = {"loss": float(loss), "g": np.asarray(g),
                   "tied_loss": float(tl), "tied_gx": np.asarray(gx),
                   "tied_gt": np.asarray(gp["tok"])}
    out["ce"] = ce

    # (b) the scatter MoE: nothing dropped; rows dropped (the capacity
    # rounds to 128 slots, one expert is the first choice of every token);
    # a batch the data axes do not divide
    mcfg = get_config("moonshot-v1-16b-a3b").reduced()
    b = ParamBuilder(jax.random.PRNGKey(12), jnp.float32)
    init_moe(b, mcfg.d_model, mcfg.n_experts, mcfg.moe_d_ff, mcfg.mlp_act,
             mcfg.n_shared_experts)
    router = np.asarray(b.params["router"])
    rng = np.random.default_rng(13)
    lean = router[:, 0] / np.linalg.norm(router[:, 0])
    cases = {
        "nodrop": (8.0, rng.standard_normal((4, 16, mcfg.d_model),
                                            np.float32)),
        "drop": (1.0, 0.3 * rng.standard_normal((8, 32, mcfg.d_model),
                                                np.float32)
                 + 4.0 * lean.astype(np.float32)),
        "odd": (1.0, rng.standard_normal((3, 5, mcfg.d_model), np.float32)),
    }
    moe_out = {"params": npt(b.params), "cases": {}}
    for name, (cf, x) in cases.items():
        dy = rng.standard_normal(x.shape, np.float32)
        kw = dict(top_k=mcfg.top_k, n_experts=mcfg.n_experts,
                  capacity_factor=cf, act=mcfg.mlp_act)

        def loss(pp, xx):
            y, aux = moe_apply_scatter(pp, xx, **kw)
            return jnp.sum(y * dy) + aux, (y, aux)
        res = {"cf": cf, "x": x, "dy": dy}
        for tag, mesh in meshes.items():
            rules = MeshRules(mesh, cfg=mcfg)
            p = jax.tree.map(jax.device_put, b.params,
                             rules.param_shardings(b.axes))
            spec = P("data", None, None) if x.shape[0] % mesh.shape["data"] \\
                == 0 else P()
            with use_rules(rules):
                (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
                    loss, argnums=(0, 1), has_aux=True))(
                    p, jax.device_put(x, NamedSharding(mesh, spec)))
            res[tag] = {"y": np.asarray(y), "aux": float(aux),
                        "gx": np.asarray(gx), "g": npt(gp)}
        moe_out["cases"][name] = res
    # moe_apply_a2a's aux loss and its gradient, the nothing-dropped input
    x = cases["nodrop"][1]
    kw = dict(top_k=mcfg.top_k, n_experts=mcfg.n_experts,
              capacity_factor=8.0, act=mcfg.mlp_act)
    for shape in ((2, 2), (1, 4)):
        with use_rules(MeshRules(make_mesh(shape, ("data", "model")),
                                 cfg=mcfg)):
            aux, g = jax.jit(jax.value_and_grad(
                lambda pp: moe_apply_a2a(pp, x, **kw)[1]))(b.params)
        moe_out[f"a2a_{shape[0]}x{shape[1]}"] = {"aux": float(aux),
                                                 "g": npt(g)}
    out["moe"] = moe_out

    # (c) the serving engine on its host mesh, a budgeted trace that evicts
    jeng = ServingEngine("tinyllama-1.1b", max_sequences=4, max_len=12,
                         seed=0)
    assert dict(jeng.rules.mesh.shape) == {"data": 2, "model": 2}
    trace_args = ("poisson", 6, {"seed": 0, "prompt_len": 4, "gen_len": 8})
    trace = make_trace(*trace_args[:2], **trace_args[2])
    budget = jeng.bytes_per_token * (12 * 2 + 2)
    eng = {"max_sequences": 4, "max_len": 12, "budget": budget,
           "trace": trace_args, "params": npt(jeng.params),
           "profile": dict(host_link_bw=16e9, host_link_latency=15e-6,
                           dma_batch_overhead=2e-6, compute_flops=5e10,
                           mem_bw=1e10),
           "prompts": {(r.rid, r.prompt_len): jeng.prompt_for(r.rid,
                                                              r.prompt_len)
                       for r in trace}}
    xfer = jeng._xfer
    for bt in (False, True):
        moved = []
        jeng._xfer = lambda fn: moved.append(xfer(fn)) or moved[-1]
        mem = MemoryEngine(MachineProfile(host_link_bw=16e9,
                                          compute_flops=5e10, mem_bw=1e10),
                           capacity_bytes=budget, trace=True)
        rep, toks = jeng.serve(trace, budget_bytes=budget, engine=mem,
                               batch_transfers=bt)
        jeng._xfer = xfer
        eng["batched" if bt else "per_slot"] = {
            "tokens": repr(sorted(toks.items())),
            "trace": repr(mem.trace.keys()), "moved": moved,
            "evictions": rep.evictions, "oom_events": rep.oom_events}
    out["engine"] = eng
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def gaps(tmp_path_factory):
    """The reference's pickle and the npz files the four ranks wrote."""
    d = str(tmp_path_factory.mktemp("gaps"))
    ref = os.path.join(d, "gaps.pkl")
    # the limits leave room for a loaded host (unloaded: about 30 and 60 s)
    _run([sys.executable, "-c", textwrap.dedent(REFERENCE), ref], 480,
         XLA_FLAGS="--xla_force_host_platform_device_count=4",
         JAX_PLATFORMS="cpu")
    ranks = _start([sys.executable, WORKERS, "gaps4", "4", d])
    _wait(ranks, 600)
    with open(ref, "rb") as f:
        data = pickle.load(f)

    def load(name, rank):
        with np.load(os.path.join(d, f"{name}_r{rank}.npz")) as z:
            return {k: z[k] for k in z.files}
    return data, load


# ----------------------------------------------------------------------
# (a) the vocab-parallel CE loss
# ----------------------------------------------------------------------
def _meshless_ce(ce):
    lg = torch.from_numpy(ce["logits"]).requires_grad_(True)
    loss = layers.softmax_cross_entropy(lg, torch.from_numpy(ce["labels"]),
                                        z_loss=ce["z"])
    (g,) = torch.autograd.grad(loss, [lg])
    gcfg = get_config("gemma-2b").reduced()
    emb = layers.Embedding(gcfg.padded_vocab, gcfg.d_model, True,
                           dtype=torch.float32, device="meta")
    emb.load_state_dict({"tok": torch.from_numpy(ce["tok"])}, strict=True,
                        assign=True)
    emb.tok.requires_grad_(True)
    x = torch.from_numpy(ce["x"]).requires_grad_(True)
    tl = layers.fused_unembed_cross_entropy(
        emb, x, torch.from_numpy(ce["tied_labels"]), True, chunk=ce["chunk"])
    gx, gt = torch.autograd.grad(tl, [x, emb.tok])
    return {"loss": loss.detach().numpy(), "g": g.numpy(),
            "tied_loss": tl.detach().numpy(), "tied_gx": gx.numpy(),
            "tied_gt": gt.numpy()}


@pytest.mark.parametrize("mesh", MESHES)
def test_vocab_parallel_ce(gaps, mesh):
    """Reduced TinyLlama's logits on the mesh (vocab over ``"model"``),
    masked labels, z-loss 1e-3; reduced Gemma's tied table through the
    fused chunked loss (three chunks): the loss and its gradients (logits;
    x and the table) equal the reference's jitted loss under the same
    shardings and the meshless port's on every rank.  On (2, 2) the
    vocabulary is sharded and the vocab-parallel function runs (four
    times: the logits' loss and three chunks, each recomputed in the
    backward, so seven); on (4, 1) it is whole and the meshless formula
    runs."""
    data, load = gaps
    ce = data["ce"]
    want, plain = ce[mesh], _meshless_ce(ce)
    for rank in range(4):
        res = _prefixed(load("gaps_ce", rank), mesh + ":")
        for k in ("loss", "g", "tied_loss", "tied_gx", "tied_gt"):
            _fp32_close(res[k], want[k], err_msg=k)
            _fp32_close(res[k], plain[k], err_msg=k)
        if mesh == "2x2":
            assert "Shard(dim=2)" in str(res["placements"])
            assert int(res["calls"]) == 7
        else:
            assert int(res["calls"]) == 0


# ----------------------------------------------------------------------
# (b) the scatter MoE on data-sharded tokens
# ----------------------------------------------------------------------
def _meshless_moe(params, case):
    cfg = get_config("moonshot-v1-16b-a3b").reduced()
    p = {k: torch.from_numpy(v).requires_grad_(True)
         for k, v in params.items()}
    x = torch.from_numpy(case["x"]).requires_grad_(True)
    kw = dict(top_k=cfg.top_k, n_experts=cfg.n_experts,
              capacity_factor=case["cf"], act=cfg.mlp_act)
    y, aux = moe.moe_apply_scatter(p, x, **kw)
    loss = (y * torch.from_numpy(case["dy"])).sum() + aux
    grads = torch.autograd.grad(loss, [x] + list(p.values()))
    _, experts, _ = moe._router(p, x.detach().reshape(-1, x.shape[-1]),
                                cfg.top_k)
    t = x.shape[0] * x.shape[1]
    cap = moe.capacity_of(t, cfg.top_k, cfg.n_experts, case["cf"])
    kept = moe.dispatch_slots(experts, cap)[2]
    return {"y": y.detach().numpy(), "aux": aux.detach().numpy(),
            "gx": grads[0].numpy(),
            **{"g:" + k: g.numpy() for k, g in zip(p, grads[1:])}}, (
        cap, int((~kept).sum()), int(torch.bincount(
            experts.reshape(-1)).max()))


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case", ["nodrop", "drop", "odd"])
def test_scatter_moe_on_data_shards(gaps, case, mesh):
    """Reduced Moonlight's scatter MoE with the tokens on the data axes:
    its output, aux loss and the gradients of ``sum(y * dy) + aux`` with
    respect to x and every weight equal the reference's jitted
    ``moe_apply_scatter`` under its rules and the meshless port's, on every
    rank.  ``drop``: 256 tokens, capacity 128 slots, one expert the first
    choice of every token (256 rows), so 128 are dropped and which ones
    depends on the global order across the data ranks.  ``odd``: a batch
    of 3 on two data ranks (padded routing slices).  The path made its
    reduce-scatters and all-gathers (none on (4, 1)'s model extent of 1
    for the routing; the capacity blocks move over the data axes)."""
    data, load = gaps
    ref = data["moe"]
    c = ref["cases"][case]
    plain, (cap, dropped, busiest) = _meshless_moe(ref["params"], c)
    if case == "drop":
        assert cap == 128 and busiest == 256 and dropped == 128
    elif case == "nodrop":
        assert dropped == 0
    want = c[mesh]
    want = {"y": want["y"], "aux": np.asarray(want["aux"]),
            "gx": want["gx"], **{"g:" + k: v for k, v in want["g"].items()}}
    for rank in range(4):
        res = _prefixed(load("gaps_moe", rank), f"{case}:{mesh}:")
        assert set(want) <= set(res)
        for k in want:
            _fp32_close(res[k], want[k], err_msg=k)
            _fp32_close(res[k], plain[k], err_msg=k)
        assert int(res["collectives"]) > 0


@pytest.mark.parametrize("mesh", ["2x2", "1x4"])
def test_a2a_aux_gradient(gaps, mesh):
    """``moe_apply_a2a``'s aux loss (the mean of the ranks' Switch losses,
    as the reference's ``pmean``) and its gradient with respect to every
    weight equal the reference's on the same mesh.  A DTensor
    ``Partial("avg")`` reduction would fail it: its backward hands each
    rank the whole gradient, 4 x the reference's on four ranks."""
    data, load = gaps
    want = data["moe"]["a2a_" + mesh]
    for rank in range(4):
        res = _prefixed(load("gaps_moe", rank), f"a2a:{mesh}:")
        np.testing.assert_allclose(res["aux"], want["aux"], rtol=1e-5)
        for k, g in want["g"].items():
            _fp32_close(res["g:" + k], g, err_msg=k)


# ----------------------------------------------------------------------
# (c) ServingEngine under a mesh
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def meshless_engine(gaps):
    """The port's meshless engine (this process has no world) with the
    reference's weights and prompts: both runs' tokens, traces and
    transfer bytes."""
    ref = gaps[0]["engine"]
    eng = ServingEngine("tinyllama-1.1b", max_sequences=ref["max_sequences"],
                        max_len=ref["max_len"], seed=0, device="cpu")
    assert eng.rules is None
    eng.params = params_from_jax(ref["params"], eng.cfg, "cpu")
    eng.prompt_for = lambda rid, n: ref["prompts"][(rid, n)]
    trace = make_trace(*ref["trace"][:2], **ref["trace"][2])
    xfer, out = eng._xfer, {}
    for bt in (False, True):
        moved = []
        eng._xfer = lambda fn: moved.append(xfer(fn)) or moved[-1]
        mem = MemoryEngine(MachineProfile(**ref["profile"]),
                           capacity_bytes=ref["budget"], trace=True)
        rep, toks = eng.serve(trace, budget_bytes=ref["budget"], engine=mem,
                              batch_transfers=bt)
        eng._xfer = xfer
        out["batched" if bt else "per_slot"] = {
            "tokens": repr(sorted(toks.items())),
            "trace": repr(mem.trace.keys()), "moved": moved,
            "report": repr(sorted(dataclasses.asdict(rep).items()))}
    return out


@pytest.mark.parametrize("run", ["per_slot", "batched"])
def test_engine_under_a_mesh(gaps, meshless_engine, run):
    """``ServingEngine`` in a world of four ranks serves on the host mesh,
    (2, 2), with its cache's slots over ``"data"`` and positions over
    ``"model"``: every request's tokens, the decision trace and each
    transfer's bytes equal the reference's engine on its four-device host
    mesh and the port's meshless engine, whose report it reproduces too;
    the budget evicts and nothing runs out of memory; the batched run
    moves each rank's pieces through the KV wrappers."""
    data, load = gaps
    ref = data["engine"][run]
    plain = meshless_engine[run]
    assert ref["evictions"] > 0 and ref["oom_events"] == 0
    assert plain["tokens"] == ref["tokens"]
    assert plain["trace"] == ref["trace"]
    assert plain["moved"] == ref["moved"]
    for rank in range(4):
        res = load("gaps_engine", rank)
        assert tuple(res["mesh"]) == (2, 2)
        assert "(Shard(dim=1), Shard(dim=2))" in " ".join(
            res["cache_placements"])
        assert str(res[run + ":tokens"]) == ref["tokens"]
        assert str(res[run + ":trace"]) == ref["trace"]
        assert list(res[run + ":moved"]) == ref["moved"]
        assert str(res[run + ":report"]) == plain["report"]
        if run == "batched":
            assert int(res[run + ":kv_calls"]) > 0
