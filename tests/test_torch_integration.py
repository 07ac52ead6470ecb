"""The port's TENSILE decisions as a train-step policy (``core.
integration``) against the JAX package's ``core.jax_integration``, on the
CPU.

Decisions are the same Python over the same plan, so they compare field
by field, exactly: the reference's captured MLP sequence moves across
field by field (``test_torch_planner.to_port``) and both packages plan it
with the same profile.  A remat policy changes what is recomputed, never
what is computed: the policy step's loss and gradients equal the plain
step's bit for bit (reduced TinyLlama, fp32, weights drawn by the JAX
package).  On the CPU a policy that offloads keeps its tensors, as the
reference's CPU fallback does (on a card it keeps them in pinned host
memory: ``tests/test_torch_cuda_training.py``).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import checkpoint

import repro.core as rc
from helpers import capture_mlp
from repro.core import jax_integration as ref
from repro.models import transformer as jax_tf
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core import integration
from repro_torch.models.registry import get_model
from test_torch_planner import PROFILE, port_profile, to_port

ARCH = "tinyllama-1.1b"


@pytest.fixture(scope="module")
def mlp_seq():
    seq, _, _ = capture_mlp(sizes=(64, 128, 128, 8), batch=16)
    return seq


def _fields(d) -> dict:
    return {f.name: getattr(d, f.name) for f in dataclasses.fields(d)}


@pytest.mark.parametrize("budget", ["one_byte", "near_peak"])
def test_schedule_for_budget_matches_reference(mlp_seq, budget):
    """A 1-byte budget (every pass at its limit) and one just under the
    planned peak give the reference's decisions, field for field."""
    peak = rc.analyze([mlp_seq]).peak_bytes
    b = 1 if budget == "one_byte" else int(0.95 * peak)
    want = ref.schedule_for_budget(mlp_seq, b, profile=PROFILE)
    got = integration.schedule_for_budget(to_port(mlp_seq), b,
                                          profile=port_profile(PROFILE))
    assert _fields(got) == _fields(want)
    assert got.summary() == want.summary()
    if budget == "one_byte":
        assert got.remat_names or got.offload_names


def test_plan_decisions_with_names_matches_reference(mlp_seq):
    """Tags given per tensor id replace the shape tags."""
    sched = rc.MemoryScheduler(PROFILE, rc.SchedulerConfig(
        memory_budget_bytes=1))
    sched.register_job(mlp_seq)
    plan = sched.schedule().plans[mlp_seq.job_id]
    names = {tid: f"t{i}" for i, tid in enumerate(sorted(mlp_seq.tensors))}
    want = ref.plan_decisions(mlp_seq, plan, names)
    tsched = integration.MemoryScheduler(
        port_profile(PROFILE),
        integration.SchedulerConfig(memory_budget_bytes=1))
    tseq = to_port(mlp_seq)
    tsched.register_job(tseq)
    got = integration.plan_decisions(
        tseq, tsched.schedule().plans[tseq.job_id], names)
    assert _fields(got) == _fields(want)
    assert all(n.startswith("t") for n in got.remat_names | got.offload_names)


# ------------------------------------------------------------ the policy
class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[func] = self.n.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


def _toy(policy):
    """Counts of a toy block checkpointed under ``policy``: sin, tagged
    ``a``, then cos of it."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 4), dtype=np.float32)).requires_grad_(True)

    def f(x):
        a = integration.checkpoint_name(torch.sin(x), "a")
        return (a * torch.cos(a)).sum()

    with _Count() as c:
        checkpoint(f, x, use_reentrant=False,
                   context_fn=policy.context_fn).backward()
    return c.n, x.grad


@pytest.mark.parametrize("offload", [False, True])
def test_policy_saves_a_tagged_tensor_and_recomputes_the_rest(offload):
    """Forward once, backward once: the kept tag runs only in the forward
    pass (its output is saved), an untagged op again in the recompute (3
    sins: forward, recompute, cos' derivative); an unkept tag runs twice.
    Offloading on the CPU saves, as the reference's CPU fallback."""
    keep = integration.TensileDecisions(
        **({"offload_names": frozenset({"a"})} if offload
           else {"save_names": frozenset({"a"})}))
    kept, g_kept = _toy(integration.make_remat_policy(keep, offload=offload))
    none, g_none = _toy(integration.make_remat_policy(
        integration.TensileDecisions()))
    tag, sin = integration.TAG, torch.ops.aten.sin.default
    assert (kept[tag], none[tag]) == (1, 2)
    assert kept[sin] == none[sin] == 3
    assert torch.equal(g_kept, g_none)


def _reduced_lm():
    tcfg = get_config(ARCH).reduced(n_layers=3)
    from repro.configs import get_config as jax_config
    params, _ = jax_tf.init_model(jax_config(ARCH).reduced(n_layers=3),
                                  jax.random.PRNGKey(1))
    model = params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu")
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, tcfg.vocab_size, (2, 24),
                                              dtype=np.int32))
             for k in ("tokens", "labels")}
    return tcfg, model, batch


def _loss_and_grads(api, model, batch, policy=None):
    named = dict(model.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    try:
        loss = api.loss(model, batch, remat_policy=policy)
        grads = torch.autograd.grad(loss, list(named.values()))
    finally:
        for p in named.values():
            p.requires_grad_(False)
    return loss.detach(), grads


def test_remat_policy_step_equals_the_plain_step_bit_for_bit():
    """The launcher's policy (shape tags no activation carries: every
    activation of a block repeat recomputed) gives the loss and gradients
    of the step without remat and of block remat, bit for bit."""
    tcfg, model, batch = _reduced_lm()
    policy = integration.make_remat_policy(integration.TensileDecisions(
        remat_names=frozenset({"activation:2x24x64:float32"}),
        offload_names=frozenset({"activation:2x24x128:float32"})))
    got = _loss_and_grads(get_model(tcfg, "cpu"), model, batch, policy)
    for remat in ("none", "block"):
        want = _loss_and_grads(get_model(dataclasses.replace(
            tcfg, remat=remat), "cpu"), model, batch)
        assert torch.equal(got[0], want[0])
        assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))


def test_checkpoint_name_is_the_identity_with_its_gradient():
    x = torch.arange(6.0).reshape(2, 3).requires_grad_(True)
    y = integration.checkpoint_name(x, "t")
    assert torch.equal(y, x) and y.data_ptr() != x.data_ptr()
    (y * 3).sum().backward()
    assert torch.equal(x.grad, torch.full((2, 3), 3.0))


def test_opt_state_placement_keeps_a_cpu_leaf():
    t = torch.ones(3)
    assert integration.opt_state_placement(t, host=True) is t
    assert integration.opt_state_placement(t, host=False) is t
