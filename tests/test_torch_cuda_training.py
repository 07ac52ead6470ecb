"""The training slice on the card (marked ``cuda``; each test skips
without one, and none imports JAX): a remat policy that offloads keeps its
tagged tensors in pinned host memory between the passes, and a step with
the moments in pinned host memory is the on-card step bit for bit.

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_training.py
"""
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs import get_config
from repro_torch.core import integration
from repro_torch.launch import steps
from repro_torch.models.registry import get_model

ARCH = "tinyllama-1.1b"


@pytest.mark.cuda
def test_offloaded_tags_live_in_pinned_host_memory_on_a_card():
    """On a card an offloaded tag is kept in pinned host memory between
    the passes, and the gradients are those of saving it on the card;
    a moment placed on the host is pinned."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    kept = []
    keep = integration._Keep.__torch_dispatch__

    def spy(self, func, types, args=(), kwargs=None):
        out = keep(self, func, types, args, kwargs)
        kept.extend(self.kept)
        return out

    x = torch.randn(64, 64, device="cuda", requires_grad=True)

    def grads(policy):
        x.grad = None

        def f(x):
            a = integration.checkpoint_name(torch.sin(x), "a")
            return (a * torch.cos(a)).sum()
        checkpoint(f, x, use_reentrant=False,
                   context_fn=policy.context_fn).backward()
        return x.grad.clone()

    d = integration.TensileDecisions(offload_names=frozenset({"a"}))
    on_card = grads(integration.make_remat_policy(d))
    integration._Keep.__torch_dispatch__ = spy
    try:
        on_host = grads(integration.make_remat_policy(d, offload=True))
    finally:
        integration._Keep.__torch_dispatch__ = keep
    assert kept and all(t.device.type == "cpu" and t.is_pinned()
                        for t in kept)
    assert torch.equal(on_card, on_host)
    m = integration.opt_state_placement(torch.ones(3, device="cuda"),
                                        host=True)
    assert m.device.type == "cpu" and m.is_pinned()


@pytest.mark.cuda
def test_offloaded_opt_state_step_is_the_plain_step_on_a_card():
    """On a card the moments and masters stay in pinned host memory
    between steps, and the new state is the on-card step's bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tcfg = get_config(ARCH).reduced(n_layers=2)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, tcfg.vocab_size, (4, 32),
                                              dtype=np.int32)).cuda()
             for k in ("tokens", "labels")}
    out = []
    for host in (False, True):
        api = get_model(tcfg, "cuda")
        model = api.init(torch.Generator(device="cuda").manual_seed(0))
        opt = steps.opt_state_for(model, use_master=True)
        step = steps.build_train_step(api, steps.TrainStepConfig(
            offload_opt_state=host))
        for _ in range(2):
            _, opt, _ = step(model, opt, batch)
        leaves = [*opt.mu.values(), *opt.nu.values(), *opt.master.values()]
        assert all(t.is_pinned() for t in leaves) is host
        out.append([t.cpu() for t in [*model.parameters(), *leaves]])
    assert all(torch.equal(a, b) for a, b in zip(*out))
