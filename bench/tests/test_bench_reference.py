"""The plain references against the port, at a tiny size in float32 on
the CPU: the loss (the forward pass), each leaf's gradient and one AdamW
step, from the same drawn weights on the same batch."""
import functools

import pytest
import torch

import tiny
from runners import train
from harness import compare, weights
from reference.common import Adam, Numerics, train_steps


def _port_step(cell, params, batch):
    from repro_torch.launch.steps import (TrainStepConfig,
                                          build_functional_train_step)
    from repro_torch.models.registry import get_model
    from repro_torch.optim.adam import adamw_init
    api = get_model(train.model_config(cell.config), "cpu")
    step = build_functional_train_step(
        api, TrainStepConfig(**cell.cell["train_step"]))
    tokens, labels = batch
    opt = adamw_init(params, use_master=True)
    new_p, new_opt, metrics = step(params, opt,
                                   {"tokens": tokens, "labels": labels})
    return new_p, new_opt, float(metrics["loss"])


@pytest.mark.parametrize("name", tiny.CONFIGS)
def test_reference_matches_the_port(name):
    torch.manual_seed(0)
    cell = tiny.tiny_cell(name, dtype="float32")
    ref = cell.reference
    specs = ref.param_specs(cell.config)
    params = weights.make_params(specs, 11, torch.device("cpu"),
                                 torch.float32)
    batch = weights.make_batches(11, 1, 2, cell.traffic["seq"],
                                 cell.config["vocab_size"], "cpu")[0]
    new_p, new_opt, loss = _port_step(cell, params, batch)
    ts = cell.cell["train_step"]
    got = train_steps(
        {k: v.clone() for k, v in params.items()}, [batch],
        functools.partial(ref.loss_sum, c=cell.config),
        Adam(ts["learning_rate"], ts["weight_decay"], ts["grad_clip_norm"]),
        rows=1)
    assert got["losses"][0] == pytest.approx(loss, rel=1e-5)
    for k in params:
        g = float(new_opt.mu[k].norm()) / (1 - train.B1)
        assert g == pytest.approx(got["grad_norms"][k], rel=1e-3, abs=1e-9)
        d = float((new_p[k] - params[k]).norm())
        assert d == pytest.approx(got["delta_norms"][k], rel=1e-3,
                                  abs=1e-9), k


@pytest.mark.parametrize("name", tiny.CONFIGS)
def test_blocks_of_rows_sum_to_the_batch(name):
    """The reference's gradient summed over blocks of rows is the one of
    the whole batch."""
    cell = tiny.tiny_cell(name, dtype="float32")
    ref = cell.reference
    specs = ref.param_specs(cell.config)
    batch = weights.make_batches(5, 2, 4, cell.traffic["seq"],
                                 cell.config["vocab_size"], "cpu")
    runs = []
    for rows in (1, 4):
        params = weights.make_params(specs, 5, torch.device("cpu"),
                                     torch.float32)
        runs.append(train_steps(
            params, batch, functools.partial(ref.loss_sum, c=cell.config),
            Adam(1e-4, 0.01, 1.0), rows=rows))
    assert compare.gaps(runs[0], runs[1])["loss_gap"] < 1e-6
    assert compare.gaps(runs[0], runs[1])["grad_gap"] < 1e-4


def test_fp8_control_rounds():
    x = torch.linspace(-3, 3, 97)
    y = Numerics(fp8=True).act(x)
    assert not torch.equal(x, y)
    assert float((x - y).abs().max()) <= 3 * 2 ** -3
