"""A run of the cell, at a tiny size on the CPU on each configuration (the
look for a card skipped), with the timed path broken underneath:
``correct`` comes out false for each fault a training cell on one card can
have.  The faults are planted around the window's call
(``runners.train.run_step``).  The sound run beside them comes out true;
the control (the reference in the program's place, its weight products in
fp8) fails one of the cell's numbers."""
import math
import time

import pytest
import torch

import tiny
from runners import train
from harness import compare

SEED = 2_147_483_659          # above 2**31


def unchanged(step, job, batch):
    """A step that returns its state unchanged."""
    kept = [t.detach().clone() for t in job.state]
    ex, loss = step(job, batch)
    job.state, job.host_inputs = kept, set()
    return ex, loss


def half_batch(step, job, batch):
    """Half of the batch left out, the mean taken over the rest."""
    tokens, labels = batch
    labels = labels.clone()
    labels[labels.shape[0] // 2:] = -1        # masked from the mean
    return step(job, (tokens, labels))


def double_update(step, job, batch):
    """The largest leaf's update doubled where the step produces it."""
    big = max(range(job.n_p), key=lambda i: math.prod(job.specs[i].shape))
    master = 1 + 3 * job.n_p + big
    old = job.state[master].detach().clone()
    ex, loss = step(job, batch)
    new = job.state[master]
    job.state[master] = 2 * new - old.to(new.device)
    job.state[big] = job.state[master].to(job.state[big].dtype)
    return ex, loss


FAULTS = (unchanged, half_batch, double_update)


@pytest.fixture(scope="module", params=tiny.CONFIGS)
def cell(request):
    torch.set_num_threads(2)
    # float32: the cell's limits are set for its own size in bf16; the
    # tiny float32 program meets them, and every fault fails them
    c = tiny.tiny_cell(request.param, dtype="float32")
    tiny.plan_for(c)
    return c


def _run(cell):
    return train.run(cell, SEED, 0.5, False, time.perf_counter(),
                     torch.device("cpu"))


def test_sound_run_is_correct(cell):
    res = _run(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) >= {"train_tokens_per_s", "setup_s"}


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
def test_fault_is_not_correct(cell, fault, monkeypatch):
    step = train.run_step
    monkeypatch.setattr(train, "run_step",
                        lambda job, batch: fault(step, job, batch))
    res = _run(cell)
    assert not res["correct"], res["checks"]


def test_control_fails_a_number(cell):
    dev = torch.device("cpu")
    ref = train.reference_steps(cell, SEED, dev)
    control = train.reference_steps(cell, SEED, dev, fp8=True)
    checks = compare.judge(compare.gaps(control, ref), cell.cell["checks"])
    assert not all(c["ok"] for name, c in checks.items()
                   if name != cell.cell["guarantee"]["name"]), checks


def test_latency_table_is_read_by_key_and_measures_what_it_lacks(cell):
    """A capture's operators find their latencies in the table by key (a
    second capture has the same keys; operators alike share one); an
    operator the table lacks, as after a change to the capture, is
    measured in set-up."""
    cpu = torch.device("cpu")
    job = train.prepare(cell, cpu, SEED)
    keys = [train.op_key(job.seq, op) for op in job.seq.operators]
    again = train.prepare(cell, cpu, SEED)
    assert keys == [train.op_key(again.seq, op) for op in again.seq.operators]
    assert len(set(keys)) < len(keys)
    table = train.latency_table(job.seq, [1e-3] * len(keys))
    lacking = keys[len(keys) // 2]
    del table[lacking]
    train.set_latencies(job, table)
    assert job.rec["measured_operators"] == keys.count(lacking)
    assert all(op.latency == 1e-3 for op, k in zip(job.seq.operators, keys)
               if k != lacking)
