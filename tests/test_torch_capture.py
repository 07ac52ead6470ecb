"""The port's capture (``core.graph_capture``: a step traced by ``make_fx``
on fake tensors into an aten graph, then a Tensor Access Sequence) against
the JAX package's capture of the same step (a jaxpr walked equation by
equation), on the CPU.

Operator counts differ by design (aten backward nodes are not jaxpr
equations).  What must agree is what the planner treats as state: the
step's argument storages by kind, with their byte sizes, and which
arguments the updated parameters and moments alias.  For the MLP both
packages flatten the arguments in one order, so the comparison is
position by position, and the unscheduled planned peaks agree to the
byte; TinyLlama's parameter dicts flatten in different key orders, so
there the comparison is of sorted lists.  No view and no ``getitem`` is a
TAS tensor: views fold into the storage they read.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.core as rc
from helpers import capture_mlp
from repro.configs import get_config as jax_config
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.launch import steps as jax_steps
from repro.models.registry import get_model as jax_get_model
from repro.optim.adam import adamw_init as jax_adamw_init
import repro_torch.core as tc
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.convert import params_from_jax
from repro_torch.core.graph_capture import graph_layout, is_view
from repro_torch.launch.steps import build_functional_train_step
from repro_torch.models.registry import get_model
from repro_torch.optim.adam import adamw_init
from repro_torch.service.workloads import make_mlp

PROFILE = rc.MachineProfile(host_link_bw=16e9, compute_flops=5e10,
                            mem_bw=1e10)


def _args(seq, n_args):
    """(kind, bytes, shape, dtype) of each step argument, in order."""
    return [(seq.tensors[t].kind.value, seq.tensors[t].size_bytes,
             tuple(seq.tensors[t].shape), seq.tensors[t].dtype)
            for t in seq.initial_resident[:n_args]]


def _aliases(seq, n_args):
    """For each updated tensor: (its kind, the position of the argument
    whose storage it takes, its bytes)."""
    pos = {t: i for i, t in enumerate(seq.initial_resident[:n_args])}
    return sorted((t.kind.value, pos[t.updates], t.size_bytes)
                  for t in seq.tensors.values() if t.updates is not None)


@pytest.fixture(scope="module")
def mlp_pair():
    jseq, closed, args = capture_mlp(sizes=(64, 128, 128, 8), batch=16)
    np_params = jax.tree.map(np.asarray, args[0])
    np_data = tuple(np.asarray(a) for a in args[2])
    step, params, opt, batch = make_mlp((64, 128, 128, 8), 16,
                                        params=np_params, data=np_data,
                                        device="cpu")
    tseq, gm = tc.capture_train_step(step, params, opt, batch)
    return jseq, len(closed.jaxpr.invars), tseq, gm


def test_mlp_arguments_and_aliases_match(mlp_pair):
    jseq, n, tseq, gm = mlp_pair
    assert len(graph_layout(gm).inputs) == n
    assert _args(tseq, n) == _args(jseq, n)
    assert _aliases(tseq, n) == _aliases(jseq, n)
    kinds = {t.kind.value for t in tseq.tensors.values()}
    assert {"param", "opt_state", "input", "activation", "output"} <= kinds


def test_mlp_unscheduled_planned_peaks_match(mlp_pair):
    jseq, _, tseq, _ = mlp_pair
    prof = tc.MachineProfile(**{f.name: getattr(PROFILE, f.name) for f in
                                dataclasses.fields(tc.MachineProfile)})
    assert tc.simulate([tseq], None, prof, iterations=1).peak_bytes == \
        rc.simulate([jseq], None, PROFILE, iterations=1).peak_bytes


def test_phases_follow_the_first_aliased_output(mlp_pair):
    _, _, tseq, _ = mlp_pair
    phases = [op.phase.value for op in tseq.operators]
    first = phases.index("opt")
    assert set(phases[first:]) == {"opt"}
    assert any(tseq.tensors[t].updates for t in
               tseq.operators[first].outputs)


@pytest.fixture(scope="module")
def lm_pair():
    jcfg = jax_config("tinyllama-1.1b").reduced(remat="none")
    tcfg = get_config("tinyllama-1.1b").reduced(remat="none")
    japi = jax_get_model(jcfg)
    jparams, _ = japi.init(jax.random.PRNGKey(0))
    jopt = jax_adamw_init(jparams)
    jbatch = japi.input_specs(JShapeSpec("s", 32, 2, "train"),
                              abstract=False)
    jstep = jax_steps.build_train_step(japi, None)
    jseq, closed = rc.capture_train_step(jstep, jparams, jopt, jbatch)
    api = get_model(tcfg, "cpu")
    params = dict(params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                  "cpu").named_parameters())
    batch = api.input_specs(ShapeSpec("s", 32, 2, "train"), abstract=False)
    tseq, gm = tc.capture_train_step(build_functional_train_step(api),
                                     params, adamw_init(params), batch)
    return jseq, len(closed.jaxpr.invars), tseq, gm


def test_lm_arguments_and_aliases_match(lm_pair):
    jseq, n, tseq, gm = lm_pair
    assert len(graph_layout(gm).inputs) == n
    assert sorted(_args(tseq, n)) == sorted(_args(jseq, n))
    # the same argument storages, by kind and size, take the updates
    jpos, tpos = ({i: a for i, a in enumerate(_args(s, n))}
                  for s in (jseq, tseq))
    assert sorted((k, jpos[p]) for k, p, _ in _aliases(jseq, n)) == \
        sorted((k, tpos[p]) for k, p, _ in _aliases(tseq, n))
    n_params = sum(1 for a in _args(tseq, n) if a[0] == "param")
    assert len(_aliases(tseq, n)) == 3 * n_params + 1   # params, mu, nu, step


def test_no_view_or_getitem_is_a_tensor(lm_pair):
    _, _, tseq, gm = lm_pair
    lay = graph_layout(gm)
    views = [nd for nd in gm.graph.nodes if nd.op == "call_function"
             and (is_view(nd.target) or nd.target.__name__ == "getitem")]
    assert views
    for nd in views:
        owned = nd in lay.tid
        # only a result of a multi-output compute op is its own owner
        assert not owned or nd.args[0] in lay.results
        if not owned:
            assert lay.owner[nd] in lay.tid
    names = {op.name for op in tseq.operators}
    assert not names & {"view", "permute", "transpose", "select", "detach",
                        "expand", "t", "_unsafe_view", "getitem"}
    assert tseq.operators and all(op.params["node"] for op in
                                  tseq.operators)


def test_inplace_ops_become_pure():
    def step(x):
        m = torch.ones(x.shape, dtype=torch.bool)
        m &= x > 0
        return torch.where(m, x, 0.0)

    seq, gm = tc.capture(step, torch.randn(4, 5))
    assert [op.name for op in seq.operators] == ["ones", "gt",
                                                 "bitwise_and", "scalar_tensor",
                                                 "where"][:len(seq.operators)]
    assert not any(getattr(nd.target, "_schema", None) is not None
                   and nd.target._schema.name.endswith("_")
                   for nd in gm.graph.nodes if nd.op == "call_function")
    x = torch.randn(4, 5)
    torch.testing.assert_close(tc.reference_outputs(gm, x)[0],
                               torch.where(x > 0, x, 0.0))


def test_mutating_an_input_is_refused():
    def step(x):
        x.add_(1.0)
        return x * 2

    with pytest.raises(NotImplementedError):
        tc.capture(step, torch.randn(3))


def test_multi_output_ops_give_one_tensor_per_used_result():
    def step(x):
        var, mean = torch.var_mean(x, dim=0)
        return mean * 2

    seq, gm = tc.capture(step, torch.randn(6, 3))
    op = next(o for o in seq.operators if o.name == "var_mean")
    assert len(op.outputs) == 1        # the variance is never read


def test_capture_allocates_nothing():
    """Fake tracing: meta-sized arguments of a huge step trace fine."""
    big = torch.empty((1 << 16, 1 << 16), device="meta")
    seq, _ = tc.capture(lambda a: (a * 2).sum(), big)
    assert seq.tensors[seq.initial_resident[0]].size_bytes == 4 << 32
