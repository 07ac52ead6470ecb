"""Static compute-graph capture: a PyTorch step -> aten graph -> Tensor
Access Sequence.

The counterpart of the JAX package's ``core/graph_capture.py``, which walks
the equations of a jaxpr.  Here the step is traced by
``torch.fx.experimental.proxy_tensor.make_fx`` in fake mode: no tensor
storage is allocated, however large the step, and autograd inside the step
is traced into aten backward nodes.  Each aten node that computes a new
tensor is an operator in V; its tensor arguments are TUAs, its results
TGAs.  Parameter / optimizer-state / input kinds come from the argument
positions of ``(params, opt_state, batch)``, and the updated-param ->
old-param aliasing (paper §IV-B situation 2) from matching output and input
pytree positions, as in the reference.

Two things an aten graph has and a jaxpr has not:

* **Views** (``view``, ``permute``, ``select``, ``detach``, ...) own no
  storage.  They are folded into their consumers: the TAS names the base
  storage, so the planner's bytes are the caching allocator's, and a base
  cannot be swapped out while one of its views is still to be read.  The
  executor rebuilds a view from its base at each use
  (``GraphLayout.owner``).  ``split``'s pieces are views too, and
  ``_unsafe_view`` counts as one (it reinterprets its input's storage).
* **Multi-output ops** produce one TAS tensor per result that is used (its
  ``getitem`` node); unused results are never tensors of the TAS.

In-place aten ops (``mask &= ...`` in the attention masks) are rewritten to
their pure forms first, so every TAS tensor is written once.
"""
from __future__ import annotations

import dataclasses
import operator
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.utils._pytree as pytree
from torch.fx.experimental.proxy_tensor import make_fx

from .access import AccessSequence, Operator, Phase, TensorKind, TensorSpec
from .cost_model import CostModel, op_name

aten = torch.ops.aten
Node = torch.fx.Node


def _schema(target):
    return getattr(target, "_schema", None)


def is_view(target) -> bool:
    """True for an aten op whose results alias an argument without writing
    it (the schema says so), and for ``_unsafe_view``."""
    if target is aten._unsafe_view.default:
        return True
    sch = _schema(target)
    if sch is None or not sch.returns:
        return False
    return all(r.alias_info is not None and not r.alias_info.is_write
               for r in sch.returns)


def _mutates(target) -> bool:
    sch = _schema(target)
    return sch is not None and any(
        a.alias_info is not None and a.alias_info.is_write
        for a in sch.arguments)


def _tensor_val(node: Node) -> bool:
    return isinstance(node.meta.get("val"), torch.Tensor)


def purify_inplace(gm: torch.fx.GraphModule) -> int:
    """Rewrite every ``op_(self, ...)`` node into ``op(self, ...)``; later
    readers of the mutated tensor already read the node's result.  Raises
    ``NotImplementedError`` for a mutation this cannot make pure: of an
    input, of a view, of a tensor that has views, or one that other nodes
    read after it.  Returns the number of nodes rewritten."""
    order = {n: i for i, n in enumerate(gm.graph.nodes)}
    count = 0
    for node in list(gm.graph.nodes):
        if node.op != "call_function" or not _mutates(node.target):
            continue
        sch = _schema(node.target)
        name = sch.name.split("::")[-1]
        first = sch.arguments[0].alias_info
        base = node.args[0] if node.args else None
        if (not name.endswith("_") or first is None or not first.is_write
                or not isinstance(base, Node)):
            raise NotImplementedError(f"mutating op {node.target}")
        if base.op != "call_function" or is_view(base.target) or any(
                u is not node and (is_view(u.target) or order[u] > order[node])
                for u in base.users if u.op == "call_function"):
            raise NotImplementedError(
                f"{node.target} mutates an input, a view, or a tensor read "
                f"after it")
        pure = getattr(getattr(aten, name[:-1]), node.target._overloadname)
        node.target = pure
        count += 1
    if count:
        gm.recompile()
    return count


@dataclasses.dataclass
class GraphLayout:
    """How a captured graph's values map onto TAS tensors.

    ``owner[n]`` is the node whose result owns the storage that value node
    ``n`` reads (``n`` itself for an owner; the base for a view); ``tid``
    names every owner ("v0", "v1", ... : placeholders, then constants, then
    results in graph order); ``ops`` are the compute nodes, one TAS operator
    each, in graph order; ``results[op]`` lists ``(index, owner)`` for the
    results of ``op`` that are TAS tensors (``index`` is None for a
    single-result op)."""
    owner: Dict[Node, Node]
    tid: Dict[Node, str]
    ops: List[Node]
    results: Dict[Node, List[Tuple[Optional[int], Node]]]
    inputs: List[Node]            # placeholders, in argument order
    consts: List[Node]            # get_attr nodes
    out_leaves: List[Any]         # the output node's flat leaves


def _aliased_arg(node: Node) -> Node:
    """The argument a view's results alias: the one in the return's alias
    set, else the first tensor argument."""
    sch = _schema(node.target)
    if sch is not None and sch.returns and sch.returns[0].alias_info:
        sets = sch.returns[0].alias_info.before_set
        for a, v in zip(sch.arguments, node.args):
            if a.alias_info is not None and a.alias_info.before_set & sets \
                    and isinstance(v, Node):
                return v
    for v in node.args:
        if isinstance(v, Node):
            return v
    raise NotImplementedError(f"view {node.target} without a tensor input")


def graph_layout(gm: torch.fx.GraphModule) -> GraphLayout:
    """Fold views and ``getitem`` into the nodes that own storage."""
    owner: Dict[Node, Node] = {}
    owners: List[Node] = []
    ops: List[Node] = []
    results: Dict[Node, List[Tuple[Optional[int], Node]]] = {}
    inputs: List[Node] = []
    consts: List[Node] = []
    out_leaves: List[Any] = []
    for n in gm.graph.nodes:
        if n.op == "placeholder":
            owner[n] = n
            inputs.append(n)
        elif n.op == "get_attr":
            owner[n] = n
            consts.append(n)
        elif n.op == "output":
            out_leaves = list(pytree.tree_leaves(n.args[0]))
        elif n.op != "call_function":
            raise NotImplementedError(f"graph node kind {n.op}")
        elif n.target is operator.getitem:
            src = n.args[0]
            if src in owner:                 # a piece of a multi-view op
                owner[n] = owner[src]
            elif src in results:             # a result of a compute op
                if n.users:                  # unread results are no tensors
                    owner[n] = n
                    owners.append(n)
                    results[src].append((n.args[1], n))
            else:
                raise NotImplementedError(f"getitem of {src.target}")
        elif is_view(n.target):
            owner[n] = owner[_aliased_arg(n)]
        else:
            ops.append(n)
            results[n] = []
            if _tensor_val(n):
                owner[n] = n
                owners.append(n)
                results[n].append((None, n))
    tid: Dict[Node, str] = {}
    for n in inputs + consts + owners:
        tid[n] = f"v{len(tid)}"
    return GraphLayout(owner=owner, tid=tid, ops=ops, results=results,
                       inputs=inputs, consts=consts, out_leaves=out_leaves)


def _spec(n: Node, tid: str, kind: TensorKind, job_id: str,
          updates: Optional[str] = None) -> TensorSpec:
    v = n.meta.get("val")
    if not isinstance(v, torch.Tensor):
        raise NotImplementedError(f"{n} holds no tensor")
    return TensorSpec(tid=tid, size_bytes=v.numel() * v.element_size(),
                      shape=tuple(v.shape),
                      dtype=str(v.dtype).replace("torch.", ""), kind=kind,
                      job_id=job_id, updates=updates)


@dataclasses.dataclass
class CaptureSpec:
    """Labels the step function's arguments/results for kind recovery.

    arg_kinds / out_kinds: one TensorKind per top-level positional argument /
    result of the step function (broadcast over that subtree's leaves).
    alias_pairs: (out_pos, arg_pos) pairs whose pytrees match leaf-for-leaf
    -- e.g. (new_params, params), (new_opt_state, opt_state).
    """
    arg_kinds: Sequence[TensorKind]
    out_kinds: Sequence[TensorKind] = ()
    alias_pairs: Sequence[Tuple[int, int]] = ()


def trace(fn: Callable, *args: Any) -> torch.fx.GraphModule:
    """``fn(*args)`` as an aten graph, traced on fake tensors (nothing is
    allocated), with in-place ops made pure."""
    gm = make_fx(fn, tracing_mode="fake")(*args)
    purify_inplace(gm)
    return gm


def capture(fn: Callable, *args: Any, job_id: str = "job0",
            spec: Optional[CaptureSpec] = None,
            cost_model: Optional[CostModel] = None,
            experience=None,
            ) -> Tuple[AccessSequence, torch.fx.GraphModule]:
    """Trace ``fn(*args)`` and build its AccessSequence.  ``args`` are
    pytrees of tensors (on any device; only their shapes, dtypes and
    devices are read).  Returns ``(seq, graph_module)``.

    ``experience`` (an ExperienceStore) warm-boots the default cost model:
    capture-time latency estimates then come from the calibration a prior
    run measured and persisted, not the data-sheet constants.  Ignored
    when an explicit ``cost_model`` is passed."""
    cost_model = cost_model or CostModel(experience=experience)
    gm = trace(fn, *args)
    lay = graph_layout(gm)
    # leaves per top-level argument and result (make_fx flattens both;
    # without nesting its graph keeps no pytree record, one leaf each)
    arg_counts = [len(pytree.tree_leaves(a)) for a in args]
    pi = getattr(gm.graph._codegen, "pytree_info", None)
    out_counts = ([c.num_leaves for c in pi.out_spec.children()]
                  if pi is not None and pi.out_spec.num_children
                  else [1] * len(lay.out_leaves))

    # ---- label input leaves ------------------------------------------
    arg_kinds = list(spec.arg_kinds) if spec else [TensorKind.INPUT] * len(
        arg_counts)
    input_kind: Dict[Node, TensorKind] = {}
    arg_slices: Dict[int, Tuple[int, int]] = {}
    i = 0
    for pos, n_leaves in enumerate(arg_counts):
        arg_slices[pos] = (i, i + n_leaves)
        for n in lay.inputs[i:i + n_leaves]:
            input_kind[n] = (arg_kinds[pos] if pos < len(arg_kinds)
                             else TensorKind.INPUT)
        i += n_leaves

    # ---- label output leaves (aliasing for updated params) -----------
    out_owner = [lay.owner.get(v) if isinstance(v, Node) else None
                 for v in lay.out_leaves]
    out_alias: Dict[Node, Node] = {}     # result owner -> aliased input
    out_kind: Dict[Node, TensorKind] = {}
    if spec:
        idx = 0
        pos_slices: Dict[int, Tuple[int, int]] = {}
        for pos, n_leaves in enumerate(out_counts):
            pos_slices[pos] = (idx, idx + n_leaves)
            for o in out_owner[idx:idx + n_leaves]:
                if o is not None and pos < len(spec.out_kinds):
                    out_kind.setdefault(o, spec.out_kinds[pos])
            idx += n_leaves
        for out_pos, arg_pos in spec.alias_pairs:
            if out_pos not in pos_slices or arg_pos not in arg_slices:
                continue
            o0, o1 = pos_slices[out_pos]
            a0, a1 = arg_slices[arg_pos]
            if o1 - o0 != a1 - a0:
                continue
            for o, inp in zip(out_owner[o0:o1], lay.inputs[a0:a1]):
                # an input returned as it is, or twice, aliases nothing new
                if o is not None and o.op == "call_function" \
                        and o not in out_alias:
                    out_alias[o] = inp

    # ---- walk operators -----------------------------------------------
    tensors: Dict[str, TensorSpec] = {}
    for n in lay.inputs:
        tensors[lay.tid[n]] = _spec(n, lay.tid[n], input_kind.get(
            n, TensorKind.INPUT), job_id)
    for n in lay.consts:
        tensors[lay.tid[n]] = _spec(n, lay.tid[n], TensorKind.INPUT, job_id)
    outputs = {o for o in out_owner if o is not None}
    operators: List[Operator] = []
    seen_opt_phase = False
    for idx, node in enumerate(lay.ops):
        in_ids: List[str] = []
        for a in node.all_input_nodes:
            o = lay.owner.get(a)
            if o is not None and lay.tid[o] not in in_ids:
                in_ids.append(lay.tid[o])
        flops, bts = cost_model.node_cost(node)
        phase = Phase.OPT if seen_opt_phase else Phase.FB
        out_ids = []
        for _, o in lay.results[node]:
            t = lay.tid[o]
            out_ids.append(t)
            alias = out_alias.get(o)
            kind = out_kind.get(o, TensorKind.OUTPUT if o in outputs
                                else TensorKind.ACTIVATION)
            if alias is not None:
                kind = (TensorKind.PARAM
                        if input_kind.get(alias) is TensorKind.PARAM
                        else TensorKind.OPT_STATE)
                seen_opt_phase = True
                phase = Phase.OPT
            tensors[t] = _spec(o, t, kind, job_id,
                               updates=lay.tid[alias] if alias is not None
                               else None)
        name = op_name(node.target)
        operators.append(Operator(
            idx=idx, name=name, inputs=tuple(in_ids), outputs=tuple(out_ids),
            flops=flops, bytes_accessed=bts,
            latency=cost_model.latency(flops, bts, name), phase=phase,
            job_id=job_id, params={"node": node.name}))

    initial = [lay.tid[n] for n in lay.inputs + lay.consts]
    seq = AccessSequence(job_id, operators, tensors, initial_resident=initial)
    seq.params = {"n_nodes": len(gm.graph.nodes)}  # type: ignore[attr-defined]
    return seq, gm


def capture_train_step(fn: Callable, params: Any, opt_state: Any, batch: Any,
                       job_id: str = "job0",
                       cost_model: Optional[CostModel] = None,
                       experience=None):
    """Capture a canonical ``train_step(params, opt_state, batch) ->
    (new_params, new_opt_state, metrics)``: params/opt-state kinds + the
    across-iteration aliasing the paper's Opt-phase scheduling needs."""
    spec = CaptureSpec(
        arg_kinds=[TensorKind.PARAM, TensorKind.OPT_STATE, TensorKind.INPUT],
        out_kinds=[TensorKind.PARAM, TensorKind.OPT_STATE, TensorKind.OUTPUT],
        alias_pairs=[(0, 0), (1, 1)])
    return capture(fn, params, opt_state, batch, job_id=job_id, spec=spec,
                   cost_model=cost_model, experience=experience)
