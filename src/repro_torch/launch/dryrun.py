"""Multi-pod dry run (the JAX package's ``launch/dryrun.py``).

For every (architecture x input shape x mesh) cell:

* build the parameters as the ``meta`` shell and shard them by the rules
  (``shard_params``), the AdamW state (``opt_state_for(abstract=True)``)
  placed as the parameters, and the batch or the cache on ``meta``,
  placed by ``rules.batch_sharding`` and ``api.cache_axes()``: shapes,
  dtypes and placements, no storage;
* run the real step builder (``build_train_step`` for ``train_4k``,
  ``build_prefill_step`` for ``prefill_32k``, the sharded
  ``build_serve_step`` for ``decode_*``/``long_*``) once on those
  tensors, in a process whose default group is torch's ``fake`` backend
  with 512 ranks (``fake_world``), as rank 0 of the production mesh
  (16 x 16, or 2 x 16 x 16 multi-pod);
* account the run (``StepAccounting``): FLOPs of the rank's local ops
  with ``torch.utils.flop_counter``'s formulas, the collectives the rank
  issues (kind, bytes, group extent) tallied with the reference's ring
  formulas (``tally_collectives``), and a ledger of the live local
  storages, whose peak plus the arguments is the per-device peak (the
  counterpart of the reference's ``arguments + temps + outputs -
  aliased``);
* write one JSON record per cell under ``experiments/artifacts_torch/``.

Departures from the reference.  PyTorch runs eagerly, so every layer
and every attention chunk is run and counted: the reference's scan-body
correction (``_body_cost``; XLA's cost analysis visits a loop body once)
has no counterpart.  The roofline uses one H100 SXM5 80GB's data-sheet
rates (``core.plan.MachineProfile``: 989 TFLOP/s dense bf16, 3.35 TB/s
HBM, 25 GB/s per NVLink link and direction), not the v5e's, and
``fits_hbm_16g`` becomes ``fits_device_memory`` against the profile's
``device_memory_bytes`` (80 GB), which the record names.  A decode cell
runs position ``seq_len - 1`` (the reference compiles for any index;
here the index is a Python int and the step's work does not depend on
it).  ``bytes_accessed`` sums the bytes of each non-view op's tensor
inputs and outputs.  ``use_flash_kernel`` stays the config's default
(``False``), as the reference's dry run runs: the kernel wrappers refuse
``meta`` tensors.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \\
        --shape train_4k --multi-pod both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time
import traceback
import weakref
from typing import Any, Dict, Iterable, Optional, Tuple

import torch
import torch.utils._pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs import (ALL_SHAPES, get_config, list_configs, shapes_for,
                       skipped_shapes_for)
from ..core.plan import MachineProfile
from ..device import is_dtensor
from ..models.registry import get_model
from .mesh import make_production_mesh
from .sharding import MeshRules, shard_params
from .steps import (TrainStepConfig, build_prefill_step, build_serve_step,
                    build_train_step, offloaded_bytes, opt_state_for,
                    shard_cache)

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "experiments", "artifacts_torch")
FAKE_WORLD = 512
HARDWARE = "H100 SXM5 80GB, 700 W, data sheet"
PROFILE = MachineProfile()

# collective ops (functional, and the c10d ops they stand for) -> the
# reference's HLO collective kinds
_KINDS = {"all_reduce": "all-reduce", "all_reduce_": "all-reduce",
          "all_reduce_coalesced": "all-reduce", "allreduce_": "all-reduce",
          "all_gather_into_tensor": "all-gather",
          "all_gather_into_tensor_coalesced": "all-gather",
          "allgather_": "all-gather", "_allgather_base_": "all-gather",
          "reduce_scatter_tensor": "reduce-scatter",
          "reduce_scatter_tensor_coalesced": "reduce-scatter",
          "reduce_scatter_": "reduce-scatter",
          "_reduce_scatter_base_": "reduce-scatter",
          "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
          "alltoall_base_": "all-to-all",
          "broadcast": "collective-permute", "broadcast_": "collective-permute"}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd",
                          "c10d")


def tally_collectives(records: Iterable[Tuple[str, int, int]]
                      ) -> Dict[str, Dict[str, float]]:
    """Per collective kind: count, result bytes and modelled wire bytes
    per device from ``(kind, result_bytes, group_extent)`` records, with
    the reference's ring formulas (``parse_collectives``): all-reduce
    2(n-1)/n, all-gather / reduce-scatter / all-to-all (n-1)/n,
    collective-permute 1; an extent below 2 counts as 2."""
    out: Dict[str, Dict[str, float]] = {}
    for kind, size, n in records:
        n = max(int(n), 2)
        if kind == "all-reduce":
            wire = 2 * size * (n - 1) / n
        elif kind == "collective-permute":
            wire = size
        else:
            wire = size * (n - 1) / n
        slot = out.setdefault(kind, {"count": 0, "bytes": 0.0,
                                     "wire_bytes": 0.0})
        slot["count"] += 1
        slot["bytes"] += size
        slot["wire_bytes"] += wire
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _local_tensors(tree) -> list:
    """The local tensors of a tree's leaves; a module's leaves are its
    parameters and buffers."""
    out = []
    for t in pytree.tree_leaves(tree):
        if isinstance(t, torch.nn.Module):
            out.extend(_local_tensors(list(t.parameters())
                                      + list(t.buffers())))
        elif isinstance(t, torch.Tensor):
            out.append(t.to_local() if is_dtensor(t) else t)
    return out


def _storages(tree) -> Dict[int, int]:
    """``{storage key: bytes}`` of the local tensors of ``tree``."""
    out = {}
    for t in _local_tensors(tree):
        st = t.untyped_storage()
        out[st._cdata] = st.nbytes()
    return out


def _view_bytes(tree) -> int:
    """Bytes of the local tensors of ``tree``, each distinct view once (a
    shard distributed on ``meta`` may be a view into its whole tensor's
    storage)."""
    seen = {}
    for t in _local_tensors(tree):
        key = (t.untyped_storage()._cdata, t.storage_offset(),
               tuple(t.shape), t.stride())
        seen[key] = _nbytes(t)
    return sum(seen.values())


_UNHASHABLE = object()


def _frozen(x):
    """A hashable key for an op's arguments: tensors by shape, strides
    and dtype; ``_UNHASHABLE`` if some argument is not hashable."""
    if isinstance(x, torch.Tensor):
        return ("T", tuple(x.shape), x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        parts = tuple(_frozen(e) for e in x)
        return _UNHASHABLE if _UNHASHABLE in parts else (type(x),) + parts
    if isinstance(x, dict):
        return _frozen(sorted(x.items()))
    try:
        hash(x)
    except TypeError:
        return _UNHASHABLE
    return x


def _tensors(args, kwargs) -> list:
    """The tensors among an op's arguments (in lists too)."""
    out = []
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(e for e in a if isinstance(e, torch.Tensor))
    return out


def _group_extent(name: str) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name).size()


class StepAccounting(TorchDispatchMode):
    """Accounts the local work of one rank while active.

    A DTensor op is passed on (``NotImplemented``): DTensor runs it as
    local ops, which come back here, and its sharding propagation runs on
    fake tensors, which pass through uncounted.  For each local op:
    ``flops`` (``torch.utils.flop_counter``'s formulas, ops without one
    decomposed first, as ``FlopCounterMode`` does), ``bytes_accessed``
    (tensor inputs and outputs of ops that return no view), each
    collective as ``(kind, result bytes, group extent)``, and a ledger of
    the storages its outputs created (an op returning a view or writing
    in place creates none): booked when first seen, released when the
    storage dies.  ``peak_bytes`` is the ledger's peak plus the
    bytes of ``args``' storages, which are never booked again."""

    def __init__(self, args=()):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.flops = 0
        self.flops_by_op: collections.Counter = collections.Counter()
        self.bytes_accessed = 0
        self.collectives: list = []
        self.arg_storages = _storages(args)
        self.arg_bytes = _view_bytes(args)
        self.live: Dict[int, int] = {}
        self.live_bytes = 0
        self.peak_live = 0
        # output metadata of meta ops seen before, by their arguments'
        self.meta_outputs: Dict[Any, Any] = {}
        self.facts: Dict[Any, Tuple[bool, bool, Optional[str]]] = {}
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        self.dtensor, self.fake = DTensor, FakeTensor

    # -- the ledger ------------------------------------------------------
    def _free(self, key: int) -> None:
        self.live_bytes -= self.live.pop(key, 0)

    def _book(self, outs) -> None:
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self.live or key in self.arg_storages:
                continue
            n = st.nbytes()
            self.live[key] = n
            self.live_bytes += n
            self.peak_live = max(self.peak_live, self.live_bytes)
            weakref.finalize(st, self._free, key)

    @property
    def peak_bytes(self) -> int:
        return self.arg_bytes + self.peak_live

    # -- dispatch --------------------------------------------------------
    def _collective(self, func, kind: str, args, kwargs, outs) -> None:
        """Record a collective: its result bytes (the reference's HLO
        result shape) and its group's extent."""
        names = [a.name for a in func._schema.arguments]
        group = None
        for key in ("group_name", "process_group"):
            if key in kwargs:
                group = kwargs[key]
            elif key in names and names.index(key) < len(args):
                group = args[names.index(key)]
        if isinstance(group, str):
            n = _group_extent(group)
        elif group is not None:
            from torch.distributed import ProcessGroup
            n = ProcessGroup.unbox(group).size()
        else:
            n = 2
        self.collectives.append((kind, sum(_nbytes(t) for t in outs), n))

    def _op_facts(self, func):
        """Per op, once: (writes an input or returns a view, decomposes
        without a FLOP formula, collective kind or None)."""
        facts = self.facts.get(func)
        if facts is None:
            schema = func._schema
            aliased = schema.is_mutable or any(
                r.alias_info is not None for r in schema.returns)
            decomposes = (func._overloadpacket not in self.registry
                          and func is not torch.ops.prim.device.default
                          and torch._C._dispatch_has_kernel_for_dispatch_key(
                              func.name(), "CompositeImplicitAutograd"))
            name = schema.name.split("::")[-1]
            kind = (_KINDS.get(name)
                    if func.namespace in _COLLECTIVE_NAMESPACES else None)
            facts = self.facts[func] = (aliased, decomposes, kind)
        return facts

    def _run(self, func, args, kwargs, leaves, aliased: bool):
        """``func(*args, **kwargs)``; an op on ``meta`` tensors that writes
        nothing and returns no view runs once per argument metadata, and
        later calls get new ``meta`` tensors of the outputs' shapes,
        strides and dtypes (the Python meta kernels cost hundreds of
        microseconds an op, and eager attention repeats each op for every
        chunk)."""
        if aliased or not leaves or not all(t.is_meta for t in leaves):
            return func(*args, **kwargs)
        key = _frozen((func, args, kwargs))
        if key is _UNHASHABLE:
            return func(*args, **kwargs)
        hit = self.meta_outputs.get(key)
        if hit is not None:
            metas, spec = hit
            return pytree.tree_unflatten(
                [torch.empty_strided(shape, stride, dtype=dtype,
                                     device="meta")
                 for shape, stride, dtype in metas], spec)
        out = func(*args, **kwargs)
        flat, spec = pytree.tree_flatten(out)
        if all(isinstance(t, torch.Tensor) and t.is_meta for t in flat):
            self.meta_outputs[key] = (
                [(tuple(t.shape), t.stride(), t.dtype) for t in flat], spec)
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        leaves = _tensors(args, kwargs)
        for t in leaves:
            if type(t) is not torch.Tensor:
                if isinstance(t, self.dtensor):
                    return NotImplemented
                if isinstance(t, self.fake):
                    # DTensor's sharding propagation
                    return func(*args, **kwargs)
        aliased, decomposes, kind = self._op_facts(func)
        if decomposes:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = self._run(func, args, kwargs, leaves, aliased)
        outs = ([out] if isinstance(out, torch.Tensor) else
                [t for t in pytree.tree_leaves(out)
                 if isinstance(t, torch.Tensor)])
        if any(isinstance(t, self.fake) for t in outs):
            return out
        if kind is not None:
            self._collective(func, kind, args, kwargs, outs)
        formula = self.registry.get(func._overloadpacket)
        if formula is not None:
            n = int(formula(*args, **kwargs, out_val=out))
            self.flops += n
            self.flops_by_op[str(func._overloadpacket)] += n
        # a copy between the host and the device moves no device bytes
        devices = {t.device.type for t in (*leaves, *outs)}
        if not aliased and not ("cpu" in devices and len(devices) > 1):
            self.bytes_accessed += sum(_nbytes(t) for t in leaves) + sum(
                _nbytes(t) for t in outs)
        if not aliased:                 # a view or an in-place write
            self._book(outs)            # allocates nothing
        return out


def account(step, args) -> Tuple[Any, "StepAccounting", float]:
    """Run ``step(*args)`` under a ``StepAccounting``; returns its output,
    the accounting and the seconds it took."""
    t0 = time.perf_counter()
    with StepAccounting(args) as acc:
        out = step(*args)
    return out, acc, time.perf_counter() - t0


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS: 6·N_active·D for training, 2·N_active·D for inference
    (D = processed tokens)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        if cfg.enc_dec:
            tokens = shape.global_batch * (shape.seq_len
                                           + shape.seq_len // cfg.enc_seq_ratio)
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


def fake_world(world_size: int = FAKE_WORLD) -> None:
    """Start a default group of ``world_size`` ranks on torch's ``fake``
    backend (no communication; this process is rank 0), unless this
    process already has one of that size."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(f"a world of {dist.get_world_size()} ranks "
                               f"is running; the dry run needs {world_size}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def place_batch(rules: MeshRules, batch):
    """``batch`` distributed by ``rules.batch_sharding``: the reference's
    ``in_shardings``, placed before the step runs."""
    shardings = rules.batch_sharding(batch)
    return {k: shardings[k].distribute(x) for k, x in batch.items()}


def cell_state(api, shape, rules: MeshRules):
    """The step and its ``meta`` arguments for one cell: ``(step, args,
    host_offload_bytes)``."""
    params = shard_params(api.shell(), rules)
    if shape.kind == "train":
        opt = opt_state_for(params, abstract=True)
        batch = place_batch(rules, api.input_specs(shape, abstract=True))
        step = build_train_step(api, TrainStepConfig(), rules=rules)
        return step, (params, opt, batch), offloaded_bytes(opt)
    if shape.kind == "prefill":
        batch = place_batch(rules, api.input_specs(shape, abstract=True))
        return build_prefill_step(api, rules=rules), (params, batch), 0
    cache = shard_cache(api, rules, api.abstract_cache(shape.global_batch,
                                                       shape.seq_len))
    batch = place_batch(rules, api.decode_input_specs(shape,
                                                        abstract=True))
    return (build_serve_step(api, rules=rules),
            (params, cache, batch, shape.seq_len - 1), 0)


def _per_device(acc: StepAccounting, out) -> Dict[str, int]:
    """The reference's ``memory_analysis`` fields from the ledger: outputs
    are the step's output storages, aliased those among them that are
    arguments (written in place), temps the rest of the peak."""
    outs = _storages(out)
    aliased = sum(n for k, n in outs.items() if k in acc.arg_storages)
    outputs = sum(outs.values())
    return {"arguments": acc.arg_bytes, "outputs": outputs,
            "temps": acc.peak_bytes - acc.arg_bytes - outputs + aliased,
            "aliased": aliased, "generated_code": 0}


def record_for(arch: str, shape, rules: MeshRules, acc: StepAccounting,
               out, seconds: float, host_bytes: int,
               multi_pod: bool) -> Dict[str, Any]:
    cfg = rules.cfg
    mesh = rules.mesh
    chips = mesh.size()
    colls = tally_collectives(acc.collectives)
    wire = sum(c["wire_bytes"] for c in colls.values())
    peak = acc.peak_bytes
    host_per_device = host_bytes // chips
    flops = float(acc.flops)
    m_flops = model_flops_for(cfg, shape)
    compute_s = flops / PROFILE.compute_flops
    memory_s = acc.bytes_accessed / PROFILE.mem_bw
    collective_s = wire / PROFILE.ici_bw
    return {
        "arch": arch, "shape": shape.name, "kind": shape.kind,
        "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)), "chips": chips,
        "multi_pod": multi_pod,
        "compile_seconds": round(seconds, 2),
        "per_device": _per_device(acc, out),
        "per_device_peak_bytes": int(peak),
        "tensile_host_offload_bytes_per_device": int(host_per_device),
        "per_device_peak_after_offload": int(peak - host_per_device),
        "fits_device_memory": bool(peak - host_per_device
                                   < PROFILE.device_memory_bytes),
        "device_memory_bytes": int(PROFILE.device_memory_bytes),
        "hardware": HARDWARE,
        "cost": {"flops": flops, "bytes_accessed": float(acc.bytes_accessed),
                 "flops_by_op": dict(acc.flops_by_op)},
        "collectives": colls,
        "roofline": {
            "compute_s": compute_s,
            "memory_s": memory_s,
            "collective_s": collective_s,
            "dominant": max(
                [("compute", compute_s), ("memory", memory_s),
                 ("collective", collective_s)], key=lambda kv: kv[1])[0],
            "model_flops": m_flops,
            "model_flops_global": m_flops,
            "useful_flops_ratio": (m_flops / chips) / flops if flops else 0.0,
            "peak_flops": PROFILE.compute_flops, "hbm_bw": PROFILE.mem_bw,
            "link_bw": PROFILE.ici_bw,
        },
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool) -> Dict[str, Any]:
    """One cell on rank 0 of the production mesh of a 512-rank ``fake``
    world (started here if this process has none)."""
    fake_world()
    cfg = get_config(arch)
    shape = {s.name: s for s in ALL_SHAPES}[shape_name]
    api = get_model(cfg, "cpu")
    rules = MeshRules(make_production_mesh(multi_pod=multi_pod,
                                           device="cpu"), cfg=cfg)
    t0 = time.perf_counter()
    step, args, host_bytes = cell_state(api, shape, rules)
    out, acc, _ = account(step, args)
    return record_for(arch, shape, rules, acc, out,
                      time.perf_counter() - t0, host_bytes, multi_pod)


def artifact_path(arch: str, shape: str, multi_pod: bool,
                  directory: Optional[str] = None) -> str:
    directory = directory or ARTIFACT_DIR
    os.makedirs(directory, exist_ok=True)
    pod = "pod2" if multi_pod else "pod1"
    return os.path.join(directory, f"{arch}__{shape}__{pod}.json")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", choices=["0", "1", "both"], default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--artifact-dir", default=None,
                    help="where the records go (default "
                         "experiments/artifacts_torch)")
    args = ap.parse_args(argv)

    archs = list_configs() if (args.all or not args.arch) else [args.arch]
    pods = {"0": [False], "1": [True], "both": [False, True]}[args.multi_pod]
    failures = []
    for arch in archs:
        cfg = get_config(arch)
        shape_names = ([args.shape] if args.shape
                       else [s.name for s in shapes_for(cfg)])
        for sk, reason in skipped_shapes_for(cfg):
            if args.shape in (None, sk.name):
                print(f"[skip] {arch} × {sk.name}: {reason}")
        for shape in shape_names:
            for mp in pods:
                path = artifact_path(arch, shape, mp, args.artifact_dir)
                if args.skip_existing and os.path.exists(path):
                    print(f"[cached] {arch} × {shape} × "
                          f"{'2pod' if mp else '1pod'}")
                    continue
                tag = f"{arch} × {shape} × {'2pod(512)' if mp else '1pod(256)'}"
                try:
                    rec = run_cell(arch, shape, mp)
                    with open(path, "w") as f:
                        json.dump(rec, f, indent=1)
                    r = rec["roofline"]
                    print(f"[ok] {tag}: run={rec['compile_seconds']}s "
                          f"peak={rec['per_device_peak_bytes']/2**30:.2f}GiB "
                          f"(offload→{rec['per_device_peak_after_offload']/2**30:.2f}) "
                          f"flops={rec['cost']['flops']:.3e} "
                          f"dominant={r['dominant']}", flush=True)
                except Exception as e:  # noqa: BLE001
                    failures.append((tag, repr(e)))
                    print(f"[FAIL] {tag}: {e}", flush=True)
                    traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for t, e in failures:
            print(" ", t, e)
        return 1
    print("\nall dry-run cells ran.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
