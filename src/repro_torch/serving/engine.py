"""ServingEngine: the real continuous-batching runtime over the PyTorch
model.

    eng = ServingEngine("tinyllama-1.1b", max_sequences=4, max_len=64)
    pr = eng.prefill(prompt_tokens, rid="r0")   # compute burst, first token
    eng.insert(pr, slot=0)                      # splice into the batch cache
    eng.generate()                              # one decode round

and a batch driver, ``serve(requests, ...)``, that wires the engine's
side-effect hooks into a :class:`~repro_torch.serving.session.ServeSession`,
so the loop that simulates a served mix in virtual time drives real decode
steps here: evictions copy a sequence's occupied cache blocks to host, and
its decode turn restores them first.

Why restoration is a correctness requirement and not just accounting: the
model's ``decode_step`` takes one scalar index, so every decode turn
writes position ``index`` of *every* batch row.  A slot sitting out a turn
whose index falls inside its valid prefix gets that prefix scribbled.  The
engine therefore keeps a host-side shadow copy of every live slot that is
not in the decoding cohort and restores it before the slot's own turn.
Batch rows are computationally independent, so a served run under memory
pressure is **bit-identical** to the unpressured run.

Differences from the JAX engine, none of which changes a decision or a
token: the cache is updated in place; host shadows are copies (pinned
host memory when the cache is on the card), never views of the live cache;
prompts are drawn with numpy; and the batched path moves the rows of
every cache leaf through the hand-written kernels of
``kernels/kv_block_copy.py``, one launch per group of up to
``MAX_LEAVES`` leaves (one launch for TinyLlama's 2 and Mamba-2's 4, two
for Jamba's 30), which read and write the leaves in place (the JAX engine
moves each leaf's slot axis to the front, a copy of the leaf, to make a
row pool).

Under a mesh (``rules``, or a default process group of more than one
rank, over which the engine builds the reference's ``MeshRules(
make_host_mesh(), cfg=cfg)``) the parameters are sharded by their axes,
the cache is placed by ``api.cache_axes()`` (slots over the data axes,
positions over ``"model"``) and the decode step is
``build_serve_step(api, rules=rules)``.  Every save, restore and splice
moves each rank's own pieces: the slots its data shard holds, the
positions its ``"model"`` shard holds, through the same kernels on the
local tensors, into host shadows of its own.  The byte counts are those
of the whole cache, so the session's decisions, its trace and every
transfer's bytes are the meshless engine's; greedy tokens come from the
gathered logits.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..configs import get_config
from ..core.engine import MemoryEngine
from ..core.plan import MachineProfile
from ..device import is_dtensor, resolve_device
from ..kernels.kv_block_copy import (MAX_LEAVES, kv_block_gather,
                                     kv_block_scatter)
from ..launch.sharding import shard_params
from ..launch.steps import build_serve_step, shard_cache
from ..models.registry import get_model
from .residency import SeqView, build_horizon
from .session import SeqState, ServeHooks, ServeReport, ServeSession
from .traces import Request


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves of a nested dict in ``jax.tree_util`` order (sorted keys)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


@dataclasses.dataclass
class _LeafAxes:
    """Which axes of one cache leaf index the batch slot / the position."""

    batch: Optional[int]
    length: Optional[int]


def _cache_leaf_axes(api, batch: int, max_len: int) -> List[_LeafAxes]:
    """Classify cache leaves by diffing shapes of caches built on the
    ``meta`` device: the axis that changes when ``batch`` grows is the slot
    axis, the one that changes with ``max_len`` is the position axis."""
    def shapes(b, m):
        return [tuple(x.shape) for x in tree_leaves(api.abstract_cache(b, m))]

    base = shapes(batch, max_len)
    bgrow = shapes(batch + 1, max_len)
    lgrow = shapes(batch, max_len + 1)

    def diff_axis(a, b):
        for i, (x, y) in enumerate(zip(a, b)):
            if x != y:
                return i
        return None

    return [_LeafAxes(batch=diff_axis(s, sb), length=diff_axis(s, sl))
            for s, sb, sl in zip(base, bgrow, lgrow)]


def _slot_index(spec: _LeafAxes, ndim: int, slot, lo: int, hi: int):
    idx: List = [slice(None)] * ndim
    if spec.batch is not None:
        idx[spec.batch] = slot
    if spec.length is not None:
        idx[spec.length] = slice(lo, hi)
    return tuple(idx)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A host copy that shares no storage with ``t``.  (``.cpu()`` of a
    CPU tensor returns ``t`` itself: a shadow made that way would alias
    the live cache.)  From the card, the copy lands in pinned memory."""
    if t.device.type == "cpu":
        return t.to("cpu", copy=True)
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _local(t: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """A cache leaf's local tensor (a DTensor's shard, written in place
    through it) and the global index of its first element on each axis."""
    if not is_dtensor(t):
        return t, (0,) * t.dim()
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    off = compute_local_shape_and_global_offset(t.shape, t.device_mesh,
                                                t.placements)[1]
    return t.to_local(), tuple(off)


def _whole(t: torch.Tensor) -> torch.Tensor:
    return t.full_tensor() if is_dtensor(t) else t


def _default_rules(cfg):
    """The reference's engine rules: ``MeshRules(make_host_mesh(),
    cfg=cfg)`` over a default process group of more than one rank; None
    without one (a world of one serves meshless, as the launcher)."""
    import torch.distributed as dist
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return None
    from ..launch.mesh import make_host_mesh
    from ..launch.sharding import MeshRules
    return MeshRules(make_host_mesh(), cfg=cfg)


@dataclasses.dataclass
class PrefillResult:
    """A prefilled prompt: its single-slot cache, ready to splice in."""

    rid: str
    prompt: np.ndarray
    prompt_len: int
    first_token: int
    cache: object            # batch-1 cache tree, positions [0, prompt_len)


class ServingEngine:
    """Continuous-batching decode over one shared cache."""

    def __init__(self, arch: str = "tinyllama-1.1b", *, reduced: bool = True,
                 max_sequences: int = 4, max_len: int = 64, seed: int = 0,
                 device=None, n_layers: Optional[int] = None, rules=None):
        """``n_layers`` cuts the model's depth to that many layers (the
        width stays the config's); None keeps the config's depth.
        ``rules`` (``launch.sharding.MeshRules``) serves on their mesh;
        without them a default process group of more than one rank gets
        the host mesh's."""
        self.device = resolve_device(device)
        cfg = get_config(arch)
        if reduced:
            cfg = cfg.reduced()
            if cfg.n_experts:
                cfg.moe_impl = "dense"
        if n_layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=int(n_layers))
        if cfg.enc_dec:
            raise ValueError(
                "ServingEngine serves decoder-only LMs; encoder-decoder "
                "arches are not ported")
        self.cfg = cfg
        self.api = get_model(cfg, self.device)
        self.max_sequences = int(max_sequences)
        self.max_len = int(max_len)
        self.rules = rules if rules is not None else _default_rules(cfg)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = self.api.init(gen)
        self.cache = self._new_cache(self.max_sequences)
        if self.rules is not None:
            shard_params(self.params, self.rules)
        self._step = build_serve_step(self.api, rules=self.rules)
        self._axes = _cache_leaf_axes(self.api, self.max_sequences,
                                      self.max_len)
        # per-token-per-sequence cache bytes, from meta shapes only
        self.bytes_per_token = sum(
            _nbytes(x) for x in tree_leaves(self.api.abstract_cache(1, 1)))
        # live serving state
        self._tok = np.zeros((self.max_sequences, 1), np.int32)
        self._states: Dict[str, SeqState] = {}
        self._outputs: Dict[str, List[int]] = {}
        self._shadow: Dict[str, Dict[int, torch.Tensor]] = {}
        self._channel = None   # bound by serve() for transfer accounting
        self._batch_kv = False  # serve(batch_transfers=True) flips this

    # -- deterministic prompts (rid-keyed, run-independent) -------------

    def prompt_for(self, rid: str, prompt_len: int) -> np.ndarray:
        """The JAX engine draws these from ``jax.random``; the port draws
        from numpy with the same crc32 seed, so its prompts differ.  Parity
        tests hand the JAX engine's prompts in instead."""
        rng = np.random.default_rng(zlib.crc32(rid.encode()) & 0x7FFFFFFF)
        hi = min(self.cfg.vocab_size, 64)
        return rng.integers(0, hi, size=prompt_len, dtype=np.int32)

    # -- cache slicing --------------------------------------------------

    def _new_cache(self, batch: int):
        """An empty cache of ``batch`` slots, placed by the rules."""
        cache = self.api.init_cache(batch, self.max_len)
        if self.rules is None:
            return cache
        return shard_cache(self.api, self.rules, cache)

    def _leaves(self) -> List[torch.Tensor]:
        return tree_leaves(self.cache)

    def _row_bytes(self, i: int, pos: int) -> int:
        """Bytes of one slot's first ``pos`` positions of leaf ``i`` in the
        whole cache (what a meshless engine's shadow of it holds)."""
        leaf, spec = self._leaves()[i], self._axes[i]
        n = leaf.element_size()
        for ax, size in enumerate(leaf.shape):
            if ax != spec.batch:
                n *= pos if ax == spec.length else size
        return n

    def _held(self, i: int, slot: int, pos: int):
        """This rank's piece of slot ``slot``'s first ``pos`` positions of
        leaf ``i``: (its local tensor, the slot's local index or None when
        another rank holds the slot, the positions held here: a prefix of
        the local position axis)."""
        local, off = _local(self._leaves()[i])
        spec = self._axes[i]
        k = slot - off[spec.batch]
        if not 0 <= k < local.shape[spec.batch]:
            k = None
        n = None
        if spec.length is not None:
            n = min(max(pos - off[spec.length], 0), local.shape[spec.length])
        return local, k, n

    def _save_slot(self, s: SeqState) -> int:
        """Shadow-copy a slot's occupied cache region to host (this rank's
        pieces of it).  Returns bytes copied (in the whole cache); no-op
        if already shadowed."""
        if s.rid in self._shadow:
            return 0
        saved: Dict[int, torch.Tensor] = {}
        nbytes = 0
        for i in self._slotted()[0]:
            local, k, n = self._held(i, s.slot, s.pos)
            if k is not None:
                spec = self._axes[i]
                saved[i] = _to_host(local[_slot_index(spec, local.ndim, k,
                                                      0, n)])
            nbytes += self._row_bytes(i, s.pos)
        self._shadow[s.rid] = saved
        return nbytes

    def _restore_slot(self, s: SeqState) -> int:
        """Write a slot's shadow copy back into the shared cache (its
        device region was scribbled by other cohorts' turns)."""
        saved = self._shadow.pop(s.rid, None)
        if saved is None:
            return 0
        nbytes = 0
        for i in self._slotted()[0]:
            local, k, n = self._held(i, s.slot, s.pos)
            if k is not None:
                spec = self._axes[i]
                local[_slot_index(spec, local.ndim, k, 0, n)].copy_(saved[i])
            nbytes += self._row_bytes(i, s.pos)
        return nbytes

    def _reduced_axis(self, spec: _LeafAxes) -> Optional[int]:
        """Where the length axis lands once the batch axis is removed —
        the axis the per-slot shadow slices along."""
        if spec.length is None:
            return None
        return spec.length - (1 if spec.batch < spec.length else 0)

    def _slotted(self) -> Tuple[List[int], List[torch.Tensor], List[int]]:
        """The cache leaves that hold a slot axis: their tree indices,
        their local tensors, and their slot axes."""
        ids = [i for i, spec in enumerate(self._axes)
               if spec.batch is not None]
        leaves = self._leaves()
        return ids, [_local(leaves[i])[0] for i in ids], [
            self._axes[i].batch for i in ids]

    def _local_slots(self, states: List[SeqState]):
        """The states whose slots this rank holds, and those slots' local
        indices (every slotted leaf splits its slots alike)."""
        i = self._slotted()[0][0]
        held = [(s, self._held(i, s.slot, 0)[1]) for s in states]
        held = [(s, k) for s, k in held if k is not None]
        return [s for s, _ in held], [k for _, k in held]

    @staticmethod
    def _groups(leaves: List[torch.Tensor], axes: List[int]):
        """Consecutive groups of at most ``MAX_LEAVES`` leaves (and their
        axes): one kernel launch moves one group."""
        for i in range(0, len(leaves), MAX_LEAVES):
            yield leaves[i:i + MAX_LEAVES], axes[i:i + MAX_LEAVES]

    def _gather(self, leaves: List[torch.Tensor], slots: List[int],
                axes: List[int]) -> List[torch.Tensor]:
        return [rows for group, ax in self._groups(leaves, axes)
                for rows in kv_block_gather(group, slots, axis=ax)]

    def _scatter(self, leaves: List[torch.Tensor], slots: List[int],
                 blocks: List[torch.Tensor], axes: List[int]) -> None:
        for i, (group, ax) in enumerate(self._groups(leaves, axes)):
            kv_block_scatter(group, slots,
                             blocks[i * MAX_LEAVES:(i + 1) * MAX_LEAVES],
                             axis=ax)

    def _save_slots(self, states: List[SeqState]) -> int:
        """Batched shadow save: one ``kv_block_gather`` launch per group of
        up to ``MAX_LEAVES`` cache leaves moves every slot's row of those
        leaves at once, read in place from the cache (this rank's slots,
        its positions of them), then per-state occupied prefixes are
        sliced out in the per-slot shadow format (so either restore path
        can consume them).  Returns bytes copied (in the whole cache)."""
        todo = [s for s in states if s.rid not in self._shadow]
        if not todo:
            return 0
        if len(todo) == 1:
            return self._save_slot(todo[0])
        ids, leaves, axes = self._slotted()
        mine, slots = self._local_slots(todo)
        shadows: Dict[str, Dict[int, torch.Tensor]] = {s.rid: {} for s in todo}
        if mine:
            gathered = self._gather(leaves, slots, axes)
            for i, rows in zip(ids, gathered):
                red = self._reduced_axis(self._axes[i])
                for k, s in enumerate(mine):
                    row = rows[k]
                    if red is not None:
                        row = row.narrow(red, 0, self._held(i, s.slot,
                                                            s.pos)[2])
                    shadows[s.rid][i] = _to_host(row)
        for s in todo:
            self._shadow[s.rid] = shadows[s.rid]
        return sum(self._row_bytes(i, s.pos) for s in todo for i in ids)

    def _restore_slots(self, states: List[SeqState]) -> int:
        """Batched shadow restore: gather the cohort's current rows of
        every cache leaf (one launch per group of leaves), patch each
        occupied prefix from its shadow, and scatter the rows back into the
        cache (one launch per group); under a mesh, of this rank's slots
        and positions.  Suffix regions round-trip their own bytes, so the
        result is bit-identical to per-slot ``_restore_slot`` calls.
        Returns bytes written (in the whole cache)."""
        todo = [s for s in states if s.rid in self._shadow]
        if not todo:
            return 0
        if len(todo) == 1:
            return self._restore_slot(todo[0])
        ids, leaves, axes = self._slotted()
        mine, slots = self._local_slots(todo)
        if mine:
            gathered = self._gather(leaves, slots, axes)
            for i, rows in zip(ids, gathered):
                red = self._reduced_axis(self._axes[i])
                for k, s in enumerate(mine):
                    arr = self._shadow[s.rid][i]
                    dst = rows[k] if red is None else rows[k].narrow(
                        red, 0, arr.shape[red])
                    dst.copy_(arr)
            self._scatter(leaves, slots, gathered, axes)
        for s in todo:
            self._shadow.pop(s.rid, None)
        return sum(self._row_bytes(i, s.pos) for s in todo for i in ids)

    def _xfer(self, fn):
        if self._channel is not None:
            return self._channel.transfer(fn)
        return fn()

    # -- the maxtext-shaped surface -------------------------------------

    def _tokens(self, tok: np.ndarray) -> Dict[str, torch.Tensor]:
        return {"tokens": torch.tensor(tok, device=self.device)}

    def prefill(self, prompt: Sequence[int], rid: str = "r?") -> PrefillResult:
        """Run one prompt through a fresh single-slot cache (the compute
        burst); the last position's logits give the first sampled token."""
        prompt = np.asarray(prompt, np.int32)
        cache = self._new_cache(1)
        logits = None
        for i in range(len(prompt)):
            logits, cache = self._step(self.params, cache,
                                       self._tokens(prompt[i:i + 1][None, :]),
                                       i)
        first = int(torch.argmax(_whole(logits)[0, -1]))
        return PrefillResult(rid=rid, prompt=prompt, prompt_len=len(prompt),
                             first_token=first, cache=cache)

    def insert(self, pr: PrefillResult, slot: int,
               state: Optional[SeqState] = None) -> None:
        """Splice a prefilled sequence into the shared cache at ``slot``."""
        src_axes = _cache_leaf_axes(self.api, 1, self.max_len)
        src_leaves = tree_leaves(pr.cache)
        for i in self._slotted()[0]:
            spec, sspec = self._axes[i], src_axes[i]
            local, k, n = self._held(i, slot, pr.prompt_len)
            if k is None:
                continue
            src, soff = _local(src_leaves[i])
            # both place their positions alike (one max_len, one rule)
            if spec.length is not None and soff[sspec.length] != _local(
                    self._leaves()[i])[1][spec.length]:
                raise ValueError("the prefill cache's positions are placed "
                                 "unlike the shared cache's")
            local[_slot_index(spec, local.ndim, k, 0, n)] = src[
                _slot_index(sspec, src.ndim, 0, 0, n)]
        self._tok[slot, 0] = pr.first_token
        self._outputs.setdefault(pr.rid, []).append(pr.first_token)
        if state is None:
            state = SeqState(rid=pr.rid, slot=slot, prompt_len=pr.prompt_len,
                             gen_len=0, priority=1.0, arrival=0.0,
                             pos=pr.prompt_len, generated=1)
        self._states[pr.rid] = state

    def _decode_turn(self, cohort: List[SeqState], start_pos: int,
                     chunk: int) -> None:
        """One chunked decode turn: restore the cohort's shadows, shadow
        every other live slot (their region [start_pos, start_pos+chunk)
        is about to be scribbled), then step ``chunk`` tokens."""
        cohort_ids = {s.rid for s in cohort}
        others = [st for rid, st in self._states.items()
                  if rid not in cohort_ids]
        if self._batch_kv:
            # batched data path: one gather (and one scatter) launch per
            # transfer moves the whole cohort's rows of every cache leaf
            # (and shadows every bystander)
            self._xfer(lambda: self._restore_slots(cohort))
            self._xfer(lambda: self._save_slots(others))
        else:
            for s in cohort:
                self._xfer(lambda s=s: self._restore_slot(s))
            for st in others:
                self._xfer(lambda st=st: self._save_slot(st))
        for k in range(chunk):
            idx = start_pos + k
            logits, self.cache = self._step(self.params, self.cache,
                                            self._tokens(self._tok), idx)
            nxt = torch.argmax(_whole(logits)[:, -1], dim=-1).to(
                torch.int32).cpu().numpy()
            for s in cohort:
                self._tok[s.slot, 0] = nxt[s.slot]
                self._outputs[s.rid].append(int(nxt[s.slot]))

    def generate(self) -> Dict[str, int]:
        """One decode round for the front position-aligned group (the
        standalone surface; ``serve`` drives turns via the session).
        Returns the token each served sequence produced."""
        views = [SeqView(rid=s.rid, slot=s.slot, pos=s.pos,
                         remaining=max(s.remaining, 1),
                         last_served=s.last_served)
                 for s in self._states.values()]
        if not views:
            return {}
        horizon = build_horizon(views)
        front = horizon.turns[0]
        cohort = [self._states[r] for r in front.rids]
        self._decode_turn(cohort, front.pos, 1)
        out = {}
        for s in cohort:
            s.pos += 1
            s.generated += 1
            s.remaining = max(s.remaining - 1, 0)
            out[s.rid] = self._outputs[s.rid][-1]
        return out

    # -- session hooks --------------------------------------------------

    def _hooks(self) -> ServeHooks:
        def on_insert(s: SeqState) -> None:
            pr = self.prefill(self.prompt_for(s.rid, s.prompt_len), rid=s.rid)
            self.insert(pr, s.slot, state=s)

        def on_evict(rid: str) -> None:
            s = self._states.get(rid)
            if s is not None:
                self._xfer(lambda: self._save_slot(s))

        def on_prefetch(rid: str) -> None:
            # data motion is deferred to the slot's decode turn (the
            # restore there is what guarantees bit-identity); the ledger
            # side already accounted the transfer in virtual time
            pass

        def on_finish(s: SeqState) -> None:
            self._shadow.pop(s.rid, None)
            self._states.pop(s.rid, None)
            self._tok[s.slot, 0] = 0

        return ServeHooks(on_insert=on_insert, on_decode=self._decode_turn,
                          on_evict=on_evict, on_prefetch=on_prefetch,
                          on_finish=on_finish)

    # -- the batch driver -----------------------------------------------

    def serve(self, requests: Sequence[Request], *,
              budget_bytes: Optional[int] = None, schedule: bool = True,
              block_tokens: int = 4,
              engine: Optional[MemoryEngine] = None,
              oversubscription: float = 2.5,
              job_id: str = "serve",
              batch_transfers: bool = False,
              ) -> Tuple[ServeReport, Dict[str, List[int]]]:
        """Serve a request trace for real: a ServeSession makes every
        residency decision against the shared ledger; this engine's hooks
        execute them on the model.  Returns the session report and the
        per-request generated token ids."""
        mem = engine or MemoryEngine(profile=MachineProfile(),
                                     capacity_bytes=None, trace=True)
        self._states.clear()
        self._outputs.clear()
        self._shadow.clear()
        self._tok[:] = 0
        self._channel = mem.channel
        self._batch_kv = bool(batch_transfers)
        try:
            session = ServeSession(
                requests, engine=mem, job_id=job_id,
                max_sequences=self.max_sequences,
                bytes_per_token=self.bytes_per_token,
                block_tokens=block_tokens, budget_bytes=budget_bytes,
                schedule=schedule, oversubscription=oversubscription,
                batch_transfers=batch_transfers,
                hooks=self._hooks())
            report = session.run()
        finally:
            self._channel = None
            self._batch_kv = False
        return report, {rid: list(toks) for rid, toks in
                        self._outputs.items()}
