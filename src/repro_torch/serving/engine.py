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
from ..device import resolve_device
from ..kernels.kv_block_copy import (MAX_LEAVES, kv_block_gather,
                                     kv_block_scatter)
from ..launch.steps import build_serve_step
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
                 device=None, n_layers: Optional[int] = None):
        """``n_layers`` cuts the model's depth to that many layers (the
        width stays the config's); None keeps the config's depth."""
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
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = self.api.init(gen)
        self.cache = self.api.init_cache(self.max_sequences, self.max_len)
        self._step = build_serve_step(self.api)
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

    def _leaves(self) -> List[torch.Tensor]:
        return tree_leaves(self.cache)

    def _save_slot(self, s: SeqState) -> int:
        """Shadow-copy a slot's occupied cache region to host.  Returns
        bytes copied; no-op if already shadowed."""
        if s.rid in self._shadow:
            return 0
        saved: Dict[int, torch.Tensor] = {}
        nbytes = 0
        for i, (leaf, spec) in enumerate(zip(self._leaves(), self._axes)):
            if spec.batch is None:
                continue
            idx = _slot_index(spec, leaf.ndim, s.slot, 0, s.pos)
            arr = _to_host(leaf[idx])
            saved[i] = arr
            nbytes += _nbytes(arr)
        self._shadow[s.rid] = saved
        return nbytes

    def _restore_slot(self, s: SeqState) -> int:
        """Write a slot's shadow copy back into the shared cache (its
        device region was scribbled by other cohorts' turns)."""
        saved = self._shadow.pop(s.rid, None)
        if saved is None:
            return 0
        leaves = self._leaves()
        nbytes = 0
        for i, arr in saved.items():
            spec = self._axes[i]
            idx = _slot_index(spec, leaves[i].ndim, s.slot, 0, s.pos)
            leaves[i][idx].copy_(arr)
            nbytes += _nbytes(arr)
        return nbytes

    def _reduced_axis(self, spec: _LeafAxes) -> Optional[int]:
        """Where the length axis lands once the batch axis is removed —
        the axis the per-slot shadow slices along."""
        if spec.length is None:
            return None
        return spec.length - (1 if spec.batch < spec.length else 0)

    def _slotted(self) -> Tuple[List[int], List[torch.Tensor], List[int]]:
        """The cache leaves that hold a slot axis: their tree indices, the
        leaves, and their slot axes."""
        ids = [i for i, spec in enumerate(self._axes)
               if spec.batch is not None]
        leaves = self._leaves()
        return ids, [leaves[i] for i in ids], [self._axes[i].batch
                                               for i in ids]

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
        leaves at once, read in place from the cache, then per-state
        occupied prefixes are sliced out in the per-slot shadow format (so
        either restore path can consume them).  Returns bytes copied."""
        todo = [s for s in states if s.rid not in self._shadow]
        if not todo:
            return 0
        if len(todo) == 1:
            return self._save_slot(todo[0])
        ids, leaves, axes = self._slotted()
        gathered = self._gather(leaves, [s.slot for s in todo], axes)
        shadows: Dict[str, Dict[int, torch.Tensor]] = {s.rid: {} for s in todo}
        nbytes = 0
        for i, rows in zip(ids, gathered):
            red = self._reduced_axis(self._axes[i])
            for k, s in enumerate(todo):
                row = rows[k]
                if red is not None:
                    row = row.narrow(red, 0, s.pos)
                arr = _to_host(row)
                shadows[s.rid][i] = arr
                nbytes += _nbytes(arr)
        for s in todo:
            self._shadow[s.rid] = shadows[s.rid]
        return nbytes

    def _restore_slots(self, states: List[SeqState]) -> int:
        """Batched shadow restore: gather the cohort's current rows of
        every cache leaf (one launch per group of leaves), patch each
        occupied prefix from its shadow, and scatter the rows back into the
        cache (one launch per group).
        Suffix regions round-trip their own bytes, so the result is
        bit-identical to per-slot ``_restore_slot`` calls.  Returns bytes
        written."""
        todo = [s for s in states if s.rid in self._shadow]
        if not todo:
            return 0
        if len(todo) == 1:
            return self._restore_slot(todo[0])
        ids, leaves, axes = self._slotted()
        slots = [s.slot for s in todo]
        gathered = self._gather(leaves, slots, axes)
        nbytes = 0
        for i, rows in zip(ids, gathered):
            red = self._reduced_axis(self._axes[i])
            for k, s in enumerate(todo):
                arr = self._shadow[s.rid].get(i)
                if arr is None:
                    continue
                nbytes += _nbytes(arr)
                dst = rows[k] if red is None else rows[k].narrow(red, 0,
                                                                 s.pos)
                dst.copy_(arr)
        self._scatter(leaves, slots, gathered, axes)
        for s in todo:
            self._shadow.pop(s.rid, None)
        return nbytes

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
        cache = self.api.init_cache(1, self.max_len)
        logits = None
        for i in range(len(prompt)):
            logits, cache = self._step(self.params, cache,
                                       self._tokens(prompt[i:i + 1][None, :]),
                                       i)
        first = int(torch.argmax(logits[0, -1]))
        return PrefillResult(rid=rid, prompt=prompt, prompt_len=len(prompt),
                             first_token=first, cache=cache)

    def insert(self, pr: PrefillResult, slot: int,
               state: Optional[SeqState] = None) -> None:
        """Splice a prefilled sequence into the shared cache at ``slot``."""
        src_axes = _cache_leaf_axes(self.api, 1, self.max_len)
        src_leaves = tree_leaves(pr.cache)
        for leaf, spec, src, sspec in zip(self._leaves(), self._axes,
                                          src_leaves, src_axes):
            if spec.batch is None:
                continue
            dst = _slot_index(spec, leaf.ndim, slot, 0, pr.prompt_len)
            srcidx = _slot_index(sspec, src.ndim, 0, 0, pr.prompt_len)
            leaf[dst] = src[srcidx]
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
            nxt = torch.argmax(logits[:, -1], dim=-1).to(
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
