"""Data pipeline: deterministic sharded token streams with background
host prefetch (the JAX package's ``data/pipeline.py``; the stream draws
the same numpy batches).

Production shape: each host produces only ITS batch shard (`host_slice`),
the stream is seedable + checkpointable (the step counter is part of the
training checkpoint, so restart resumes mid-epoch deterministically), and a
double-buffering prefetch thread overlaps host data generation with device
compute (the host-side analogue of TENSILE's swap/compute overlap).

Sources: synthetic LM token stream (default — zipfian tokens with a simple
Markov structure so the loss actually decreases), or a memory-mapped token
file (np.memmap) for real corpora.

Three departures from the reference.  Two are about resuming: the
stream's iterator yields the batch of ``self.step`` as it stands when the
batch is asked for, so after ``load_state_dict`` the next batch is the
loaded step's (the reference's generator yields the step after it); and
``Prefetcher.seek`` drops the batches already prefetched and restarts
from a loaded data state.  The third: ``Prefetcher.close`` waits for its
worker to stop.  ``to_device`` moves a numpy batch onto a card
through pinned memory without blocking.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from ..device import resolve_device


@dataclasses.dataclass
class DataConfig:
    seq_len: int = 512
    global_batch: int = 8
    vocab_size: int = 512
    seed: int = 0
    kind: str = "synthetic"        # synthetic | memmap
    path: Optional[str] = None     # for memmap
    # modality stubs
    frontend: str = "none"
    n_patches: int = 0
    d_model: int = 0
    enc_dec: bool = False
    enc_seq_ratio: int = 4


class TokenStream:
    """Deterministic, seekable token-batch stream."""

    def __init__(self, cfg: DataConfig, host_id: int = 0, n_hosts: int = 1):
        assert cfg.global_batch % n_hosts == 0, \
            "global batch must divide across hosts"
        self.cfg = cfg
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.local_batch = cfg.global_batch // n_hosts
        self.step = 0
        if cfg.kind == "memmap":
            assert cfg.path, "memmap source needs a path"
            self._tokens = np.memmap(cfg.path, dtype=np.int32, mode="r")
        else:
            self._tokens = None

    # -- checkpointable state ------------------------------------------
    def state_dict(self) -> Dict[str, int]:
        return {"step": self.step, "seed": self.cfg.seed,
                "host_id": self.host_id}

    def load_state_dict(self, d: Dict[str, int]) -> None:
        self.step = int(d["step"])

    # ------------------------------------------------------------------
    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            (self.cfg.seed * 1_000_003 + step) * 4096 + self.host_id)

    def _synthetic(self, step: int) -> np.ndarray:
        cfg = self.cfg
        rng = self._rng(step)
        b, s, v = self.local_batch, cfg.seq_len + 1, cfg.vocab_size
        # zipf-ish marginals + deterministic successor structure: tokens
        # depend on their predecessor, so an LM can reduce loss quickly
        base = rng.zipf(1.5, size=(b, s)).astype(np.int64) % v
        succ = (np.arange(v) * 31 + 7) % v
        mask = rng.random((b, s)) < 0.7
        out = base.copy()
        for t in range(1, s):
            out[:, t] = np.where(mask[:, t], succ[out[:, t - 1]], base[:, t])
        return out.astype(np.int32)

    def _memmap_batch(self, step: int) -> np.ndarray:
        cfg = self.cfg
        b, s = self.local_batch, cfg.seq_len + 1
        n = self._tokens.shape[0] - s - 1
        rng = self._rng(step)
        starts = rng.integers(0, n, size=b)
        return np.stack([self._tokens[st:st + s] for st in starts]).astype(
            np.int32)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        toks = (self._memmap_batch(step) if cfg.kind == "memmap"
                else self._synthetic(step))
        if cfg.enc_dec:
            s_dec = max(cfg.seq_len // cfg.enc_seq_ratio, 8)
            rng = self._rng(step)
            feats = rng.standard_normal(
                (self.local_batch, cfg.seq_len, cfg.d_model)).astype(
                np.float32)
            return {"audio_feats": feats,
                    "tokens": toks[:, :s_dec],
                    "labels": toks[:, 1:s_dec + 1]}
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.frontend == "vision_stub":
            rng = self._rng(step)
            batch["extra_embeds"] = rng.standard_normal(
                (self.local_batch, cfg.n_patches, cfg.d_model)).astype(
                np.float32)
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            step = self.step
            self.step = step + 1
            yield self.batch_at(step)


class Prefetcher:
    """Double-buffered background prefetch (overlaps data generation /
    host→device transfer with compute)."""

    def __init__(self, stream: TokenStream, depth: int = 2,
                 to_device=None):
        self.stream = stream
        self.to_device = to_device or (lambda x: x)
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._start()

    def _start(self) -> None:
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._worker,
                                       args=(self._stop,), daemon=True)
        self.thread.start()

    def _worker(self, stop: threading.Event):
        it = iter(self.stream)
        while not stop.is_set():
            try:
                batch = next(it)
            except StopIteration:
                break
            put_done = False
            while not put_done and not stop.is_set():
                try:
                    self.q.put(self.to_device(batch), timeout=0.1)
                    put_done = True
                except queue.Full:
                    continue

    def seek(self, data_state: Dict[str, int]) -> None:
        """Resume at a loaded data state: stop the worker, drop what it
        prefetched, load the state into the stream and start again."""
        self.close()
        while not self.q.empty():
            self.q.get_nowait()
        self.stream.load_state_dict(data_state)
        self._start()

    def __next__(self):
        return self.q.get()

    def __iter__(self):
        return self

    def close(self):
        """Stop the worker and wait for it: a daemon worker left making a
        batch could still be in torch's C++ code when the interpreter
        exits, which aborts the process."""
        self._stop.set()
        self.thread.join()


def to_device(device=None):
    """A ``Prefetcher``'s ``to_device`` for ``device`` (default ``cuda``):
    each numpy array of a batch as a tensor there; on a card pinned first
    and copied without blocking (on the worker's stream, the default one,
    which the train step runs on too)."""
    dev = resolve_device(device)

    def move(batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        out = {}
        for k, a in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(a))
            if dev.type == "cuda":
                t = t.pin_memory().to(dev, non_blocking=True)
            out[k] = t
        return out

    return move
