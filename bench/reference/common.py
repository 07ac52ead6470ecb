"""Plain float32 building blocks shared by the references, and the step
they are trained with.

Nothing here imports the program under test.  The references take their
sizes from a configuration file of ``bench/configs`` and their weights
from ``harness.weights`` (made from the run's seed, as the program's are),
keyed by the parameter names that ``param_specs`` lists.

Layout conventions (the parameter names and shapes the program keeps, so
one set of drawn weights serves both sides): a projection is stored as
(fan_in, ..., fan_out), layer leaves are stacked on a leading layer axis,
and an RMS norm's stored weight ``w`` scales by ``1 + w``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Sequence, Tuple

import torch

FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0


@dataclasses.dataclass(frozen=True)
class Spec:
    """One parameter: name, shape, and how it is drawn: ``("normal",
    scale)`` or ``("const", value)``."""
    name: str
    shape: Tuple[int, ...]
    init: Tuple[str, float]


def normal(shape: Sequence[int], fan_in_axis: int = 0,
           scale: float = None) -> Tuple[str, float]:
    """Normal(0, 1) scaled by 1/sqrt(fan-in), the fan-in being the
    per-layer shape's first axis (or ``scale`` as given)."""
    if scale is None:
        scale = 1.0 / math.sqrt(max(shape[fan_in_axis], 1))
    return ("normal", float(scale))


def _through(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``q`` forward, the gradient as through ``x`` (a rounding)."""
    return x + (q - x).detach()


class Numerics:
    """The precision the reference computes in.  ``fp8=False``: float32
    throughout.  ``fp8=True`` (the control): one precision below what the
    configuration states, wherever the program computes: what it keeps in
    bf16 (both operands of every weight product and the activations it
    stores: ``act``) in float8 e4m3, each tensor with one scale (its
    largest magnitude onto 448), and what it computes in float32 (norms,
    attention scores and probabilities, the SSD's decays, states and
    outputs: ``low``) in bf16."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def act(self, x: torch.Tensor) -> torch.Tensor:
        """A tensor the program keeps in bf16, as the control rounds it."""
        if not self.fp8:
            return x
        scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
        return _through(x, (x / scale).to(FP8).to(torch.float32) * scale)

    def low(self, x: torch.Tensor) -> torch.Tensor:
        """A tensor the program computes in float32, as the control rounds
        it."""
        if not self.fp8:
            return x
        return _through(x, x.to(torch.bfloat16).to(torch.float32))

    def linear(self, eq: str, x: torch.Tensor, w: torch.Tensor):
        return self.act(torch.einsum(eq, self.act(x), self.act(w)))


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * (1.0 + w)


def token_ce_sum(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The sum over tokens of -log softmax(logits)[label]."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return (lse - gold).sum()


@dataclasses.dataclass
class Adam:
    """AdamW with bias correction, decoupled weight decay and clipping by
    the global gradient norm (scale ``min(1, clip / (norm + 1e-12))``)."""
    lr: float
    weight_decay: float
    grad_clip_norm: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8


def train_steps(params: Dict[str, torch.Tensor],
                batches: List[Tuple[torch.Tensor, torch.Tensor]],
                loss_sum: Callable, opt: Adam,
                rows: int = 1) -> dict:
    """``len(batches)`` AdamW steps of float32 ``params`` (updated in
    place) on the token-mean loss.  Each batch's gradient is summed over
    blocks of ``rows`` rows (``loss_sum(params, tokens, labels)`` returns
    the block's summed token loss), so that the activations of one block
    at a time are alive.  Returns each step's loss, each leaf's first
    clipped gradient norm, and each leaf's change after the last step
    (``"delta"``, float32 norms)."""
    p0 = {k: v.detach().clone() for k, v in params.items()}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, first_grad = [], None
    for step, (tokens, labels) in enumerate(batches, start=1):
        n_tok = labels.numel()
        grads = {k: torch.zeros_like(v) for k, v in params.items()}
        total = 0.0
        for r in range(0, tokens.shape[0], rows):
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in params.items()}
            loss = loss_sum(leaves, tokens[r:r + rows],
                            labels[r:r + rows]) / n_tok
            gs = torch.autograd.grad(loss, list(leaves.values()),
                                     allow_unused=True)
            for k, g in zip(leaves, gs):
                if g is not None:
                    grads[k] += g
            total += float(loss.detach())
            del leaves, loss, gs
        losses.append(total)
        gnorm = torch.sqrt(sum(g.pow(2).sum() for g in grads.values()))
        scale = torch.clamp(opt.grad_clip_norm / (gnorm + 1e-12), max=1.0)
        bc1, bc2 = 1 - opt.b1 ** step, 1 - opt.b2 ** step
        with torch.no_grad():
            for k, p in params.items():
                g = grads[k] * scale
                mu[k].mul_(opt.b1).add_((1 - opt.b1) * g)
                nu[k].mul_(opt.b2).add_((1 - opt.b2) * g * g)
                p.sub_(opt.lr * ((mu[k] / bc1) / (torch.sqrt(nu[k] / bc2)
                                                  + opt.eps)
                                 + opt.weight_decay * p))
        if first_grad is None:
            first_grad = {k: float((g * scale).norm())
                          for k, g in grads.items()}
        del grads
    delta = {k: float((params[k] - p0[k]).norm()) for k in params}
    return {"losses": losses, "grad_norms": first_grad,
            "delta_norms": delta}
