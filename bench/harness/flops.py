"""Model FLOPs of one training step, counted from shapes.

A multiply-add is 2 FLOPs.  The backward pass is counted as twice the
forward's products (the gradients of each product's two operands), so a
step is 3 x the forward.  Counted: every product with a weight (the LM
head included; the embedding lookup is no product), causal attention's
two products up to the diagonal, and the SSD's products within each
chunk up to the diagonal and from the chunks' states.  Not counted:
norms, activations, softmax, the convolution, the recurrence from chunk
to chunk (chunks^2 x heads x head size x state a row), the optimizer,
and anything the program computes again (recomputation is the program's
choice, not the model's work).
"""
from __future__ import annotations


def _weight_macs_per_token(shapes) -> int:
    return sum(a * b for a, b in shapes)


def qwen2_forward(c: dict, batch: int, seq: int,
                  causal_half: bool = True) -> int:
    d, h = c["hidden_size"], c["num_attention_heads"]
    kv, ff = c["num_key_value_heads"], c["intermediate_size"]
    hd = c.get("head_dim", d // h)
    layer = _weight_macs_per_token([(d, h * hd), (d, kv * hd), (d, kv * hd),
                                    (h * hd, d), (d, ff), (d, ff), (ff, d)])
    tokens = batch * seq
    weights = 2 * tokens * (c["num_hidden_layers"] * layer
                            + d * c["padded_vocab_size"])
    # scores and probabilities x values: 2 products of S x S x hd per head
    pairs = seq * (seq + 1) // 2 if causal_half else seq * seq
    attn = 2 * 2 * batch * h * hd * pairs * c["num_hidden_layers"]
    return weights + attn


def mamba2_parts(c: dict, batch: int, seq: int,
                 causal_half: bool = True) -> dict:
    """The forward's weight products and its SSD products, apart.  The
    head has the published rows: the vocabulary rounded up to
    ``pad_vocab_size_multiple`` (rows a program pads beyond them are not
    the model's work)."""
    d = c["d_model"]
    m = c["pad_vocab_size_multiple"]
    rows = -(-c["vocab_size"] // m) * m
    di = c["expand"] * d
    n, p, q = c["d_state"], c["headdim"], c["chunk_size"]
    h = di // p
    layer = _weight_macs_per_token([(d, di), (d, di), (d, n), (d, n), (d, h),
                                    (di, d)])
    tokens = batch * seq
    weights = 2 * tokens * (c["n_layer"] * layer + d * rows)
    # per chunk of q positions: C.B^T (q x q x n) and its weights times X
    # (q x q x h x p) up to the diagonal; the chunk's state B^T X
    # (q x h x p x n); the entering state to the outputs (q x h x p x n)
    pairs = q * (q + 1) // 2 if causal_half else q * q
    chunks = batch * (seq // q)
    ssd = 2 * chunks * (pairs * n + pairs * h * p + 2 * q * h * p * n)
    return {"weights": weights, "ssd": ssd * c["n_layer"]}


def mamba2_forward(c: dict, batch: int, seq: int,
                   causal_half: bool = True) -> int:
    return sum(mamba2_parts(c, batch, seq, causal_half).values())


FORWARD = {"qwen2": qwen2_forward, "mamba2": mamba2_forward}


def train_step_flops(family: str, c: dict, batch: int, seq: int) -> int:
    """Model FLOPs of one forward and backward pass."""
    return 3 * FORWARD[family](c, batch, seq)
