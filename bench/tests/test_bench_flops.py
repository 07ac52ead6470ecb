"""The FLOP counts against hand counts and against
``torch.utils.flop_counter`` on the plain references."""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import tiny
from harness import flops, weights


def test_qwen2_hand_count():
    c = {"hidden_size": 8, "num_attention_heads": 2, "head_dim": 4,
         "num_key_value_heads": 1, "intermediate_size": 16,
         "num_hidden_layers": 1, "padded_vocab_size": 10}
    # per token: q 8x8, k 8x4, v 8x4, o 8x8, mlp 3 x 8x16, head 8x10
    macs = 64 + 32 + 32 + 64 + 3 * 128 + 80
    b, s = 2, 3
    attn = 2 * 2 * b * 2 * 4 * (s * (s + 1) // 2)
    assert flops.qwen2_forward(c, b, s) == 2 * b * s * macs + attn
    assert flops.train_step_flops("qwen2", c, b, s) == 3 * (
        2 * b * s * macs + attn)


def test_mamba2_hand_count():
    c = {"d_model": 4, "expand": 2, "d_state": 2, "headdim": 4,
         "chunk_size": 2, "n_layer": 1, "vocab_size": 5,
         "pad_vocab_size_multiple": 3}
    # d_inner 8, 2 heads; per token: z 4x8, x 4x8, B 4x2, C 4x2, dt 4x2,
    # out 8x4, head 4x6 (5 ids padded to a multiple of 3)
    macs = 32 + 32 + 8 + 8 + 8 + 32 + 24
    b, s = 1, 4
    pairs = 3                     # a chunk of 2 up to its diagonal
    ssd = 2 * 2 * (pairs * 2 + pairs * 2 * 4 + 2 * 2 * 2 * 4 * 2)
    assert flops.mamba2_forward(c, b, s) == 2 * b * s * macs + ssd


def _counted(cell, batch_rows=2):
    ref = cell.reference
    params = weights.make_params(ref.param_specs(cell.config), 3, "cpu",
                                 torch.float32)
    tokens, labels = weights.make_batches(3, 1, batch_rows,
                                          cell.traffic["seq"],
                                          cell.config["vocab_size"], "cpu")[0]
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        ref.loss_sum(params, tokens, labels, cell.config)
    return counter.get_total_flops(), counter.get_flop_counts()


def test_qwen2_matches_the_flop_counter():
    """The counter counts the reference's dense S x S attention: the count
    without the causal half equals it exactly."""
    cell = tiny.tiny_cell(tiny.CONFIGS[0], dtype="float32")
    total, _ = _counted(cell)
    assert total == flops.qwen2_forward(cell.config, 2, cell.traffic["seq"],
                                        causal_half=False)


def test_mamba2_weight_products_match_the_flop_counter():
    """The reference's products with weights (``Numerics.linear``) are the
    count's weight part exactly; the counter's total adds the SSD's dense
    chunk products and the convolution, above the count's SSD part and
    within a few times its dense form."""
    from reference import common
    cell = tiny.tiny_cell(tiny.CONFIGS[1], dtype="float32")
    seq = cell.traffic["seq"]
    macs = []

    def linear(self, eq, x, w):
        out = torch.einsum(eq, x, w)
        macs.append(out.numel() * x.shape[-1])
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(common.Numerics, "linear", linear)
        total, _ = _counted(cell)
    parts = flops.mamba2_parts(cell.config, 2, seq)
    dense = flops.mamba2_parts(cell.config, 2, seq, causal_half=False)
    assert 2 * sum(macs) == parts["weights"]
    assert parts["ssd"] < total - parts["weights"] < 4 * dense["ssd"]
