"""The decode step under a mesh of several ranks (``build_serve_step(
rules=)``), against the meshless step, on the CPU.

Four gloo ranks (``tests/torch_dist_workers.py decode4``) run reduced
TinyLlama (attention, GQA), Mamba-2 (SSM), whisper (encoder-decoder) and
Moonlight (MoE) at two layers on (2, 2) and (1, 4) meshes: four decode
steps from an empty cache of 8 positions, whose sequence is sharded over
``"model"`` (``kv_cache_axes``: ``kv_seq``), so on (1, 4) the four
positions written fall on two ranks and two ranks hold only masked
positions.  The logits equal the meshless step's, and each rank's local
cache shard its slice of the meshless cache, at the distribution tests'
fp32 tolerance (``_fp32_close``: the sharded softmax sums in another
order).
"""
import os
import sys

import numpy as np
import pytest

from test_torch_distribution import WORKERS, _fp32_close, _run

ARCHS = ("tinyllama-1.1b", "mamba2-780m", "whisper-base",
         "moonshot-v1-16b-a3b")
MESHES = ("2x2", "1x4")


@pytest.fixture(scope="module")
def decoded(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("decode"))
    # unloaded: about 20 s
    _run([sys.executable, WORKERS, "decode4", "4", d], 600)

    def load(rank):
        with np.load(os.path.join(d, f"sharded_decode_r{rank}.npz")) as z:
            return {k: z[k] for k in z.files}
    return [load(r) for r in range(4)]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_decode_logits(decoded, arch, mesh):
    tag = f"{arch}:{mesh}"
    for res in decoded:
        got, want = res[tag + ":logits"], res[tag + ":want"]
        assert got.shape == want.shape and got.shape[0] == 4
        assert np.isfinite(got).all()
        _fp32_close(got, want)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_decode_cache_shards(decoded, arch, mesh):
    """Each rank's local shard of each cache leaf is its slice of the
    meshless cache; attention leaves are sharded on the sequence over the
    model axis, and together the ranks' K slices hold every written
    position."""
    tag = f"{arch}:{mesh}"
    n_model = int(mesh.split("x")[1])
    written = {}
    for res in decoded:
        leaves = sorted(k[len(tag) + 3:] for k in res
                        if k.startswith(tag + ":c:"))
        assert leaves
        for leaf in leaves:
            local = res[f"{tag}:c:{leaf}"]
            off = tuple(res[f"{tag}:o:{leaf}"])
            whole = res[f"{tag}:w:{leaf}"]
            part = whole[tuple(slice(o, o + n) for o, n in
                               zip(off, local.shape))]
            assert part.shape == local.shape, leaf
            _fp32_close(local, part, err_msg=leaf)
            if leaf.endswith("['k']"):
                seq = local.ndim - 3
                assert local.shape[seq] * n_model == whole.shape[seq], leaf
                assert "Shard(dim=%d)" % seq in str(res[f"{tag}:p:{leaf}"])
                rows = np.abs(local).reshape(-1, *local.shape[seq:]).max(
                    axis=(0, 2, 3))
                for i, used in enumerate(rows > 0):
                    if used:
                        written.setdefault(leaf, set()).add(off[seq] + i)
    for leaf, pos in written.items():
        assert pos == {0, 1, 2, 3}, leaf
