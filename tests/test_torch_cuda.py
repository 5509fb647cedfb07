"""CUDA kernels of the PyTorch port against their plain PyTorch twins, on
the card. Skipped without a CUDA device.

This file imports neither JAX nor the JAX package, so it also runs where
JAX is not installed: ``python -m pytest --noconftest -m cuda
tests/test_torch_cuda.py`` (``--noconftest`` skips tests/conftest.py, which
sets JAX up for the rest of the suite).
"""

import numpy as np
import pytest
import torch

from scann_tpu_torch.ops import tree_ah_grouped as tag


def _grouped_inputs(rng, *, packed, q_cap, l_tile, b=64, p=10, t=40, c=16,
                    s_logical=25):
    """Random CSR slab + grouped LUTs laid out as the search path lays them
    out: partition starts 128-aligned, unused groups of size 0, pad
    subspaces with code 0 and zero LUT rows."""
    s_pad = 2 * (((s_logical + 1) // 2 + 7) // 8 * 8) if packed else \
        (s_logical + 31) // 32 * 32
    l_cap = 2 * l_tile
    sizes = rng.integers(1, l_cap + 1, size=t)
    sizes[0] = l_cap
    aligned = np.zeros(t + 1, np.int64)
    aligned[1:] = np.cumsum((sizes + 127) // 128 * 128)
    n_csr = int(aligned[-1]) + l_cap
    codes = rng.integers(0, c, size=(s_pad, n_csr)).astype(np.uint8)
    codes[s_logical:] = 0
    luts = rng.normal(size=(b * p, s_pad, c)).astype(np.float32) * 4
    luts[:, s_logical:] = 0.0
    parts = torch.from_numpy(rng.integers(0, t, size=(b, p)))
    grp_part, slot, ng = tag.group_pairs_by_partition(parts, t, q_cap)
    safe = grp_part.clamp_min(0).numpy()
    grp_off = aligned[:-1][safe].astype(np.int32)
    grp_size = np.where(grp_part.numpy() >= 0, sizes[safe], 0).astype(np.int32)
    pair_of_slot = np.zeros(ng * q_cap, np.int64)
    pair_of_slot[slot.numpy()] = np.arange(b * p)
    if packed:
        codes = (codes[0::2] | (codes[1::2] << 4)).astype(np.uint8)
        luts = np.concatenate([luts[:, 0::2], luts[:, 1::2]], axis=1)
    luts_grouped = luts.reshape(b * p, -1)[pair_of_slot]
    return luts_grouped, codes, grp_off, grp_size, l_cap


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("q_cap,l_tile", [(1, 128), (8, 512), (16, 256),
                                          (32, 128)])
def test_tree_ah_grouped_kernel_matches_twin(packed, q_cap, l_tile):
    """Masked slots equal, every other slot bit-identical: kernel and twin
    add the same bf16 table entries in the same order in float32 and round
    once to bf16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(7 + q_cap + l_tile)
    arrays = _grouped_inputs(rng, packed=packed, q_cap=q_cap, l_tile=l_tile)
    args = [torch.from_numpy(a).cuda() for a in arrays[:4]]
    kw = dict(l_cap=arrays[4], l_tile=l_tile, q_cap=q_cap, packed=packed)
    before = tag.LAUNCHES
    got = tag.tree_ah_grouped_scores(*args, **kw)
    torch.cuda.synchronize()
    assert tag.LAUNCHES == before + 1
    want = tag.tree_ah_grouped_scores_reference(*args, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_tree_ah_grouped_kernel_rejects_wrong_dtype():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(0)
    luts, codes, off, size, l_cap = _grouped_inputs(
        rng, packed=True, q_cap=8, l_tile=128)
    with pytest.raises(ValueError, match="int32"):
        tag.tree_ah_grouped_scores(
            torch.from_numpy(luts).cuda(), torch.from_numpy(codes).cuda(),
            torch.from_numpy(off).long().cuda(), torch.from_numpy(size).cuda(),
            l_cap=l_cap, l_tile=128, q_cap=8, packed=True)
