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


# -- block-min sweep (csrc/block_min_sweep.cu) --------------------------------

def _sweep_inputs(rng, *, n, d, b, r, int8_rows, penalty):
    """Augmented rows and queries as the searcher builds them (squared L2,
    padded tail rows masked), plus an optional allowlist penalty."""
    from scann_tpu_torch.ops import sweep as sw
    from scann_tpu_torch.ops.distances import DistanceMeasure

    db = rng.normal(size=(n, d)).astype(np.float32)
    q = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32))
    n_valid = n - 3 * r // 2
    measure = DistanceMeasure.SQUARED_L2
    if int8_rows:
        aug, scales, sn = sw.build_int8_augmented_db(db, n_valid, measure,
                                                     tile_n=n)
        q_aug = sw._augment_queries_int8(q, measure, scales, sn, aug.shape[1])
        mask_value = 4.0 * sw.INT8_NORM_DIGIT_MAX * sn
    else:
        aug = sw.build_augmented_db(db, n_valid, measure, tile_n=n)
        q_aug = sw._augment_queries(q, measure, aug.shape[1])
        mask_value = 4 * sw.BLOCK_MASK_VALUE
    pen = None
    if penalty:
        pen = sw.build_allow_penalty(rng.random(n_valid) < 0.3, n, r,
                                     mask_value=mask_value).cuda()
    return q_aug.cuda(), aug.cuda(), pen


@pytest.mark.cuda
@pytest.mark.parametrize("form,r,b", [
    ("rowmajor", 8, 40), ("rowmajor", 64, 200), ("rowmajor", 256, 130),
    ("qmajor", 32, 64), ("qmajor", 512, 24),
    ("compact", 64, 150), ("compact", 256, 16),
    ("top2", 2, 40), ("top2", 8, 64), ("top2", 64, 130), ("top2", 512, 16),
])
@pytest.mark.parametrize("int8_rows,penalty", [(False, False), (True, True)])
def test_block_min_sweep_kernel_matches_twin(form, r, b, int8_rows, penalty):
    """Each form of the sweep kernel against its twin on the same inputs:
    values within 1e-5 of the block's sum of term magnitudes (only the
    float32 summation order differs), compact values within 1 bf16 ulp,
    offsets achieving the twin's minimum; one launch counted per call. Most
    offsets are the twin's own; those of padded rows, whose scores near
    2**30 tie in float32, may differ."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from scann_tpu_torch.ops import sweep as sw

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(r * 7 + b)
    n = max(4096, 8 * r)
    q_aug, aug, pen = _sweep_inputs(rng, n=n, d=100, b=b, r=r,
                                    int8_rows=int8_rows, penalty=penalty)
    name = {"rowmajor": "block_min", "qmajor": "block_min_qmajor",
            "compact": "block_min_qmajor_compact", "top2": "block_min2"}[form]
    before = sw.LAUNCHES[name]
    if form == "top2":
        got = sw.block_min2_sweep(q_aug, aug, r=r, penalty=pen)
    elif form == "rowmajor":
        got = sw.block_min_sweep(q_aug, aug, r=r, penalty=pen)
    else:
        got = sw.block_min_sweep_qmajor(q_aug, aug, r=r, penalty=pen,
                                        compact=form == "compact")
    torch.cuda.synchronize()
    assert sw.LAUNCHES[name] == before + 1
    report = sw.check_against_twin(form, got, q_aug, aug, r=r, penalty=pen)
    assert report["checked"] == (n // r) * b * (2 if form == "top2" else 1)
    assert report["loc_equal"] > 0.9


@pytest.mark.cuda
def test_block_min_sweep_kernel_rejects_bad_arguments():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from scann_tpu_torch.ops import sweep as sw

    rng = np.random.default_rng(0)
    q_aug, aug, _ = _sweep_inputs(rng, n=4096, d=100, b=16, r=64,
                                  int8_rows=False, penalty=False)
    with pytest.raises(ValueError, match="bfloat16"):
        sw.block_min_sweep(q_aug.float(), aug, r=64)
    with pytest.raises(ValueError, match="power of two"):
        sw.block_min_sweep(q_aug, aug, r=24)
    with pytest.raises(ValueError, match="r <= 256"):
        sw.block_min_sweep_qmajor(q_aug, aug, r=512, compact=True)
    with pytest.raises(ValueError, match="penalty"):
        sw.block_min_sweep(q_aug, aug, r=64,
                           penalty=torch.zeros(64, 64, device="cuda"))


@pytest.mark.cuda
def test_block_sweep_searcher_on_card():
    """The searcher's default device is the card: its results are exact
    re-ranked distances with recall near 1 against brute force."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from scann_tpu_torch import BlockSweepConfig, BlockSweepSearcher, DenseDataset
    from scann_tpu_torch.ops import sweep as sw

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(5)
    db = rng.normal(size=(20_000, 48)).astype(np.float32)
    q = rng.normal(size=(64, 48)).astype(np.float32)
    s = BlockSweepSearcher(DenseDataset(db), BlockSweepConfig(
        block_r=32, pre_reorder_k=128))
    assert s.device.type == "cuda"
    sw.reset_launches()
    idx, dist = s.search_batched_arrays(q, 10)
    assert sw.LAUNCHES["block_min_qmajor_compact"] == 1
    d2 = ((q[:, None, :] - db[None]) ** 2).sum(-1)
    gt = np.argsort(d2, axis=1)[:, :10]
    recall = np.mean([len(set(a) & set(g)) / 10 for a, g in zip(idx, gt)])
    assert recall >= 0.98
    np.testing.assert_allclose(dist, np.take_along_axis(d2, idx, 1),
                               rtol=1e-4, atol=1e-3)
