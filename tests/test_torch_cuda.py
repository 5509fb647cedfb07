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

from scann_tpu_torch.ops import grouped_luts as gl
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
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("q_cap,l_tile,s_logical", [
    (1, 128, 25), (8, 512, 50), (16, 256, 50), (32, 128, 7)])
def test_tree_ah_grouped_int8_kernel_matches_twin(packed, q_cap, l_tile,
                                                  s_logical):
    """The int8-LUT branch (#1b): int16 sums equal bit for bit (integer
    sums are exact), masked slots I16_MASK, one launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(11 + q_cap + l_tile + s_logical)
    luts, codes, off, size, l_cap = _grouped_inputs(
        rng, packed=packed, q_cap=q_cap, l_tile=l_tile, s_logical=s_logical)
    luts_i8 = np.clip(np.round(luts * 8), -128, 127).astype(np.int8)
    args = [torch.from_numpy(a).cuda() for a in (luts_i8, codes, off, size)]
    kw = dict(l_cap=l_cap, l_tile=l_tile, q_cap=q_cap, packed=packed)
    before = tag.LAUNCHES
    got = tag.tree_ah_grouped_scores(*args, **kw)
    torch.cuda.synchronize()
    assert tag.LAUNCHES == before + 1
    want = tag.tree_ah_grouped_scores_reference(*args, **kw)
    assert got.dtype == torch.int16 and got.shape == want.shape
    assert torch.equal(got, want)
    assert bool((want == tag.I16_MASK).any())


# Group layouts past the search path's; "full" is l_cap, a pair is the
# (bf16, int8) value. Offsets and N_csr that are not multiples of 16 reach
# the ring's shifted copies; "C=256" takes the largest q_cap whose tables
# fit; "small ring" leaves room for two 2-row (bf16) or 8-row stages;
# "odd table width" (S_pad * C = 91) stages the tables one entry at a
# time; at "tables at the limit" (bf16 2*1*512*227 = 232,448 bytes, int8
# 8*113*256 = 231,424) no ring fits and codes come from global memory;
# "S_pad 768" is the 1536-d deployment's (768 subspaces of 16 codes) at the
# q_cap fit_q_cap takes for the rule's 16 (8: 213,520 bytes a block, 24
# ring stages of 16 packed rows a tile); int16 sums bound int8 tables to
# S_pad 128, so its int8 pair is the widest they take, at q_cap 16.
GROUPED_LAYOUTS = {
    "one group fills l_cap": dict(
        q_cap=8, s_pad=64, c=16, packed=True, l_cap=6144, l_tile=512,
        sizes=["full", 0, 0, 0, 0], offsets=[0] * 5, n_csr=6656),
    "offsets, N_csr not x16": dict(
        q_cap=8, s_pad=64, c=16, packed=True, l_cap=1024, l_tile=256,
        sizes=[1000, 17, 1024, 0, 333], offsets=[3, 1021, 7, 5, 1500],
        n_csr=2061),
    "unpacked, offsets not x16": dict(
        q_cap=4, s_pad=32, c=16, packed=False, l_cap=768, l_tile=256,
        sizes=[700, 1, 768], offsets=[9, 715, 1201], n_csr=1979),
    "q_cap 16, ranges": dict(
        q_cap=16, s_pad=64, c=16, packed=True, l_cap=2560, l_tile=512,
        sizes=["full", 1029, 0, 2000], offsets=[5, 2571, 11, 3611],
        n_csr=5613),
    "q_cap 32, ranges": dict(
        q_cap=32, s_pad=64, c=16, packed=True, l_cap=1536, l_tile=128,
        sizes=[1535, "full", 3], offsets=[1, 1549, 3090], n_csr=3101),
    "sizes 1 and full": dict(
        q_cap=8, s_pad=64, c=16, packed=True, l_cap=2048, l_tile=512,
        sizes=[1, "full", 1, "full", 0, 1],
        offsets=[0, 7, 2061, 2070, 0, 4118], n_csr=4119),
    "l_cap not x4": dict(
        q_cap=8, s_pad=16, c=16, packed=True, l_cap=150, l_tile=75,
        sizes=[150, 149, 2, 0], offsets=[0, 151, 303, 0], n_csr=313),
    "packed, C=8": dict(  # not the instance with C fixed at 16
        q_cap=8, s_pad=32, c=8, packed=True, l_cap=512, l_tile=256,
        sizes=[300, 512, 7], offsets=[0, 301, 820], n_csr=900),
    "C=256 unpacked, largest q_cap": dict(
        q_cap=(8, 16), s_pad=32, c=256, packed=False, l_cap=512,
        l_tile=128, sizes=[512, 300, 0, 1], offsets=[0, 520, 7, 1000],
        n_csr=1100),
    "small ring": dict(
        q_cap=(8, 32), s_pad=(56, 28), c=256, packed=False, l_cap=640,
        l_tile=128, sizes=[640, 77], offsets=[1, 645], n_csr=723),
    "odd table width": dict(
        q_cap=(8, 16), s_pad=13, c=7, packed=False, l_cap=256, l_tile=128,
        sizes=[200, 256, 0], offsets=[0, 201, 5], n_csr=460),
    "tables at the limit": dict(
        q_cap=(1, 8), s_pad=(512, 113), c=(227, 256), packed=False,
        l_cap=256, l_tile=128, sizes=[256, 5, 0], offsets=[3, 261, 0],
        n_csr=270),
    "S_pad 768": dict(
        q_cap=(8, 16), s_pad=(768, 128), c=16, packed=True, l_cap=1024,
        l_tile=512, sizes=["full", 1000, 0, 513, 1, "full", 77, 640],
        offsets=[0, 1024, 0, 2048, 2688, 2816, 3840, 3968], n_csr=4992),
}


def _grouped_case(name, int8):
    """(tables, codes, offsets, sizes) and the scorer's keywords of one
    GROUPED_LAYOUTS case: random codes (columns outside every group too),
    normal bf16 or uniform int8 tables."""
    kw = {k: v[int8] if isinstance(v, tuple) else v
          for k, v in GROUPED_LAYOUTS[name].items()}
    q_cap, s_pad, c, packed, l_cap = (kw[k] for k in (
        "q_cap", "s_pad", "c", "packed", "l_cap"))
    rng = np.random.default_rng(len(name) + int8)
    sizes = np.array([l_cap if v == "full" else v for v in kw["sizes"]],
                     np.int32)
    offsets = np.array(kw["offsets"], np.int32)
    assert (offsets + sizes <= kw["n_csr"]).all()
    rows = s_pad // 2 if packed else s_pad
    codes = rng.integers(0, 256 if packed else c, size=(rows, kw["n_csr"]),
                         dtype=np.uint8)
    if packed and c < 16:
        codes &= (c - 1) * 0x11
    shape = (len(sizes) * q_cap, s_pad * c)
    if int8:
        luts = rng.integers(-128, 128, size=shape).astype(np.int8)
    else:
        luts = (rng.normal(size=shape) * 4).astype(np.float32)
    return (luts, codes, offsets, sizes), dict(
        l_cap=l_cap, l_tile=kw["l_tile"], q_cap=q_cap, packed=packed)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("name", list(GROUPED_LAYOUTS))
def test_tree_ah_grouped_kernel_layouts(name, int8):
    """#1 and #1b on group layouts the search path rarely makes: bit for bit
    with the twin (torch.equal), one launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    arrays, kw = _grouped_case(name, int8)
    args = [torch.from_numpy(a).cuda() for a in arrays]
    before = tag.LAUNCHES
    got = tag.tree_ah_grouped_scores(*args, **kw)
    torch.cuda.synchronize()
    assert tag.LAUNCHES == before + 1
    want = tag.tree_ah_grouped_scores_reference(*args, **kw)
    assert got.dtype == (torch.int16 if int8 else torch.bfloat16)
    assert torch.equal(got, want)


def _leaf_inputs(rng, *, b, p, s, s_pad, c, l_cap, t=30, aligned=False):
    """CSR codes [S_pad, N_csr] (pad subspaces code 0), per-pair float32
    tables [B, p, S, C], offsets (128-aligned or not) and sizes <= l_cap of
    the pairs' partitions."""
    sizes_t = rng.integers(0, l_cap + 1, size=t)
    sizes_t[0] = l_cap
    starts = np.zeros(t + 1, np.int64)
    gaps = (sizes_t + 127) // 128 * 128 if aligned else sizes_t + \
        rng.integers(0, 5, size=t)
    starts[1:] = np.cumsum(gaps)
    n_csr = int(starts[-1]) + l_cap
    codes = rng.integers(0, c, size=(s_pad, n_csr)).astype(np.uint8)
    codes[s:] = 0
    parts = rng.integers(0, t, size=(b, p))
    luts = (rng.normal(size=(b, p, s, c)) * 3).astype(np.float32)
    return (luts, codes, starts[:-1][parts].astype(np.int32),
            sizes_t[parts].astype(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("b,p,s,s_pad,c,l_cap,aligned", [
    (1024, 30, 50, 64, 16, 2048, True),    # the per-pair path's shapes
    (7, 3, 8, 32, 16, 300, False),         # l_cap not a multiple of the tile
    (16, 4, 13, 13, 256, 512, False),      # C=256, S_pad = S
    (3, 2, 4, 32, 16, 64, True),
])
def test_tree_ah_leaf_kernel_matches_twin(b, p, s, s_pad, c, l_cap, aligned):
    """#10: float32 sums in ascending s on both sides, so every slot is
    bit-identical; masked slots MASKED_DISTANCE; one launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from scann_tpu_torch.ops import tree_ah_leaf as tal
    from scann_tpu_torch.types import MASKED_DISTANCE

    rng = np.random.default_rng(b + p + s + l_cap)
    arrays = _leaf_inputs(rng, b=b, p=p, s=s, s_pad=s_pad, c=c, l_cap=l_cap,
                          aligned=aligned)
    args = [torch.from_numpy(a).cuda() for a in arrays]
    before = tal.LAUNCHES
    got = tal.tree_ah_leaf_scores(*args, l_cap=l_cap)
    torch.cuda.synchronize()
    assert tal.LAUNCHES == before + 1
    want = tal.tree_ah_leaf_scores_reference(*args, l_cap=l_cap)
    assert got.dtype == torch.float32 and got.shape == (b, p, l_cap)
    assert torch.equal(got, want)
    masked = want >= MASKED_DISTANCE / 2
    sizes = args[3].long()[:, :, None]
    assert torch.equal(masked, torch.arange(l_cap, device="cuda") >= sizes)


def _schedule_case(name):
    """Inputs that steer #10's partition-order schedule: (luts, codes,
    offsets, sizes) as numpy arrays, l_cap, and the pairs per block Q the
    wrapper must pick."""
    rng = np.random.default_rng(len(name))
    if name == "one partition":      # every pair probes partition 0
        b, p, l_cap, s, s_pad, c = 24, 4, 700, 8, 32, 16
        sizes_t = np.array([650, 700, 12])
        parts = np.zeros((b, p), int)
    elif name == "run straddles a chunk":   # sorted runs 3, 11, 3, 4, 1, 1, 1
        b, p, l_cap, s, s_pad, c = 6, 4, 700, 8, 32, 16
        sizes_t = rng.integers(300, 701, size=10)
        parts = np.array([[0, 0, 0, 1], [1, 1, 1, 1], [1, 1, 1, 1],
                          [1, 1, 2, 2], [3, 3, 3, 3], [2, 4, 5, 6]])
    elif name == "distinct partitions":     # density below 1
        b, p, l_cap, s, s_pad, c = 12, 4, 200, 10, 16, 16
        sizes_t = rng.integers(1, 201, size=200)
        parts = rng.permutation(200)[:b * p].reshape(b, p)
    elif name == "sizes 0 and l_cap":       # empty partitions share offsets
        b, p, l_cap, s, s_pad, c = 9, 5, 300, 9, 50, 16
        sizes_t = np.array([0, 300, 0, 0, 300, 17, 0, 299, 1, 300])
        parts = rng.integers(0, len(sizes_t), size=(b, p))
    elif name == "C=256":                   # Q < 8
        b, p, l_cap, s, s_pad, c = 12, 3, 600, 13, 13, 256
        sizes_t = rng.integers(100, 601, size=4)
        parts = rng.integers(0, 4, size=(b, p))
    else:                                   # "C=9": 4-byte table copies
        b, p, l_cap, s, s_pad, c = 10, 3, 130, 6, 7, 9
        sizes_t = rng.integers(0, 131, size=5)
        parts = rng.integers(0, 5, size=(b, p))
    starts = np.zeros(len(sizes_t) + 1, np.int64)
    starts[1:] = np.cumsum(sizes_t + rng.integers(0, 3, size=len(sizes_t)))
    n_csr = int(starts[-1]) + l_cap
    codes = rng.integers(0, c, size=(s_pad, n_csr)).astype(np.uint8)
    codes[s:] = 0
    luts = (rng.normal(size=(b, p, s, c)) * 3).astype(np.float32)
    arrays = (luts, codes, starts[:-1][parts].astype(np.int32),
              sizes_t[parts].astype(np.int32))
    return arrays, l_cap, 3 if c == 256 else 8


@pytest.mark.cuda
@pytest.mark.parametrize("name", [
    "one partition", "run straddles a chunk", "distinct partitions",
    "sizes 0 and l_cap", "C=256", "C=9"])
def test_tree_ah_leaf_schedule_matches_twin(name):
    """#10's partition-order schedule at its edges: one partition for every
    pair, a run of equal offsets across a chunk boundary, a different
    partition for every pair, sizes 0 and l_cap, C=256 tables that leave
    room for Q=3 a block, and C=9 tables (neither width the kernel
    specialises, copied 4 bytes at a time). Bit for bit against the twin,
    one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from scann_tpu_torch.ops import tree_ah_leaf as tal

    arrays, l_cap, q = _schedule_case(name)
    args = [torch.from_numpy(a).cuda() for a in arrays]
    assert tal.pairs_per_block(arrays[1].shape[0], arrays[0].shape[3]) == q
    before = tal.LAUNCHES
    got = tal.tree_ah_leaf_scores(*args, l_cap=l_cap)
    torch.cuda.synchronize()
    assert tal.LAUNCHES == before + 1
    want = tal.tree_ah_leaf_scores_reference(*args, l_cap=l_cap)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_tree_ah_leaf_kernel_rejects_bad_arguments():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from scann_tpu_torch.ops import tree_ah_leaf as tal

    rng = np.random.default_rng(0)
    args = [torch.from_numpy(a).cuda() for a in _leaf_inputs(
        rng, b=2, p=2, s=8, s_pad=32, c=16, l_cap=128)]
    before = tal.LAUNCHES
    with pytest.raises(ValueError, match="int32"):
        tal.tree_ah_leaf_scores(args[0], args[1], args[2].long(), args[3],
                                l_cap=128)
    with pytest.raises(ValueError, match="float32"):
        tal.tree_ah_leaf_scores(args[0].double(), *args[1:], l_cap=128)
    with pytest.raises(ValueError, match="is on"):
        tal.tree_ah_leaf_scores(args[0], args[1].cpu(), *args[2:], l_cap=128)
    assert tal.LAUNCHES == before


@pytest.mark.cuda
def test_tree_ah_searcher_variants_on_card():
    """A balanced SOAR index built on the card: the searcher (#1), the
    int8-LUT path (#1b) and the per-pair path (#10) launch their kernels
    and agree with the same index served on the CPU; restricts return only
    allowed ids."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from scann_tpu_torch import (AsymmetricHasherConfig, DenseDataset,
                                 SearchParameters, TreeXHybridConfig,
                                 TreeXHybridSearcher)
    from scann_tpu_torch.models import tree_x_hybrid as tx
    from scann_tpu_torch.ops import tree_ah_leaf as tal

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(3)
    cent = rng.normal(size=(40, 32)).astype(np.float32) * 3
    db = (cent[rng.integers(0, 40, 20_000)]
          + rng.normal(size=(20_000, 32))).astype(np.float32)
    q = (cent[rng.integers(0, 40, 64)]
         + rng.normal(size=(64, 32))).astype(np.float32)
    s = TreeXHybridSearcher(TreeXHybridConfig(
        num_partitions=64, partitions_to_search=8, spilling=True,
        spilling_mode="soar", hash_config=AsymmetricHasherConfig(
            num_codes=16, num_subspaces=16, seed=0, max_iterations=8,
            training_sample_size=10_000))).build(DenseDataset(db))
    assert s.partitioner.tokenization.max_multiplicity == 2
    d2 = ((q[:, None, :] - db[None]) ** 2).sum(-1)
    gt = np.argsort(d2, axis=1)[:, :10]
    params = SearchParameters(pre_reordering_num_neighbors=100)
    before, staged = tag.LAUNCHES, gl.LAUNCHES
    idx, dist = s.search_batched_arrays(q, 10, params)
    assert tag.LAUNCHES == before + 1
    assert gl.LAUNCHES == staged + 1
    recall = np.mean([len(set(a) & set(g)) / 10 for a, g in zip(idx, gt)])
    assert recall >= 0.9
    np.testing.assert_allclose(dist, np.take_along_axis(d2, idx, 1),
                               rtol=1e-4, atol=1e-3)
    idx_m, _ = s.search_batched_arrays(q, 10, params,
                                       allow_mask=np.arange(20_000) % 2 == 0)
    assert ((idx_m % 2 == 0) | (idx_m < 0)).all()
    qt = torch.from_numpy(q).cuda()
    common = dict(p=8, pre_k=100, k=10, use_residuals=True)
    db_dev = s._device_state()
    codes, off, sizes, perm, l_cap = s._csr_state()
    before, staged = tag.LAUNCHES, gl.LAUNCHES
    _, i8 = tx.tree_ah_search_grouped(
        db_dev, s.partitioner.centers, codes, off, sizes, perm,
        s.codebook.centroids, qt, float("inf"), float("inf"), l_cap=l_cap,
        q_cap=8, l_tile=512, packed=True, multiplicity=2, int8_luts=True,
        **common)
    assert tag.LAUNCHES == before + 1
    assert gl.LAUNCHES == staged      # int8 tables keep the gather
    codes_u, off, sizes, perm, l_cap = s._csr_state(packed=False)
    before = tal.LAUNCHES
    _, ip = tx.tree_ah_search(
        db_dev, s.partitioner.centers, codes_u, off, sizes, perm,
        s.codebook.centroids, qt, float("inf"), float("inf"), l_cap=l_cap,
        multiplicity=2, **common)
    assert tal.LAUNCHES == before + 1
    for got in (i8, ip):
        got = got.cpu().numpy()
        assert np.mean([len(set(a) & set(g)) / 10
                        for a, g in zip(got, gt)]) >= 0.9


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


# -- grouped tables (csrc/grouped_luts.cu) ------------------------------------

# (B, p, S, S_pad, C, partitions, q_cap, per-query source, bias, packed,
# tables offset by one float): the benchmark cells' shapes (dbpedia's 768
# subspaces at q_cap 8 over 2,560 partitions, glove's 50 padded to 64 at
# q_cap 16, sift's per-pair squared-L2 source) and layouts past them: rows
# of S_pad * C not a multiple of 8 (2-byte stores), C not a multiple of 8
# or tables off 16 bytes (per-element loads), unpacked rows, q_cap 1
STAGE_CASES = {
    "dbpedia": (1024, 100, 768, 768, 16, 2560, 8, True, True, True, False),
    "glove": (1024, 100, 50, 64, 16, 2000, 16, True, True, True, False),
    "sift per pair": (1024, 100, 64, 64, 16, 2000, 16, False, False, True,
                      False),
    "odd rows": (37, 7, 5, 6, 3, 50, 4, True, True, False, False),
    "odd rows per pair": (37, 7, 5, 6, 3, 50, 4, False, False, True, False),
    "tables off 16 bytes": (64, 10, 30, 32, 16, 100, 8, False, False, True,
                            True),
    "unpacked q_cap 1": (64, 10, 25, 32, 16, 40, 1, True, True, False,
                         False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(STAGE_CASES))
def test_grouped_luts_kernel_matches_twin(name):
    """Every row bit-identical to the twin (the composition the kernel
    replaced; unused rows zero) over ragged groups (partitions drawn by a
    Zipf-like popularity), one launch and every row counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    b, p, s, s_pad, c, k, q_cap, per_query, bias, packed, offset = \
        STAGE_CASES[name]
    gen = torch.Generator(device="cuda").manual_seed(len(name))
    weight = torch.arange(1, k + 1, device="cuda").float() ** -0.7
    parts = torch.multinomial(weight.expand(b, k), p, generator=gen)
    _, slot, ng = tag.group_pairs_by_partition(parts, k, q_cap)
    rows = ng * q_cap
    n = b if per_query else b * p
    flat = torch.randn(n * s * c + 1, generator=gen, device="cuda") * 0.05
    tables = flat[int(offset):int(offset) + n * s * c].view(n, s, c)
    src = gl.LutSource(tables, torch.randn(b, p, generator=gen,
                                           device="cuda") if bias else None,
                       per_query)
    kw = dict(p=p, s_pad=s_pad, rows=rows, packed=packed)
    launches, staged = gl.LAUNCHES, gl.STAGED_ROWS
    got = gl.grouped_luts(src, slot, **kw)
    torch.cuda.synchronize()
    assert gl.LAUNCHES == launches + 1
    assert gl.STAGED_ROWS == staged + rows
    want = gl.grouped_luts_reference(src, slot, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    used = torch.zeros(rows, dtype=torch.bool, device="cuda")
    used[slot] = True
    assert not bool(used.all())


@pytest.mark.cuda
@pytest.mark.parametrize("measure", ["DOT_PRODUCT", "SQUARED_L2"])
def test_grouped_leaf_scores_same_from_source_on_card(measure):
    """On the card the grouped leaf scores fed the source and fed the flat
    expansion (both through the kernel) equal, bit for bit, #1's scores
    over the composition's rows (bf16 cast, even-first `cat`, gather)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from scann_tpu_torch.models import tree_x_hybrid as tx
    from scann_tpu_torch.ops.distances import DistanceMeasure

    gen = torch.Generator(device="cuda").manual_seed(5)
    b, p, k, s, s_pad, c, l_tile, q_cap = 128, 10, 60, 50, 64, 16, 256, 8
    l_cap = 2 * l_tile

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    sizes = torch.randint(1, l_cap + 1, (k,), generator=gen, device="cuda")
    aligned = (sizes + 127) // 128 * 128
    offsets = (torch.cumsum(aligned, 0) - aligned).int()
    codes = torch.randint(0, 256, (s_pad // 2, int(aligned.sum()) + l_cap),
                          generator=gen, device="cuda", dtype=torch.uint8)
    q, cent, cb = randn(b, 2 * s), randn(k, 2 * s), randn(s, c, 2)
    kw = dict(use_residuals=True, measure=DistanceMeasure[measure])
    parts = tx._select_partitions(cent, q, p=p, measure=kw["measure"])
    src = tx._lut_source(q, cent, parts, cb, **kw)
    flat = tx._residual_luts(q, cent, parts, cb, s_pad=s_pad, **kw)
    skw = dict(p=p, l_cap=l_cap, q_cap=q_cap, l_tile=l_tile, packed=True)
    launches = gl.LAUNCHES
    got = [tx.leaf_scores_grouped(x, parts, codes, offsets, sizes.int(),
                                  **skw).view(torch.int16)
           for x in (src, flat)]
    assert gl.LAUNCHES == launches + 2
    grp_part, slot, ng = tag.group_pairs_by_partition(parts, k, q_cap)
    pair_of_slot = torch.zeros(ng * q_cap, dtype=torch.long, device="cuda")
    pair_of_slot[slot] = torch.arange(b * p, device="cuda")
    composed = gl.even_first(flat.bfloat16(), s_pad)[pair_of_slot]
    safe = grp_part.clamp_min(0)
    scores = tag.tree_ah_grouped_scores(
        composed, codes, offsets[safe],
        torch.where(grp_part >= 0, sizes[safe], 0).int(), l_cap=l_cap,
        l_tile=l_tile, q_cap=q_cap, packed=True)
    want = tx._leaf_major(scores, slot, b=b, p=p, l_cap=l_cap)
    assert torch.equal(got[0], got[1])
    assert torch.equal(got[0], want.view(torch.int16))


@pytest.mark.cuda
def test_grouped_luts_kernel_rejects_bad_arguments():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    src = gl.LutSource(torch.randn(4, 8, 16, device="cuda"),
                       torch.randn(4, 3, device="cuda"), True)
    slot = torch.arange(12, device="cuda")
    with pytest.raises(ValueError, match="S_pad"):
        gl.grouped_luts(src, slot, p=3, s_pad=4, rows=12, packed=True)
    with pytest.raises(ValueError, match="on cpu"):
        gl.grouped_luts(src, slot.cpu(), p=3, s_pad=8, rows=12, packed=True)
    per_pair = gl.LutSource(torch.randn(12, 8, 16, device="cuda"),
                            torch.randn(4, 3, device="cuda"), False)
    with pytest.raises(ValueError, match="per-query"):
        gl.grouped_luts(per_pair, slot, p=3, s_pad=8, rows=12, packed=True)


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
@pytest.mark.parametrize("n,d,b,r,penalty,int8_rows,kernel", [
    # the wgmma kernel (csrc/block_min_compact.cu): r, B, a ragged last
    # tile, D1 = 8 / 104 / 136, the penalty, r = 256 across two tiles
    (4096, 100, 64, 8, False, False, "block_min_compact"),
    (4096, 100, 64, 16, True, False, "block_min_compact"),
    (4096, 100, 64, 32, False, False, "block_min_compact"),
    (4096, 100, 64, 128, True, False, "block_min_compact"),
    (8192, 100, 200, 256, True, False, "block_min_compact"),
    (4096, 100, 1, 64, False, False, "block_min_compact"),
    (4096, 100, 64, 64, True, False, "block_min_compact"),
    (8192, 100, 1000, 64, False, False, "block_min_compact"),
    (4096 + 64, 100, 150, 64, True, False, "block_min_compact"),
    (4096 + 8, 7, 70, 8, False, False, "block_min_compact"),
    (4096, 130, 130, 32, True, False, "block_min_compact"),
    # runs stored in 16-byte pieces; the second's last run is one tile
    (131072 + 1024, 100, 256, 64, False, False, "block_min_compact"),
    (131072 + 128, 100, 300, 8, True, False, "block_min_compact"),
    # the mma.sync kernel (csrc/block_min_sweep.cu): int8 rows, r < 8,
    # rows wider than 256
    (4096, 100, 64, 64, True, True, "block_min_sweep"),
    (4096, 100, 64, 4, False, False, "block_min_sweep"),
    (4096, 260, 64, 64, True, False, "block_min_sweep"),
])
def test_block_min_compact_kernel_matches_twin(n, d, b, r, penalty, int8_rows,
                                               kernel):
    """Each compact call against its twin through check_against_twin
    ("compact"): values within 1 bf16 ulp (or the float32 tolerance near 0),
    offsets reaching the twin's minimum; one launch of the kernel that
    compact_plan names, one block_min_qmajor_compact launch either way."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from scann_tpu_torch.ops import sweep as sw

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(n + d + b + r)
    q_aug, aug, pen = _sweep_inputs(rng, n=n, d=d, b=b, r=r,
                                    int8_rows=int8_rows, penalty=penalty)
    plan = sw.compact_plan(n, b, aug.shape[1], r, int8_rows)
    assert (plan is not None) == (kernel == "block_min_compact")
    sw.reset_launches()
    got = sw.block_min_sweep_qmajor(q_aug, aug, r=r, penalty=pen,
                                    compact=True)
    torch.cuda.synchronize()
    assert sw.LAUNCHES["block_min_qmajor_compact"] == 1
    assert sw.COMPACT_LAUNCHES[kernel] == 1
    assert sum(sw.COMPACT_LAUNCHES.values()) == 1
    assert got[0].shape == (b, n // r) and got[1].dtype == torch.uint8
    report = sw.check_against_twin("compact", got, q_aug, aug, r=r,
                                   penalty=pen)
    assert report["checked"] == (n // r) * b
    assert report["loc_equal"] > 0.9


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["rowmajor", "top2"])
@pytest.mark.parametrize("n,d,b,r,penalty,int8_rows,kernel", [
    # the wgmma kernel (csrc/block_min_compact.cu): each r, B not a
    # multiple of 128, a ragged last tile, D1 = 8 / 104 / 136, the penalty,
    # r = 256 across two tiles
    (4096, 100, 70, 8, False, False, "block_min_compact"),
    (4096 + 8, 7, 300, 8, True, False, "block_min_compact"),
    (4096, 100, 130, 16, True, False, "block_min_compact"),
    (4096 + 32, 100, 200, 32, False, False, "block_min_compact"),
    (4096, 100, 512, 64, False, False, "block_min_compact"),
    (4096 + 64, 100, 600, 64, True, False, "block_min_compact"),
    (8192, 130, 1, 128, True, False, "block_min_compact"),
    (8192, 100, 1024, 128, False, False, "block_min_compact"),
    (8192, 100, 200, 256, True, False, "block_min_compact"),
    (8192, 100, 64, 256, False, False, "block_min_compact"),
    # the mma.sync kernel (csrc/block_min_sweep.cu): int8 rows, r < 8
    (4096, 100, 64, 64, True, True, "block_min_sweep"),
    (4096, 100, 64, 4, False, False, "block_min_sweep"),
])
def test_block_min_rowmajor_kernels_match_twin(form, n, d, b, r, penalty,
                                               int8_rows, kernel):
    """#3 and #6 through their wrappers against their twins with
    check_against_twin: values within 1e-5 * sum|terms| + 1e-5, offsets
    reaching the twin's; one launch of the kernel that sweep_plan names."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from scann_tpu_torch.ops import sweep as sw

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(n + d + b + r + len(form))
    q_aug, aug, pen = _sweep_inputs(rng, n=n, d=d, b=b, r=r,
                                    int8_rows=int8_rows, penalty=penalty)
    plan = sw.sweep_plan(form, n, b, aug.shape[1], r, int8_rows)
    assert (plan is not None) == (kernel == "block_min_compact")
    name = "block_min2" if form == "top2" else "block_min"
    sw.reset_launches()
    fn = sw.block_min2_sweep if form == "top2" else sw.block_min_sweep
    got = fn(q_aug, aug, r=r, penalty=pen)
    torch.cuda.synchronize()
    assert sw.LAUNCHES[name] == 1 and sum(sw.LAUNCHES.values()) == 1
    assert sw.LAUNCHES_BY_KERNEL[name][kernel] == 1
    assert sum(sw.LAUNCHES_BY_KERNEL[name].values()) == 1
    assert [tuple(t.shape) for t in got] == [(n // r, b)] * len(got)
    report = sw.check_against_twin(form, got, q_aug, aug, r=r, penalty=pen)
    assert report["checked"] == (n // r) * b * (2 if form == "top2" else 1)
    assert report["loc_equal"] > 0.9


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["rowmajor", "top2", "compact"])
@pytest.mark.parametrize("r,b", [(8, 130), (16, 64), (64, 512), (128, 200),
                                 (256, 70)])
@pytest.mark.parametrize("penalty", [False, True])
def test_block_min_kernels_break_ties_as_the_twin(form, r, b, penalty):
    """Integer-valued bf16 rows and queries (|v| <= 8) and a penalty of 0
    or 256: every float32 sum is exact in any order, so the new kernel's
    values and offsets equal the twin's bit for bit, the tournament's tie
    order included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from scann_tpu_torch.ops import sweep as sw

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(r + b + 3 * penalty)
    n, d1 = 8192 + (0 if r > 64 else r), 104
    rows = torch.from_numpy(rng.integers(-8, 9, size=(n, d1)).astype(
        np.float32)).to(torch.bfloat16).cuda()
    rows[0:n - 1:5] = rows[1::5]    # repeated rows: ties inside blocks
    q = torch.from_numpy(rng.integers(-8, 9, size=(b, d1)).astype(
        np.float32)).to(torch.bfloat16).cuda()
    pen = None
    if penalty:
        pen = torch.from_numpy(np.where(rng.random((n // r, r)) < 0.3, 256.0,
                                        0.0).astype(np.float32)).to(
            torch.bfloat16).cuda()
    assert sw.sweep_plan(form, n, b, d1, r, False) is not None
    sw.reset_launches()
    if form == "top2":
        got = sw.block_min2_sweep(q, rows, r=r, penalty=pen)
        want = sw.block_min2_sweep_reference(q, rows, r=r, penalty=pen)
        name = "block_min2"
    elif form == "rowmajor":
        got = sw.block_min_sweep(q, rows, r=r, penalty=pen)
        want = sw.block_min_sweep_reference(q, rows, r=r, penalty=pen)
        name = "block_min"
    else:
        got = sw.block_min_sweep_qmajor(q, rows, r=r, penalty=pen,
                                        compact=True)
        want = sw.block_min_sweep_qmajor_reference(q, rows, r=r, penalty=pen,
                                                   compact=True)
        name = "block_min_qmajor_compact"
    torch.cuda.synchronize()
    assert sw.LAUNCHES_BY_KERNEL[name] == {"block_min_compact": 1,
                                           "block_min_sweep": 0}
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert torch.equal(g, w)
    if form == "top2":      # the tie rule is exercised
        assert bool((got[2] == got[0]).any())


@pytest.mark.cuda
@pytest.mark.parametrize("r", [8, 256, 512])
@pytest.mark.parametrize("b", [24, 128, 300])
@pytest.mark.parametrize("penalty", [False, True])
def test_block_min_qmajor_kernel_matches_twin(r, b, penalty):
    """#4 on the q-major form of block_min_compact.cu against its twin
    through check_against_twin("qmajor"): float32 values within 1e-5 *
    sum|terms| + 1e-5, offsets reaching the twin's minimum; r = 512 carries
    a block across four tiles; one launch of the new kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from scann_tpu_torch.ops import sweep as sw

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(r + b + penalty)
    n = 16 * max(r, 128) + (8 if r == 8 else 0)
    q_aug, aug, pen = _sweep_inputs(rng, n=n, d=100, b=b, r=r,
                                    int8_rows=False, penalty=penalty)
    assert sw.sweep_plan("qmajor", n, b, aug.shape[1], r, False) is not None
    sw.reset_launches()
    got = sw.block_min_sweep_qmajor(q_aug, aug, r=r, penalty=pen)
    torch.cuda.synchronize()
    assert sw.LAUNCHES_BY_KERNEL["block_min_qmajor"] == {
        "block_min_compact": 1, "block_min_sweep": 0}
    assert [(tuple(t.shape), t.dtype) for t in got] == [
        ((b, n // r), torch.float32), ((b, n // r), torch.int32)]
    report = sw.check_against_twin("qmajor", got, q_aug, aug, r=r,
                                   penalty=pen)
    assert report["checked"] == (n // r) * b
    assert report["loc_equal"] > 0.9


@pytest.mark.cuda
@pytest.mark.parametrize("r,b", [(8, 130), (256, 70), (512, 24), (512, 300)])
@pytest.mark.parametrize("penalty", [False, True])
def test_block_min_qmajor_kernel_breaks_ties_as_the_twin(r, b, penalty):
    """Integer-valued bf16 rows and queries with repeated rows and a
    penalty of 0 or 256: every sum is exact, so values and offsets equal
    the twin's bit for bit, the lowest row first among equal minima (at
    r = 512 across the four tiles of a block)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from scann_tpu_torch.ops import sweep as sw

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(r + b + 3 * penalty)
    n, d1 = 8192, 104
    rows = torch.from_numpy(rng.integers(-8, 9, size=(n, d1)).astype(
        np.float32)).to(torch.bfloat16).cuda()
    rows[0:n - 1:5] = rows[1::5]    # repeated rows: ties inside blocks
    rows[128:256] = rows[0:128]     # a block's tiles repeated: ties across
    q = torch.from_numpy(rng.integers(-8, 9, size=(b, d1)).astype(
        np.float32)).to(torch.bfloat16).cuda()
    pen = None
    if penalty:
        pen = torch.from_numpy(np.where(rng.random((n // r, r)) < 0.3, 256.0,
                                        0.0).astype(np.float32)).to(
            torch.bfloat16).cuda()
    sw.reset_launches()
    got = sw.block_min_sweep_qmajor(q, rows, r=r, penalty=pen)
    want = sw.block_min_sweep_qmajor_reference(q, rows, r=r, penalty=pen)
    torch.cuda.synchronize()
    assert sw.LAUNCHES_BY_KERNEL["block_min_qmajor"] == {
        "block_min_compact": 1, "block_min_sweep": 0}
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("int8_rows,r", [(True, 512), (True, 64),
                                         (False, 4)])
def test_block_min_qmajor_calls_outside_the_plan_stay_on_the_old_kernel(
        int8_rows, r):
    """int8 rows and r < 8 go to block_min_sweep.cu, within the twin's
    tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from scann_tpu_torch.ops import sweep as sw

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(r + int8_rows)
    n = 16 * max(r, 128)
    q_aug, aug, pen = _sweep_inputs(rng, n=n, d=100, b=70, r=r,
                                    int8_rows=int8_rows, penalty=int8_rows)
    assert sw.sweep_plan("qmajor", n, 70, aug.shape[1], r, int8_rows) is None
    sw.reset_launches()
    got = sw.block_min_sweep_qmajor(q_aug, aug, r=r, penalty=pen)
    torch.cuda.synchronize()
    assert sw.LAUNCHES_BY_KERNEL["block_min_qmajor"] == {
        "block_min_compact": 0, "block_min_sweep": 1}
    sw.check_against_twin("qmajor", got, q_aug, aug, r=r, penalty=pen)


@pytest.mark.cuda
def test_block_min_rowmajor_kernels_reject_bad_arguments():
    """A call the plan accepts raises on bad arguments instead of falling
    back; the C entry point refuses a top-2 call without its seconds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from scann_tpu_torch.ops import sweep as sw

    rng = np.random.default_rng(1)
    q_aug, aug, _ = _sweep_inputs(rng, n=4096, d=100, b=16, r=64,
                                  int8_rows=False, penalty=False)
    with pytest.raises(ValueError, match="penalty"):
        sw.block_min2_sweep(q_aug, aug, r=64,
                            penalty=torch.zeros(64, 32, dtype=torch.bfloat16,
                                                device="cuda"))
    with pytest.raises(ValueError, match="multiple"):
        sw.block_min_sweep(q_aug, aug[:4000], r=64)
    with pytest.raises(ValueError, match="width"):
        sw.block_min2_sweep(q_aug[:, :96].contiguous(), aug, r=64)
    plan = sw.sweep_plan("top2", 4096, 16, aug.shape[1], 64, False)
    out = torch.empty(64, 16, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    err = sw._compact_kernel_fn()(
        aug.data_ptr(), q_aug.data_ptr(), None, out.data_ptr(), out.data_ptr(),
        4096, 16, aug.shape[1], 64, plan.stages, plan.run_tiles,
        plan.cluster, 2, None, None, stream)
    assert err != 0
    # an unknown form (form 3 is the q-major form since it was added)
    err = sw._compact_kernel_fn()(
        aug.data_ptr(), q_aug.data_ptr(), None, out.data_ptr(), out.data_ptr(),
        4096, 16, aug.shape[1], 64, plan.stages, plan.run_tiles,
        plan.cluster, 4, None, None, stream)
    assert err != 0
    # the q-major form: r past 512, and r = 512 with runs of part of a block
    qplan = sw.sweep_plan("qmajor", 4096, 16, aug.shape[1], 512, False)
    for r, run_tiles in ((1024, 8), (512, 2)):
        err = sw._compact_kernel_fn()(
            aug.data_ptr(), q_aug.data_ptr(), None, out.data_ptr(),
            out.data_ptr(), 4096, 16, aug.shape[1], r, qplan.stages,
            run_tiles, 1, 3, None, None, stream)
        assert err != 0


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


# -- LUT16 scoring (csrc/lut16_scoring.cu) ------------------------------------


def _fused_inputs(rng, *, b, s, n, c=16):
    """u8 tables -> even-first int8 tables and packed transposed codes, as
    the hasher lays them out."""
    from scann_tpu_torch.hashes import lut, lut16

    luts_u8 = torch.from_numpy(rng.integers(0, 256, size=(b, s, c)).astype(
        np.uint8))
    codes = rng.integers(0, c, size=(n, s)).astype(np.uint8)
    packed_t = np.ascontiguousarray(lut16.pack_codes_4bit(codes).T)
    return (lut.luts_i8_evenfirst(luts_u8).cuda(),
            torch.from_numpy(packed_t).cuda())


@pytest.mark.cuda
@pytest.mark.parametrize("s,r,b,n,n_valid", [
    (50, 32, 1024, 16384, 16000),     # the main path's S and r
    (50, 32, 100, 4096, 4096 - 40),   # B not a multiple of 64, last block out
    (7, 16, 64, 2048, 1000),          # odd S, r < 32
    (8, 8, 33, 1040, 1040),           # r = 8, N not a multiple of 1024
    (12, 64, 70, 3072, 2999),         # r > 32: a running minimum per warp
    (4, 1024, 5, 4096, 3500),         # r = one CTA tile
    (2, 32, 3, 96, 50),               # N % 16 != 0: byte-wise code staging
    (50, 32, 129, 1056, 1040),        # B one past the 128-query tile; N one
                                      # block past a 32-unit item
    (50, 32, 226, 4096, 4000),        # B = 226
    (9, 16, 257, 2048, 1999),         # sh odd, B past two query tiles
    (7, 8, 40, 1048, 1031),           # r = 8, N = 8 (mod 16): codes re-laid
                                      # at a 16-byte pitch
    (16, 1024, 130, 8192, 5000),      # r = 1024, n_valid inside a block
    (74, 32, 100, 2048, 2048),        # the widest S_pad of 128-query tiles
    (75, 32, 129, 2048, 2000),        # 64-query tiles, two stages each
    (100, 8, 70, 1048, 1041),         # the same at r = 8
    (112, 64, 257, 4096, 4000),       # the widest S_pad with two stages
    (150, 16, 65, 2048, 1999),        # 64-query tiles, one stage each
])
def test_lut16_fused_sweep_kernel_matches_twin(s, r, b, n, n_valid):
    """Combined block minima equal, bit for bit: integer sums, the lowest
    row first among equal sums, INVALID_COMBINED blocks. The cases cross
    the 128- and 64-query tiles, the 32-unit item and the 16-row code
    window, and take each tile plan of lut16_fused_plan."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from scann_tpu_torch.ops import scoring_kernels as sk

    rng = np.random.default_rng(s * 1000 + r + b)
    i8, packed = _fused_inputs(rng, b=b, s=s, n=n)
    before = sk.LAUNCHES["lut16_fused_sweep"]
    got = sk.lut16_fused_sweep(i8, packed, n_valid, r=r)
    torch.cuda.synchronize()
    assert sk.LAUNCHES["lut16_fused_sweep"] == before + 1
    want = sk.lut16_fused_sweep_reference(i8, packed, n_valid, r)
    assert got.shape == want.shape == (n // r, b)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_lut16_fused_sweep_kernel_small_code_count_and_ties():
    """C < 16 (tables padded to 16 entries for the kernel) and tables with a
    tiny range, where equal sums are common."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from scann_tpu_torch.hashes import lut, lut16
    from scann_tpu_torch.ops import scoring_kernels as sk

    rng = np.random.default_rng(2)
    b, s, c, n = 40, 9, 5, 2048
    luts_u8 = torch.from_numpy(rng.integers(0, 3, size=(b, s, c)).astype(
        np.uint8))
    codes = rng.integers(0, c, size=(n, s)).astype(np.uint8)
    packed = torch.from_numpy(np.ascontiguousarray(
        lut16.pack_codes_4bit(codes).T)).cuda()
    i8 = lut.luts_i8_evenfirst(luts_u8).cuda()
    got = sk.lut16_fused_sweep(i8, packed, 2000, r=32)
    want = sk.lut16_fused_sweep_reference(i8, packed, 2000, 32)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,c,n", [(1024, 50, 16, 20000), (100, 7, 16, 5000),
                                     (33, 8, 256, 777), (1, 3, 4, 10),
                                     # the approximate-only hasher's call and
                                     # the 16,384-row hasher's re-rank call
                                     (128, 50, 16, 1_183_514),
                                     (1024, 50, 16, 16_384)])
def test_lut16_score_kernel_matches_twin(out_dtype, b, s, c, n):
    """Bit-identical: both add bf16(entry) in ascending s in float32 and
    round once to the output type. Every call takes the query-tiled
    kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from scann_tpu_torch.ops import scoring_kernels as sk

    rng = np.random.default_rng(b + s + c + n)
    luts = torch.from_numpy((rng.normal(size=(b, s, c)) * 5).astype(
        np.float32)).cuda()
    codes_t = torch.from_numpy(rng.integers(0, c, size=(s, n)).astype(
        np.uint8)).cuda()
    before = sk.LAUNCHES["lut16_score"]
    tiled = sk.SCORE_LAUNCHES["query_tiled"]
    got = sk.lut16_score(luts, codes_t, out_dtype)
    torch.cuda.synchronize()
    assert sk.LAUNCHES["lut16_score"] == before + 1
    assert sk.SCORE_LAUNCHES["query_tiled"] == tiled + 1
    want = sk.lut16_score_reference(luts, codes_t, out_dtype)
    assert got.dtype == out_dtype and got.shape == (b, n)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,c,n", [(1024, 50, 16, 20000), (100, 7, 16, 5000),
                                     (33, 8, 256, 777), (1, 3, 4, 10)])
def test_lut16_score_per_column_kernel_matches_twin(out_dtype, b, s, c, n):
    """The one-column-a-thread kernel (chip_smoke.py's same-run yardstick,
    reached only through _score_launch(per_column=True)) stays bit-identical
    to the twin."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from scann_tpu_torch.ops import scoring_kernels as sk

    rng = np.random.default_rng(b + s + c + n + 1)
    luts = torch.from_numpy((rng.normal(size=(b, s, c)) * 5).astype(
        np.float32)).cuda()
    codes_t = torch.from_numpy(rng.integers(0, c, size=(s, n)).astype(
        np.uint8)).cuda()
    before = sk.SCORE_LAUNCHES["column_per_thread"]
    got = sk._score_launch(luts, codes_t, out_dtype, per_column=True)
    torch.cuda.synchronize()
    assert sk.SCORE_LAUNCHES["column_per_thread"] == before + 1
    assert torch.equal(got, sk.lut16_score_reference(luts, codes_t,
                                                     out_dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,c,n,view", [
    (70, 5, 16, 1000, 3),     # codes a view starting 3 bytes in
    (130, 50, 16, 4099, 0),   # N odd, B past a tile
    (9, 12, 256, 300, 1),     # 16 queries a tile, C = 256
])
def test_lut16_score_kernel_reads_any_code_alignment(b, s, c, n, view):
    """Codes at any alignment and row pitch (a column slice of a wider
    matrix, made contiguous by the wrapper, and an offset view): the ring's
    aligned copies and funnel shifts give the twin's result bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from scann_tpu_torch.ops import scoring_kernels as sk

    rng = np.random.default_rng(b + n)
    luts = torch.from_numpy((rng.normal(size=(b, s, c)) * 5).astype(
        np.float32)).cuda()
    flat = torch.from_numpy(rng.integers(0, c, size=s * n + view).astype(
        np.uint8)).cuda()
    codes_t = flat[view:].view(s, n)
    assert codes_t.is_contiguous() and codes_t.data_ptr() % 16 == view
    for dtype in (torch.float32, torch.bfloat16):
        got = sk.lut16_score(luts, codes_t, dtype)
        assert torch.equal(got, sk.lut16_score_reference(luts, codes_t,
                                                         dtype))


@pytest.mark.cuda
def test_lut16_kernels_raise_instead_of_falling_back():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from scann_tpu_torch.ops import scoring_kernels as sk

    rng = np.random.default_rng(0)
    i8, packed = _fused_inputs(rng, b=8, s=8, n=1024)
    before = dict(sk.LAUNCHES)
    with pytest.raises(ValueError, match="power of two"):
        sk.lut16_fused_sweep(i8, packed, 1024, r=4)
    with pytest.raises(ValueError, match="shared memory"):
        sk.lut16_fused_sweep(torch.zeros(1, 300 * 16, dtype=torch.int8,
                                         device="cuda"),
                             torch.zeros(150, 64, dtype=torch.uint8,
                                         device="cuda"), 64, r=32)
    with pytest.raises(ValueError, match="is on"):
        sk.lut16_fused_sweep(i8, packed.cpu(), 1024, r=32)
    luts = torch.zeros(2, 4000, 16, device="cuda")
    with pytest.raises(ValueError, match="shared memory"):
        sk.lut16_score(luts, torch.zeros(4000, 8, dtype=torch.uint8,
                                         device="cuda"))
    with pytest.raises(ValueError, match="uint8"):
        sk.lut16_score(luts[:, :8], torch.zeros(8, 8, dtype=torch.int32,
                                                device="cuda"))
    assert sk.LAUNCHES == before


@pytest.mark.cuda
def test_asymmetric_hasher_on_card():
    """The hasher's default device is the card; every path launches its
    kernel and returns exact re-ranked distances at recall near 1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from scann_tpu_torch import (AsymmetricHasher, AsymmetricHasherConfig,
                                 DenseDataset, SearchParameters)
    from scann_tpu_torch.ops import scoring_kernels as sk

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(5)
    db = rng.normal(size=(40_000, 32)).astype(np.float32)
    q = rng.normal(size=(64, 32)).astype(np.float32)
    h = AsymmetricHasher(AsymmetricHasherConfig(
        num_codes=16, num_subspaces=16, seed=0, max_iterations=8,
        training_sample_size=10_000)).build(DenseDataset(db))
    assert h.device.type == "cuda" and h.codes.is_cuda
    d2 = ((q[:, None, :] - db[None]) ** 2).sum(-1)
    gt = np.argsort(d2, axis=1)[:, :10]
    for pre_k, kernel in ((300, "lut16_fused_sweep"), (None, "lut16_score"),
                          (700, "lut16_score")):
        sk.reset_launches()
        idx, dist = h.search_batched_arrays(q, 10, SearchParameters(
            pre_reordering_num_neighbors=pre_k))
        assert sk.LAUNCHES[kernel] == 1, (pre_k, sk.LAUNCHES)
        if pre_k is not None:
            recall = np.mean([len(set(a) & set(g)) / 10
                              for a, g in zip(idx, gt)])
            assert recall >= 0.9, (pre_k, recall)
            np.testing.assert_allclose(dist, np.take_along_axis(d2, idx, 1),
                                       rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 7, 129, 226, 256, 257])
@pytest.mark.parametrize("d,n,scale", [
    (13, 1000, 1.0), (64, 777, 1.0), (100, 2049, 1.0), (128, 130, 1.0),
    (8, 129, 1.0),          # D = 8; N one past the 128-row tile
    (100, 136, 1.0),        # N = 8 (mod 16): codes re-laid at a 16-byte pitch
    (100, 1000, 1e-30),     # the bf16 x 3 split's exactness at both ends of
    (37, 500, 1e30),        # the float32 range
    (200, 300, 1.0)])       # D past one launch: two slices summed
def test_int8_dots_kernel_matches_twin(b, d, n, scale):
    """|kernel - twin| <= 1e-5 * sum_d |q_d * c_d| per entry: three bf16
    products of the split queries on the tensor cores against a float32
    matrix product. B crosses the 128-query tile (129, 257) and takes the
    searcher's chunk (226); N is never a multiple of the 128-row tile."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from scann_tpu_torch.ops import scoring_kernels as sk

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(b * 1000 + d)
    q = torch.from_numpy((rng.normal(size=(b, d)) * scale).astype(
        np.float32)).cuda()
    codes = torch.from_numpy(
        rng.integers(0, 256, size=(d, n)).astype(np.uint8)).cuda()
    before = sk.LAUNCHES["int8_dots"]
    got = sk.int8_dots(q, codes)
    torch.cuda.synchronize()
    assert sk.LAUNCHES["int8_dots"] == before + -(-d // sk.INT8_DOTS_MAX_D)
    want = sk.int8_dots_reference(q, codes)
    bound = 1e-5 * (q.abs() @ codes.float())
    assert got.shape == (b, n) and got.dtype == torch.float32
    assert bool(((got - want).abs() <= bound).all())


def _fused_case(rng, n, d, b, dup=False):
    db = rng.random((n, d), dtype=np.float32)
    q = rng.random((b, d), dtype=np.float32)
    if dup:
        # rows 3 and 9 equal row 20, row 7 equals row 8; queries sit on them
        db[3] = db[9] = db[20]
        db[7] = db[8]
        q[0], q[1] = db[20], db[8]
    norms = (db.astype(np.float64) ** 2).sum(1).astype(np.float32)
    return [torch.from_numpy(a).cuda() for a in (q, db, norms)]


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 10, 16])
@pytest.mark.parametrize("n,d,b,n_valid,dup", [
    (10_000, 64, 100, 10_000, False),     # bench.py's shape: many splits
    (3_000, 13, 37, 2_500, True),         # n_valid < N, duplicates
    (200, 8, 5, 200, True),               # one split: no merge
    (50_000, 32, 8, 49_990, False),       # many sub-chunks per split
    (20, 4, 3, 6, False),                 # k > n_valid: (inf, -1) slots
    (10_000, 64, 1, 10_000, False),       # B=1
    (10_000, 64, 6400, 10_000, False),    # bench.py's B=6400
    (50_000, 100, 37, 44_444, True),      # partial query tile, n_valid < N
    (777, 13, 300, 700, True),            # D % 4 != 0: 4-byte copies
])
def test_fused_bf_kernel_matches_twin(k, n, d, b, n_valid, dup):
    """Values within 1e-5 of the terms |q|^2 + |x|^2, ids equal away from
    ties, missing slots equal (``fused_bf.check_against_twin``); equal
    values lowest row first; the cluster kernel served the call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from scann_tpu_torch.ops import fused_bf as fb

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(n + k)
    q, db, norms = _fused_case(rng, n, d, b, dup)
    before = fb.LAUNCHES
    served = dict(fb.LAUNCHES_BY_KERNEL)
    vals, idx = fb.fused_bf_search(q, db, norms, n_valid, k)
    torch.cuda.synchronize()
    assert fb.LAUNCHES == before + 1
    assert fb.LAUNCHES_BY_KERNEL["cluster"] == served["cluster"] + 1
    assert fb.LAUNCHES_BY_KERNEL["scratch_merge"] == served["scratch_merge"]
    assert vals.shape == (b, k) and idx.dtype == torch.int32
    fb.check_against_twin(q, db, norms, n_valid, k, vals, idx)
    i = idx.cpu().numpy()
    assert (i < n_valid).all()
    if n_valid < k:
        assert (i[:, n_valid:] == -1).all()
        assert torch.isinf(vals[:, n_valid:]).all()
    if dup:
        assert list(i[0, :min(k, 3)]) == [3, 9, 20][:k]
        assert list(i[1, :min(k, 2)]) == [7, 8][:k]
        assert vals[0, 0] == 0.0 or bool(vals[0, 0] < 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 10, 16])
@pytest.mark.parametrize("q_tile,cluster,n,b,n_valid", [
    (16, 1, 3_000, 16, 3_000),       # one CTA a tile: no merge
    (16, 2, 3_000, 13, 2_900),       # a partial query tile
    (16, 5, 10_000, 100, 9_999),     # a cluster width that is no power of 2
    (32, 8, 10_000, 33, 10_000),     # the widest portable cluster
    (16, 16, 50_000, 20, 50_000),    # past the portable 8; many sub-chunks
    (32, 16, 40, 3, 37),             # ranges of 3 rows, k > the range
    (32, 1, 6_000, 1, 6_000),        # B=1
])
def test_fused_bf_cluster_plans_match_twin(k, q_tile, cluster, n, b, n_valid):
    """The cluster kernel under each plan shape, against the twin."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from scann_tpu_torch.ops import fused_bf as fb

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(q_tile * cluster + k)
    q, db, norms = _fused_case(rng, n, 24, b, dup=b > 1)
    plan = fb.ClusterPlan(q_tile, cluster, -(-n_valid // cluster))
    vals, idx = fb._launch(q, db, norms, n_valid, k, plan=plan)
    torch.cuda.synchronize()
    fb.check_against_twin(q, db, norms, n_valid, k, vals, idx)
    assert (idx.cpu().numpy() < n_valid).all()


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 10, 16])
@pytest.mark.parametrize("scratch_merge", [False, True])
def test_fused_bf_kernels_equal_twin_bit_for_bit_on_ties(k, scratch_merge):
    """Integer-valued rows with many equal distances: every sum is exact,
    so both kernels (the cluster kernel and the first port's, kept as a
    yardstick) equal the twin in values and ids, ties lowest row first."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from scann_tpu_torch.ops import fused_bf as fb

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(k)
    db = rng.integers(0, 3, size=(20_000, 8)).astype(np.float32)
    q = rng.integers(0, 3, size=(77, 8)).astype(np.float32)
    db[9_000:9_005] = db[1]
    q[0] = db[1]
    norms = (db ** 2).sum(1).astype(np.float32)
    q, db, norms = (torch.from_numpy(a).cuda() for a in (q, db, norms))
    served = dict(fb.LAUNCHES_BY_KERNEL)
    kernel = "scratch_merge" if scratch_merge else "cluster"
    for plan in ([None] if scratch_merge else
                 [None, fb.ClusterPlan(16, 16, 1_219),
                  fb.ClusterPlan(32, 3, 6_500)]):
        vals, idx = fb._launch(q, db, norms, 19_500, k,
                               scratch_merge=scratch_merge, plan=plan)
        want_v, want_i = fb.fused_bf_search_reference(q, db, norms, 19_500,
                                                      k)
        assert torch.equal(vals, want_v) and torch.equal(idx, want_i)
    assert fb.LAUNCHES_BY_KERNEL[kernel] == served[kernel] + (
        1 if scratch_merge else 3)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 10, 16])
def test_fused_bf_cluster_kernel_on_rows_sorted_by_falling_distance(k):
    """Every sub-chunk beats the list the one before left, more than 64
    candidates survive and the selection takes its rounds: still the
    twin's result bit for bit (integer-valued rows, ties between
    neighbours), with D not a multiple of 4 and one with more than a stage
    of d."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from scann_tpu_torch.ops import fused_bf as fb

    torch.backends.cuda.matmul.allow_tf32 = False
    n, b = 3_000, 40       # every |q|^2 + |x|^2 below 2^24: exact sums
    for d in (5, 200):
        db = np.zeros((n, d), np.float32)
        db[:, 0] = np.arange(n, 0, -1)
        db[:, 1] = np.arange(n) % 2
        q = np.zeros((b, d), np.float32)
        q[:, 0] = np.arange(b) * 10
        q[1::2, 1] = 1.0
        norms = (db ** 2).sum(1).astype(np.float32)
        q, db, norms = (torch.from_numpy(a).cuda() for a in (q, db, norms))
        for plan in (None, fb.ClusterPlan(16, 1, n - 3),
                     fb.ClusterPlan(32, 4, 750)):
            vals, idx = fb._launch(q, db, norms, n - 3, k, plan=plan)
            want_v, want_i = fb.fused_bf_search_reference(q, db, norms,
                                                          n - 3, k)
            assert torch.equal(vals, want_v) and torch.equal(idx, want_i)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 10, 16])
def test_fused_bf_scratch_merge_kernel_matches_twin(k):
    """The first port's kernel, kept as a yardstick, still holds to the
    twin at the headline shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from scann_tpu_torch.ops import fused_bf as fb

    torch.backends.cuda.matmul.allow_tf32 = False
    q, db, norms = _fused_case(np.random.default_rng(k), 10_000, 64, 100)
    vals, idx = fb._launch(q, db, norms, 10_000, k, scratch_merge=True)
    torch.cuda.synchronize()
    fb.check_against_twin(q, db, norms, 10_000, k, vals, idx)


@pytest.mark.cuda
def test_fused_bf_cluster_entry_rejects_bad_arguments():
    """Plans that leave rows out or name a tile or width the kernel is not
    built for raise before a launch; the C entry refuses the same."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import ctypes

    from scann_tpu_torch.ops import fused_bf as fb

    q, db, norms = _fused_case(np.random.default_rng(0), 100, 8, 4)
    before = fb.LAUNCHES
    for plan in (fb.ClusterPlan(16, 2, 49), fb.ClusterPlan(8, 1, 100),
                 fb.ClusterPlan(16, 17, 6), fb.ClusterPlan(16, 1, 0)):
        with pytest.raises(ValueError, match="does not cover"):
            fb._launch(q, db, norms, 100, 5, plan=plan)
    assert fb.LAUNCHES == before
    search, cap, _ = fb._kernel_fns()
    out_v = torch.empty(4, 5, device="cuda")
    out_i = torch.empty(4, 5, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = (q.data_ptr(), db.data_ptr(), norms.data_ptr())
    for n_valid, d, k, q_tile, cluster, rows, dk in (
            (100, 8, 17, 16, 1, 100, 8), (100, 8, 5, 16, 2, 49, 8),
            (100, 8, 5, 8, 1, 100, 8), (100, 8, 5, 16, 17, 6, 8),
            (100, 0, 5, 16, 1, 100, 8), (-1, 8, 5, 16, 1, 100, 8),
            (100, 8, 5, 16, 1, 100, 12), (100, 8, 5, 16, 1, 100, 96),
            (100, 8, 5, 32, 1, 100, 0)):
        assert search(*ptrs, n_valid, 4, d, k, q_tile, cluster, rows, dk,
                      out_v.data_ptr(), out_i.data_ptr(), stream) != 0
    assert torch.cuda.synchronize() is None
    got = ctypes.c_int(-1)
    assert cap(16, 17, 8, ctypes.byref(got)) != 0 and got.value == 0
    assert cap(16, 2, 8, ctypes.byref(got)) == 0 and got.value >= 1
    # a good call still launches after the refusals
    vals, idx = fb.fused_bf_search(q, db, norms, 100, 5)
    fb.check_against_twin(q, db, norms, 100, 5, vals, idx)


@pytest.mark.cuda
def test_fused_bf_kernel_rejects_bad_arguments():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from scann_tpu_torch.ops import fused_bf as fb

    rng = np.random.default_rng(0)
    q, db, norms = _fused_case(rng, 100, 8, 4)
    before = fb.LAUNCHES
    with pytest.raises(ValueError, match="k must be"):
        fb.fused_bf_search(q, db, norms, 100, 17)
    with pytest.raises(ValueError, match="float32"):
        fb.fused_bf_search(q.double(), db, norms, 100, 5)
    with pytest.raises(ValueError, match="n_valid"):
        fb.fused_bf_search(q, db, norms, 101, 5)
    with pytest.raises(ValueError, match="is on"):
        fb.fused_bf_search(q, db.cpu(), norms, 100, 5)
    assert fb.LAUNCHES == before


@pytest.mark.cuda
def test_brute_force_searchers_on_card():
    """Both searchers default to the card, launch their kernels on their
    paths and agree with the same searchers on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from scann_tpu_torch import (BruteForceSearcher, DenseDataset,
                                 ScalarQuantizedBruteForceSearcher,
                                 ScalarQuantizedConfig)
    from scann_tpu_torch.ops import fused_bf as fb
    from scann_tpu_torch.ops import scoring_kernels as sk

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(42)
    db = rng.random((10_000, 64), dtype=np.float32)
    q = rng.random((100, 64), dtype=np.float32)
    bf = BruteForceSearcher(DenseDataset(db))
    assert bf.device.type == "cuda"
    before = fb.LAUNCHES
    idx, dist = bf.search_batched_arrays(q, 10)
    assert fb.LAUNCHES == before + 1
    gt = np.argsort(((q[:, None] - db[None]) ** 2).sum(-1), axis=1)[:, :10]
    assert np.mean([len(set(a) & set(g)) / 10 for a, g in zip(idx, gt)]) == 1
    idx2, _ = bf.search_batched_arrays(np.repeat(q, 64, axis=0), 10)
    assert fb.LAUNCHES == before + 1          # B=6400: the composed path
    np.testing.assert_array_equal(idx2[::64], idx)
    for storage, kernel in (("int8", True), ("int4", True), ("bf16", False),
                            ("fp8_e4m3", False)):
        cfg = ScalarQuantizedConfig(storage=storage)
        card = ScalarQuantizedBruteForceSearcher(DenseDataset(db), cfg)
        cpu = ScalarQuantizedBruteForceSearcher(DenseDataset(db), cfg,
                                                device="cpu")
        sk.reset_launches()
        got_i, got_d = card.search_batched_arrays(q, 10)
        assert card.uses_kernel() == kernel
        assert sk.LAUNCHES["int8_dots"] == int(kernel), storage
        want_i, want_d = cpu.search_batched_arrays(q, 10)
        np.testing.assert_allclose(got_d, want_d, rtol=1e-5, atol=1e-4)
        assert (got_i == want_i).mean() > 0.99, storage


def _facade_data():
    rng = np.random.default_rng(3)
    centers = rng.normal(size=(24, 32)).astype(np.float32) * 3
    db = (centers[rng.integers(0, 24, 4000)]
          + rng.normal(size=(4000, 32))).astype(np.float32)
    q = (centers[rng.integers(0, 24, 64)]
         + rng.normal(size=(64, 32))).astype(np.float32)
    return db, q


def _facade_config(mode):
    from scann_tpu_torch import ScannConfig, PartitioningConfig, HashConfig

    cfg = ScannConfig().with_partitioning(PartitioningConfig(
        num_partitions=32, num_partitions_to_search=8))
    if mode == "tree_ah":
        cfg.with_hashing(HashConfig(num_blocks=16, num_buckets=16)) \
            .with_reordering()
    return cfg


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["tree_ah", "partitioned"])
def test_facade_on_card_matches_the_cpu(mode, tmp_path):
    """The facade's TREE_AH and PARTITIONED modes on the card against the
    same searcher on the CPU (built there, carried to the card through
    save_index / load_index): equal ids (#1 is bit-identical to its twin,
    the selections tie-free), distances within 1e-5 relative; #1 launched
    once a batch on the TREE_AH path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from scann_tpu_torch import (DenseDataset, Scann, load_index,
                                 save_index)

    torch.backends.cuda.matmul.allow_tf32 = False
    db, q = _facade_data()
    ds = DenseDataset(db)
    cpu = Scann(ds, _facade_config(mode), device="cpu")
    path = str(tmp_path / "facade.npz")
    save_index(path, cpu)
    card = Scann(ds, cpu.config, _impl=load_index(path),
                 _mode=cpu.search_mode)
    assert card.device.type == "cuda"
    assert card.impl.device.type == "cuda"
    before = tag.LAUNCHES
    got_i, got_d = card.search_batched_arrays(q)
    assert tag.LAUNCHES == before + (mode == "tree_ah")
    want_i, want_d = cpu.search_batched_arrays(q)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_d, want_d, rtol=1e-5, atol=1e-5)
    ids, _ = card.search_batched_tensors(torch.from_numpy(q).cuda())
    assert ids.is_cuda
    np.testing.assert_array_equal(ids.cpu().numpy(), got_i)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["tree_ah", "partitioned", "hashed"])
def test_facade_save_load_round_trip_on_card(mode, tmp_path):
    """A facade built on the card (the default device) saves and loads back
    onto the card with bit-identical results."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from scann_tpu_torch import (DenseDataset, HashConfig, Scann,
                                 ScannConfig, SearchParameters, load_index,
                                 save_index)

    db, q = _facade_data()
    cfg = (_facade_config(mode) if mode != "hashed" else
           ScannConfig().with_hashing(HashConfig(num_blocks=16,
                                                 num_buckets=16))
           .with_reordering())
    s = Scann(DenseDataset(db), cfg)
    assert s.device.type == "cuda"
    path = str(tmp_path / "facade.npz")
    save_index(path, s)
    back = load_index(path)
    assert back.device.type == "cuda"
    k, params = s.search_arguments()
    if mode == "hashed":
        assert params == SearchParameters(pre_reordering_num_neighbors=100)
    got = back.search_batched_arrays(q, k, params)
    want = s.search_batched_arrays(q)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("measure", ["SQUARED_L2", "L2", "DOT_PRODUCT"])
def test_dynamic_merge_on_card_matches_the_cpu(measure):
    """The dynamic searcher's merge on the card against the same merge on
    the CPU, on equal inputs (duplicates between the candidates and the
    delta slab, invalid slots, an epsilon): equal ids, distances within
    1e-5 relative."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from scann_tpu_torch.mutator import dynamic_merge
    from scann_tpu_torch.ops.distances import DistanceMeasure

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(29)
    b, f, e, d, n = 64, 40, 300, 32, 5000
    snap = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    q = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32))
    cand = torch.from_numpy(rng.integers(-1, n, size=(b, f)))
    extra_ids = torch.from_numpy(np.concatenate([
        rng.choice(n, 100, replace=False), np.arange(n, n + e - 100)]))
    extra = torch.from_numpy(rng.normal(size=(e, d)).astype(np.float32))
    valid = torch.from_numpy(rng.random(e) < 0.8)
    m = DistanceMeasure[measure]
    for eps in (float("inf"), 60.0):
        want = dynamic_merge(q, snap, cand, extra, extra_ids, valid, eps,
                             k=10, measure=m)
        got = dynamic_merge(*(t.cuda() for t in (q, snap, cand, extra,
                                                 extra_ids, valid)),
                            eps, k=10, measure=m)
        assert got[0].is_cuda and got[1].is_cuda
        np.testing.assert_array_equal(got[1].cpu().numpy(),
                                      want[1].numpy())
        np.testing.assert_allclose(
            got[0].cpu().numpy(), want[0].numpy(), rtol=1e-5, atol=1e-5,
            err_msg=_merge_sides(q, snap, extra, extra_ids, valid, want[1],
                                 want[0], got[0].cpu(), measure))


def _merge_sides(q, snap, extra, extra_ids, valid, ids, cpu, card, measure):
    """Which side of a merge comparison moved: each one's largest relative
    error against float64 distances to the returned ids (the slab's copy
    where it holds one), beside torch's CPU settings."""
    rows = np.concatenate([snap.numpy(), np.zeros(
        (int(extra_ids.max()) + 1 - len(snap), snap.shape[1]), np.float32)])
    rows[extra_ids.numpy()[valid.numpy()]] = extra.numpy()[valid.numpy()]
    ids = ids.numpy()
    x = rows.astype(np.float64)[np.clip(ids, 0, None)]
    q64 = q.numpy().astype(np.float64)[:, None, :]
    exact = {"SQUARED_L2": ((q64 - x) ** 2).sum(-1),
             "L2": np.sqrt(((q64 - x) ** 2).sum(-1)),
             "DOT_PRODUCT": -(q64 * x).sum(-1)}[measure]
    live = ids >= 0

    def rel(v):
        v = v.numpy().astype(np.float64)[live]
        return float((np.abs(v - exact[live]) / np.maximum(
            np.abs(exact[live]), 1e-30)).max(initial=0.0))
    return (f"against float64: card max rel {rel(card):.3g}, CPU max rel "
            f"{rel(cpu):.3g}; torch CPU threads {torch.get_num_threads()}, "
            f"capability {torch.backends.cpu.get_cpu_capability()}")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["tree_ah", "block_sweep"])
def test_filtered_search_on_card_matches_the_cpu(kind, tmp_path):
    """``search_batched_with_filter`` on the card (the mask applied there:
    #1 for tree-x-AH, the block-min sweep with the allowlist penalty)
    against the same searcher on the CPU: equal ids, distances within 1e-5
    relative, every id allowed, a kernel launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from scann_tpu_torch import (BlockSweepConfig, BlockSweepSearcher,
                                 DenseDataset, Scann, load_index, save_index)
    from scann_tpu_torch.ops import sweep as sw
    from scann_tpu_torch.restricts import (AllowlistFilter, AndFilter,
                                           NotFilter, RangeFilter,
                                           RestrictAllowlist)

    torch.backends.cuda.matmul.allow_tf32 = False
    db, q = _facade_data()
    n = len(db)
    filt = AndFilter([AllowlistFilter(RestrictAllowlist.from_indices(
        range(0, n, 2), n)), NotFilter(RangeFilter(0, 300))])
    if kind == "tree_ah":
        cpu = Scann(DenseDataset(db), _facade_config("tree_ah"),
                    device="cpu").impl
        path = str(tmp_path / "tree.npz")
        save_index(path, cpu)
        card = load_index(path)
        count = lambda: tag.LAUNCHES          # noqa: E731
    else:
        cfg = BlockSweepConfig(block_r=32, pre_reorder_k=64)
        cpu = BlockSweepSearcher(DenseDataset(db), cfg, device="cpu")
        card = BlockSweepSearcher(DenseDataset(db), cfg)
        count = lambda: sum(sw.LAUNCHES.values())  # noqa: E731
    assert card.device.type == "cuda" and card.supports_allow_mask()
    before = count()
    got = card.search_batched_with_filter(q, 10, filt)
    torch.cuda.synchronize()
    assert count() > before
    want = cpu.search_batched_with_filter(q, 10, filt)
    assert [r.indices() for r in got] == [r.indices() for r in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.distances(), w.distances(), rtol=1e-5,
                                   atol=1e-5)
        assert all(filt.is_allowed(i) for i in g.indices())


def _sparse_points(rng, n, d):
    """Sets with repeated indices, explicit zeros, signed values and some
    empty sets, at a width past ``VALUE_SELECT_MIN_N`` so that the
    selection by value and its tie fallback both run."""
    points = []
    for i in range(n):
        nnz = 0 if i % 97 == 5 else int(rng.integers(1, 24))
        idx = rng.integers(0, d, nnz)
        if nnz > 2:
            idx[-1] = idx[0]
        vals = rng.normal(size=nnz).astype(np.float32)
        vals[rng.random(nnz) < 0.1] = 0.0
        points.append((idx, vals))
    return points


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["JACCARD", "DICE", "NON_ZERO_INTERSECT",
                                  "OVERLAP", "WEIGHTED_JACCARD"])
def test_sparse_searcher_on_card_matches_the_cpu(name):
    """``SparseBruteForceSearcher`` on the card (cuSPARSE products over the
    stored nonzeros) against the same searcher on the CPU: the set measures
    equal bit for bit (integer counts, the same float32 formula), weighted
    Jaccard within 1e-6 with equal ids away from ties; through both entry
    points, and the same again on a second run (no order-dependent sums)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from scann_tpu_torch import (DistanceMeasure, SparseBruteForceSearcher,
                                 SparseDataset)
    from scann_tpu_torch.ops import topk

    rng = np.random.default_rng(17)
    d = 3000
    ds = SparseDataset(d)
    for idx, vals in _sparse_points(rng, topk.VALUE_SELECT_MIN_N + 700, d):
        ds.append(idx, vals)
    q = (rng.random((70, d)) < 0.004) * rng.normal(size=(70, d))
    q = q.astype(np.float32)
    card = SparseBruteForceSearcher(ds, DistanceMeasure[name])
    cpu = SparseBruteForceSearcher(ds, DistanceMeasure[name], device="cpu")
    assert card.device.type == "cuda"
    gi, gd = card.search_batched_arrays(q, 10)
    wi, wd = cpu.search_batched_arrays(q, 10)
    again = card.search_batched_arrays(q, 10)
    np.testing.assert_array_equal(again[0], gi)
    np.testing.assert_array_equal(again[1], gd)
    sparse_q = [np.flatnonzero(row) for row in q[:8]]
    got = [card.search_sparse(i, 10, values=q[r, i])
           for r, i in enumerate(sparse_q)]
    want = [cpu.search_sparse(i, 10, values=q[r, i])
            for r, i in enumerate(sparse_q)]
    if name != "WEIGHTED_JACCARD":
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gd, wd)
        for g, w in zip(got, want):
            assert g.indices() == w.indices()
            np.testing.assert_allclose(g.distances(), w.distances(),
                                       rtol=0, atol=1e-6)
        return
    np.testing.assert_allclose(gd, wd, rtol=0, atol=1e-6)
    for row_g, row_w, dist in zip(gi, wi, wd):
        for pos in range(9):
            if np.abs(np.delete(dist, pos) - dist[pos]).min() > 1e-6:
                assert row_g[pos] == row_w[pos]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.distances(), w.distances(), rtol=0,
                                   atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("cov", ["FULL", "DIAGONAL", "SPHERICAL"])
def test_gmm_on_card_matches_the_cpu(cov):
    """``GaussianMixture`` fitted on the card from the host start the CPU
    fit draws: parameters and log-likelihood within 1e-3 relative,
    predictions equal away from near-ties, samples bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from scann_tpu_torch.utils.gmm import (CovarianceType, GaussianMixture,
                                           GmmConfig)

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(4)
    centers = rng.normal(size=(5, 6)) * 4.0
    x = (centers[rng.integers(0, 5, 3000)]
         + rng.normal(size=(3000, 6))).astype(np.float32)
    cfg = GmmConfig(num_components=5, covariance_type=CovarianceType[cov],
                    max_iterations=40, seed=3)
    card = GaussianMixture(cfg).fit(x)
    cpu = GaussianMixture(cfg, device="cpu").fit(x)
    assert card.means.device.type == "cuda"
    for g, w in ((card.weights, cpu.weights), (card.means, cpu.means),
                 (card.covariances, cpu.covariances)):
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=1e-3,
                                   atol=1e-3 * float(w.abs().max()))
    assert card._log_likelihood == pytest.approx(cpu._log_likelihood,
                                                 rel=1e-3)
    proba = cpu.predict_proba(x).numpy()
    top2 = np.sort(proba, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 1e-2
    np.testing.assert_array_equal(card.predict(x).cpu().numpy()[clear],
                                  cpu.predict(x).numpy()[clear])
    carried = GaussianMixture.from_numpy(
        cpu.weights.numpy(), cpu.means.numpy(), cpu.covariances.numpy(),
        config=cfg)
    np.testing.assert_array_equal(carried.sample(200, seed=1).cpu().numpy(),
                                  cpu.sample(200, seed=1).numpy())


def _tuning_data(n=4000, d=24, q=32, seed=7):
    """``tests/test_autotune.py``'s clustered data: 32 centres, noise 0.4."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(32, d)).astype(np.float32) * 3.0
    db = (centers[rng.integers(0, 32, size=n)]
          + rng.normal(size=(n, d)) * 0.4).astype(np.float32)
    qs = (centers[rng.integers(0, 32, size=q)]
          + rng.normal(size=(q, d)) * 0.4).astype(np.float32)
    return db, qs


def _same_tables(card, cpu, tol):
    """Equal (params, cost) entries in the same order, recalls within
    ``tol``."""
    assert [(e.params, e.cost) for e in card.table] == \
        [(e.params, e.cost) for e in cpu.table]
    for g, w in zip(card.table, cpu.table):
        assert abs(g.recall - w.recall) <= tol, (g, w)


@pytest.mark.cuda
def test_autotune_on_card_matches_the_cpu(tmp_path):
    """``autotune`` of a tree-x-AH index built on the CPU, saved and loaded
    onto the card, against the same index on the CPU: the same grid and
    costs, and recalls equal within one id of the sample (#1 equals its
    twin bit for bit and the selections are tie-free, so the ids agree);
    the same choice. #1 launches once a grid point."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from scann_tpu_torch import (AsymmetricHasherConfig, DenseDataset,
                                 TreeXHybridConfig, TreeXHybridSearcher,
                                 autotune, load_index, save_index)

    torch.backends.cuda.matmul.allow_tf32 = False
    db, q = _tuning_data()
    cpu = TreeXHybridSearcher(TreeXHybridConfig(
        num_partitions=32, partitions_to_search=4,
        hash_config=AsymmetricHasherConfig(num_codes=16, num_subspaces=8,
                                           seed=1, max_iterations=5)),
        device="cpu").build(DenseDataset(db))
    path = str(tmp_path / "tree.npz")
    save_index(path, cpu)
    card = load_index(path)
    assert card.device.type == "cuda"
    grid = dict(p_grid=(2, 4, 8, 16), pre_k_grid=(20, 50, 100))
    before = tag.LAUNCHES
    got = autotune(card, q, k=10, target_recall=0.95, **grid)
    assert tag.LAUNCHES - before == 12
    want = autotune(cpu, q, k=10, target_recall=0.95, **grid)
    _same_tables(got, want, 1 / (len(q) * 10) + 1e-12)
    assert got.params == want.params and got.target_met == want.target_met


@pytest.mark.cuda
def test_scann_auto_on_card_matches_the_cpu():
    """``Scann.auto(target_recall=0.95)`` on the card and on the CPU over
    the same rows: the same config (the sample is uniform-mass, far from
    the skew cut), the block sweep, the same tuning grid and costs, the
    target met on both; the card's searches launch #5, and its tuned
    defaults serve the sample at the target less 0.01. Per grid point the
    recalls may differ at a small pre_k: the card's compact q-major sweep
    (#5) keeps bf16 block minima, as the JAX package's compact kernel does,
    where the CPU's row-major form keeps float32, so blocks that tie in
    bf16 are selected differently (0.6438 against 0.7344 at pre_k=10 on
    this sample); at the deepest pre_k the top blocks hold every neighbour
    and the recalls agree within one id."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from scann_tpu_torch import BruteForceSearcher, DenseDataset, Scann
    from scann_tpu_torch.ops import sweep as sw
    from scann_tpu_torch.utils.benchmarking import recall_at_k

    torch.backends.cuda.matmul.allow_tf32 = False
    db, q = _tuning_data(n=8192)
    ds = DenseDataset(db)
    sw.reset_launches()
    card = Scann.auto(ds, target_recall=0.95, tune_queries=q)
    assert sw.COMPACT_LAUNCHES["block_min_compact"] > 0
    cpu = Scann.auto(ds, target_recall=0.95, tune_queries=q, device="cpu")
    assert card.config.to_dict() == cpu.config.to_dict()
    assert type(card.impl).__name__ == "BlockSweepSearcher"
    got, want = card.autotune_result, cpu.autotune_result
    assert [(e.params, e.cost) for e in got.table] == \
        [(e.params, e.cost) for e in want.table]
    assert got.target_met and want.target_met
    assert abs(got.table[-1].recall - want.table[-1].recall) <= \
        1 / (len(q) * 10) + 1e-12
    assert card.default_params == got.params
    idx, _ = card.search_batched_arrays(q)
    gt, _ = BruteForceSearcher(ds, device="cpu").search_batched_arrays(q, 10)
    assert recall_at_k(idx, gt) >= 0.95 - 0.01


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [24, 37, 100])
def test_compact_sweep_row_bytes_equal_memory_usage_on_card(dim):
    """The advisor's skew-route ceiling counts the bytes an int8 sweep with
    bfloat16 re-rank rows takes on the card: ``memory_usage()`` is N times
    ``compact_sweep_bytes_per_row(dim)`` for N a multiple of the sweep's
    row padding (4096 rows at block_r=32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from scann_tpu_torch import (BlockSweepConfig, BlockSweepSearcher,
                                 DenseDataset)
    from scann_tpu_torch.utils.advisor import compact_sweep_bytes_per_row

    n = 8192
    db = np.random.default_rng(dim).normal(size=(n, dim)).astype(np.float32)
    s = BlockSweepSearcher(DenseDataset(db), BlockSweepConfig(
        sweep_dtype="int8", rerank_dtype="bfloat16"))
    aug, rows, _ = s.device_state()
    assert aug.is_cuda and aug.shape[0] == n
    assert s.memory_usage() == n * compact_sweep_bytes_per_row(dim)


@pytest.mark.cuda
@pytest.mark.parametrize("algorithm", ["brute-force", "block-sweep",
                                       "tree-ah"])
def test_harness_on_card_matches_the_cpu(algorithm, tmp_path):
    """``run_benchmark`` on the card against the CPU on the same rows and
    ground truth: the same recall (brute force exact; the block sweep's #5
    and tree-x-AH's #1 equal their twins, the tree-x-AH index built on the
    CPU and loaded on the card through --load-index) and the same report
    keys."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses

    from scann_tpu_torch.harness import ann_benchmark as hb

    torch.backends.cuda.matmul.allow_tf32 = False
    db, q = _tuning_data(n=3000, d=16, q=40)
    gt = hb.exact_ground_truth(db, q, 10, device="cpu")
    data = hb.BenchmarkData(db, q, gt, "clustered", 16)
    extra = ["--batch-size", "20"]
    if algorithm == "tree-ah":
        path = str(tmp_path / "tree.npz")
        hb.run_benchmark(algorithm, data, hb.make_parser().parse_args(
            ["--device", "cpu", "--num-partitions", "16", "--num-blocks",
             "4", "--reorder", "50", "--save-index", path, *extra]))
        extra += ["--load-index", path]
    reports = [hb.run_benchmark(algorithm, data, hb.make_parser().parse_args(
        ["--algorithm", algorithm, "--device", device, *extra]))
        for device in ("cuda", "cpu")]
    assert reports[0].recall_at_k == reports[1].recall_at_k
    assert dataclasses.asdict(reports[0]).keys() == \
        dataclasses.asdict(reports[1]).keys()


# -- sharded searchers on a mesh of 4 shards of one card ----------------------


def _meshes(n=4):
    from scann_tpu_torch.parallel import make_mesh

    return (make_mesh(devices=[torch.device("cuda", 0)] * n),
            make_mesh(devices=[torch.device("cpu")] * n))


def _same_on_card(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["grouped", "xla"])
def test_sharded_tree_ah_on_card_matches_the_cpu(kernel, tmp_path):
    """ShardedTreeXHybridSearcher on [cuda:0] * 4 against the same wrapper
    on 4 CPU shards over one index: equal ids, distances within 1e-5
    relative; #1 (grouped) or #10 (per pair) launched once a shard a batch;
    a save_layout / load_layout round trip on the card bit-identical; the
    shards' tensors on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from scann_tpu_torch import (DenseDataset, Scann, SearchParameters,
                                 load_index, save_index)
    from scann_tpu_torch.ops import tree_ah_leaf as tal
    from scann_tpu_torch.parallel import ShardedTreeXHybridSearcher

    torch.backends.cuda.matmul.allow_tf32 = False
    db, q = _facade_data()
    cpu = Scann(DenseDataset(db), _facade_config("tree_ah"),
                device="cpu").impl
    path = str(tmp_path / "tree.npz")
    save_index(path, cpu)
    card_mesh, cpu_mesh = _meshes()
    card = ShardedTreeXHybridSearcher(load_index(path), card_mesh,
                                      force_kernel=kernel)
    host = ShardedTreeXHybridSearcher(cpu, cpu_mesh, force_kernel=kernel)
    assert all(c.is_cuda for c in card._codes)
    params = SearchParameters(pre_reordering_num_neighbors=100)
    count = ((lambda: tag.LAUNCHES) if kernel == "grouped"
             else (lambda: tal.LAUNCHES))
    before = count()
    got = card.search_batched_arrays(q, 10, params)
    torch.cuda.synchronize()
    assert count() == before + 4
    _same_on_card(got, host.search_batched_arrays(q, 10, params))
    ids, _ = card.search_batched_tensors(torch.from_numpy(q).cuda(), 10,
                                         params)
    assert ids.is_cuda
    np.testing.assert_array_equal(ids.cpu().numpy(), got[0])
    lpath = str(tmp_path / "layout.npz")
    card.save_layout(lpath)
    back = ShardedTreeXHybridSearcher.load_layout(lpath, card_mesh,
                                                  force_kernel=kernel)
    again = back.search_batched_arrays(q, 10, params)
    np.testing.assert_array_equal(again[0], got[0])
    np.testing.assert_array_equal(again[1], got[1])


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", [dict(), dict(top2=True),
                                 dict(sweep_dtype="int8")],
                         ids=["compact", "top2", "int8"])
def test_sharded_block_sweep_on_card_matches_the_cpu(cfg):
    """ShardedBlockSweepSearcher on [cuda:0] * 4 (each shard through the
    kernel ``sweep_plan`` routes it to) against 4 CPU shards: equal ids,
    distances within 1e-5 relative, a sweep launched a shard a batch, and
    an allowlist through the penalty stream."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from scann_tpu_torch import (BlockSweepConfig, BlockSweepSearcher,
                                 DenseDataset)
    from scann_tpu_torch.ops import sweep as sw
    from scann_tpu_torch.parallel import ShardedBlockSweepSearcher

    torch.backends.cuda.matmul.allow_tf32 = False
    db, q = _facade_data()
    bc = BlockSweepConfig(block_r=32, pre_reorder_k=64, **cfg)
    card_mesh, cpu_mesh = _meshes()
    card = ShardedBlockSweepSearcher(
        BlockSweepSearcher(DenseDataset(db), bc), card_mesh)
    host = ShardedBlockSweepSearcher(
        BlockSweepSearcher(DenseDataset(db), bc, device="cpu"), cpu_mesh)
    before = sum(sw.LAUNCHES.values())
    got = card.search_batched_arrays(q, 10)
    torch.cuda.synchronize()
    assert sum(sw.LAUNCHES.values()) == before + 4
    _same_on_card(got, host.search_batched_arrays(q, 10))
    allow = np.zeros(len(db), bool)
    allow[::3] = True
    got = card.search_batched_arrays(q, 10, allow_mask=allow)
    assert np.all(allow[got[0][got[0] >= 0]])
    _same_on_card(got, host.search_batched_arrays(q, 10, allow_mask=allow))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["fused", "xla"])
def test_sharded_hasher_on_card_matches_the_cpu(kernel):
    """ShardedAsymmetricHasher on [cuda:0] * 4 against 4 CPU shards: the
    fused LUT16 sweep (#7, bit-identical to its twin) launched once a
    shard, or the plain score path; equal ids, distances within 1e-5
    relative."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from scann_tpu_torch import (AsymmetricHasher, AsymmetricHasherConfig,
                                 DenseDataset, SearchParameters)
    from scann_tpu_torch.ops import scoring_kernels as sk
    from scann_tpu_torch.parallel import ShardedAsymmetricHasher

    torch.backends.cuda.matmul.allow_tf32 = False
    db, q = _facade_data()
    h = AsymmetricHasher(AsymmetricHasherConfig(
        num_codes=16, num_subspaces=16, seed=5), device="cpu").build(
        DenseDataset(db))
    card_mesh, cpu_mesh = _meshes()
    card = ShardedAsymmetricHasher(h, card_mesh, force_kernel=kernel,
                                   fused_r=8)
    host = ShardedAsymmetricHasher(h, cpu_mesh, force_kernel=kernel,
                                   fused_r=8)
    params = SearchParameters(pre_reordering_num_neighbors=30)
    before = sk.LAUNCHES["lut16_fused_sweep"]
    got = card.search_batched_arrays(q, 10, params)
    torch.cuda.synchronize()
    assert sk.LAUNCHES["lut16_fused_sweep"] == before + (
        4 if kernel == "fused" else 0)
    _same_on_card(got, host.search_batched_arrays(q, 10, params))


@pytest.mark.cuda
def test_sharded_exact_search_and_build_on_card():
    """ShardedBruteForceSearcher and one sharded k-means step on
    [cuda:0] * 4 against 4 CPU shards (equal ids; centres within 1e-4),
    and the sharded build on the card serving at recall@10 >= 0.9 with
    #1 launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from scann_tpu_torch import (AsymmetricHasherConfig, DenseDataset,
                                 SearchParameters, TreeXHybridConfig)
    from scann_tpu_torch.parallel import (ShardedBruteForceSearcher,
                                          ShardedTreeXHybridSearcher,
                                          shard_rows, sharded_kmeans_step)

    torch.backends.cuda.matmul.allow_tf32 = False
    db, q = _facade_data()
    card_mesh, cpu_mesh = _meshes()
    got = ShardedBruteForceSearcher(DenseDataset(db), mesh=card_mesh
                                    ).search_batched_arrays(q, 10)
    want = ShardedBruteForceSearcher(DenseDataset(db), mesh=cpu_mesh
                                     ).search_batched_arrays(q, 10)
    _same_on_card(got, want)
    cen = torch.from_numpy(db[:24].copy())
    outs = []
    for mesh in (card_mesh, cpu_mesh):
        sh, n = shard_rows(mesh, db)
        outs.append([t.cpu() if torch.is_tensor(t) else t for t in
                     sharded_kmeans_step(mesh, 24)(sh, cen, n)])
    np.testing.assert_allclose(outs[0][0].numpy(), outs[1][0].numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(outs[0][1].numpy(), outs[1][1].numpy())
    built = ShardedTreeXHybridSearcher.build(DenseDataset(db), TreeXHybridConfig(
        num_partitions=32, partitions_to_search=8,
        hash_config=AsymmetricHasherConfig(num_codes=16, num_subspaces=16,
                                           seed=42, max_iterations=8)),
        card_mesh)
    before = tag.LAUNCHES
    idx, _ = built.search_batched_arrays(q, 10, SearchParameters(
        pre_reordering_num_neighbors=100))
    torch.cuda.synchronize()
    assert tag.LAUNCHES == before + 4
    recall = np.mean([len(set(a.tolist()) & set(b.tolist())) / 10
                      for a, b in zip(idx, want[0])])
    assert recall >= 0.9, recall
