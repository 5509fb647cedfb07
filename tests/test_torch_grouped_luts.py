"""The grouped scorer's bf16 tables written from the un-expanded source
(``ops/grouped_luts``) on the CPU: the twin of ``csrc/grouped_luts.cu``
against the composition it replaced (the [B, p, S, C] expansion, the bias
added in place, the pad, the bf16 cast, the even-first order and the slot
gather), bit for bit, and the leaf scores that follow from either.

The card's kernel is held to the same twin in ``tests/test_torch_cuda.py``
and ``chip_smoke.py`` [46]."""

import numpy as np
import pytest
import torch

from scann_tpu_torch.models import tree_x_hybrid as tx
from scann_tpu_torch.ops import grouped_luts as gl
from scann_tpu_torch.ops.distances import DistanceMeasure
from scann_tpu_torch.ops.tree_ah_grouped import group_pairs_by_partition

B, P, K, C = 24, 6, 40, 16


def _composed_luts(queries, centers, parts, codebook, *, s_pad,
                   use_residuals, measure):
    """The expansion the grouped path used to run (``_residual_luts``
    before the source was split out): [B*p, s_pad*C] float32."""
    b, d = queries.shape
    p = parts.shape[1]
    if measure == DistanceMeasure.DOT_PRODUCT:
        s, c, dsub = codebook.shape
        luts = -torch.einsum("bsd,scd->bsc", queries.reshape(b, s, dsub),
                             codebook)
        luts = luts[:, None].expand(b, p, s, c).clone()
        if use_residuals:
            bias = -torch.einsum("bd,bpd->bp", queries, centers[parts])
            luts[:, :, 0, :] += bias[:, :, None]
        luts = luts.reshape(b * p, s, c)
    else:
        q_eff = (queries[:, None, :] - centers[parts] if use_residuals
                 else queries[:, None, :].expand(b, p, d))
        luts = tx.lut_kernel(q_eff.reshape(b * p, d), codebook)
    s, c = luts.shape[1], luts.shape[2]
    luts = torch.nn.functional.pad(luts, (0, 0, 0, s_pad - s))
    return luts.reshape(b * p, s_pad * c)


def _composed_group(luts_flat, slot, *, rows, s_pad, packed):
    """The grouping that used to follow it: bf16 cast, even-first
    ``cat``, the gather through ``pair_of_slot``."""
    bp = luts_flat.shape[0]
    pair_of_slot = torch.zeros(rows, dtype=torch.int64)
    pair_of_slot[slot] = torch.arange(bp)
    luts = luts_flat.to(torch.bfloat16)
    if packed:
        l3 = luts.reshape(bp, s_pad, -1)
        luts = torch.cat([l3[:, 0::2], l3[:, 1::2]], dim=1).reshape(bp, -1)
    return luts[pair_of_slot]


def _problem(seed, *, s, dsub=2):
    """Queries, centres, a codebook and [B, P] probes whose partitions are
    drawn by a Zipf-like popularity: a few partitions span several groups,
    most open one partly filled group, and the NG bound leaves whole groups
    unused."""
    gen = torch.Generator().manual_seed(seed)
    d = s * dsub
    queries = torch.randn(B, d, generator=gen)
    centers = torch.randn(K, d, generator=gen) * 2
    codebook = torch.randn(s, C, dsub, generator=gen)
    weight = torch.arange(1, K + 1).float() ** -1.2
    parts = torch.multinomial(weight.expand(B, K), P, generator=gen)
    return queries, centers, codebook, parts


def _bits(t):
    return t.view(torch.int16)


@pytest.mark.parametrize("q_cap", [1, 8, 16])
@pytest.mark.parametrize("s,s_pad", [(50, 64), (64, 64)])
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("use_residuals", [True, False])
@pytest.mark.parametrize("measure", [DistanceMeasure.DOT_PRODUCT,
                                     DistanceMeasure.SQUARED_L2])
def test_grouped_tables_equal_the_composition(measure, use_residuals, packed,
                                              s, s_pad, q_cap):
    """``_group_luts`` fed the source (per query with its bias for
    DOT_PRODUCT, per pair for SQUARED_L2) and fed ``_residual_luts``'s
    expansion both give the composition's rows bit for bit in every used
    slot and zeros in every other; ``_residual_luts`` itself is unchanged;
    the twin counts no launch."""
    queries, centers, codebook, parts = _problem(
        7 + q_cap + s + packed + use_residuals, s=s)
    sizes = torch.randint(1, 300, (K,), generator=torch.Generator()
                          .manual_seed(1)).int()
    offsets = (torch.cumsum(sizes, 0) - sizes).int()
    kw = dict(use_residuals=use_residuals, measure=measure)
    flat = _composed_luts(queries, centers, parts, codebook, s_pad=s_pad, **kw)
    assert torch.equal(
        tx._residual_luts(queries, centers, parts, codebook, s_pad=s_pad,
                          **kw), flat)
    _, slot, ng = group_pairs_by_partition(parts, K, q_cap)
    rows = ng * q_cap
    want = _composed_group(flat, slot, rows=rows, s_pad=s_pad, packed=packed)
    used = torch.zeros(rows, dtype=torch.bool)
    used[slot] = True
    assert not bool(used.all()), "the layout should leave slots unused"
    src = tx._lut_source(queries, centers, parts, codebook, **kw)
    assert src.per_query == (measure == DistanceMeasure.DOT_PRODUCT)
    assert (src.bias is not None) == (src.per_query and use_residuals)
    launches = gl.LAUNCHES
    for luts in (src, flat):
        got, grp_off, grp_size, got_slot = tx._group_luts(
            luts, parts, offsets, sizes, s_pad=s_pad, q_cap=q_cap,
            packed=packed)
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        assert torch.equal(got_slot, slot)
        assert torch.equal(_bits(got[used]), _bits(want[used]))
        assert not bool(_bits(got[~used]).any())
        assert grp_off.dtype == grp_size.dtype == torch.int32
        assert grp_off.shape == grp_size.shape == (ng,)
    assert gl.LAUNCHES == launches


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("per_query,bias", [(True, True), (True, False),
                                            (False, False)])
def test_twin_rows_follow_their_definition(per_query, bias, packed):
    """Row slot[i] of the twin, entry by entry from a numpy reading of the
    definition: pair i = (b, t) reads tables[b] or tables[i], subspace 0
    plus bias[b, t] in float32 (per-query source), zeros past S, one
    rounding to bf16, output position j holding subspace j, or 2j /
    2(j - S_pad/2) + 1 when packed; any other row zero."""
    gen = torch.Generator().manual_seed(3 + 4 * per_query + 2 * bias + packed)
    b, p, s, s_pad, c, q_cap = 5, 4, 5, 8, 3, 4
    parts = torch.randint(0, 6, (b, p), generator=gen)
    _, slot, ng = group_pairs_by_partition(parts, 6, q_cap)
    tables = torch.randn(b if per_query else b * p, s, c, generator=gen)
    bias_t = torch.randn(b, p, generator=gen) if bias else None
    got = gl.grouped_luts(gl.LutSource(tables, bias_t, per_query), slot, p=p,
                          s_pad=s_pad, rows=ng * q_cap, packed=packed)
    tab, sl = tables.numpy(), slot.numpy()
    want = np.zeros((ng * q_cap, s_pad, c), np.float32)
    for i in range(b * p):
        row = np.zeros((s_pad, c), np.float32)
        row[:s] = tab[i // p if per_query else i]
        if bias:
            row[0] += np.float32(bias_t.numpy().reshape(-1)[i])
        order = (list(range(0, s_pad, 2)) + list(range(1, s_pad, 2))
                 if packed else list(range(s_pad)))
        want[sl[i]] = row[order]
    want_bf16 = torch.from_numpy(want.reshape(ng * q_cap, -1)).bfloat16()
    assert torch.equal(_bits(got), _bits(want_bf16))


@pytest.mark.parametrize("q_cap", [1, 8])
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("measure", [DistanceMeasure.DOT_PRODUCT,
                                     DistanceMeasure.SQUARED_L2])
def test_leaf_scores_same_from_source_and_expansion(measure, packed, q_cap):
    """``leaf_scores_grouped`` gives bit-identical flat scores fed the
    source or the flat expansion, and the expansion's scores are those of
    the grouped scorer over the composition's rows."""
    s, s_pad, l_tile = 50, 64, 128
    queries, centers, codebook, parts = _problem(11 + packed + q_cap, s=s)
    gen = torch.Generator().manual_seed(5)
    sizes = torch.randint(1, 2 * l_tile + 1, (K,), generator=gen)
    sizes[0] = 2 * l_tile
    aligned = (sizes + 127) // 128 * 128
    offsets = (torch.cumsum(aligned, 0) - aligned).int()
    l_cap = 2 * l_tile
    n_csr = int(aligned.sum()) + l_cap
    codes = torch.randint(0, C, (s_pad, n_csr), generator=gen,
                          dtype=torch.uint8)
    codes[s:] = 0
    if packed:
        codes = codes[0::2] | (codes[1::2] << 4)
    kw = dict(use_residuals=True, measure=measure)
    src = tx._lut_source(queries, centers, parts, codebook, **kw)
    flat = tx._residual_luts(queries, centers, parts, codebook, s_pad=s_pad,
                             **kw)
    skw = dict(p=P, l_cap=l_cap, q_cap=q_cap, l_tile=l_tile, packed=packed)
    from_src = tx.leaf_scores_grouped(src, parts, codes, offsets, sizes.int(),
                                      **skw)
    from_flat = tx.leaf_scores_grouped(flat, parts, codes, offsets,
                                       sizes.int(), **skw)
    assert from_src.dtype == torch.bfloat16
    assert from_src.shape == (B, P * l_cap)
    assert torch.equal(_bits(from_src), _bits(from_flat))
    grp_part, slot, ng = group_pairs_by_partition(parts, K, q_cap)
    safe = grp_part.clamp_min(0)
    composed = tx.tree_ah_grouped_scores(
        _composed_group(flat, slot, rows=ng * q_cap, s_pad=s_pad,
                        packed=packed), codes, offsets[safe],
        torch.where(grp_part >= 0, sizes[safe], 0).int(), l_cap=l_cap,
        l_tile=l_tile, q_cap=q_cap, packed=packed)
    want = tx._leaf_major(composed, slot, b=B, p=P, l_cap=l_cap)
    assert torch.equal(_bits(from_src), _bits(want))


@pytest.mark.parametrize("case", ["slot shape", "S past S_pad",
                                  "odd S_pad packed", "per-pair rows",
                                  "bias shape", "per-pair bias"])
def test_grouped_tables_reject_bad_arguments(case):
    """Shapes the kernel cannot take raise on the CPU too."""
    b, p, s, c = 3, 2, 4, 16
    tables = torch.randn(b, s, c)
    slot = torch.arange(b * p)
    kw = dict(p=p, s_pad=s, rows=b * p, packed=True)
    src = gl.LutSource(tables, None, True)
    if case == "slot shape":
        slot = slot[:-1]
    elif case == "S past S_pad":
        kw["s_pad"] = s - 2
    elif case == "odd S_pad packed":
        src = gl.LutSource(torch.randn(b, 3, c), None, True)
        kw["s_pad"] = 3
    elif case == "per-pair rows":
        src = gl.LutSource(torch.randn(b * p + 1, s, c), None, False)
    elif case == "per-pair bias":
        src = gl.LutSource(torch.randn(b * p, s, c), torch.randn(b, p), False)
    else:
        src = gl.LutSource(tables, torch.randn(b, p + 1), True)
    with pytest.raises(ValueError):
        gl.grouped_luts(src, slot, **kw)
