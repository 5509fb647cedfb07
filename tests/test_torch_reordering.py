"""Re-rank stores of the PyTorch port (``utils/reordering.py``) against the
JAX package's: codec statistics and code bytes, the stores' bytes on the
device, the id-embedded CSR store and the gathers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scann_tpu.utils import reordering as jr
from scann_tpu_torch.utils import reordering as pr


def _data(seed=0, n=500, d=12, k=6):
    rng = np.random.default_rng(seed)
    centers = (rng.normal(size=(k, d)) * 4).astype(np.float32)
    tokens = rng.integers(0, k, size=n).astype(np.int32)
    x = (centers[tokens] + rng.normal(size=(n, d))).astype(np.float32)
    x[0, 0] = 40.0                      # an outlier past the 4-sigma clip
    return x, tokens, centers


def _as_u(x: torch.Tensor) -> np.ndarray:
    """A port store's codes as the JAX package's numpy codes (int16 stores
    hold uint16 - 32768; bf16 compares by its bits)."""
    if x.dtype == torch.int16:
        return (x.numpy().astype(np.int32) + 32768).astype(np.uint16)
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint16)
    return x.numpy()


def _jax_u(x) -> np.ndarray:
    """A JAX store as numpy, bf16 as its bits."""
    x = np.asarray(x)
    return x.view(np.uint16) if str(x.dtype) == "bfloat16" else x


def test_rerank_codec_bytes_match_jax():
    x, _, _ = _data()
    _, enc_j, (sc_j, mn_j) = jr.rerank_codec(x, 400, "int8")
    dt, enc_p, (sc_p, mn_p) = pr.rerank_codec(x, 400, "int8")
    assert dt == torch.uint8
    np.testing.assert_array_equal(sc_p, sc_j)
    np.testing.assert_array_equal(mn_p, mn_j)
    np.testing.assert_array_equal(enc_p(x), enc_j(x))
    _, enc_j, _ = jr.rerank_codec(x, 400, "bfloat16")
    _, enc_p, _ = pr.rerank_codec(x, 400, "bfloat16")
    np.testing.assert_array_equal(_as_u(enc_p(x)), _jax_u(enc_j(x)))
    with pytest.raises(ValueError):
        pr.rerank_codec(x, 400, "float16")


@pytest.mark.parametrize("levels", [255, 65535])
def test_residual_codec_matches_jax(levels):
    """Float64 statistics, the 4-sigma clip intersected with min/max:
    (scale, mn) equal, codes equal."""
    x, tokens, centers = _data(1)
    enc_j, (sc_j, mn_j) = jr.residual_rerank_codec(x, len(x), tokens,
                                                   centers, levels=levels)
    enc_p, (sc_p, mn_p) = pr.residual_rerank_codec(x, len(x), tokens,
                                                   centers, levels=levels)
    np.testing.assert_array_equal(sc_p, sc_j)
    np.testing.assert_array_equal(mn_p, mn_j)
    codes = enc_p(x, tokens)
    np.testing.assert_array_equal(codes, enc_j(x, tokens))
    assert codes.dtype == (np.uint8 if levels == 255 else np.uint16)
    assert codes[0, 0] == levels          # the outlier saturates


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_build_rerank_store_matches_jax(dtype):
    x, _, _ = _data(2)
    want, want_n = jr.build_rerank_store(x, 480, dtype, 8)
    got, got_n = pr.build_rerank_store(x, 480, dtype, 8, "cpu")
    if dtype == "int8":
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_as_u(g), np.asarray(w))
    else:
        np.testing.assert_array_equal(_as_u(got), _jax_u(want))
    assert pr.rerank_store_rows(got) == jr.rerank_store_rows(want) == 480
    np.testing.assert_allclose(got_n.numpy(), np.asarray(want_n), rtol=1e-5)
    with pytest.raises(ValueError):
        pr.build_rerank_store(x, 480, "float32", 8, "cpu")


@pytest.mark.parametrize("levels", [255, 65535])
def test_build_residual_rerank_store_matches_jax(levels):
    x, tokens, centers = _data(3)
    want, want_n = jr.build_residual_rerank_store(x, len(x), tokens, centers,
                                                  8, levels=levels)
    got, got_n = pr.build_residual_rerank_store(x, len(x), tokens, centers, 8,
                                                "cpu", levels=levels)
    assert len(got) == len(want) == 5
    np.testing.assert_array_equal(_as_u(got[0]), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(got_n.numpy(), np.asarray(want_n), rtol=1e-5)
    idx = np.random.default_rng(0).integers(0, len(x), size=(4, 30))
    np.testing.assert_array_equal(
        pr.gather_rerank_rows(got, torch.from_numpy(idx)).numpy(),
        np.asarray(jr.gather_rerank_rows(want, jnp.asarray(idx))))


def _csr_layout(tokens, extra, k):
    """perm and row partitions of an aligned CSR layout (starts at
    multiples of 8, gap rows id 0) with secondary assignments ``extra``."""
    pts = np.concatenate([np.arange(len(tokens)), extra[:, 0]])
    toks = np.concatenate([tokens, extra[:, 1]])
    order = np.argsort(toks, kind="stable")
    sizes = np.bincount(toks, minlength=k)
    starts = np.zeros(k + 1, np.int64)
    starts[1:] = np.cumsum((sizes + 7) // 8 * 8)
    perm = np.zeros(starts[-1] + 16, np.int32)
    parts = np.zeros_like(perm)
    off = 0
    for t in range(k):
        perm[starts[t]:starts[t] + sizes[t]] = pts[order[off:off + sizes[t]]]
        parts[starts[t]:starts[t] + sizes[t]] = t
        off += sizes[t]
    return perm, parts


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "int16"])
def test_csr_store_and_gather_match_jax(dtype):
    """The id-embedded CSR store over a spilled layout: bytes equal (the
    anchored codecs calibrated on the PRIMARY tokens' residuals, each CSR
    row encoded against its own partition, so secondary copies may
    saturate); the gather returns the JAX rows and ids."""
    x, tokens, centers = _data(4)
    rng = np.random.default_rng(4)
    extra = np.stack([np.arange(len(x)), (tokens + 1 + rng.integers(
        0, 5, len(x))) % len(centers)], axis=1)
    perm, parts = _csr_layout(tokens, extra, len(centers))
    kw = {}
    if dtype in ("int8", "int16"):
        kw = dict(row_parts=parts, tokens=tokens, centers=centers)
    want = jr.build_csr_rerank_store(x, perm, dtype, **kw)
    got = pr.build_csr_rerank_store(x, perm, dtype, "cpu", **kw)
    if kw:
        np.testing.assert_array_equal(_as_u(got[0]), np.asarray(want[0]))
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        _, (sc, mn) = pr.residual_rerank_codec(
            x, len(x), tokens, centers, levels=255 if dtype == "int8"
            else 65535)
        np.testing.assert_array_equal(got[1].numpy(), sc)
        levels = 255 if dtype == "int8" else 65535
        sat = (_as_u(got[0])[:, :x.shape[1]] == levels) | \
            (_as_u(got[0])[:, :x.shape[1]] == 0)
        secondary = parts != tokens[perm]
        assert sat[secondary].mean() > sat[~secondary].mean()
    else:
        np.testing.assert_array_equal(_as_u(got), _jax_u(want))
    rows_idx = rng.integers(0, len(perm), size=(3, 25))
    g_rows, g_ids = pr.gather_csr_rerank_rows(got, torch.from_numpy(rows_idx),
                                              x.shape[1])
    w_rows, w_ids = jr.gather_csr_rerank_rows(want, jnp.asarray(rows_idx),
                                              x.shape[1])
    np.testing.assert_array_equal(g_rows.numpy(), np.asarray(w_rows))
    np.testing.assert_array_equal(g_ids.numpy(), np.asarray(w_ids))
    np.testing.assert_array_equal(g_ids.numpy(), perm[rows_idx])


def test_gather_rows_of_every_store_match_jax():
    x, _, _ = _data(5)
    idx = np.random.default_rng(1).integers(0, 300, size=(2, 40))
    for dtype in ("bfloat16", "int8"):
        want, _ = jr.build_rerank_store(x, 300, dtype, 8)
        got, _ = pr.build_rerank_store(x, 300, dtype, 8, "cpu")
        np.testing.assert_array_equal(
            pr.gather_rerank_rows(got, torch.from_numpy(idx)).numpy(),
            np.asarray(jr.gather_rerank_rows(want, jnp.asarray(idx))))
    plain = torch.from_numpy(x)
    np.testing.assert_array_equal(
        pr.gather_rerank_rows(plain, torch.from_numpy(idx)).numpy(), x[idx])
    assert pr.rerank_store_bytes(plain) == x.nbytes


@pytest.mark.parametrize("form", [
    "id-float32", "id-bfloat16", "id-int8", "id-anchored", "row",
    "csr", "csr-anchored"])
def test_gather_candidates_takes_each_store_forms_gather(form):
    """The one gather of the exact re-rank returns what each store form's
    own gather returns: by point id from an id-order store (float32, bf16,
    int8, anchored), by CSR row from a store in local CSR order (a shard's),
    by CSR row from the id-embedded store with its ids decoded and, when
    anchored, each slot's partition centroid added back."""
    x, tokens, centers = _data(6)
    rng = np.random.default_rng(6)
    extra = np.stack([np.arange(len(x)), (tokens + 1) % len(centers)], 1)
    perm, parts = _csr_layout(tokens, extra, len(centers))
    rows = torch.from_numpy(rng.integers(0, len(perm), size=(3, 20)))
    ids = torch.from_numpy(perm.astype(np.int64))[rows]
    ids[0, :3] = -1                     # a dedup's fill: missing slots
    slot = torch.from_numpy(centers[parts])[rows]
    kind, _, dtype = form.partition("-")
    if kind == "id":
        if dtype == "float32":
            store = torch.from_numpy(x)
        elif dtype == "anchored":
            store, _ = pr.build_residual_rerank_store(x, len(x), tokens,
                                                      centers, 8, "cpu")
        else:
            store, _ = pr.build_rerank_store(x, len(x), dtype, 8, "cpu")
        want = pr.gather_rerank_rows(store, ids.clamp_min(0)), ids
    elif kind == "row":
        store = torch.from_numpy(x[perm])
        want = pr.gather_rerank_rows(store, rows), ids
        np.testing.assert_array_equal(want[0].numpy(), x[perm][rows.numpy()])
    else:
        kw = dict(row_parts=parts, tokens=tokens, centers=centers) \
            if dtype else {}
        store = pr.build_csr_rerank_store(x, perm, "int8" if dtype
                                          else "float32", "cpu", **kw)
        w_rows, w_ids = pr.gather_csr_rerank_rows(store, rows, x.shape[1])
        want = (w_rows + slot if dtype else w_rows), w_ids
        np.testing.assert_array_equal(w_ids.numpy(), perm[rows.numpy()])
        ids = None                      # the store's lanes hold them
    got = pr.gather_candidates(store, rows, ids, order=kind,
                               slot_centers=lambda: slot)
    assert got[0].dtype == torch.float32
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
