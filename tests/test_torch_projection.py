"""Projections and linear algebra of the PyTorch port against the JAX
package on the CPU.

Projections with carried state (a JAX object's matrix, rotation or PCA
fields through ``from_numpy``) project and invert to 1e-5; ``fit_pca``
components agree up to a sign a row and variances to 1e-4 relative; OPQ
trained from the same initial rotation agrees to 1e-4. The port's own
draws (a ``torch.Generator``, which the JAX package's ``jax.random`` draws
cannot repeat) are tested by their properties. The float64 host helpers
are equal.
"""

import numpy as np
import pytest
import torch

import scann_tpu.projection as jp
import scann_tpu.projection.opq as jax_opq
import scann_tpu.utils.linear_algebra as jla
import scann_tpu_torch.projection as tp
import scann_tpu_torch.projection.opq as torch_opq
import scann_tpu_torch.utils.linear_algebra as tla
from scann_tpu.errors import ScannError as JaxError
from scann_tpu_torch.errors import ScannError
from torch_threads import one_torch_thread  # noqa: F401

ATOL = 1e-5


def _x(n=200, d=16, seed=0):
    rng = np.random.default_rng(seed)
    scale = np.linspace(3.0, 0.2, d).astype(np.float32)
    return (rng.normal(size=(n, d)) * scale).astype(np.float32)


def _close(got, want, atol=ATOL):
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol)


def _same_error(port_call, jax_call):
    with pytest.raises(JaxError) as want:
        jax_call()
    with pytest.raises(ScannError) as got:
        port_call()
    assert got.value.code.value == want.value.code.value


def test_identity_matches_jax():
    x = _x(4, 6)
    j, t = jp.IdentityProjection(6), tp.IdentityProjection(6, device="cpu")
    _close(t.project(x), j.project(x))
    _close(t.inverse_project(x), j.inverse_project(x))
    assert (t.input_dim, t.output_dim) == (j.input_dim, j.output_dim)
    assert t.is_trainable == j.is_trainable
    _same_error(lambda: t.project(_x(2, 5)), lambda: j.project(_x(2, 5)))


@pytest.mark.parametrize("out", [None, 5])
def test_random_orthogonal_carried_matches_jax(out):
    x = _x(30, 12)
    j = jp.RandomOrthogonalProjection(12, out, seed=3)
    t = tp.RandomOrthogonalProjection.from_numpy(j.matrix, device="cpu")
    assert (t.input_dim, t.output_dim) == (j.input_dim, j.output_dim)
    _close(t.project(x), j.project(x))
    y = j.project(x)
    _close(t.inverse_project(y), j.inverse_project(y))


def test_random_gaussian_carried_matches_jax():
    x = _x(30, 16)
    j = jp.RandomGaussianProjection(16, 6, seed=0)
    t = tp.RandomGaussianProjection.from_numpy(j.matrix, device="cpu")
    assert (t.input_dim, t.output_dim) == (16, 6)
    _close(t.project(x), j.project(x))
    assert t.inverse_project(x) is None and j.inverse_project(x) is None


def test_own_random_orthogonal_draws_by_their_properties():
    q = tla.random_orthogonal_matrix(24, seed=1, device="cpu")
    assert q.shape == (24, 24) and q.dtype == torch.float32
    np.testing.assert_allclose((q @ q.T).numpy(), np.eye(24), atol=1e-5)
    assert torch.equal(q, tla.random_orthogonal_matrix(24, 1, device="cpu"))
    assert not torch.allclose(q, tla.random_orthogonal_matrix(
        24, 2, device="cpu"))
    p = tp.RandomOrthogonalProjection(24, 10, seed=1, device="cpu")
    assert torch.equal(p.matrix, q[:10])
    x = _x(40, 24)
    full = tp.RandomOrthogonalProjection(24, device="cpu")
    y = full.project(x)
    np.testing.assert_allclose(((y[:1] - y) ** 2).sum(-1).numpy(),
                               ((x[:1] - x) ** 2).sum(-1), rtol=1e-4)
    _close(full.inverse_project(y), x, atol=1e-4)


def test_own_random_gaussian_draws_by_their_properties():
    p = tp.RandomGaussianProjection(256, 64, seed=0, device="cpu")
    m = p.matrix.numpy()
    assert m.shape == (64, 256)
    # entries N(0, 1/64): mean and spread of 16,384 draws
    assert abs(m.mean()) < 4 / np.sqrt(m.size) / 8
    assert abs(m.std() * 8 - 1.0) < 0.03
    assert torch.equal(p.matrix, tp.RandomGaussianProjection(
        256, 64, seed=0, device="cpu").matrix)
    # squared norms kept in expectation (JL): within 3 standard deviations
    x = np.random.default_rng(0).normal(size=(500, 256)).astype(np.float32)
    ratio = (p.project(x) ** 2).sum(-1).numpy() / (x ** 2).sum(-1)
    assert abs(ratio.mean() - 1.0) < 3 * np.sqrt(2 / 64) / np.sqrt(500)


def test_fit_pca_matches_jax_up_to_sign():
    x = _x(300, 10)
    want = jla.fit_pca(x, 4)
    got = tla.fit_pca(x, 4, device="cpu")
    comp, ref = got.components.numpy(), np.asarray(want.components)
    signs = np.sign((comp * ref).sum(axis=1))
    np.testing.assert_allclose(comp * signs[:, None], ref, atol=1e-4)
    _close(got.mean, want.mean)
    for a, b in ((got.explained_variance, want.explained_variance),
                 (got.explained_variance_ratio,
                  want.explained_variance_ratio)):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4)
    _same_error(lambda: tla.fit_pca(x, 11, device="cpu"),
                lambda: jla.fit_pca(x, 11))
    _same_error(lambda: tla.fit_pca(x[:1], 2, device="cpu"),
                lambda: jla.fit_pca(x[:1], 2))


def test_pca_projection_trained_and_carried():
    x = _x(300, 10)
    j = jp.PcaProjection(10, 3).train(x)
    t = tp.PcaProjection(10, 3, device="cpu").train(x)
    np.testing.assert_allclose(t.explained_variance_ratio().numpy(),
                               j.explained_variance_ratio(), rtol=1e-4)
    # up to the per-axis sign
    yj, yt = j.project(x), t.project(x).numpy()
    signs = np.sign((yj * yt).sum(axis=0))
    np.testing.assert_allclose(yt * signs, yj, atol=1e-3)
    r = j.result
    c = tp.PcaProjection.from_numpy(r.components, r.mean,
                                    r.explained_variance,
                                    r.explained_variance_ratio, device="cpu")
    assert c.is_trained and (c.input_dim, c.output_dim) == (10, 3)
    _close(c.project(x), j.project(x), atol=1e-4)
    y = j.project(x)
    _close(c.inverse_project(y), j.inverse_project(y), atol=1e-4)
    fresh_t, fresh_j = tp.PcaProjection(10, 3, device="cpu"), \
        jp.PcaProjection(10, 3)
    assert fresh_t.inverse_project(y) is None
    _same_error(lambda: fresh_t.project(x), lambda: fresh_j.project(x))
    _same_error(lambda: fresh_t.explained_variance_ratio(),
                lambda: fresh_j.explained_variance_ratio())
    _same_error(lambda: fresh_t.train(x[:, :9]),
                lambda: fresh_j.train(x[:, :9]))


def test_opq_from_a_carried_rotation_matches_jax():
    x = _x(300, 16)
    cfg = dict(dim=16, num_subspaces=4, num_iterations=3, seed=0)
    start = jla.random_orthogonal_matrix(16, 0)
    j = jp.OpqProjection(jp.OpqConfig(**cfg)).train(x)
    t = tp.OpqProjection(tp.OpqConfig(**cfg), device="cpu").train(
        x, initial_rotation=start)
    _close(t.rotation, j.rotation, atol=1e-4)
    carried = tp.OpqProjection.from_numpy(j.rotation, device="cpu")
    _close(carried.project(x), j.project(x))
    y = j.project(x)
    _close(carried.inverse_project(y), j.inverse_project(y))
    # the port's own start: still a rotation
    own = tp.OpqProjection(tp.OpqConfig(**cfg), device="cpu").train(x)
    r = own.rotation.numpy()
    np.testing.assert_allclose(r @ r.T, np.eye(16), atol=1e-4)
    assert own.is_trained and own.is_trainable


def test_opq_keeps_the_product_when_gram_schmidt_loses_rank(monkeypatch):
    """When Gram–Schmidt returns fewer rows, both packages keep the
    un-orthonormalized product of the rotation and the block eigenvectors."""
    x = _x(200, 8)
    cfg = dict(dim=8, num_subspaces=2, num_iterations=2, seed=0)
    monkeypatch.setattr(jax_opq, "gram_schmidt",
                        lambda v: jla.gram_schmidt(v)[:-1])
    monkeypatch.setattr(torch_opq, "gram_schmidt",
                        lambda v: tla.gram_schmidt(v)[:-1])
    j = jp.OpqProjection(jp.OpqConfig(**cfg)).train(x)
    t = tp.OpqProjection(tp.OpqConfig(**cfg), device="cpu").train(
        x, initial_rotation=jla.random_orthogonal_matrix(8, 0))
    assert t.rotation.shape == (8, 8)
    _close(t.rotation, j.rotation, atol=1e-4)


def test_opq_errors_match_jax():
    x = _x(50, 16)
    for cfg, data in ((dict(dim=16), x[:0]), (dict(dim=12), x),
                      (dict(dim=16, num_subspaces=5), x)):
        _same_error(
            lambda: tp.OpqProjection(tp.OpqConfig(**cfg),
                                     device="cpu").train(data),
            lambda: jp.OpqProjection(jp.OpqConfig(**cfg)).train(data))
    fresh_t = tp.OpqProjection(tp.OpqConfig(dim=16), device="cpu")
    fresh_j = jp.OpqProjection(jp.OpqConfig(dim=16))
    _same_error(lambda: fresh_t.project(x), lambda: fresh_j.project(x))
    assert fresh_t.inverse_project(x) is None


def test_truncate_matches_jax():
    x = _x(3, 6)
    j = jp.TruncateProjection(6, 3, offset=1)
    t = tp.TruncateProjection(6, 3, offset=1, device="cpu")
    _close(t.project(x), j.project(x))
    y = j.project(x)
    _close(t.inverse_project(y), j.inverse_project(y))
    for args in ((4, 3, 2), (8, 4, -4), (8, 0, 0)):
        _same_error(lambda: tp.TruncateProjection(*args, device="cpu"),
                    lambda: jp.TruncateProjection(*args))


def test_chunking_matches_jax():
    x = _x(4, 12)
    j = jp.ChunkingProjection(jp.ChunkingConfig(input_dim=12, num_chunks=3))
    t = tp.ChunkingProjection(tp.ChunkingConfig(input_dim=12, num_chunks=3),
                              device="cpu")
    assert t.output_dim == j.output_dim == 12
    for a, b in zip(t.chunks(x), j.chunks(x)):
        _close(a, b)
    _close(t.project(x), j.project(x))
    j.set_chunk_projection(1, jp.TruncateProjection(4, 2))
    t.set_chunk_projection(1, tp.TruncateProjection(4, 2, device="cpu"))
    assert t.output_dim == j.output_dim == 10
    _close(t.project(x), j.project(x))
    _same_error(
        lambda: t.set_chunk_projection(0, tp.TruncateProjection(
            5, 2, device="cpu")),
        lambda: j.set_chunk_projection(0, jp.TruncateProjection(5, 2)))
    _same_error(lambda: tp.ChunkingConfig(input_dim=10, num_chunks=3),
                lambda: jp.ChunkingConfig(input_dim=10, num_chunks=3))


def test_chunking_with_projection():
    x = _x(5, 16)
    t = tp.ChunkingProjection(tp.ChunkingConfig(
        input_dim=16, num_chunks=4).with_projection(2), device="cpu")
    j = jp.ChunkingProjection(jp.ChunkingConfig(
        input_dim=16, num_chunks=4).with_projection(2))
    assert t.output_dim == j.output_dim == 8
    assert t.project(x).shape == (5, 8)
    for i, p in enumerate(t.chunk_projections):
        assert torch.equal(p.matrix, tla.random_orthogonal_matrix(
            4, 42 + i, device="cpu")[:2])
    for bad in (0, 5):
        _same_error(
            lambda: tp.ChunkingProjection(tp.ChunkingConfig(
                input_dim=16, num_chunks=4).with_projection(bad),
                device="cpu"),
            lambda: jp.ChunkingProjection(jp.ChunkingConfig(
                input_dim=16, num_chunks=4).with_projection(bad)))


@pytest.mark.parametrize("kind,kwargs", [
    ("identity", dict(dim=4)),
    ("truncate", dict(input_dim=8, output_dim=2)),
    ("random_orthogonal", dict(input_dim=8, output_dim=4)),
    ("random_gaussian", dict(input_dim=8, output_dim=3)),
    ("pca", dict(input_dim=8, output_dim=3)),
    ("opq", dict(dim=8, num_subspaces=2)),
    ("chunking", dict(input_dim=8, num_chunks=2)),
])
def test_factory_matches_jax(kind, kwargs):
    j = jp.ProjectionFactory.create(kind, **kwargs)
    t = tp.ProjectionFactory.create(kind.upper(), device="cpu", **kwargs)
    assert type(t).__name__ == type(j).__name__
    assert (t.input_dim, t.output_dim) == (j.input_dim, j.output_dim)
    assert t.device == torch.device("cpu")


def test_factory_rejects_unknown_kinds_and_expanding_orthogonal():
    _same_error(lambda: tp.ProjectionFactory.create("bogus", device="cpu"),
                lambda: jp.ProjectionFactory.create("bogus"))
    _same_error(lambda: tp.RandomOrthogonalProjection(4, 8, device="cpu"),
                lambda: jp.RandomOrthogonalProjection(4, 8))


def test_host_helpers_equal_jax():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(6, 6)).astype(np.float32)
    a = a + a.T
    for got, want in zip(tla.symmetric_eigen(a), jla.symmetric_eigen(a)):
        np.testing.assert_array_equal(got, want)
    v = rng.normal(size=(4, 7)).astype(np.float32)
    v[3] = 2 * v[0]               # a dependent row is dropped
    np.testing.assert_array_equal(tla.gram_schmidt(v), jla.gram_schmidt(v))
    assert tla.gram_schmidt(v).shape == (3, 7)
    _same_error(lambda: tla.symmetric_eigen(a[:3]),
                lambda: jla.symmetric_eigen(a[:3]))
