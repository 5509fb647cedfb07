"""The plain reference against NumPy at a tiny size."""

import ast
import pathlib

import numpy as np
import pytest
import torch

from portbench.reference import exact

REF_DIR = pathlib.Path(exact.__file__).parent


def _numpy_scores(measure, q, x):
    if measure == "DotProduct":
        return -(q @ x.T)
    return ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)


@pytest.mark.parametrize("measure", exact.MEASURES)
def test_exact_top_k_matches_numpy_argsort(measure):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((300, 9)).astype(np.float32)
    q = rng.standard_normal((37, 9)).astype(np.float32)
    ids, dists = exact.exact_top_k(torch.from_numpy(x), torch.from_numpy(q),
                                   5, measure, block=16)
    want = _numpy_scores(measure, q.astype(np.float64), x.astype(np.float64))
    order = np.argsort(want, axis=1, kind="stable")[:, :5]
    np.testing.assert_array_equal(ids.numpy(), order)
    np.testing.assert_allclose(dists.numpy(),
                               np.take_along_axis(want, order, 1),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("measure", exact.MEASURES)
def test_distances_of_returned_ids_in_float64(measure):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((50, 6))
    q = rng.standard_normal((4, 6))
    ids = rng.integers(0, 50, (4, 3))
    dist, scale = exact.distances_of(torch.from_numpy(x).float(),
                                     torch.from_numpy(q).float(),
                                     torch.from_numpy(ids), measure)
    xf, qf = x.astype(np.float32).astype(np.float64), \
        q.astype(np.float32).astype(np.float64)
    want = np.take_along_axis(_numpy_scores(measure, qf, xf), ids, 1)
    np.testing.assert_allclose(dist.numpy(), want, rtol=1e-12, atol=1e-12)
    assert dist.dtype == torch.float64 and (scale > 0).all()


def test_reference_imports_nothing_of_the_program():
    for path in REF_DIR.glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                tops = [(node.module or "").split(".")[0]]
            else:
                continue
            for top in tops:
                assert top not in ("jax", "jaxlib", "flax", "scann_tpu",
                                   "scann_tpu_torch"), (path, top)
