"""The generator repeats for a seed and differs across seeds."""

import pytest
import torch

from portbench.datagen import mixture

DATA = {"kind": "gaussian_mixture", "rows": 500, "dim": 12, "clusters": 7,
        "spread": 2.5, "noise": 1.0, "queries": 64, "normalize": False}
CPU = torch.device("cpu")


@pytest.mark.parametrize("seed", [0, 5, 2**31 + 17, 2**40 + 3])
def test_same_seed_same_inputs(seed):
    a, qa = mixture(DATA, seed, CPU)
    b, qb = mixture(DATA, seed, CPU)
    assert torch.equal(a, b) and torch.equal(qa, qb)
    assert a.shape == (500, 12) and qa.shape == (64, 12)
    assert a.dtype == torch.float32


def test_seeds_differ_with_the_same_sizes():
    a, qa = mixture(DATA, 1, CPU)
    b, qb = mixture(DATA, 2, CPU)
    assert a.shape == b.shape and qa.shape == qb.shape
    assert not torch.equal(a, b) and not torch.equal(qa, qb)


def test_normalised_rows_are_unit():
    rows, queries = mixture(dict(DATA, normalize=True), 3, CPU)
    torch.testing.assert_close(rows.norm(dim=1), torch.ones(500))
    torch.testing.assert_close(queries.norm(dim=1), torch.ones(64))
