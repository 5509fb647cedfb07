"""The dataset API of the PyTorch port against the JAX package on the CPU:
``DenseDataset`` (constructors, accessors, ``append``, the device cache,
memory) and ``Datapoint`` give the same answers and raise the same error
codes. The port's device tensor is exactly [N, D]: the JAX package pads
rows for the TPU's sublanes, which the card does not need."""

import numpy as np
import pytest
import torch

from scann_tpu.data.dataset import Datapoint as JaxDatapoint
from scann_tpu.data.dataset import DenseDataset as JaxDataset
from scann_tpu.errors import ScannError as JaxError
from scann_tpu_torch.data.dataset import Datapoint, DenseDataset
from scann_tpu_torch.errors import ScannError
from torch_threads import one_torch_thread  # noqa: F401


def _x(n=12, d=5, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _same_dataset(port, ref):
    assert len(port) == len(ref) and port.size == ref.size
    assert port.dimensionality == ref.dimensionality
    assert port.is_empty == ref.is_empty
    assert port.dtype == ref.dtype
    np.testing.assert_array_equal(port.numpy(), ref.numpy())
    assert port.memory_usage_bytes() == ref.memory_usage_bytes()
    if ref.docids is None:
        assert port.docids is None
    else:
        assert port.docids.to_list() == ref.docids.to_list()
    for i in range(ref.size):
        np.testing.assert_array_equal(port.get(i), ref.get(i))
        np.testing.assert_array_equal(port[i], ref[i])


def _same_error(port_call, jax_call, code):
    with pytest.raises(JaxError) as want:
        jax_call()
    with pytest.raises(ScannError) as got:
        port_call()
    assert got.value.code.value == want.value.code.value == code


@pytest.mark.parametrize("docids", [None, "str", "int"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_constructors_match_jax(docids, dtype):
    x = _x()
    ids = (None if docids is None else
           [f"d{i}" for i in range(len(x))] if docids == "str" else
           list(range(100, 100 + len(x))))
    _same_dataset(DenseDataset(x, docids=ids, dtype=dtype),
                  JaxDataset(x, docids=ids, dtype=dtype))
    _same_dataset(DenseDataset.from_vecs(x.tolist(), docids=ids, dtype=dtype),
                  JaxDataset.from_vecs(x.tolist(), docids=ids, dtype=dtype))
    _same_dataset(
        DenseDataset.from_flat(x.reshape(-1), 5, docids=ids, dtype=dtype),
        JaxDataset.from_flat(x.reshape(-1), 5, docids=ids, dtype=dtype))


@pytest.mark.parametrize("d", [1, 7])
def test_empty_matches_jax(d):
    port, ref = DenseDataset.empty(d), JaxDataset.empty(d)
    _same_dataset(port, ref)
    t, n = port.device("cpu")
    assert n == 0 and tuple(t.shape) == (0, d)


@pytest.mark.parametrize("case", [
    "not_2d", "docid_count", "from_flat_dim", "from_flat_zero", "get_neg",
    "get_past", "append_shape", "append_dup_docid"])
def test_errors_match_jax(case):
    x = _x()
    ids = [f"d{i}" for i in range(len(x))]
    calls = {
        "not_2d": (lambda m: m(x[0]), "INVALID_ARGUMENT"),
        "docid_count": (lambda m: m(x, docids=ids[:-1]), "INVALID_ARGUMENT"),
        "from_flat_dim": (lambda m: m.from_flat(x.reshape(-1)[:-1], 5),
                          "INVALID_ARGUMENT"),
        "from_flat_zero": (lambda m: m.from_flat(x.reshape(-1), 0),
                           "INVALID_ARGUMENT"),
        "get_neg": (lambda m: m(x).get(-1), "OUT_OF_RANGE"),
        "get_past": (lambda m: m(x)[len(x)], "OUT_OF_RANGE"),
        "append_shape": (lambda m: m(x).append(np.zeros(4)),
                         "INVALID_ARGUMENT"),
        "append_dup_docid": (lambda m: m(x, docids=ids).append(
            np.zeros(5), docid="d3"), "ALREADY_EXISTS"),
    }
    call, code = calls[case]
    _same_error(lambda: call(DenseDataset), lambda: call(JaxDataset), code)


@pytest.mark.parametrize("with_docids", [False, True])
def test_append_matches_jax_and_drops_the_device_cache(with_docids):
    x = _x()
    ids = [f"d{i}" for i in range(len(x))] if with_docids else None
    port, ref = DenseDataset(x, docids=ids), JaxDataset(x, docids=ids)
    t, n = port.device("cpu")
    assert n == len(x) and t.shape == (len(x), 5)
    assert port.device("cpu")[0] is t          # cached
    rng = np.random.default_rng(1)
    for j in range(3):
        p = rng.normal(size=5)
        docid = f"new{j}" if with_docids or j == 2 else None
        assert port.append(p, docid=docid) == ref.append(p, docid=docid)
        _same_dataset(port, ref)
    t2, n2 = port.device("cpu")
    assert t2 is not t and n2 == len(x) + 3
    np.testing.assert_array_equal(t2.numpy(), port.numpy())


def test_device_tensor_is_exact_and_cached():
    x = _x(10, 3)
    ds = DenseDataset(x)
    t, n = ds.device("cpu")
    assert n == 10 and t.dtype == torch.float32
    np.testing.assert_array_equal(t.numpy(), x)       # no padding rows
    assert ds.device_tensor("cpu") is t
    ds.drop_device_cache()
    t2, _ = ds.device("cpu")
    assert t2 is not t
    np.testing.assert_array_equal(t2.numpy(), x)


def test_device_refuses_a_missing_card(monkeypatch):
    """The default device is the card; without one ``device()`` raises
    instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = DenseDataset(_x())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ds.device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ds.device("cuda")


DATAPOINTS = {
    "dense": lambda m: m.dense([3.0, 0.0, -4.0]),
    "sparse": lambda m: m.sparse([1, 4, 6], [2.0, -1.0, 0.5], 8),
    "sparse_unsorted": lambda m: m.sparse([6, 1, 4], [0.5, 2.0, -1.0]),
    "sparse_empty": lambda m: m.sparse([], []),
    "zero": lambda m: m.dense([0.0, 0.0]),
}


@pytest.mark.parametrize("name", list(DATAPOINTS))
def test_datapoint_matches_jax(name):
    port, ref = DATAPOINTS[name](Datapoint), DATAPOINTS[name](JaxDatapoint)
    assert port.is_dense == ref.is_dense and port.is_sparse == ref.is_sparse
    assert port.dimensionality == ref.dimensionality
    np.testing.assert_array_equal(port.values, ref.values)
    if ref.indices is None:
        assert port.indices is None
    else:
        np.testing.assert_array_equal(port.indices, ref.indices)
    for dim in range(ref.dimensionality):
        assert port.get(dim) == ref.get(dim)
    np.testing.assert_array_equal(port.to_dense().values,
                                  ref.to_dense().values)
    assert port.squared_l2_norm() == ref.squared_l2_norm()
    assert port.l2_norm() == ref.l2_norm()
    pn, rn = port.normalize(), ref.normalize()
    np.testing.assert_array_equal(pn.values, rn.values)
    assert pn.dimensionality == rn.dimensionality


def test_datapoint_length_mismatch_matches_jax():
    _same_error(lambda: Datapoint.sparse([1, 2], [1.0]),
                lambda: JaxDatapoint.sparse([1, 2], [1.0]),
                "INVALID_ARGUMENT")
