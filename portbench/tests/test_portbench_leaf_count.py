"""The leaf scorer's count against a hand count with no l_cap padding."""

import types

import pytest
import torch

from portbench import peaks, spec, tracing

LEAF = spec.metric_reader("leaf_roofline")


def _module():
    import importlib.util
    path = spec.HERE / "metrics" / "leaf_roofline.py"
    s = importlib.util.spec_from_file_location("leaf_count", path)
    m = importlib.util.module_from_spec(s)
    s.loader.exec_module(m)
    return m


def test_batch_work_by_hand():
    m = _module()
    sizes = torch.tensor([100, 7, 0, 513])
    parts = torch.tensor([[0, 3], [3, 1], [0, 1]])     # B=3, p=2
    s, c = 50, 16
    nbytes, adds = m.batch_work(parts, sizes, s, c)
    pairs = 6
    pair_rows = 100 + 513 + 513 + 7 + 100 + 7
    probed_rows = 100 + 7 + 513                     # partitions 0, 1, 3
    assert nbytes == pairs * s * c * 2 + probed_rows * 25 + pair_rows * 2
    assert adds == pair_rows * s
    # unpacked codes past 16 a subspace: a byte a subspace
    assert m.batch_work(parts, sizes, s, 256)[0] == (
        pairs * s * 256 * 2 + probed_rows * 50 + pair_rows * 2)


@pytest.mark.parametrize("measure", ["DotProduct", "SquaredL2"])
def test_selection_is_the_programs_rule(measure):
    m = _module()
    g = torch.Generator().manual_seed(0)
    centers = torch.randn(20, 8, generator=g)
    q = torch.randn(5, 8, generator=g)
    got = m.selected_partitions({"centers": centers, "p": 4,
                                 "measure": measure}, q)
    if measure == "DotProduct":
        want = torch.topk(q @ centers.T, 4, dim=-1).indices
    else:
        want = torch.topk(torch.cdist(q, centers), 4, dim=-1,
                          largest=False).indices
    assert torch.equal(got.sort(-1).values, want.sort(-1).values)


def test_roofline_share_over_the_traced_kernel_time():
    m = _module()
    centers = torch.eye(4)
    sizes = torch.tensor([1000, 2000, 3000, 4000])
    q = torch.eye(4)[[0, 3]]
    view = {"centers": centers, "sizes": sizes, "subspaces": 50,
            "codes": 16, "p": 2, "measure": "DotProduct"}
    trace = tracing.DeviceTrace(
        window=(0, 10**6), batches=3,
        device=[("tree_ah_grouped_kernel<8,true,false,1>", 0, 2000,
                 "kernel")] * 3, host=[])
    sched = types.SimpleNamespace(batches=[q])
    run = types.SimpleNamespace(trace=trace, index=view, slices=[0, 0, 0],
                                schedule=sched)
    parts = m.selected_partitions(view, q)
    nbytes, adds = m.batch_work(parts, sizes, 50, 16)
    least = peaks.least_s(adds, peaks.PEAK_F32_ADDS_S, nbytes)
    assert LEAF(run) == pytest.approx(100 * 3 * least / 6e-6)
