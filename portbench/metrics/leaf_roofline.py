"""leaf_roofline (%, device trace): the least time the batches' leaf
scoring could take on the card over the device time of the grouped leaf
scorer (#1, ``csrc/tree_ah_grouped.cu``, by kernel name) in the traced
window.

The count is this metric's own and takes only what the batch needs, never
the kernel's padding (no ``l_cap`` slots, no pad subspaces, no empty
group slots). Each request's top-p partitions are selected again here in
plain PyTorch from the built index's centres (read-only); then:

- bytes: each real (query, partition) pair's S x C table of bf16 entries
  once, each probed partition's packed codes once (ceil(S / 2) bytes a
  row for C <= 16, S bytes otherwise), one 2-byte score a real (pair,
  row);
- operations: S float32 adds a real (pair, row).

The least time is the larger of bytes over HBM bandwidth and adds over
the float32 add rate (``peaks.py``), summed over the window's requests.
"""

import torch

from portbench.peaks import PEAK_F32_ADDS_S, least_s

KERNEL = "tree_ah_grouped_kernel"
TABLE_ENTRY_BYTES = 2
SCORE_BYTES = 2
_MIPS = ("DotProduct", "GeneralInnerProduct")


def selected_partitions(view, queries):
    """[B, p] partitions each query probes: largest inner product for the
    inner-product measures, nearest centre otherwise."""
    centers = view["centers"].to(queries.device).float()
    dots = queries.float() @ centers.T
    if view["measure"] in _MIPS:
        score = -dots
    else:
        score = (centers * centers).sum(-1) - 2.0 * dots
    return torch.topk(score, view["p"], dim=-1, largest=False).indices


def batch_work(parts, sizes, s, c):
    """(bytes, adds) the leaf scoring of one batch needs."""
    sizes = sizes.to(parts.device).long()
    pair_rows = int(sizes[parts].sum())
    probed_rows = int(sizes[torch.unique(parts)].sum())
    code_bytes = (s + 1) // 2 if c <= 16 else s
    nbytes = (parts.numel() * s * c * TABLE_ENTRY_BYTES
              + probed_rows * code_bytes + pair_rows * SCORE_BYTES)
    return nbytes, pair_rows * s


def read(run):
    t, view = run.trace, run.index
    if t is None or view is None:
        return None
    kernel_s = t.kernel_s(lambda n: KERNEL in n)
    if kernel_s <= 0:
        return None
    least, by_slice = 0.0, {}
    for s in run.slices:
        if s not in by_slice:
            parts = selected_partitions(view, run.schedule.batches[s])
            nbytes, adds = batch_work(parts, view["sizes"],
                                      view["subspaces"], view["codes"])
            by_slice[s] = least_s(adds, PEAK_F32_ADDS_S, nbytes)
        least += by_slice[s]
    return 100.0 * least / kernel_s
