"""select_ms_per_batch (ms, device trace): device time of the sort and
top-k kernels (the partition selection, the approximate top-pre_k, the
re-rank's top-k, their ordering sorts and the pair grouping's sort) over
the traced requests.

The kernels are PyTorch's, found by these parts of their names."""

SELECT_KERNELS = (
    "topk", "TopK", "radixFindKthValues", "computeBlockwiseWithinKCounts",
    "computeBlockwiseKthCounts", "gatherTopK", "bitonicSort", "RadixSort",
    "radixSort", "sortKeyValueInplace", "SegmentedSort", "segmented_sort",
    "warpMergeSort", "sort_postprocess", "fill_reverse_indices",
)


def is_select(name):
    return any(p in name for p in SELECT_KERNELS)


def read(run):
    t = run.trace
    if t is None or t.batches == 0:
        return None
    secs = t.kernel_s(is_select)
    if secs <= 0:
        return None
    return secs * 1e3 / t.batches
