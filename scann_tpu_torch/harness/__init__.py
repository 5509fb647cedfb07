"""Evaluation harness: ANN-Benchmarks-style runner (build time, QPS,
recall@k), counterpart of ``scann_tpu/harness``.

The names resolve from ``harness.ann_benchmark`` on first use, so that
``python -m scann_tpu_torch.harness.ann_benchmark`` does not find its
module imported already by this package."""

__all__ = [
    "BenchmarkData",
    "BenchmarkReport",
    "average_recall_at_k",
    "generate_synthetic_dataset",
    "load_json_dataset",
    "run_benchmark",
]


def __getattr__(name):
    if name in __all__:
        from scann_tpu_torch.harness import ann_benchmark

        return getattr(ann_benchmark, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
