"""Data containers: dense and sparse datasets and document-id tables."""

from scann_tpu_torch.data.dataset import Datapoint, DenseDataset, SparseDataset
from scann_tpu_torch.data.docid import DocIdCollection

__all__ = ["DenseDataset", "SparseDataset", "Datapoint", "DocIdCollection"]
