"""Datasets of the port."""

from gridnext_tpu_torch.data.datasets import (CountGridDataset, MMStackDataset,
                                              SlideGridDataset, create_visium_dataset)
from gridnext_tpu_torch.data.dense_ingest import DenseWSIGridDataset

__all__ = ["CountGridDataset", "DenseWSIGridDataset", "MMStackDataset",
           "SlideGridDataset", "create_visium_dataset"]
