"""Datasets of the port."""

from gridnext_tpu_torch.data.datasets import (CountGridDataset, CountSpotDataset,
                                              MMStackDataset, SlideGridDataset,
                                              SlideSpotDataset, Subset,
                                              create_visium_dataset)
from gridnext_tpu_torch.data.dense_ingest import DenseWSIGridDataset

__all__ = ["CountGridDataset", "CountSpotDataset", "DenseWSIGridDataset", "MMStackDataset",
           "SlideGridDataset", "SlideSpotDataset", "Subset", "create_visium_dataset"]
