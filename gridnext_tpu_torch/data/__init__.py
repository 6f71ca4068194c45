"""Datasets of the port."""

from gridnext_tpu_torch.data.datasets import CountGridDataset

__all__ = ["CountGridDataset"]
