"""Datasets of the port, and the Spaceranger-shaped fixtures of ``simulate``."""

from gridnext_tpu_torch.data.datasets import (CountGridDataset, CountSpotDataset,
                                              MMSpotDataset, MMStackDataset,
                                              PatchGridDataset, PatchSpotDataset,
                                              SlideGridDataset, SlideSpotDataset, Subset,
                                              create_visium_dataset, load_count_dataset,
                                              load_count_grid_dataset)
from gridnext_tpu_torch.data.dense_ingest import DenseWSIGridDataset
from gridnext_tpu_torch.data.simulate import (lattice_positions, pseudo_visium_from_image,
                                              simulate_spaceranger_dir)

__all__ = ["CountGridDataset", "CountSpotDataset", "DenseWSIGridDataset", "MMSpotDataset",
           "MMStackDataset", "PatchGridDataset", "PatchSpotDataset", "SlideGridDataset", "SlideSpotDataset", "Subset",
           "create_visium_dataset", "lattice_positions", "load_count_dataset",
           "load_count_grid_dataset", "pseudo_visium_from_image", "simulate_spaceranger_dir"]
