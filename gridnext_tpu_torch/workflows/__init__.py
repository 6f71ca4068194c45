"""Cohort workflows of the port: PCA-reduced counts, highly variable genes
and grouped cross-validation (the JAX package's ``workflows``)."""

from gridnext_tpu_torch.workflows.cv import (CVResult, cross_validate,  # noqa: F401
                                             grouped_partitions, partition_masks)
from gridnext_tpu_torch.workflows.hvg import (highly_variable_genes,  # noqa: F401
                                              select_hvgs_from_count_files)
from gridnext_tpu_torch.workflows.pca import (CountTable, PCAFit,  # noqa: F401
                                              filtered_norm_logcounts, fit_cohort_scaler,
                                              fit_pca, load_pca, n_pcs_for_variance,
                                              pca_transform, preprocess_cohorts,
                                              scale_logcounts)
