"""Host-side readers of Spaceranger outputs, and the unified count caches."""

from gridnext_tpu_torch.io.spaceranger import (Positions, cohort_hd_lattice_dims,
                                               find_feature_matrix_files,
                                               find_position_file, hd_lattice_dims,
                                               read_feature_matrix, read_feature_names,
                                               read_positions, read_positions_file)
from gridnext_tpu_torch.io.unify import (prepare_count_files, unified_cache_path,
                                         unified_count_suffix)

__all__ = ["Positions", "cohort_hd_lattice_dims", "find_feature_matrix_files",
           "find_position_file", "hd_lattice_dims", "prepare_count_files",
           "read_feature_matrix", "read_feature_names", "read_positions",
           "read_positions_file", "unified_cache_path", "unified_count_suffix"]
