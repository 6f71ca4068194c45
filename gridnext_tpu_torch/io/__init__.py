"""Host-side readers of Spaceranger outputs, and the unified count caches."""

from gridnext_tpu_torch.io.spaceranger import (Positions, cohort_hd_lattice_dims,
                                               coord_string, find_feature_matrix_files,
                                               find_position_file, hd_lattice_dims,
                                               positions_to_coord_strings,
                                               read_feature_matrix, read_feature_names,
                                               read_positions, read_positions_file)
from gridnext_tpu_torch.io.unify import (prepare_count_files, unified_cache_path,
                                         unified_count_suffix)

__all__ = ["Positions", "cohort_hd_lattice_dims", "coord_string", "find_feature_matrix_files",
           "find_position_file", "hd_lattice_dims", "positions_to_coord_strings",
           "prepare_count_files",
           "read_feature_matrix", "read_feature_names", "read_positions",
           "read_positions_file", "unified_cache_path", "unified_count_suffix"]
