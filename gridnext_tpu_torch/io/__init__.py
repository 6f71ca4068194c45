"""Host-side readers of Spaceranger outputs."""

from gridnext_tpu_torch.io.spaceranger import (Positions, cohort_hd_lattice_dims,
                                               find_feature_matrix_files,
                                               find_position_file, hd_lattice_dims,
                                               read_feature_matrix, read_feature_names,
                                               read_positions, read_positions_file)

__all__ = ["Positions", "cohort_hd_lattice_dims", "find_feature_matrix_files",
           "find_position_file", "hd_lattice_dims", "read_feature_matrix",
           "read_feature_names", "read_positions", "read_positions_file"]
