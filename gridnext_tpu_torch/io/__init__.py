"""Host-side readers of Spaceranger outputs, the unified count caches, and the
slide readers (JPEG, TIFF, PNG) that need no PIL."""

from gridnext_tpu_torch.io.jpeg import decode_jpeg, jpeg_info
from gridnext_tpu_torch.io.png import decode_png, png_info
from gridnext_tpu_torch.io.spaceranger import (Positions, cohort_hd_lattice_dims,
                                               coord_string, find_feature_matrix_files,
                                               find_position_file, hd_lattice_dims,
                                               positions_to_coord_strings,
                                               read_feature_matrix, read_feature_names,
                                               read_positions, read_positions_file)
from gridnext_tpu_torch.io.tiff import decode_tiff, tiff_info
from gridnext_tpu_torch.io.unify import (prepare_count_files, unified_cache_path,
                                         unified_count_suffix)

__all__ = ["Positions", "cohort_hd_lattice_dims", "coord_string", "decode_jpeg", "decode_png",
           "decode_tiff", "find_feature_matrix_files", "find_position_file", "hd_lattice_dims",
           "jpeg_info", "png_info", "positions_to_coord_strings", "prepare_count_files",
           "read_feature_matrix", "read_feature_names", "read_positions",
           "read_positions_file", "tiff_info", "unified_cache_path", "unified_count_suffix"]
