"""Host-side readers of Spaceranger outputs."""

from gridnext_tpu_torch.io.spaceranger import (Positions, find_position_file,
                                               read_positions,
                                               read_positions_file)

__all__ = ["Positions", "find_position_file", "read_positions",
           "read_positions_file"]
