"""The parallel tier of the port: meshes over ranks or devices
(:mod:`~gridnext_tpu_torch.parallel.mesh`), one process a card over
``torch.distributed`` (:mod:`~gridnext_tpu_torch.parallel.multihost`) and
the collectives the trainers use
(:mod:`~gridnext_tpu_torch.parallel.collectives`)."""

from gridnext_tpu_torch.parallel.mesh import (Mesh, default_mesh_shape,  # noqa: F401
                                              make_mesh, replicate, shard_grid_batch,
                                              shard_spot_batch, shard_token_batch)
from gridnext_tpu_torch.parallel.multihost import (global_grid_batch,  # noqa: F401
                                                   global_spot_batch, initialize_multihost,
                                                   is_primary, local_shard_indices)
