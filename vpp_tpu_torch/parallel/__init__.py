"""The sharded paths (port of ``vpp_tpu.parallel``) on ``torch.distributed``:
the process mesh and its collectives (``mesh``), column-sharded FAST and
the data-parallel tracker step (``sharded``), and the column-sharded
tracker front end (``sharded_tracker``). ``slam.ba`` and ``slam.pipeline``
take the same mesh for the landmark- and observation-sharded BA."""

from .mesh import make_mesh, shard_batch, shard_image_cols
from .sharded import (halo_exchange_cols, sharded_fast9_score,
                      sharded_tracker_batch_step)

__all__ = ["make_mesh", "shard_batch", "shard_image_cols",
           "halo_exchange_cols", "sharded_fast9_score",
           "sharded_tracker_batch_step"]
