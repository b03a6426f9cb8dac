"""Data and tensor parallelism on ``torch.distributed``
(mcan_vqa_tpu/parallel/): the mesh (``mesh.py``) and the sharding rule
with its collectives (``sharding.py``)."""

from mcan_vqa_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, Mesh,
                                              init_distributed, make_mesh)
from mcan_vqa_tpu_torch.parallel.sharding import param_spec, shard_dim

__all__ = ["DATA_AXIS", "MODEL_AXIS", "Mesh", "init_distributed",
           "make_mesh", "param_spec", "shard_dim"]
