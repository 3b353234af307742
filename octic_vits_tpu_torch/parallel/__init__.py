"""Data parallelism and sharding over processes (counterpart of
octic_vits_tpu/parallel/): the ``(data, fsdp)`` device mesh and the batch's
split (``mesh``), JAX's shape rule for sharding a tensor and the FSDP2 and
DDP layouts of modules (``sharding``)."""

from octic_vits_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    FSDP_AXIS,
    batch_sharding,
    create_hybrid_mesh,
    create_mesh,
    replicated,
)
from octic_vits_tpu_torch.parallel.sharding import (
    leaf_partition_spec,
    replicated_tree,
    tree_shardings,
)

__all__ = ["DATA_AXIS", "FSDP_AXIS", "batch_sharding", "create_hybrid_mesh", "create_mesh",
           "replicated", "leaf_partition_spec", "replicated_tree", "tree_shardings"]
