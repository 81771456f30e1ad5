"""Data parallelism: the process-group bootstrap (``dist``) and meshes,
batch shards, collectives and model replicas (``mesh``)."""

from audioset_convnext_inf_torch.parallel.dist import initialize_distributed, is_primary
from audioset_convnext_inf_torch.parallel.mesh import (
    Mesh,
    Replicas,
    batch_sharding,
    get_mesh,
    replicate,
    shard_batch,
)

__all__ = [
    "Mesh",
    "Replicas",
    "batch_sharding",
    "get_mesh",
    "initialize_distributed",
    "is_primary",
    "replicate",
    "shard_batch",
]
