"""Distribution on ``torch.distributed``: the named mesh and its
collectives, sharding rules and block cuts, gradient compression (port of
``repro.distributed`` and the mesh half of ``repro.compat``)."""

from repro_torch.distributed.compression import (CompressionState,
                                                 compressed_psum)
from repro_torch.distributed.shardings import (NamedSharding, P,
                                               PartitionSpec, batch_spec,
                                               make_param_specs, replicate,
                                               shard_batch, sync_grads)

__all__ = [
    "CompressionState",
    "NamedSharding",
    "P",
    "PartitionSpec",
    "batch_spec",
    "compressed_psum",
    "make_param_specs",
    "replicate",
    "shard_batch",
    "sync_grads",
]
