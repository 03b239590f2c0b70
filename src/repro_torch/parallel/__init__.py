"""Mesh parallelism: sharding rules and the serving shard plan
(``sharding``), the collectives of tensor-parallel serving
(``tensor_parallel``) and GPipe pipelining (``pipeline_parallel``)."""
from repro_torch.parallel import sharding
from repro_torch.parallel.pipeline_parallel import (bubble_fraction,
                                                    pipeline_apply)

__all__ = ["sharding", "bubble_fraction", "pipeline_apply"]
