"""Sharded DeepMapping cluster of the port: a relation range- or
hash-partitioned into K independent
:class:`~repro_torch.core.hybrid.DeepMappingStore` shards behind a
scatter/gather router — parallel build, per-shard lazy retrain, shared
memory pool, directory-of-stores serialization.

It re-exports what ``repro.cluster`` does, less mesh scatter (ROADMAP
item M11).
"""

from repro_torch.cluster.partitioner import (  # noqa: F401
    HashPartitioner,
    Partitioner,
    RangePartitioner,
    make_partitioner,
    plan_range_partitions,
)
from repro_torch.cluster.router import ShardBatch, ShardRouter  # noqa: F401
from repro_torch.cluster.sharded_store import (  # noqa: F401
    ClusterConfig,
    QuarantinedShard,
    ShardedDeepMappingStore,
    load_sharded_store,
    save_sharded_store,
)
