"""The paper's comparison baselines (§V-A3):

* **AB**    — array-based, uncompressed (serialized numpy partitions);
* **ABC-D/G/Z/L** — array-based + Dictionary/Gzip/Z-Standard/LZMA;
* **HB**    — hash-based, uncompressed (pickled dict partitions);
* **HBC-Z/L** — hash-based + Z-Standard/LZMA.

All stores implement the full :class:`~repro_torch.api.protocol.MappingStore`
protocol (lookup / insert / delete / update / range_lookup / scan /
save / load / ``query()``) — modifications go through an overlay over
the immutable partitions (`repro_torch.baselines.partitioned`) — and charge
decompressed partitions to the same
:class:`~repro_torch.storage.pool.MemoryPool`, so the benchmark comparisons
see identical memory pressure (§V-A5 partition-size tuning applies).

A copy of ``repro.baselines``.  The stores are host code in both
packages (numpy and pickle); they take no ``device`` argument and never
touch CUDA, because the reference gives them no device either.  Their
files are byte-equal to the reference's for the same table, factory and
codec, and open in either package.
"""

from repro_torch.baselines.array_store import ArrayStore  # noqa: F401
from repro_torch.baselines.hash_store import HashStore  # noqa: F401
from repro_torch.baselines.partitioned import PartitionedBaselineStore  # noqa: F401

BASELINE_FACTORIES = {
    "AB": lambda table, pool=None, **kw: ArrayStore.build(table, codec="none", pool=pool, **kw),
    "ABC-D": lambda table, pool=None, **kw: ArrayStore.build(
        table, codec="none", dictionary=True, pool=pool, **kw
    ),
    "ABC-G": lambda table, pool=None, **kw: ArrayStore.build(table, codec="gzip", pool=pool, **kw),
    "ABC-Z": lambda table, pool=None, **kw: ArrayStore.build(table, codec="zstd", pool=pool, **kw),
    "ABC-L": lambda table, pool=None, **kw: ArrayStore.build(table, codec="lzma", pool=pool, **kw),
    "HB": lambda table, pool=None, **kw: HashStore.build(table, codec="none", pool=pool, **kw),
    "HBC-Z": lambda table, pool=None, **kw: HashStore.build(table, codec="zstd", pool=pool, **kw),
    "HBC-L": lambda table, pool=None, **kw: HashStore.build(table, codec="lzma", pool=pool, **kw),
}
