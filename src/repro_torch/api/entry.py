"""Top-level entrypoints: ``repro_torch.open(path)`` / ``repro_torch.build(table, ...)``.

The port of ``repro.api.entry``.  ``open`` sniffs the on-disk format in
the reference's order:

* directory with ``manifest.msgpack``  -> sharded cluster
  (:func:`~repro_torch.cluster.sharded_store.load_sharded_store`);
* directory with ``meta.msgpack``      -> single DeepMapping store
  (:func:`~repro_torch.core.serialize.load_store`);
* msgpack file with a ``kind`` header  -> AB/HB baseline store
  (:func:`~repro_torch.baselines.partitioned.load_baseline_store`).

``build`` trains/assembles a store from a
:class:`~repro_torch.core.table.Table`: a single
:class:`~repro_torch.core.hybrid.DeepMappingStore` by default, or a
sharded cluster when a
:class:`~repro_torch.cluster.sharded_store.ClusterConfig` with
``num_shards > 1`` is given.  Both run on the CUDA device unless given
``device=`` (a baseline store is host code and ignores it).  All imports
are lazy so ``import repro_torch`` stays light.
"""

from __future__ import annotations

import os


#: The on-disk formats ``open`` recognizes, in the sniffing order (also
#: the error-message inventory).
SUPPORTED_FORMATS = (
    "sharded cluster: directory containing manifest.msgpack "
    "(ShardedDeepMappingStore.save)",
    "single DeepMapping store: directory containing meta.msgpack "
    "(DeepMappingStore.save)",
    "baseline overlay store: single msgpack file with an "
    "array_store/hash_store 'kind' header (ArrayStore/HashStore.save)",
)


def open(path: str, pool=None, device=None, on_corrupt: str = "raise"):  # noqa: A001 — deliberate builtin shadow inside repro_torch.*
    """Load a saved store, sniffing the on-disk format.

    A **directory** holding ``manifest.msgpack`` is a sharded cluster,
    every shard loaded onto ``device`` (CUDA by default); a directory
    holding ``meta.msgpack`` is a single DeepMapping store, loaded onto
    ``device``.  A **file** is parsed as a baseline msgpack blob and
    dispatched on its ``kind`` header (``array_store``/``hash_store``);
    baselines are host code, so ``device`` does not apply to them.
    Anything else raises a ``ValueError`` (or
    ``FileNotFoundError`` when ``path`` does not exist) that lists the
    supported formats.  ``pool`` is the shared
    :class:`~repro_torch.storage.MemoryPool` to charge decompressed
    partitions to (one is created per store when omitted).

    Every artifact's crc32 recorded at save time is verified — a corrupt
    or truncated artifact raises
    :class:`~repro_torch.fault.errors.IntegrityError` rather than
    decoding into wrong values.  ``on_corrupt`` applies to sharded
    clusters: ``'quarantine'`` degrades a cluster with corrupt shard
    directories to its healthy shards (see
    :func:`~repro_torch.cluster.sharded_store.load_sharded_store`)
    instead of refusing outright.  A ``<path>.tmp`` with no ``<path>``
    means a save died before its atomic rename — that raises a
    ``ValueError`` naming the interruption, because there is nothing
    verified to load.
    """
    supported = "; ".join(SUPPORTED_FORMATS)
    if not os.path.exists(path) and os.path.exists(path + ".tmp"):
        raise ValueError(
            f"interrupted save detected: {path + '.tmp'!r} exists but "
            f"{path!r} does not — the save never completed its atomic "
            f"rename, and the tmp contents are unverifiable; rebuild the "
            f"store or restore from a backup/replica"
        )
    if os.path.isdir(path):
        if os.path.exists(os.path.join(path, "manifest.msgpack")):
            from repro_torch.cluster.sharded_store import ShardedDeepMappingStore

            return ShardedDeepMappingStore.load(
                path, pool=pool, on_corrupt=on_corrupt, device=device
            )
        if os.path.exists(os.path.join(path, "meta.msgpack")):
            from repro_torch.core.hybrid import DeepMappingStore

            return DeepMappingStore.load(path, pool=pool, device=device)
        raise ValueError(
            f"{path!r} is a directory but holds neither a cluster "
            f"manifest nor a store meta file; supported formats: "
            f"{supported}"
        )
    if os.path.isfile(path):
        from repro_torch.baselines.partitioned import load_baseline_store
        from repro_torch.fault.errors import IntegrityError

        try:
            return load_baseline_store(path, pool=pool)
        except IntegrityError:
            raise  # corruption, not an unrecognized format — say so
        except ValueError as err:
            raise ValueError(
                f"{err}; supported formats: {supported}"
            ) from err
    raise FileNotFoundError(
        f"{path!r} does not exist; repro_torch.open loads any of: {supported}"
    )


def build(
    table,
    config=None,
    cluster=None,
    pool=None,
    verbose: bool = False,
    spec=None,
    params=None,
    device=None,
):
    """Build a store from a table on ``device`` (CUDA by default).

    ``config`` is a :class:`~repro_torch.core.hybrid.DeepMappingConfig`
    (default-constructed when omitted); pass ``cluster`` (a
    :class:`~repro_torch.cluster.sharded_store.ClusterConfig`) with
    ``num_shards > 1`` to build a sharded cluster instead of a single
    store.  ``spec``/``params`` skip training (single store only).
    """
    from repro_torch.core.hybrid import DeepMappingConfig, DeepMappingStore

    config = config if config is not None else DeepMappingConfig()
    if cluster is not None and cluster.num_shards > 1:
        from repro_torch.cluster.sharded_store import ShardedDeepMappingStore

        if spec is not None or params is not None:
            raise ValueError("spec/params pre-seeding is single-store only")
        return ShardedDeepMappingStore.build(
            table, config, cluster, pool=pool, verbose=verbose, device=device
        )
    return DeepMappingStore.build(
        table, config, pool=pool, spec=spec, params=params, verbose=verbose,
        device=device,
    )
