"""Top-level entrypoints: ``repro_torch.open(path)`` / ``repro_torch.build(table, ...)``.

The port of ``repro.api.entry``.  ``open`` sniffs the on-disk format in
the reference's order:

* directory with ``manifest.msgpack``  -> sharded cluster (not ported
  yet: raises, naming ROADMAP item M8);
* directory with ``meta.msgpack``      -> single DeepMapping store
  (:func:`~repro_torch.core.serialize.load_store`);
* a file                               -> AB/HB baseline store (not
  ported yet: raises, naming ROADMAP item M7).

``build`` trains/assembles a single
:class:`~repro_torch.core.hybrid.DeepMappingStore` from a
:class:`~repro_torch.core.table.Table`.  Both run on the CUDA device
unless given ``device=``.  All imports are lazy so ``import
repro_torch`` stays light.
"""

from __future__ import annotations

import os


#: The on-disk formats ``open`` recognizes, in the sniffing order (also
#: the error-message inventory).
SUPPORTED_FORMATS = (
    "sharded cluster: directory containing manifest.msgpack "
    "(ShardedDeepMappingStore.save; not ported yet, M8)",
    "single DeepMapping store: directory containing meta.msgpack "
    "(DeepMappingStore.save)",
    "baseline overlay store: single msgpack file with an "
    "array_store/hash_store 'kind' header (not ported yet, M7)",
)


def open(path: str, pool=None, device=None):  # noqa: A001 — deliberate builtin shadow inside repro_torch.*
    """Load a saved store, sniffing the on-disk format.

    A **directory** holding ``meta.msgpack`` is a single DeepMapping
    store, loaded onto ``device`` (CUDA by default).  A directory
    holding ``manifest.msgpack`` (a sharded cluster) and a **file** (a
    baseline store) are the reference's other formats; the port cannot
    load them yet and raises ``NotImplementedError`` naming the ROADMAP
    item that brings them.  Anything else raises a ``ValueError`` (or
    ``FileNotFoundError`` when ``path`` does not exist) that lists the
    supported formats.  ``pool`` is the shared
    :class:`~repro_torch.storage.MemoryPool` to charge decompressed
    partitions to (one is created per store when omitted).

    Every artifact's crc32 recorded at save time is verified — a corrupt
    or truncated artifact raises
    :class:`~repro_torch.fault.errors.IntegrityError` rather than
    decoding into wrong values.  A ``<path>.tmp`` with no ``<path>``
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
            raise NotImplementedError(
                f"{path!r} is a sharded cluster; the port loads clusters "
                f"with ROADMAP item M8 (cluster, federation, failure)"
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
        raise NotImplementedError(
            f"{path!r} is a file, which only a baseline store "
            f"(ArrayStore/HashStore) saves; the port loads baselines "
            f"with ROADMAP item M7; supported formats: {supported}"
        )
    raise FileNotFoundError(
        f"{path!r} does not exist; repro_torch.open loads any of: {supported}"
    )


def build(
    table,
    config=None,
    pool=None,
    verbose: bool = False,
    spec=None,
    params=None,
    device=None,
):
    """Build a single store from a table on ``device`` (CUDA by default).

    ``config`` is a :class:`~repro_torch.core.hybrid.DeepMappingConfig`
    (default-constructed when omitted).  ``spec``/``params`` skip
    training.  The reference's ``cluster=`` argument comes with M8.
    """
    from repro_torch.core.hybrid import DeepMappingConfig, DeepMappingStore

    config = config if config is not None else DeepMappingConfig()
    return DeepMappingStore.build(
        table, config, pool=pool, spec=spec, params=params, verbose=verbose,
        device=device,
    )
