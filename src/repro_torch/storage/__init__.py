"""Shared storage substrate: compression codecs + bounded memory pool.

A copy of ``repro.storage``.  ``zstandard`` and ``lzma`` stay optional:
without them the codec names compress through stdlib ``zlib``.
"""

from repro_torch.storage.codecs import CODECS, HAVE_ZSTD, Codec, get_codec  # noqa: F401
from repro_torch.storage.pool import MemoryPool  # noqa: F401
