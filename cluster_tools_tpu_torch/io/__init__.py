"""Chunked containers of the port: zarr v2 and N5 (numpy + zlib), HDF5
(``h5py``, imported when a file is opened) and ``memory://``, read through
the process-wide chunk cache (:mod:`.chunk_cache`); bounded-window
prefetch in :mod:`.prefetch`."""

from .chunk_cache import ChunkCache, get_chunk_cache
from .chunk_cache import cache_enabled as chunk_cache_enabled
from .containers import H5Container, MemoryContainer, ZarrContainer, open_container

__all__ = ["ChunkCache", "H5Container", "MemoryContainer", "ZarrContainer", "chunk_cache_enabled",
           "get_chunk_cache", "open_container"]
