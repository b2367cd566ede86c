"""Chunked containers of the port: zarr v2 (numpy + zlib) and ``memory://``."""

from .containers import MemoryContainer, ZarrContainer, open_container

__all__ = ["MemoryContainer", "ZarrContainer", "open_container"]
