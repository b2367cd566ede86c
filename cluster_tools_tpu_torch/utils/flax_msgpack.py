"""Read flax ``.msgpack`` checkpoints without flax or msgpack.

``flax.serialization.to_bytes`` writes a model's state dict as one msgpack
document: nested maps with string keys, array leaves as msgpack
extension objects, and arrays over flax's chunk size split into chunks.
This module decodes that much of msgpack, and no more:

- nil, booleans, integers, float32/float64, strings, binary data, arrays
  and maps (every msgpack type except the timestamp extension);
- extension type 1, an ndarray: a msgpack ``(shape, dtype name, row-major
  bytes)``; ``bfloat16`` leaves widen to float32, which is exact;
- extension type 2, a native complex number: a msgpack ``(real, imag)``;
- extension type 3, a numpy scalar: an ndarray of shape ``()``;
- flax's chunked form of a large leaf, a map with
  ``__msgpack_chunked_array__``, ``shape`` and ``chunks`` (maps keyed
  ``"0"``, ``"1"`` ...), joined back into one array.

:func:`restore` returns the tree of dicts, lists and numpy arrays that
``flax.serialization.msgpack_restore`` returns; :func:`flatten` joins its
paths with ``'/'``, the keys of the JAX package's npz checkpoints.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Tuple

import numpy as np

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError(f"truncated msgpack: {n} bytes wanted at offset {self.pos} of {len(self.data)}")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(">" + fmt)))[0]


def _decode(r: _Reader) -> Any:
    b = r.unpack("B")
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _map(r, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return [_decode(r) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return bytes(r.take(b & 0x1F)).decode("utf-8")
    if b == 0xC0:
        return None
    if b in (0xC2, 0xC3):
        return b == 0xC3
    if b in (0xC4, 0xC5, 0xC6):
        return bytes(r.take(r.unpack("BHI"[b - 0xC4])))
    if b in (0xC7, 0xC8, 0xC9):
        n = r.unpack("BHI"[b - 0xC7])
        return _ext(r.unpack("b"), bytes(r.take(n)))
    if b == 0xCA:
        return r.unpack("f")
    if b == 0xCB:
        return r.unpack("d")
    if 0xCC <= b <= 0xCF:
        return r.unpack("BHIQ"[b - 0xCC])
    if 0xD0 <= b <= 0xD3:
        return r.unpack("bhiq"[b - 0xD0])
    if 0xD4 <= b <= 0xD8:
        code = r.unpack("b")
        return _ext(code, bytes(r.take(1 << (b - 0xD4))))
    if 0xD9 <= b <= 0xDB:
        return bytes(r.take(r.unpack("BHI"[b - 0xD9]))).decode("utf-8")
    if b in (0xDC, 0xDD):
        return [_decode(r) for _ in range(r.unpack("HI"[b - 0xDC]))]
    if b in (0xDE, 0xDF):
        return _map(r, r.unpack("HI"[b - 0xDE]))
    raise ValueError(f"unsupported msgpack type byte 0x{b:02x} at offset {r.pos - 1}")


def _map(r: _Reader, n: int) -> Dict[Any, Any]:
    out = {}
    for _ in range(n):
        key = _decode(r)
        out[key] = _decode(r)
    return out


def unpackb(data: bytes) -> Any:
    """One msgpack document, decoded (extension types as flax writes
    them); trailing bytes are an error."""
    r = _Reader(data)
    out = _decode(r)
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} trailing bytes after the msgpack document")
    return out


def _ndarray(payload: bytes) -> np.ndarray:
    shape, dtype, buf = unpackb(payload)
    dtype = dtype.decode() if isinstance(dtype, bytes) else dtype
    if dtype == "bfloat16":
        # bfloat16 is the top half of a float32: widening is exact
        bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << np.uint32(16)
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape).copy()


def _ext(code: int, payload: bytes) -> Any:
    if code == _EXT_NDARRAY:
        return _ndarray(payload)
    if code == _EXT_COMPLEX:
        real, imag = unpackb(payload)
        return complex(real, imag)
    if code == _EXT_NPSCALAR:
        return _ndarray(payload)[()]
    raise ValueError(f"unsupported msgpack extension type {code}")


def _unchunk(tree: Any) -> Any:
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def restore(data: bytes) -> Any:
    """A flax msgpack checkpoint's state dict: nested dicts of numpy
    arrays (``flax.serialization.msgpack_restore``)."""
    return _unchunk(unpackb(data))


def flatten(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()) -> Dict[str, Any]:
    """``{'a': {'b': x}}`` -> ``{'a/b': x}``."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        path = prefix + (str(k),)
        if isinstance(v, dict):
            out.update(flatten(v, path))
        else:
            out["/".join(path)] = v
    return out
