"""A msgpack decoder for the JAX package's checkpoints, with no
dependency (neither ``msgpack`` nor ``flax`` is needed).

``unpackb(data)`` decodes what flax's ``serialization.msgpack_serialize``
writes, as its ``msgpack_restore`` does:

  * maps (dicts), arrays (lists), str, bin (bytes), ints, floats, nil and
    bool;
  * ext type 1, an ndarray packed as the msgpack array ``(shape, dtype
    name, C-order bytes)``; ``bfloat16``, which numpy does not know, is
    decoded by name into float32 (exact: a bfloat16 is the high half of a
    float32);
  * ext type 2, a Python complex packed as ``(real, imag)``;
  * ext type 3, a numpy scalar packed as a 0-d ndarray;
  * flax's chunked-array dicts (``__msgpack_chunked_array__``, for arrays
    past 2**30 bytes), joined back into one array.

An unknown ext type, a reserved byte or a truncated input raises
``ValueError``.  A trainer checkpoint holds two levels: the payload
``{args, records, params, batch_stats}``, whose ``params`` and
``batch_stats`` are msgpack bytes themselves; ``unpackb`` them again.
"""
from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

_CHUNKED = "__msgpack_chunked_array__"


def _bfloat16_to_float32(buf: bytes) -> np.ndarray:
    bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
    return bits.view(np.float32)


def _ndarray(data: bytes) -> np.ndarray:
    shape, name, buf = unpackb(data)
    if isinstance(name, bytes):
        name = name.decode()
    if name == "bfloat16":
        flat = _bfloat16_to_float32(buf)
    else:
        flat = np.frombuffer(buf, dtype=np.dtype(name))
    return flat.reshape(tuple(shape)).copy()


def _ext(code: int, data: bytes) -> Any:
    if code == 1:
        return _ndarray(data)
    if code == 2:
        real, imag = unpackb(data)
        return complex(real, imag)
    if code == 3:
        return _ndarray(data)[()]
    raise ValueError(f"unknown msgpack ext type {code}")


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError("truncated msgpack input")
        out = bytes(self.data[self.pos:end])
        self.pos = end
        return out

    def unpack(self, fmt: str) -> Tuple:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return self.array(b & 0x0f)
        if 0xa0 <= b <= 0xbf:
            return self.take(b & 0x1f).decode()
        if b == 0xc0:
            return None
        if b == 0xc2:
            return False
        if b == 0xc3:
            return True
        if b in (0xc4, 0xc5, 0xc6):
            (n,) = self.unpack({0xc4: ">B", 0xc5: ">H", 0xc6: ">I"}[b])
            return self.take(n)
        if b in (0xc7, 0xc8, 0xc9):
            (n,) = self.unpack({0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}[b])
            (code,) = self.unpack(">b")
            return _ext(code, self.take(n))
        if b == 0xca:
            return self.unpack(">f")[0]
        if b == 0xcb:
            return self.unpack(">d")[0]
        if 0xcc <= b <= 0xd3:
            return self.unpack(">" + "BHIQbhiq"[b - 0xcc])[0]
        if 0xd4 <= b <= 0xd8:
            (code,) = self.unpack(">b")
            return _ext(code, self.take(1 << (b - 0xd4)))
        if b in (0xd9, 0xda, 0xdb):
            (n,) = self.unpack({0xd9: ">B", 0xda: ">H", 0xdb: ">I"}[b])
            return self.take(n).decode()
        if b in (0xdc, 0xdd):
            (n,) = self.unpack(">H" if b == 0xdc else ">I")
            return self.array(n)
        if b in (0xde, 0xdf):
            (n,) = self.unpack(">H" if b == 0xde else ">I")
            return self.map(n)
        raise ValueError(f"reserved msgpack byte 0x{b:02x}")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> Any:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        if out.get(_CHUNKED) is True:
            return _unchunk(out)
        return out


def _unchunk(d: dict) -> np.ndarray:
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    return np.concatenate(chunks).reshape(shape)


def unpackb(data: bytes) -> Any:
    """The value msgpack-encoded in ``data`` (which it must fill)."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} bytes past the msgpack "
                         "value")
    return out
