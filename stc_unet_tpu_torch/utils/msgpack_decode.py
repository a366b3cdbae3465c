"""A msgpack decoder on ``struct``, for the JAX package's ``.ckpt`` files.

The card's machine has no ``msgpack`` package, and a ``.ckpt`` is msgpack
(``stc_unet_tpu/engine/checkpoint.py``). ``unpackb`` decodes every type of
the msgpack spec as ``msgpack.unpackb`` does by default: nil, bools, ints
of every width, float 32 and 64, str (UTF-8, or bytes with ``raw=True``),
bin, arrays (as lists), maps (as dicts) and ext / fixext, which go to
``ext_hook(code, data)`` or else become an ``ExtType``. The timestamp
extension (code -1) is not special: it is an ``ExtType`` too.
"""
from __future__ import annotations

import struct
from typing import Any, Callable, NamedTuple, Optional


class ExtType(NamedTuple):
    """An extension value that no hook decoded (equal, as a tuple, to
    ``msgpack.ExtType``)."""
    code: int
    data: bytes


# fixed-size leads: struct format of the value
_SCALARS = {0xca: '>f', 0xcb: '>d', 0xcc: '>B', 0xcd: '>H', 0xce: '>I',
            0xcf: '>Q', 0xd0: '>b', 0xd1: '>h', 0xd2: '>i', 0xd3: '>q'}
# leads with a length: struct format of the length
_LENGTHS = {0xc4: '>B', 0xc5: '>H', 0xc6: '>I',     # bin
            0xd9: '>B', 0xda: '>H', 0xdb: '>I',     # str
            0xdc: '>H', 0xdd: '>I',                 # array
            0xde: '>H', 0xdf: '>I',                 # map
            0xc7: '>B', 0xc8: '>H', 0xc9: '>I'}     # ext
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


class _Reader:
    def __init__(self, data, ext_hook, raw):
        self.buf = memoryview(data)
        self.pos = 0
        self.ext_hook = ext_hook
        self.raw = raw

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError('msgpack: data truncated')
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def string(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode('utf-8')

    def ext(self, n: int):
        code = self.unpack('>b')
        data = bytes(self.take(n))
        if self.ext_hook is not None:
            return self.ext_hook(code, data)
        return ExtType(code, data)

    def array(self, n: int):
        return [self.value() for _ in range(n)]

    def map(self, n: int):
        out = {}
        for _ in range(n):
            key = self.value()
            if not isinstance(key, (str, bytes)):
                raise ValueError(f'msgpack: map key {key!r} is not str or '
                                 f'bytes')
            out[key] = self.value()
        return out

    def value(self) -> Any:
        lead = self.unpack('>B')
        if lead <= 0x7f:
            return lead
        if lead >= 0xe0:
            return lead - 0x100
        if lead <= 0x8f:
            return self.map(lead & 0x0f)
        if lead <= 0x9f:
            return self.array(lead & 0x0f)
        if lead <= 0xbf:
            return self.string(lead & 0x1f)
        if lead in (0xc0, 0xc2, 0xc3):
            return {0xc0: None, 0xc2: False, 0xc3: True}[lead]
        if lead in _SCALARS:
            return self.unpack(_SCALARS[lead])
        if lead in _FIXEXT:
            return self.ext(_FIXEXT[lead])
        if lead not in _LENGTHS:
            raise ValueError(f'msgpack: invalid lead byte 0x{lead:02x}')
        n = self.unpack(_LENGTHS[lead])
        if lead <= 0xc6:
            return bytes(self.take(n))
        if lead <= 0xc9:
            return self.ext(n)
        if lead <= 0xdb:
            return self.string(n)
        if lead <= 0xdd:
            return self.array(n)
        return self.map(n)


def unpackb(data, *, ext_hook: Optional[Callable[[int, bytes], Any]] = None,
            raw: bool = False) -> Any:
    """The one msgpack object in ``data`` (bytes-like), as
    ``msgpack.unpackb(data, ext_hook=ext_hook, raw=raw)`` gives it. Data
    left after the object raises."""
    reader = _Reader(data, ext_hook, raw)
    out = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError(f'msgpack: {len(reader.buf) - reader.pos} bytes of '
                         f'extra data')
    return out
