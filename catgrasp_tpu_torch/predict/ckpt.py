"""Read and write the trainer's checkpoints without flax or msgpack.

A checkpoint (``catgrasp_tpu/train/trainer.py:save_checkpoint``; the
params-only exports in ``artifacts_tracked/``) is a msgpack map ``{epoch,
params, step}`` whose ``params`` is itself a msgpack blob: the flax
parameter tree as nested maps of arrays.  flax packs an array as msgpack
ext type 1 whose payload is a msgpack array ``(shape, dtype name, raw C
bytes)``, and a numpy scalar the same way as ext type 3.  This module
decodes that subset of msgpack (nil, booleans, ints, floats, str, bin,
arrays, maps and those ext types), the counterpart of flax's
``serialization.msgpack_restore`` on these files, and encodes it
(``packb``), the counterpart of ``msgpack_serialize``: a numpy array as
ext type 1, a numpy scalar as ext type 3, each integer in the smallest
msgpack form, a float as a 64-bit float, bytes as bin.
"""
from __future__ import annotations

import struct

import numpy as np

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
# fixed-width types: tag -> struct format (big-endian)
_SCALARS = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
            0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
# tag -> struct format of the length prefix
_STR, _BIN = {0xd9: ">B", 0xda: ">H", 0xdb: ">I"}, {0xc4: ">B", 0xc5: ">H", 0xc6: ">I"}
_ARRAY, _MAP = {0xdc: ">H", 0xdd: ">I"}, {0xde: ">H", 0xdf: ">I"}
_EXT = {0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def number(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        tag = self.take(1)[0]
        if tag <= 0x7f:
            return tag
        if tag >= 0xe0:
            return tag - 0x100
        if tag <= 0x8f:
            return self.map(tag & 0x0f)
        if tag <= 0x9f:
            return [self.value() for _ in range(tag & 0x0f)]
        if tag <= 0xbf:
            return str(self.take(tag & 0x1f), "utf-8")
        if tag in (0xc0, 0xc2, 0xc3):
            return {0xc0: None, 0xc2: False, 0xc3: True}[tag]
        if tag in _SCALARS:
            return self.number(_SCALARS[tag])
        if tag in _STR:
            return str(self.take(self.number(_STR[tag])), "utf-8")
        if tag in _BIN:
            return bytes(self.take(self.number(_BIN[tag])))
        if tag in _ARRAY:
            return [self.value() for _ in range(self.number(_ARRAY[tag]))]
        if tag in _MAP:
            return self.map(self.number(_MAP[tag]))
        if tag in _EXT or tag in _FIXEXT:
            n = self.number(_EXT[tag]) if tag in _EXT else _FIXEXT[tag]
            code = self.number(">b")
            return _ext(code, bytes(self.take(n)))
        raise ValueError(f"msgpack type 0x{tag:02x} is not used by checkpoints")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out


def _ext(code: int, payload: bytes):
    if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
        raise ValueError(f"msgpack ext type {code} is not used by checkpoints")
    shape, dtype, buf = unpackb(payload)
    arr = np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)
    return arr if code == _EXT_NDARRAY else arr[()]


def unpackb(data: bytes):
    """Decode one msgpack object that spans all of ``data``."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} trailing bytes after the msgpack object")
    return out


def read_checkpoint_blob(path: str) -> dict:
    """The checkpoint's top-level map: ``epoch``, ``step`` and the
    ``params`` blob (bytes), and ``opt_state`` in a training checkpoint."""
    with open(path, "rb") as f:
        return unpackb(f.read())


def read_params(path: str) -> dict:
    """The checkpoint's flax parameter tree: nested dicts of numpy arrays,
    keyed by the flax module names (``PointNetEncoder_0/STN_1/...``)."""
    return unpackb(read_checkpoint_blob(path)["params"])


def _head(out: bytearray, n: int, small: int | None, small_max: int, sized: tuple) -> None:
    """A length-prefixed type's tag: the fix form ``small | n`` up to
    ``small_max``, else the first of ``sized`` ((tag, struct format, max))
    that holds n."""
    if small is not None and n <= small_max:
        out.append(small | n)
        return
    for tag, fmt, top in sized:
        if n <= top:
            out.append(tag)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack length {n} is too long")


_U8, _U16, _U32 = 0xff, 0xffff, 0xffffffff


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v <= 0x7f or -32 <= v < 0:
        out += struct.pack(">b" if v < 0 else ">B", v)
        return
    if v >= 0:
        forms = ((0xcc, ">B", _U8), (0xcd, ">H", _U16), (0xce, ">I", _U32),
                 (0xcf, ">Q", 2 ** 64 - 1))
        for tag, fmt, top in forms:
            if v <= top:
                out.append(tag)
                out += struct.pack(fmt, v)
                return
    else:
        for tag, fmt, bits in ((0xd0, ">b", 8), (0xd1, ">h", 16), (0xd2, ">i", 32),
                               (0xd3, ">q", 64)):
            if v >= -(2 ** (bits - 1)):
                out.append(tag)
                out += struct.pack(fmt, v)
                return
    raise ValueError(f"integer {v} does not fit msgpack")


def _pack_ext(out: bytearray, code: int, payload: bytes) -> None:
    n = len(payload)
    fix = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fix:
        out.append(fix[n])
    else:
        _head(out, n, None, 0, ((0xc7, ">B", _U8), (0xc8, ">H", _U16), (0xc9, ">I", _U32)))
    out += struct.pack(">b", code)
    out += payload


def _array_payload(a: np.ndarray) -> bytes:
    return packb([list(a.shape), a.dtype.name, np.ascontiguousarray(a).tobytes()])


def _pack(out: bytearray, v) -> None:
    if v is None:
        out.append(0xc0)
    elif v is True or v is False:
        out.append(0xc3 if v else 0xc2)
    elif isinstance(v, np.ndarray):
        _pack_ext(out, _EXT_NDARRAY, _array_payload(v))
    elif isinstance(v, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _array_payload(np.asarray(v)))
    elif isinstance(v, int):
        _pack_int(out, v)
    elif isinstance(v, float):
        out.append(0xcb)
        out += struct.pack(">d", v)
    elif isinstance(v, str):
        b = v.encode("utf-8")
        _head(out, len(b), 0xa0, 31, ((0xd9, ">B", _U8), (0xda, ">H", _U16), (0xdb, ">I", _U32)))
        out += b
    elif isinstance(v, (bytes, bytearray)):
        _head(out, len(v), None, 0, ((0xc4, ">B", _U8), (0xc5, ">H", _U16), (0xc6, ">I", _U32)))
        out += v
    elif isinstance(v, (list, tuple)):
        _head(out, len(v), 0x90, 15, ((0xdc, ">H", _U16), (0xdd, ">I", _U32)))
        for x in v:
            _pack(out, x)
    elif isinstance(v, dict):
        _head(out, len(v), 0x80, 15, ((0xde, ">H", _U16), (0xdf, ">I", _U32)))
        for k, x in v.items():
            _pack(out, k)
            _pack(out, x)
    else:
        raise TypeError(f"msgpack: cannot pack {type(v).__name__}")


def packb(obj) -> bytes:
    """Encode one object: dicts, lists and tuples of None, booleans, ints,
    floats, str, bytes, numpy arrays and numpy scalars."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


def write_checkpoint_blob(path: str, blob: dict) -> None:
    """Write a checkpoint's top-level map (``read_checkpoint_blob``'s
    inverse)."""
    with open(path, "wb") as f:
        f.write(packb(blob))
