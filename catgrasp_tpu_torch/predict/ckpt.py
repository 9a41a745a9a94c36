"""Read the trainer's checkpoints without flax or msgpack.

A checkpoint (``catgrasp_tpu/train/trainer.py:save_checkpoint``; the
params-only exports in ``artifacts_tracked/``) is a msgpack map ``{epoch,
params, step}`` whose ``params`` is itself a msgpack blob: the flax
parameter tree as nested maps of arrays.  flax packs an array as msgpack
ext type 1 whose payload is a msgpack array ``(shape, dtype name, raw C
bytes)``, and a numpy scalar the same way as ext type 3.  This module
decodes that subset of msgpack (nil, booleans, ints, floats, str, bin,
arrays, maps and those ext types), the counterpart of flax's
``serialization.msgpack_restore`` on these files.
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
