"""The msgpack subset that `flax.serialization` writes, in pure Python.

A checkpoint's `state.msgpack` is a msgpack map of maps whose leaves are
numpy arrays, packed as msgpack ext type 1 holding the msgpack array
(shape, dtype name, raw C-order bytes); numpy scalars use ext type 3 with
the same payload (flax/serialization.py). This module reads and writes
that subset: maps, arrays, str, bin, int, float, bool, nil and the two
ext types, so that the port needs no `msgpack` package. flax's split of
arrays over 2**30 bytes into chunks is not handled: no leaf of these
models comes near it.

`packb(tree)` encodes dicts (str keys), lists and tuples, str, bytes,
int, float, bool, None and numpy arrays (ext 1) or numpy scalars (ext 3).
`unpackb(data)` returns dicts, lists, str, bytes, int, float, bool, None
and numpy arrays (scalars as 0-d arrays).
"""
from __future__ import annotations

import struct

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

def _pack_int(n: int, out: list) -> None:
    if 0 <= n < 0x80:
        out.append(struct.pack("B", n))
    elif -32 <= n < 0:
        out.append(struct.pack("b", n))
    elif n >= 0:
        for code, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                               (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if n < top:
                out.append(bytes([code]) + struct.pack(fmt, n))
                return
        raise OverflowError(f"int {n} does not fit msgpack")
    else:
        for code, fmt, lo in ((0xD0, ">b", -(1 << 7)),
                              (0xD1, ">h", -(1 << 15)),
                              (0xD2, ">i", -(1 << 31)),
                              (0xD3, ">q", -(1 << 63))):
            if n >= lo:
                out.append(bytes([code]) + struct.pack(fmt, n))
                return
        raise OverflowError(f"int {n} does not fit msgpack")


def _pack_len(n: int, fix: int, fix_max: int, codes, out: list) -> None:
    """A length header: fix form below fix_max, else 8/16/32-bit (codes
    lists the codes for the widths it has, None where absent)."""
    if fix is not None and n < fix_max:
        out.append(bytes([fix | n]))
        return
    for code, fmt, top in zip(codes, (">B", ">H", ">I"),
                              (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < top:
            out.append(bytes([code]) + struct.pack(fmt, n))
            return
    raise OverflowError(f"length {n} does not fit msgpack")


def _pack_bytes(b: bytes, out: list) -> None:
    _pack_len(len(b), None, 0, (0xC4, 0xC5, 0xC6), out)
    out.append(b)


def _pack_str(s: str, out: list) -> None:
    b = s.encode("utf-8")
    _pack_len(len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB), out)
    out.append(b)


def _pack_ext(code: int, payload: bytes, out: list) -> None:
    n = len(payload)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(bytes([fixed[n], code]))
    else:
        for hdr, fmt, top in ((0xC7, ">B", 1 << 8), (0xC8, ">H", 1 << 16),
                              (0xC9, ">I", 1 << 32)):
            if n < top:
                out.append(bytes([hdr]) + struct.pack(fmt, n)
                           + struct.pack("b", code))
                break
        else:
            raise OverflowError(f"ext payload of {n} bytes")
    out.append(payload)


def _array_payload(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.fields is not None:
        raise ValueError(f"cannot serialize dtype {arr.dtype}")
    return packb([list(arr.shape), arr.dtype.name,
                  np.ascontiguousarray(arr).tobytes()])


def _pack(x, out: list) -> None:
    if x is None:
        out.append(b"\xc0")
    elif x is True:
        out.append(b"\xc3")
    elif x is False:
        out.append(b"\xc2")
    elif isinstance(x, np.ndarray):
        _pack_ext(EXT_NDARRAY, _array_payload(x), out)
    elif isinstance(x, np.generic):
        _pack_ext(EXT_NPSCALAR, _array_payload(np.asarray(x)), out)
    elif isinstance(x, int):
        _pack_int(x, out)
    elif isinstance(x, float):
        out.append(b"\xcb" + struct.pack(">d", x))
    elif isinstance(x, str):
        _pack_str(x, out)
    elif isinstance(x, (bytes, bytearray, memoryview)):
        _pack_bytes(bytes(x), out)
    elif isinstance(x, dict):
        _pack_len(len(x), 0x80, 16, (None, 0xDE, 0xDF), out)
        for key, val in x.items():
            if not isinstance(key, str):
                raise TypeError(f"map keys must be str, got {type(key)}")
            _pack_str(key, out)
            _pack(val, out)
    elif isinstance(x, (list, tuple)):
        _pack_len(len(x), 0x90, 16, (None, 0xDC, 0xDD), out)
        for val in x:
            _pack(val, out)
    else:
        raise TypeError(f"cannot serialize {type(x)}")


def packb(tree) -> bytes:
    """Encode `tree` as flax.serialization.msgpack_serialize would."""
    out: list = []
    _pack(tree, out)
    return b"".join(out)


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------

def _array_from_payload(payload: bytes) -> np.ndarray:
    shape, dtype_name, buf = unpackb(payload)
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    return np.frombuffer(bytearray(buf), dtype=np.dtype(dtype_name)
                         ).reshape(shape)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def ext(self, code: int, n: int):
        payload = bytes(self.take(n))
        if code in (EXT_NDARRAY, EXT_NPSCALAR):
            return _array_from_payload(payload)
        raise ValueError(f"unknown msgpack ext type {code}")

    def read(self):
        b = self.unpack("B")
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if b in sized:
            return bytes(self.take(self.unpack(sized[b])))
        if b in (0xC7, 0xC8, 0xC9):
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            return self.ext(self.unpack("b"), n)
        if b == 0xCA:
            return self.unpack(">f")
        if b == 0xCB:
            return self.unpack(">d")
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in ints:
            return self.unpack(ints[b])
        if 0xD4 <= b <= 0xD8:
            return self.ext(self.unpack("b"), 1 << (b - 0xD4))
        strs = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in strs:
            return str(self.take(self.unpack(strs[b])), "utf-8")
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"msgpack type byte 0x{b:02x} is not supported")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def array(self, n: int) -> list:
        return [self.read() for _ in range(n)]


def unpackb(data: bytes):
    """Decode msgpack bytes written by flax.serialization (or `packb`)."""
    reader = _Reader(data)
    out = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack object")
    return out
