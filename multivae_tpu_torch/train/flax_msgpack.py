"""Reading the JAX package's checkpoints without flax or msgpack.

The JAX package writes its params and its ``FlatAdamState`` with
``flax.serialization.to_bytes`` (``multivae_tpu/train/checkpoint.py:35-49``):
msgpack of the state dict, a NamedTuple keyed by its field names, each
array an ext 1 and each numpy scalar an ext 3 whose payload is itself
msgpack of ``[shape, dtype name, C-order buffer]``. :func:`decode` reads
that subset of msgpack in plain Python: maps, arrays, str, bin, ints,
floats, nil, booleans, ext 1 and ext 3. Anything else raises
``ValueError``: another ext type, flax's chunked-array marker (arrays of
more than 1 GiB, which no checkpoint of this model family holds), a
dtype numpy does not know (bfloat16), a truncated file or trailing bytes.
"""

from __future__ import annotations

import struct

import numpy as np

EXT_NDARRAY, EXT_NPSCALAR = 1, 3
CHUNKED_MARKER = "__msgpack_chunked_array__"


def is_msgpack_map(head: bytes) -> bool:
    """Whether a file's first byte opens a msgpack map (what ``to_bytes``
    writes for a state dict)."""
    return bool(head) and (0x80 <= head[0] <= 0x8F or head[0] in (0xDE,
                                                                   0xDF))


class _Reader:
    def __init__(self, data: bytes, allow_ext: bool = True):
        self.data, self.pos, self.allow_ext = data, 0, allow_ext

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError(f"truncated msgpack: {n} bytes wanted at offset "
                             f"{self.pos} of {len(self.data)}")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode("utf-8")
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return fixed[b]
        sized = {0xC4: (">B", "bin"), 0xC5: (">H", "bin"),
                 0xC6: (">I", "bin"), 0xD9: (">B", "str"),
                 0xDA: (">H", "str"), 0xDB: (">I", "str"),
                 0xDC: (">H", "array"), 0xDD: (">I", "array"),
                 0xDE: (">H", "map"), 0xDF: (">I", "map"),
                 0xC7: (">B", "ext"), 0xC8: (">H", "ext"),
                 0xC9: (">I", "ext")}
        if b in sized:
            fmt, kind = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return self.take(n)
            if kind == "str":
                return self.take(n).decode("utf-8")
            if kind == "array":
                return self.array(n)
            if kind == "map":
                return self.map(n)
            return self.ext(n)
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        raise ValueError(f"msgpack type byte 0x{b:02x} at offset "
                         f"{self.pos - 1} is not one flax writes")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        if CHUNKED_MARKER in out:
            raise ValueError("a chunked array (flax's form for arrays of "
                             "more than 1 GiB) is not read")
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        payload = self.take(n)
        if not self.allow_ext or code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"msgpack ext type {code} is not an ndarray "
                             f"(1) or a numpy scalar (3)")
        arr = _ndarray(payload)
        return arr if code == EXT_NDARRAY else arr[()]


def _ndarray(payload: bytes) -> np.ndarray:
    """The array of an ext payload: msgpack of ``[shape, dtype name,
    buffer]``."""
    fields = _decode(payload, allow_ext=False)
    if not (isinstance(fields, list) and len(fields) == 3):
        raise ValueError("an ndarray ext payload is [shape, dtype, buffer]")
    shape, name, buf = fields
    if isinstance(name, bytes):
        name = name.decode("ascii")
    try:
        dtype = np.dtype(name)
    except TypeError as err:
        raise ValueError(f"dtype {name!r} is not a numpy dtype") from err
    if not isinstance(buf, bytes) or len(buf) != dtype.itemsize * int(
            np.prod(shape, dtype=np.int64)):
        raise ValueError(f"an array of shape {shape} and dtype {name} needs "
                         f"{dtype.itemsize * int(np.prod(shape))} bytes")
    return np.frombuffer(buf, dtype=dtype).reshape(tuple(shape)).copy()


def _decode(data: bytes, allow_ext: bool = True):
    reader = _Reader(data, allow_ext)
    out = reader.value()
    if reader.pos != len(data):
        raise ValueError(f"{len(data) - reader.pos} bytes after the msgpack "
                         f"value")
    return out


def decode(data: bytes):
    """The state dict that ``flax.serialization.to_bytes`` wrote: nested
    dicts of numpy arrays (and of whatever plain values it held)."""
    return _decode(bytes(data))


def read(path: str) -> dict:
    """:func:`decode` of a file."""
    with open(path, "rb") as fh:
        return decode(fh.read())
