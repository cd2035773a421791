"""Serialization: msgpack(+numpy) blobs and json, with no msgpack package.

Counterpart of ``lp_gnn_tpu/utils/serialize.py``. The processed ``*.pk``
blobs and their ``.meta`` sidecars are msgpack with ``msgpack_numpy``-style
ndarray maps. This module reads and writes them with its own small msgpack
codec in plain Python, for the subset those blobs use: nil, bool, int,
float, str, bin, array and map. Its output is byte-identical to
``msgpack.packb(obj, default=<ndarray encoder>, use_bin_type=True)``, and it
reads what that wrote (``tests/test_torch_serialize.py`` holds it against
the ``msgpack`` package).
"""
from __future__ import annotations

import json
import os
import struct
from typing import Any

import numpy as np


def _mkparent(path: str) -> None:
    d = os.path.dirname(os.path.abspath(path))
    if d:
        os.makedirs(d, exist_ok=True)


# ---------------------------------------------------------------- numpy maps
def _encode_np(obj):
    """ndarray / numpy scalar -> the ``msgpack_numpy`` map (bytes keys)."""
    if isinstance(obj, np.ndarray):
        if obj.dtype == object:
            raise TypeError("object arrays are not msgpack-serializable")
        if not obj.flags["C_CONTIGUOUS"]:
            obj = np.ascontiguousarray(obj)
        return {
            b"nd": True,
            b"type": obj.dtype.str,
            b"kind": b"",
            b"shape": list(obj.shape),
            b"data": obj.tobytes(),
        }
    if isinstance(obj, (np.bool_, np.number)):
        return {b"nd": False, b"type": obj.dtype.str, b"data": obj.tobytes()}
    raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def _decode_np(obj: dict, copy: bool):
    if b"nd" not in obj:
        return obj
    dtype = np.dtype(obj[b"type"])
    if obj[b"nd"]:
        arr = np.frombuffer(obj[b"data"], dtype=dtype).reshape(obj[b"shape"])
        return arr.copy() if copy else arr
    return np.frombuffer(obj[b"data"], dtype=dtype)[0]


# ------------------------------------------------------------------- packer
def _pack_int(v: int, out: list) -> None:
    # same width choice as msgpack's packer: unsigned forms for v >= 0,
    # signed forms for v < 0, always the narrowest that holds v
    if 0 <= v < 0x80:
        out.append(struct.pack("B", v))
    elif -0x20 <= v < 0:
        out.append(struct.pack("b", v))
    elif v >= 0:
        if v <= 0xFF:
            out.append(struct.pack(">BB", 0xCC, v))
        elif v <= 0xFFFF:
            out.append(struct.pack(">BH", 0xCD, v))
        elif v <= 0xFFFFFFFF:
            out.append(struct.pack(">BI", 0xCE, v))
        elif v <= 0xFFFFFFFFFFFFFFFF:
            out.append(struct.pack(">BQ", 0xCF, v))
        else:
            raise OverflowError("int too big to pack")
    elif v >= -0x80:
        out.append(struct.pack(">Bb", 0xD0, v))
    elif v >= -0x8000:
        out.append(struct.pack(">Bh", 0xD1, v))
    elif v >= -0x80000000:
        out.append(struct.pack(">Bi", 0xD2, v))
    elif v >= -0x8000000000000000:
        out.append(struct.pack(">Bq", 0xD3, v))
    else:
        raise OverflowError("int too big to pack")


def _pack_len(n: int, fix: int | None, fix_max: int, codes, out: list) -> None:
    """Header of a str / bin / array / map of length ``n``: the fix form
    when there is one and ``n`` fits, else the 8/16/32-bit length forms
    (``codes``; None where the type has no such form)."""
    if fix is not None and n <= fix_max:
        out.append(struct.pack("B", fix | n))
    elif codes[0] is not None and n <= 0xFF:
        out.append(struct.pack(">BB", codes[0], n))
    elif n <= 0xFFFF:
        out.append(struct.pack(">BH", codes[1], n))
    elif n <= 0xFFFFFFFF:
        out.append(struct.pack(">BI", codes[2], n))
    else:
        raise ValueError("object too large to pack")


def _pack(obj, out: list, defaulted: bool = False) -> None:
    # the order of these checks is msgpack's: bool before int (bool is an
    # int subclass), np.float64 packs as a float (it subclasses float),
    # other numpy objects go through the ndarray encoder
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif isinstance(obj, (bytes, bytearray)):
        _pack_len(len(obj), None, 0, (0xC4, 0xC5, 0xC6), out)
        out.append(bytes(obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB), out)
        out.append(raw)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 15, (None, 0xDE, 0xDF), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 15, (None, 0xDC, 0xDD), out)
        for v in obj:
            _pack(v, out)
    elif not defaulted:
        _pack(_encode_np(obj), out, defaulted=True)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj: Any) -> bytes:
    """msgpack bytes of ``obj`` (use_bin_type=True, numpy maps)."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


# ----------------------------------------------------------------- unpacker
class _Reader:
    __slots__ = ("buf", "pos", "copy")

    def __init__(self, buf: bytes, copy: bool):
        self.buf = buf
        self.pos = 0
        self.copy = copy

    def take(self, n: int) -> bytes:
        p = self.pos
        if p + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        self.pos = p + n
        return self.buf[p:p + n]

    def unpack(self, fmt: str):
        v = struct.unpack_from(fmt, self.buf, self.pos)
        self.pos += struct.calcsize(fmt)
        return v[0]

    def obj(self):
        b = self.buf[self.pos]
        self.pos += 1
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode("utf-8")
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        if b in _INT_FMT:
            return self.unpack(_INT_FMT[b])
        if b == 0xCA:
            return self.unpack(">f")
        if b == 0xCB:
            return self.unpack(">d")
        if b in _LEN_FMT:
            kind, fmt = _LEN_FMT[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return self.take(n)
            if kind == "str":
                return self.take(n).decode("utf-8")
            if kind == "array":
                return self.array(n)
            return self.map(n)
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int):
        d = {}
        for _ in range(n):
            k = self.obj()
            d[k] = self.obj()
        return _decode_np(d, self.copy)


_INT_FMT = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_LEN_FMT = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
            0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
            0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
            0xDE: ("map", ">H"), 0xDF: ("map", ">I")}


def unpackb(data: bytes, copy: bool = True) -> Any:
    """Inverse of :func:`packb`: str as str, bin as bytes, arrays as lists,
    numpy maps as arrays (writable copies when ``copy``)."""
    r = _Reader(data, copy)
    obj = r.obj()
    if r.pos != len(data):
        raise ValueError("extra bytes after the msgpack object")
    return obj


def msgpack_dump(obj: Any, path: str) -> None:
    _mkparent(path)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(packb(obj))
    os.replace(tmp, path)


def msgpack_load(path: str, copy: bool = True) -> Any:
    with open(path, "rb") as f:
        return unpackb(f.read(), copy=copy)


# --------------------------------------------------------------------- json
class _NpEncoder(json.JSONEncoder):
    def default(self, o):
        if isinstance(o, np.integer):
            return int(o)
        if isinstance(o, np.floating):
            return float(o)
        if isinstance(o, np.ndarray):
            return o.tolist()
        return super().default(o)


def json_dump(obj: Any, path: str) -> None:
    _mkparent(path)
    with open(path, "w") as f:
        json.dump(obj, f, cls=_NpEncoder)


def json_load(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


# ------------------------------------------------------------ results table
_HDF5_MAGIC = b"\x89HDF\r\n\x1a\n"


def have_pandas() -> bool:
    """Results tables (``time.h5``) are written only where pandas is."""
    try:
        import pandas  # noqa: F401
    except ImportError:
        return False
    return True


def df_dump(df, path: str) -> None:
    """Persist a results table (``time.h5``) as the JAX package does: real
    HDF5 when pytables is importable, a pandas pickle otherwise. Only called
    where pandas is importable."""
    _mkparent(path)
    try:
        import tables  # noqa: F401
    except ImportError:
        df.to_pickle(path)
    else:
        df.to_hdf(path, key="df", mode="w")


def df_load(path: str):
    import pandas as pd
    with open(path, "rb") as f:
        magic = f.read(8)
    if magic == _HDF5_MAGIC:
        return pd.read_hdf(path, key="df")
    return pd.read_pickle(path)


def _cell(v):
    """A results-table cell as json writes it: NaN as null."""
    if isinstance(v, (float, np.floating)):
        v = float(v)
        return None if v != v else v
    return v


def table_dump(rows: list[dict], path: str) -> None:
    """Write the results table, one dict a LP (the JAX package's ``time.h5``
    rows, the same column names), to ``path`` (``time.json``; a missing or
    NaN cell is null), and where pandas imports also to ``time.h5`` beside
    it through :func:`df_dump`."""
    json_dump([{k: _cell(v) for k, v in r.items()} for r in rows], path)
    if have_pandas():
        import pandas as pd
        df_dump(pd.DataFrame(rows), os.path.splitext(path)[0] + ".h5")

