"""GGUF container format: reader (v1/v2/v3, little-endian) and writer (v2).

A copy of ctransformers_tpu/formats/gguf.py. Layout:

    u32 magic 'GGUF', u32 version
    u64 n_tensors, u64 n_kv              (u32 in v1)
    n_kv * { str key; u32 type; value }  (str = u64 len + bytes; u32 len in v1)
    n_tensors * { str name; u32 n_dims; u64 ne[n_dims]; u32 type; u64 offset }
    pad to `general.alignment` (default 32)
    tensor data blob (offsets relative to blob start)

Tensor payloads are memory-mapped, so loading touches only the pages it
consumes. The writer streams payloads to the file one by one (the same bytes
as the reference writer, without holding the whole file in memory).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Any, BinaryIO, Dict, Sequence, Tuple, Union

import numpy as np

from .quants import GGMLType, dequantize, row_nbytes

GGUF_MAGIC = 0x46554747
GGUF_VERSION = 2
GGUF_DEFAULT_ALIGNMENT = 32


class GGUFValueType:
    UINT8 = 0
    INT8 = 1
    UINT16 = 2
    INT16 = 3
    UINT32 = 4
    INT32 = 5
    FLOAT32 = 6
    BOOL = 7
    STRING = 8
    ARRAY = 9
    UINT64 = 10
    INT64 = 11
    FLOAT64 = 12


_SCALAR_FMT = {
    GGUFValueType.UINT8: "<B",
    GGUFValueType.INT8: "<b",
    GGUFValueType.UINT16: "<H",
    GGUFValueType.INT16: "<h",
    GGUFValueType.UINT32: "<I",
    GGUFValueType.INT32: "<i",
    GGUFValueType.FLOAT32: "<f",
    GGUFValueType.BOOL: "<?",
    GGUFValueType.UINT64: "<Q",
    GGUFValueType.INT64: "<q",
    GGUFValueType.FLOAT64: "<d",
}

_ARRAY_DTYPE = {
    GGUFValueType.UINT8: "<u1",
    GGUFValueType.INT8: "<i1",
    GGUFValueType.UINT16: "<u2",
    GGUFValueType.INT16: "<i2",
    GGUFValueType.UINT32: "<u4",
    GGUFValueType.INT32: "<i4",
    GGUFValueType.FLOAT32: "<f4",
    GGUFValueType.BOOL: "<u1",
    GGUFValueType.UINT64: "<u8",
    GGUFValueType.INT64: "<i8",
    GGUFValueType.FLOAT64: "<f8",
}


@dataclass
class GGUFTensorInfo:
    name: str
    ne: Tuple[int, ...]  # GGML dim order: ne[0] is fastest-varying
    type: GGMLType
    offset: int  # relative to data section

    @property
    def n_elements(self) -> int:
        n = 1
        for d in self.ne:
            n *= d
        return n

    @property
    def nbytes(self) -> int:
        return row_nbytes(self.type, self.n_elements)

    @property
    def numpy_shape(self) -> Tuple[int, ...]:
        """Row-major shape matching the on-disk memory layout."""
        return tuple(reversed(self.ne))


class GGUFReader:
    """Parses GGUF metadata; tensor payloads are memory-mapped lazily."""

    def __init__(self, path: str):
        self.path = str(path)
        self.kv: Dict[str, Any] = {}
        self.kv_types: Dict[str, int] = {}
        self.tensors: Dict[str, GGUFTensorInfo] = {}
        self.alignment = GGUF_DEFAULT_ALIGNMENT
        with open(self.path, "rb") as f:
            self._parse(f)
        self._mmap = np.memmap(self.path, dtype=np.uint8, mode="r")

    def _parse(self, f: BinaryIO) -> None:
        magic, version = struct.unpack("<II", f.read(8))
        if magic != GGUF_MAGIC:
            raise ValueError(f"not a GGUF file: magic {magic:#x}")
        if version < 1 or version > 3:
            raise ValueError(f"unsupported GGUF version {version}")
        self.version = version
        cnt_fmt = "<I" if version == 1 else "<Q"
        cnt_size = struct.calcsize(cnt_fmt)

        def read_cnt() -> int:
            return struct.unpack(cnt_fmt, f.read(cnt_size))[0]

        n_tensors, n_kv = read_cnt(), read_cnt()

        def read_str() -> str:
            return f.read(read_cnt()).decode("utf-8", errors="replace")

        def read_value(vtype: int):
            if vtype in _SCALAR_FMT:
                fmt = _SCALAR_FMT[vtype]
                return struct.unpack(fmt, f.read(struct.calcsize(fmt)))[0]
            if vtype == GGUFValueType.STRING:
                return read_str()
            if vtype == GGUFValueType.ARRAY:
                (atype,) = struct.unpack("<I", f.read(4))
                n = read_cnt()
                if atype == GGUFValueType.STRING:
                    return [read_str() for _ in range(n)]
                if atype == GGUFValueType.ARRAY:
                    raise ValueError("nested GGUF arrays are invalid")
                dt = np.dtype(_ARRAY_DTYPE[atype])
                arr = np.frombuffer(f.read(int(n) * dt.itemsize), dtype=dt)
                return arr.astype(bool) if atype == GGUFValueType.BOOL else arr
            raise ValueError(f"invalid GGUF value type {vtype}")

        for _ in range(n_kv):
            key = read_str()
            (vtype,) = struct.unpack("<I", f.read(4))
            self.kv[key] = read_value(vtype)
            self.kv_types[key] = vtype

        for _ in range(n_tensors):
            name = read_str()
            (n_dims,) = struct.unpack("<I", f.read(4))
            ne = tuple(read_cnt() for _ in range(n_dims))
            (ttype,) = struct.unpack("<I", f.read(4))
            (offset,) = struct.unpack("<Q", f.read(8))
            self.tensors[name] = GGUFTensorInfo(name, ne, GGMLType(ttype), offset)

        self.alignment = int(self.kv.get("general.alignment", GGUF_DEFAULT_ALIGNMENT))
        pos = f.tell()
        pad = pos % self.alignment
        if pad:
            pos += self.alignment - pad
        self.data_offset = pos

    def tensor_bytes(self, name: str) -> np.ndarray:
        info = self.tensors[name]
        start = self.data_offset + info.offset
        return self._mmap[start : start + info.nbytes]

    def tensor_f32(self, name: str) -> np.ndarray:
        """Dequantized tensor, row-major numpy shape (reversed ne)."""
        info = self.tensors[name]
        return dequantize(
            self.tensor_bytes(name), info.type, info.n_elements
        ).reshape(info.numpy_shape)

    def tensor_storage(self, name: str) -> np.ndarray:
        """Float tensor at its FILE precision (f16 stays f16: the engine
        upcasts after the host-to-device copy, bit-identical to a host
        upcast at half the bytes)."""
        info = self.tensors[name]
        if info.type == GGMLType.F16:
            return self.tensor_bytes(name).view("<f2").reshape(info.numpy_shape)
        return self.tensor_f32(name)


# -- writer -------------------------------------------------------------------


def _infer_type(v: Any) -> Tuple[int, Any]:
    if isinstance(v, tuple) and len(v) == 2 and isinstance(v[0], int) and v[0] <= 12:
        return v  # explicit (type, value)
    if isinstance(v, bool):
        return GGUFValueType.BOOL, v
    if isinstance(v, (int, np.integer)):
        return GGUFValueType.UINT32 if 0 <= v < 2**32 else GGUFValueType.INT64, int(v)
    if isinstance(v, (float, np.floating)):
        return GGUFValueType.FLOAT32, float(v)
    if isinstance(v, str):
        return GGUFValueType.STRING, v
    if isinstance(v, np.ndarray):
        kind = {"f": GGUFValueType.FLOAT32, "i": GGUFValueType.INT32,
                "u": GGUFValueType.UINT32}[v.dtype.kind]
        return GGUFValueType.ARRAY, (kind, list(v.tolist()))
    if isinstance(v, (list, tuple)):
        if not v:
            return GGUFValueType.ARRAY, (GGUFValueType.INT32, [])
        el = v[0]
        if isinstance(el, str):
            return GGUFValueType.ARRAY, (GGUFValueType.STRING, list(v))
        if isinstance(el, (float, np.floating)):
            return GGUFValueType.ARRAY, (GGUFValueType.FLOAT32, [float(x) for x in v])
        return GGUFValueType.ARRAY, (GGUFValueType.INT32, [int(x) for x in v])
    raise TypeError(f"cannot infer GGUF type for {v!r}")


def write_gguf(
    path: str,
    kv: Dict[str, Any],
    tensors: Dict[str, Tuple[Union[GGMLType, int], Sequence[int], Union[bytes, np.ndarray]]],
    alignment: int = GGUF_DEFAULT_ALIGNMENT,
) -> None:
    """Write a GGUF v2 file.

    tensors: name -> (ggml_type, ne (GGML dim order), payload bytes or uint8
    array). A payload may also be a zero-argument callable returning it, so
    that multi-GB files are generated one tensor at a time."""
    out = bytearray()
    out += struct.pack("<IIQQ", GGUF_MAGIC, GGUF_VERSION, len(tensors), len(kv))

    def w_str(s: str):
        b = s.encode("utf-8")
        out.extend(struct.pack("<Q", len(b)))
        out.extend(b)

    def w_value(vtype: int, v: Any):
        if vtype in _SCALAR_FMT:
            out.extend(struct.pack(_SCALAR_FMT[vtype], v))
        elif vtype == GGUFValueType.STRING:
            w_str(v)
        elif vtype == GGUFValueType.ARRAY:
            atype, items = v
            out.extend(struct.pack("<IQ", atype, len(items)))
            if atype == GGUFValueType.STRING:
                for s in items:
                    w_str(s)
            else:
                out.extend(np.asarray(items).astype(_ARRAY_DTYPE[atype]).tobytes())
        else:
            raise ValueError(f"bad GGUF value type {vtype}")

    for key, raw in kv.items():
        vtype, v = _infer_type(raw)
        w_str(key)
        out.extend(struct.pack("<I", vtype))
        w_value(vtype, v)

    offset = 0
    sizes = []
    for name, (ttype, ne, _) in tensors.items():
        ttype = GGMLType(ttype)
        nbytes = row_nbytes(ttype, int(np.prod(ne)))
        w_str(name)
        out.extend(struct.pack("<I", len(ne)))
        for d in ne:
            out.extend(struct.pack("<Q", d))
        out.extend(struct.pack("<IQ", int(ttype), offset))
        sizes.append(nbytes)
        offset += nbytes
        if offset % alignment:
            offset += alignment - offset % alignment

    if len(out) % alignment:
        out.extend(b"\x00" * (alignment - len(out) % alignment))
    with open(path, "wb") as f:
        f.write(bytes(out))
        for (name, (_, _, data)), nbytes in zip(tensors.items(), sizes):
            if callable(data):
                data = data()
            if isinstance(data, np.ndarray):
                data = np.ascontiguousarray(data).view(np.uint8).reshape(-1)
            if len(data) != nbytes:
                raise ValueError(f"tensor {name}: payload {len(data)} != expected {nbytes}")
            f.write(data)
            if nbytes % alignment:
                f.write(b"\x00" * (alignment - nbytes % alignment))
