"""Minimal safetensors container reader/writer, numpy only (the port's
copy of ctransformers_tpu/formats/safetensors.py).

Format: u64 header_len | JSON header {name: {dtype, shape, data_offsets}}
| raw tensor blob. Offsets are relative to the end of the header. Used by
the GPTQ loader (gptq/llm.py), which parses the checkpoint directly and
repacks it into QTensor planes.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, Tuple

import numpy as np

_DTYPES = {
    "F64": np.float64,
    "F32": np.float32,
    "F16": np.float16,
    "BF16": None,  # handled specially (numpy has no bfloat16)
    "I64": np.int64,
    "I32": np.int32,
    "I16": np.int16,
    "I8": np.int8,
    "U8": np.uint8,
    "BOOL": np.bool_,
}


class SafetensorsReader:
    def __init__(self, path: str):
        self.path = str(path)
        with open(self.path, "rb") as f:
            (hlen,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(hlen).decode("utf-8"))
        self.meta = header.pop("__metadata__", {})
        self.tensors: Dict[str, dict] = header
        self._data_start = 8 + hlen
        self._mmap = np.memmap(self.path, dtype=np.uint8, mode="r")

    def names(self):
        return list(self.tensors)

    def __contains__(self, name: str) -> bool:
        return name in self.tensors

    def shape(self, name: str) -> Tuple[int, ...]:
        return tuple(self.tensors[name]["shape"])

    def tensor(self, name: str) -> np.ndarray:
        info = self.tensors[name]
        start, end = info["data_offsets"]
        raw = self._mmap[self._data_start + start : self._data_start + end]
        dtype = info["dtype"]
        shape = tuple(info["shape"])
        if dtype == "BF16":
            # bf16 -> f32 by zero-extending into the high 16 bits
            u16 = raw.view("<u2").astype(np.uint32) << 16
            return u16.view(np.float32).reshape(shape)
        arr = raw.view(np.dtype(_DTYPES[dtype]).newbyteorder("<"))
        return arr.reshape(shape)

    def tensor_f32(self, name: str) -> np.ndarray:
        return np.asarray(self.tensor(name), np.float32)


_NAMES = {np.dtype(v): k for k, v in _DTYPES.items() if v is not None}


def write_safetensors(path: str, tensors: Dict[str, object]) -> None:
    """Write `tensors` in order. A value is an array, or a lazy
    (dtype, shape, make) triple whose make() returns the array when its turn
    comes, so that a file larger than the host would hold is written one
    tensor at a time."""
    header = {}
    offset = 0
    for name, t in tensors.items():
        dtype, shape = (t[0], t[1]) if isinstance(t, tuple) else (t.dtype, t.shape)
        size = int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize
        header[name] = {
            "dtype": _NAMES[np.dtype(dtype)],
            "shape": [int(d) for d in shape],
            "data_offsets": [offset, offset + size],
        }
        offset += size
    hjson = json.dumps(header).encode("utf-8")
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hjson)))
        f.write(hjson)
        for name, t in tensors.items():
            arr = np.ascontiguousarray(t[2]() if isinstance(t, tuple) else t)
            info = header[name]
            if _NAMES[arr.dtype] != info["dtype"] or list(arr.shape) != info["shape"]:
                raise ValueError(f"{name}: made {arr.dtype} {arr.shape}, declared {info}")
            f.write(arr.tobytes())
