"""Carry the JAX package's model parameters across to the port.

`from_jax_params` takes the nested dict that ctransformers_tpu's
`load_bundle` or `random_params` return, with every array given as (or
convertible to) a numpy array, and returns the port's params. QTensor
leaves are recognized by their field names, so this module imports nothing
of the JAX package. Nibble planes come out in the layout the port packs
now (`pack_layout`, by default ops/qmatmul.py's rule: CT_PACK4_LAYOUT,
else adjk): planes already in it are carried across byte for byte, planes
in the other layout (the JAX package packs "ksplit" on a host without the
TPU int4 bitcast: byte r holds rows r and r + K_pad/2, the high nibble
sign-biased) are unpacked and re-packed. A KV cache (the JAX
package's KVCache: k, v and the int8 scale planes ks, vs, in either
layout) becomes the port's KVCache with the same arrays.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from ..ops.qmatmul import QTensor, _pack4_layout, pack4
from .forward import KVCache

_QT_FIELDS = ("qs", "scales", "mins", "kind", "group", "shape", "pack_layout")


def _is_qtensor(v: Any) -> bool:
    return all(hasattr(v, f) for f in _QT_FIELDS)


def _np(a):
    return None if a is None else np.asarray(a)


def _unpack4(qs: np.ndarray, zp: int, layout: str) -> np.ndarray:
    """(K_pad/2, N_pad) nibble bytes in `layout` -> the (K_pad, N_pad) int8
    grid q."""
    u = np.asarray(qs).view(np.uint8)
    if layout == "ksplit":
        lo = (u & 0xF).astype(np.int16) - zp  # rows 0 .. K_pad/2 - 1
        hi = ((u >> 4) ^ 8).astype(np.int16) - zp  # rows K_pad/2 .. K_pad - 1
        return np.concatenate([lo, hi], axis=0).astype(np.int8)
    q = np.empty((2 * u.shape[0], u.shape[1]), np.int16)
    q[0::2] = ((u & 0xF) ^ 8).astype(np.int16) - zp  # nibbles hold q + zp - 8
    q[1::2] = ((u >> 4) ^ 8).astype(np.int16) - zp
    return q.astype(np.int8)


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a)
    if a.dtype.name == "bfloat16":  # numpy knows bf16 only through ml_dtypes
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def convert_qtensor(v: Any, device="cpu", pack_layout: Optional[str] = None) -> QTensor:
    """The port's QTensor of a JAX QTensor; nibbles in `pack_layout` ("adjk"
    or "ksplit"; None: the port's rule, ops/qmatmul.py:_pack4_layout)."""
    if getattr(v, "n_stack", 1) != 1:
        raise NotImplementedError("layer-stacked QTensors: unstack them first")
    qs = _np(v.qs)
    layout = "adjk"
    if v.packed:
        layout = pack_layout or _pack4_layout()
        for name in (v.pack_layout, layout):
            if name not in ("adjk", "ksplit"):
                raise ValueError(f"unknown pack layout {name!r}")
        if v.pack_layout != layout:
            qs = pack4(_unpack4(qs, int(v.zp), v.pack_layout), int(v.zp), layout)
        qs = qs.view(np.uint8 if layout == "ksplit" else np.int8)

    def opt(a):
        return None if a is None else _tensor(a, device)

    return QTensor(
        _tensor(qs, device),
        _tensor(_np(v.scales), device),
        opt(_np(v.mins)),
        str(v.kind),
        int(v.group),
        tuple(int(d) for d in v.shape),
        bool(v.packed),
        int(v.zp),
        perm=opt(_np(getattr(v, "perm", None))),
        splits=getattr(v, "splits", None),
        sd=opt(_np(getattr(v, "sd", None))),
        sm=opt(_np(getattr(v, "sm", None))),
        sfactor=int(getattr(v, "sfactor", 0)),
        pack_layout=layout,
    )


def from_jax_params(params: Any, device="cpu", pack_layout: Optional[str] = None) -> Any:
    """Recursively convert dicts, lists, tuples and NamedTuples of arrays
    and QTensors (nibbles in `pack_layout`, see convert_qtensor)."""
    if _is_qtensor(params):
        return convert_qtensor(params, device, pack_layout)
    if isinstance(params, dict):
        return {k: from_jax_params(v, device, pack_layout) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        items = [from_jax_params(v, device, pack_layout) for v in params]
        fields = getattr(params, "_fields", None)
        if fields == KVCache._fields:
            return KVCache(*items)
        # a NamedTuple takes its fields as arguments, a list or tuple an iterable
        return type(params)(*items) if fields is not None else type(params)(items)
    if params is None:
        return None
    return _tensor(params, device)
