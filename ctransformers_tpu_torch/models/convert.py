"""Carry the JAX package's model parameters across to the port.

`from_jax_params` takes the nested dict that ctransformers_tpu's
`load_bundle` or `random_params` return, with every array given as (or
convertible to) a numpy array, and returns the port's params. QTensor
leaves are recognized by their field names, so this module imports nothing
of the JAX package. Planes packed in the JAX package's "ksplit" nibble
layout (byte r holds rows r and r + K_pad/2, the high nibble sign-biased;
what it packs on a host without the TPU int4 bitcast) are unpacked and
re-packed as adjk, the only layout of the port. A KV cache (the JAX
package's KVCache: k, v and the int8 scale planes ks, vs, in either
layout) becomes the port's KVCache with the same arrays.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..ops.qmatmul import QTensor
from .forward import KVCache

_QT_FIELDS = ("qs", "scales", "mins", "kind", "group", "shape", "pack_layout")


def _is_qtensor(v: Any) -> bool:
    return all(hasattr(v, f) for f in _QT_FIELDS)


def _np(a):
    return None if a is None else np.asarray(a)


def _ksplit_to_adjk(qs: np.ndarray, zp: int) -> np.ndarray:
    """ksplit bytes (K_pad/2, N_pad) -> adjk bytes of the same grid."""
    u = np.asarray(qs).view(np.uint8)
    lo = (u & 0xF).astype(np.int16) - zp  # rows 0 .. K_pad/2 - 1
    hi = ((u >> 4) ^ 8).astype(np.int16) - zp  # rows K_pad/2 .. K_pad - 1
    q = np.concatenate([lo, hi], axis=0).astype(np.int8)
    nib = (q + np.int8(zp - 8)).view(np.uint8) & np.uint8(0xF)
    return (nib[0::2] | (nib[1::2] << np.uint8(4))).view(np.int8)


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a)
    if a.dtype.name == "bfloat16":  # numpy knows bf16 only through ml_dtypes
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def convert_qtensor(v: Any, device="cpu") -> QTensor:
    if getattr(v, "n_stack", 1) != 1:
        raise NotImplementedError("layer-stacked QTensors: unstack them first")
    qs = _np(v.qs)
    layout = v.pack_layout if v.packed else "adjk"
    if v.packed and layout == "ksplit":
        qs = _ksplit_to_adjk(qs, int(v.zp))
    elif v.packed and layout != "adjk":
        raise ValueError(f"unknown pack layout {layout!r}")
    if v.packed:
        qs = qs.view(np.int8)

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
        pack_layout="adjk",
    )


def from_jax_params(params: Any, device="cpu") -> Any:
    """Recursively convert dicts, lists, tuples and NamedTuples of arrays
    and QTensors."""
    if _is_qtensor(params):
        return convert_qtensor(params, device)
    if isinstance(params, dict):
        return {k: from_jax_params(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        items = [from_jax_params(v, device) for v in params]
        fields = getattr(params, "_fields", None)
        if fields == KVCache._fields:
            return KVCache(*items)
        # a NamedTuple takes its fields as arguments, a list or tuple an iterable
        return type(params)(*items) if fields is not None else type(params)(items)
    if params is None:
        return None
    return _tensor(params, device)
