"""Quantized weights as torch tensors: the QTensor container, load-time
repacking, QKV / gate-up fusion and the matmul dispatch onto the Hopper
kernels of ops/qmm_kernels.py.

The counterpart of ctransformers_tpu/ops/qmatmul.py. A GGML block tensor is
repacked at load time into planes that compute x @ W with W logically
(in_features K, out_features N), padded to (K_pad, N_pad):

    qs     (K_pad/2, N_pad) int8   4-bit grids (Q4_K, GPTQ4), "adjk" layout:
                                   byte (r, n) holds rows 2r (low nibble)
                                   and 2r+1 (high nibble), both as two's-
                                   complement q - 8
           (K_pad, N_pad) int8     int8 grids (Q6_K: q in [-32, 31], Q5_K:
                                   q in [0, 31]), one byte per weight
    scales (K_pad/g, N_pad) int8   k-quant sub-scales per group of g rows
                                   (g = 32; 16 for Q6_K)
    mins   (K_pad/g, N_pad) int8   sub-mins (None when the format has none,
                                   as Q6_K)
    sd, sm (K_pad/256, N_pad) f32  superblock factors: s = sd * scales,
                                   m = sm * mins

so that W = q * s + m. GPTQ 4-bit weights (formats/gptq.py) are not
factored: scales and mins are the f32 (K_pad/g, N_pad) planes s and m
themselves, sd and sm are absent (sfactor 0), g is the checkpoint's group
size (128, 64 or 32), and an act-order checkpoint adds `perm`, the (K,)
gather of input rows that makes its groups contiguous.

The planes equal the JAX package's byte for byte in its adjk layout. The
port always packs 4-bit grids as adjk: the JAX package falls back to a
K-split layout where its TPU backend cannot bitcast int4 (its _int4_ok
capability probe), and on Hopper unpacking a nibble is two integer
instructions, so that probe has no counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..formats.quants import GGMLType, decompose, decompose_factors
from . import qmm_kernels as kern

# formats stored nibble-packed, with the zero point that re-biases their
# grid into [0, 15]; the other 4-bit grids join as their slices port them
_PACK4_ZP = {"Q4_K": 0, "GPTQ4": 0}


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass
class QTensor:
    """A quantized 2-D weight (see the module docstring). One layer's
    weight is one QTensor: the port walks layers in Python, so it needs
    neither the JAX package's layer stacking nor its tensor-parallel tag."""

    qs: torch.Tensor
    scales: torch.Tensor
    mins: Optional[torch.Tensor]
    kind: str  # ggml type name, e.g. "Q4_K"
    group: int
    shape: Tuple[int, int]  # logical (K, N)
    packed: bool = False
    zp: int = 0
    perm: Optional[torch.Tensor] = None  # (K,) input-row gather (GPTQ)
    # fused weight (QKV / gate-up): per-segment (padded, logical) widths
    splits: Optional[tuple] = None
    sd: Optional[torch.Tensor] = None
    sm: Optional[torch.Tensor] = None
    sfactor: int = 0  # groups per superblock (0 = unfactored f32 planes)
    pack_layout: str = "adjk"

    def to(self, device) -> "QTensor":
        planes = ("qs", "scales", "mins", "perm", "sd", "sm")
        return dataclasses.replace(self, **{
            f: getattr(self, f).to(device) for f in planes if getattr(self, f) is not None
        })


def _t(a: Optional[np.ndarray], dtype) -> Optional[torch.Tensor]:
    if a is None:
        return None
    return torch.from_numpy(np.ascontiguousarray(a, dtype))


def padded_shape(k: int, n: int) -> Tuple[int, int]:
    """(K_pad, N_pad) of a logical (K, N) weight: big dims pad to
    1024-multiples, as the JAX package does, so that the planes compare
    byte for byte (llama's n_ff 11008 -> 11264)."""
    return (_round_up(k, 1024 if k >= 1024 else 256),
            _round_up(n, 1024 if n >= 1024 else 128))


def make_qtensor(
    q: np.ndarray,  # (K, N) int8
    s: np.ndarray,  # (K/g, N) f32, or int8 sub-scales when sd is given
    m: Optional[np.ndarray],
    kind: str,
    group: int,
    perm: Optional[np.ndarray] = None,
    sd: Optional[np.ndarray] = None,  # (K/(g*sf), N) f32 superblock scales
    sm: Optional[np.ndarray] = None,
    sfactor: int = 0,
) -> QTensor:
    """Pad, pack and wrap host planes as CPU tensors (placement on the
    device is the Engine's job)."""
    k, n = q.shape
    kp, npad = padded_shape(k, n)
    if (kp, npad) != (k, n):
        q = np.pad(q, ((0, kp - k), (0, npad - n)))
        s = np.pad(s, ((0, kp // group - s.shape[0]), (0, npad - n)))
        if m is not None:
            m = np.pad(m, ((0, kp // group - m.shape[0]), (0, npad - n)))
        if sd is not None:
            sb = group * sfactor
            sd = np.pad(sd, ((0, kp // sb - sd.shape[0]), (0, npad - n)))
            if sm is not None:
                sm = np.pad(sm, ((0, kp // sb - sm.shape[0]), (0, npad - n)))
    packed = kind in _PACK4_ZP
    zp = _PACK4_ZP.get(kind, 0)
    if packed:
        # adjacent rows per byte, both nibbles two's-complement (q + zp - 8)
        nib = (q + np.int8(zp - 8)).view(np.uint8) & np.uint8(0xF)
        q = (nib[0::2] | (nib[1::2] << np.uint8(4))).view(np.int8)
    sdtype = np.int8 if sd is not None else np.float32
    return QTensor(
        _t(q, np.int8),
        _t(s, sdtype),
        _t(m, sdtype),
        kind,
        group,
        (k, n),
        packed,
        zp,
        _t(perm, np.int32),
        sd=_t(sd, np.float32),
        sm=_t(sm, np.float32),
        sfactor=sfactor if sd is not None else 0,
    )


def repack(data, t: GGMLType, rows: int, cols: int) -> QTensor:
    """Repack a GGML tensor (file layout: `rows` x `cols`, quant blocks along
    cols) into a QTensor computing x @ W with W logically (cols, rows): the
    load-time transpose, with the k-quant scale factors kept factored."""
    t = GGMLType(t)
    n = rows * cols
    q, _, _, group = decompose(data, t, n)
    sd, sq, sm, mq, group = decompose_factors(data, t, n)
    sf = sq.shape[1]  # groups per superblock
    if cols % (group * sf):
        raise ValueError(f"{t.name}: row length {cols} is not a superblock multiple")
    q = np.ascontiguousarray(q.reshape(rows, cols).T)  # (K=cols, N=rows)
    sq = np.ascontiguousarray(sq.reshape(rows, cols // group).T)
    sd = np.ascontiguousarray(sd.reshape(rows, cols // (group * sf)).T)
    if mq is not None:  # Q6_K has no mins
        mq = np.ascontiguousarray(mq.reshape(rows, cols // group).T)
        sm = np.ascontiguousarray(sm.reshape(rows, cols // (group * sf)).T)
    return make_qtensor(q, sq, mq, t.name, group, sd=sd, sm=sm, sfactor=sf)


def unpack_grid(qt: QTensor) -> torch.Tensor:
    """The (K_pad, N_pad) int8 grid q, unpacking nibbles when packed."""
    if not qt.packed:
        return qt.qs
    u = qt.qs.to(torch.int32) & 0xFF
    # stored nibbles are two's-complement (nib - 8); nib = s4u ^ 8
    lo = ((u & 0xF) ^ 8) - qt.zp  # rows 0, 2, 4, ...
    hi = (((u >> 4) & 0xF) ^ 8) - qt.zp  # rows 1, 3, 5, ...
    rows, n = qt.qs.shape
    return torch.stack([lo, hi], dim=1).reshape(2 * rows, n).to(torch.int8)


def scale_planes(qt: QTensor):
    """f32 (K_pad/g, N_pad) scale/min planes, rebuilt from the superblock
    factors when present (the same f32 multiply decompose performs)."""
    if qt.sfactor == 0:
        return qt.scales, qt.mins
    s = qt.sd.repeat_interleave(qt.sfactor, 0) * qt.scales.float()
    m = None
    if qt.mins is not None:
        m = qt.sm.repeat_interleave(qt.sfactor, 0) * qt.mins.float()
    return s, m


def dequantize_qtensor(qt: QTensor) -> torch.Tensor:
    """Dense f32 (K, N) view in logical row order."""
    sp, mp_ = scale_planes(qt)
    w = unpack_grid(qt).float() * sp.repeat_interleave(qt.group, 0)
    if mp_ is not None:
        w = w + mp_.repeat_interleave(qt.group, 0)
    k, n = qt.shape
    w = w[:k, :n]
    if qt.perm is not None:
        w = torch.zeros_like(w).index_copy_(0, qt.perm.long(), w)
    return w


# -- matmul ------------------------------------------------------------------


def select_mode(m: int, qt: QTensor) -> str:
    """Kernel for an (m, K_pad) x (K_pad, N_pad) product with weight `qt`.
    A fixed rule that follows the JAX package's kernel candidates and the
    pattern of its measured TPU choices without reading them; provisional
    until kernel selection is ported (ROADMAP Queue 1).

    Nibble-packed Q4_K: decode takes the in-kernel activation quantization
    ("qx"), short chunks the pre-quantized form ("q"), long chunks the bf16
    tensor-core GEMMs, folding the bias through the group sums where N is
    the wider side ("si", else "i").

    Nibble-packed weights with plain f32 planes (sfactor 0: GPTQ4, any
    group) take "qx" at m = 1, "q" at 2 <= m <= 32 and "i" at m > 32 on
    every shape: the pattern of the JAX package's measured GPTQ4 choices
    ("qx" at m = 1 and "i" at m = 128 on every llama-7B shape), followed
    here without reading its table; it offers no "si" pick for GPTQ4.

    int8 grids (Q6_K, Q5_K): at m <= 32 the pre-quantized int8 dot ("q8",
    the JAX package's "q" mode with packed4=False; it offers no "qx" for
    unpacked grids). At m > 32 its candidates are only "b" and "sb", and its
    autotuner drops the sum-fold "sb" where the weight has no mins: "b"
    for Q6_K, "sb" for Q5_K."""
    rows, npad = qt.qs.shape
    if not qt.packed:
        if m <= 32:
            return "q8"
        return "sb" if qt.mins is not None else "b"
    if m == 1:
        return "qx"
    if m <= 32:
        return "q"
    if qt.sfactor == 0:
        return "i"
    return "si" if npad > 2 * rows else "i"


def matmul(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w for dense tensors or QTensor weights; x is (..., K)."""
    if isinstance(w, QTensor):
        return qmatmul(x, w)
    return x @ w


def qmatmul(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    lead = x.shape[:-1]
    k, n = qt.shape
    xm = x.reshape(-1, k).float()
    if qt.perm is not None:
        # act-order row gather (GPTQ): plain tensor code in the JAX package
        # too, outside its kernels
        xm = xm.index_select(1, qt.perm)
    kp = qt.qs.shape[0] * (2 if qt.packed else 1)
    if kp != k:
        xm = torch.nn.functional.pad(xm, (0, kp - k))
    xm = xm.contiguous()
    mode = select_mode(xm.shape[0], qt)
    # looked up at call time, so that a caller may wrap the module's kernels
    name = kern.kernel_name(mode, qt)
    fn = getattr(kern, name)
    if name in kern.PREQUANTIZED:
        out = fn(*kern.quantize_activations(xm, qt.group), qt)
    else:
        out = fn(xm, qt)
    return out[:, :n].reshape(*lead, n)


# -- fusion --------------------------------------------------------------------


def concat_qtensors(qts) -> Optional[QTensor]:
    """Fuse column-wise compatible QTensors into one wide weight so one
    kernel call serves several projections (QKV, gate+up). Returns None when
    fusion does not apply (mixed formats, dense weights, perms, other K)."""
    if len(qts) < 2 or not all(isinstance(q, QTensor) for q in qts):
        return None
    head = qts[0]
    for q in qts:
        if (
            q.kind != head.kind
            or q.group != head.group
            or q.packed != head.packed
            or q.zp != head.zp
            or q.perm is not None
            or q.qs.shape[0] != head.qs.shape[0]
            or q.shape[0] != head.shape[0]
            or q.pack_layout != head.pack_layout
            or (q.mins is None) != (head.mins is None)
            or q.sfactor != head.sfactor
        ):
            return None

    def cat(field):
        if getattr(head, field) is None:
            return None
        return torch.cat([getattr(q, field) for q in qts], dim=1)

    splits = tuple((int(q.qs.shape[1]), int(q.shape[1])) for q in qts)
    qs = cat("qs")
    return QTensor(
        qs,
        cat("scales"),
        cat("mins"),
        head.kind,
        head.group,
        (head.shape[0], int(qs.shape[1])),  # logical N = padded total
        head.packed,
        head.zp,
        splits=splits,
        sd=cat("sd"),
        sm=cat("sm"),
        sfactor=head.sfactor,
        pack_layout=head.pack_layout,
    )


def split_fused(out: torch.Tensor, qt: QTensor):
    """Slice a fused matmul output back into per-projection tensors."""
    parts = []
    off = 0
    for npad_i, n_i in qt.splits:
        parts.append(out[..., off : off + n_i])
        off += npad_i
    return parts


def fuse_layer_params(params) -> int:
    """Fuse wq/wk/wv -> w_qkv and w_gate/w_up -> w_gateup in place where
    compatible. Returns the number of fused groups created."""
    n = 0
    for layer in params.get("layers", []):
        if all(k in layer for k in ("wq", "wk", "wv")) and "w_qkv" not in layer:
            fused = concat_qtensors([layer["wq"], layer["wk"], layer["wv"]])
            if fused is not None:
                layer["w_qkv"] = fused
                del layer["wq"], layer["wk"], layer["wv"]
                n += 1
        if all(k in layer for k in ("w_gate", "w_up")) and "w_gateup" not in layer:
            fused = concat_qtensors([layer["w_gate"], layer["w_up"]])
            if fused is not None:
                layer["w_gateup"] = fused
                del layer["w_gate"], layer["w_up"]
                n += 1
    return n
