"""GGML block quantization, numpy, limited to the types the port serves.

A copy of ctransformers_tpu/formats/quants.py for F32, F16 and Q4_K (block
layouts: the reference's k_quants.h; decode: dequantize_row_q4_K; encode:
quantize_row_q4_K_reference). Every other block type has its size here, so
a GGUF holding it can be parsed, but decoding it raises NotImplementedError
until a later slice ports it (see ROADMAP).
"""

from __future__ import annotations

import enum

import numpy as np

QK = 32  # basic block size
QK_K = 256  # super-block size
K_SCALE_SIZE = 12


class GGMLType(enum.IntEnum):
    """Tensor data types, values match enum ggml_type."""

    F32 = 0
    F16 = 1
    Q4_0 = 2
    Q4_1 = 3
    Q5_0 = 6
    Q5_1 = 7
    Q8_0 = 8
    Q8_1 = 9
    Q2_K = 10
    Q3_K = 11
    Q4_K = 12
    Q5_K = 13
    Q6_K = 14
    Q8_K = 15
    I8 = 16
    I16 = 17
    I32 = 18


# type -> (elements per block, bytes per block)
_TRAITS = {
    GGMLType.F32: (1, 4),
    GGMLType.F16: (1, 2),
    GGMLType.Q4_0: (QK, 2 + QK // 2),
    GGMLType.Q4_1: (QK, 4 + QK // 2),
    GGMLType.Q5_0: (QK, 2 + 4 + QK // 2),
    GGMLType.Q5_1: (QK, 4 + 4 + QK // 2),
    GGMLType.Q8_0: (QK, 2 + QK),
    GGMLType.Q8_1: (QK, 8 + QK),
    GGMLType.Q2_K: (QK_K, QK_K // 16 + QK_K // 4 + 4),
    GGMLType.Q3_K: (QK_K, QK_K // 8 + QK_K // 4 + 12 + 2),
    GGMLType.Q4_K: (QK_K, 4 + K_SCALE_SIZE + QK_K // 2),  # 144
    GGMLType.Q5_K: (QK_K, 4 + K_SCALE_SIZE + QK_K // 8 + QK_K // 2),
    GGMLType.Q6_K: (QK_K, QK_K // 2 + QK_K // 4 + QK_K // 16 + 2),
    GGMLType.Q8_K: (QK_K, 4 + QK_K + QK_K // 16 * 2),
    GGMLType.I8: (1, 1),
    GGMLType.I16: (1, 2),
    GGMLType.I32: (1, 4),
}


def _not_ported(t) -> NotImplementedError:
    return NotImplementedError(
        f"{GGMLType(t).name} is not yet ported, see ROADMAP"
    )


def row_nbytes(t: GGMLType, n_elements: int) -> int:
    bs, ts = _TRAITS[GGMLType(t)]
    if n_elements % bs:
        raise ValueError(f"{n_elements} not a multiple of block size {bs} for {t!r}")
    return n_elements // bs * ts


def _f16(b: np.ndarray) -> np.ndarray:
    """View little-endian fp16 bytes as float32."""
    return b.view("<f2").astype(np.float32)


def _blocks(data, t: GGMLType, n: int) -> np.ndarray:
    """Reshape a flat uint8 buffer into (nb, type_size) block rows."""
    bs, ts = _TRAITS[t]
    if n % bs:
        raise ValueError(f"{n} elements not a multiple of block size {bs}")
    nb = n // bs
    if isinstance(data, (bytes, bytearray, memoryview)):
        data = np.frombuffer(data, dtype=np.uint8, count=nb * ts)
    else:
        data = np.ascontiguousarray(data, dtype=np.uint8).reshape(-1)[: nb * ts]
    return data.reshape(nb, ts)


def _q45k_tables():
    # dequantize_row_q4_K: 4 chunks of 64; within a chunk, 32 low nibbles
    # then 32 high nibbles; qs advances 32 per chunk
    l = np.arange(QK_K)
    chunk = l // 64
    hi = (l % 64) // 32
    pos = l % 32
    return 32 * chunk + pos, 4 * hi, 2 * chunk + hi


_Q4K_BYTE, _Q4K_SHIFT, _Q4K_SC = _q45k_tables()


def _unpack_scale_min_k4(sc_bytes: np.ndarray):
    """The 12-byte 6-bit packed scales/mins of q4_K -> (nb, 8) each."""
    q = sc_bytes.astype(np.uint8)
    sc = np.empty(q.shape[:-1] + (8,), np.uint8)
    m = np.empty_like(sc)
    sc[..., :4] = q[..., 0:4] & 63
    m[..., :4] = q[..., 4:8] & 63
    sc[..., 4:] = (q[..., 8:12] & 0xF) | ((q[..., 0:4] >> 6) << 4)
    m[..., 4:] = (q[..., 8:12] >> 4) | ((q[..., 4:8] >> 6) << 4)
    return sc, m


def _pack_scale_min_k4(sc: np.ndarray, m: np.ndarray) -> np.ndarray:
    """Inverse of _unpack_scale_min_k4; sc/m are (nb, 8) 6-bit values."""
    sc = sc.astype(np.uint8)
    m = m.astype(np.uint8)
    out = np.zeros(sc.shape[:-1] + (12,), np.uint8)
    out[..., 0:4] = (sc[..., :4] & 63) | ((sc[..., 4:] >> 4) << 6)
    out[..., 4:8] = (m[..., :4] & 63) | ((m[..., 4:] >> 4) << 6)
    out[..., 8:12] = (sc[..., 4:] & 0xF) | ((m[..., 4:] & 0xF) << 4)
    return out


# -- dequantization -----------------------------------------------------------


def dequantize(data, t: GGMLType, n: int) -> np.ndarray:
    """Decode a flat buffer of `n` elements of ggml type `t` to float32."""
    t = GGMLType(t)
    if t in (GGMLType.F32, GGMLType.F16):
        dt = "<f4" if t == GGMLType.F32 else "<f2"
        if isinstance(data, (bytes, bytearray, memoryview)):
            raw = np.frombuffer(data, dt, count=n)
        else:
            raw = np.asarray(data, np.uint8).reshape(-1)[: n * np.dtype(dt).itemsize].view(dt)
        return raw.astype(np.float32)
    if t != GGMLType.Q4_K:
        raise _not_ported(t)
    b = _blocks(data, t, n)
    d = _f16(b[:, 0:2])
    dmin = _f16(b[:, 2:4])
    sc, mn = _unpack_scale_min_k4(b[:, 4:16])
    q = (b[:, 16:144][:, _Q4K_BYTE] >> _Q4K_SHIFT) & 0xF
    dl = d * sc[:, _Q4K_SC].astype(np.float32)
    ml = dmin * mn[:, _Q4K_SC].astype(np.float32)
    return (dl * q.astype(np.float32) - ml).reshape(-1)[:n]


# -- quantization (quantize_row_q4_K_reference) ---------------------------------


def _round_half_away(x):
    """C roundf semantics: round half away from zero."""
    return np.sign(x) * np.floor(np.abs(x) + 0.5)


def _nearest_int(x):
    return _round_half_away(x).astype(np.int32)


def _make_qkx2_quants(xs, nmax, weights, rmin, rdelta, nstep):
    """Vectorized make_qkx2_quants: the weighted grid-search min/scale fit;
    x ~= scale*L - the_min with L in [0, nmax]."""
    mn = xs.min(axis=-1)
    mx = xs.max(axis=-1)
    sum_w = weights.sum(axis=-1)
    sum_x = (weights * xs).sum(axis=-1)
    mn = np.where(mn > 0, 0.0, mn)
    flat = mx == mn
    span = np.where(flat, 1.0, mx - mn)
    iscale = nmax / span
    scale = 1.0 / iscale
    L = np.clip(_nearest_int(iscale[..., None] * (xs - mn[..., None])), 0, nmax)
    diff = scale[..., None] * L + mn[..., None] - xs
    diff = diff * diff
    best_mad = (weights * diff).sum(axis=-1)
    cur_min = mn.copy()
    for step in range(nstep + 1):
        isc = (rmin + rdelta * step + nmax) / span
        l = np.clip(_nearest_int(isc[..., None] * (xs - mn[..., None])), 0, nmax)
        wl = weights * l
        sum_l = wl.sum(axis=-1)
        sum_l2 = (wl * l).sum(axis=-1)
        sum_xl = (wl * xs).sum(axis=-1)
        D = sum_w * sum_l2 - sum_l * sum_l
        ok = D > 0
        Dsafe = np.where(ok, D, 1.0)
        this_scale = (sum_w * sum_xl - sum_x * sum_l) / Dsafe
        this_min = (sum_l2 * sum_x - sum_l * sum_xl) / Dsafe
        pos = this_min > 0
        this_scale = np.where(
            pos, sum_xl / np.where(sum_l2 > 0, sum_l2, 1.0), this_scale
        )
        this_min = np.where(pos, 0.0, this_min)
        diff = this_scale[..., None] * l + this_min[..., None] - xs
        diff = diff * diff
        mad = (weights * diff).sum(axis=-1)
        better = ok & (mad < best_mad)
        best_mad = np.where(better, mad, best_mad)
        scale = np.where(better, this_scale, scale)
        cur_min = np.where(better, this_min, cur_min)
        L = np.where(better[..., None], l, L)
    scale = np.where(flat, 0.0, scale)
    L = np.where(flat[..., None], 0, L)
    the_min = np.where(flat, -mn, -cur_min)
    return scale, L, the_min


def _q_q4_K(xb):
    nb = xb.shape[0]
    groups = xb.reshape(nb, 8, 32)
    weights = np.sqrt((groups * groups).mean(axis=-1, keepdims=True)) + np.abs(groups)
    scales, _, mins = _make_qkx2_quants(
        groups, 15, weights, rmin=-1.0, rdelta=0.1, nstep=20
    )
    max_scale = scales.max(axis=1)
    max_min = mins.max(axis=1)
    inv_scale = np.where(max_scale > 0, 63.0 / np.where(max_scale > 0, max_scale, 1), 0.0)
    inv_min = np.where(max_min > 0, 63.0 / np.where(max_min > 0, max_min, 1), 0.0)
    ls = np.clip(_nearest_int(inv_scale[:, None] * scales), 0, 63).astype(np.uint8)
    lm = np.clip(_nearest_int(inv_min[:, None] * mins), 0, 63).astype(np.uint8)
    d = np.where(max_scale > 0, max_scale / 63.0, 0.0).astype(np.float16)
    dmin = np.where(max_min > 0, max_min / 63.0, 0.0).astype(np.float16)
    dl = d.astype(np.float32)[:, None] * ls
    ml = dmin.astype(np.float32)[:, None] * lm
    with np.errstate(divide="ignore", invalid="ignore"):
        Lq = _nearest_int((groups + ml[..., None]) / np.where(dl == 0, 1, dl)[..., None])
    Lq = np.clip(Lq, 0, 15).astype(np.uint8)
    Lq = np.where((dl == 0)[..., None], 0, Lq).reshape(nb, 4, 2, 32)
    out = np.empty((nb, 144), np.uint8)
    out[:, 0:2] = d.astype("<f2").view(np.uint8).reshape(-1, 2)
    out[:, 2:4] = dmin.astype("<f2").view(np.uint8).reshape(-1, 2)
    out[:, 4:16] = _pack_scale_min_k4(ls, lm)
    out[:, 16:144] = (Lq[:, :, 0] | (Lq[:, :, 1] << 4)).reshape(nb, 128)
    return out


def quantize(x: np.ndarray, t: GGMLType) -> np.ndarray:
    """Encode float32 array `x` into ggml type `t` (returns uint8 buffer)."""
    t = GGMLType(t)
    x = np.ascontiguousarray(x, np.float32).reshape(-1)
    if t == GGMLType.F32:
        return x.view(np.uint8).copy()
    if t == GGMLType.F16:
        return x.astype("<f2").view(np.uint8).copy()
    if t != GGMLType.Q4_K:
        raise _not_ported(t)
    if x.size % QK_K:
        raise ValueError(f"{x.size} not a multiple of block size {QK_K}")
    return _q_q4_K(x.reshape(-1, QK_K)).reshape(-1)


# -- structured decomposition: x[i] = q[i] * s[i // g] + m[i // g] ---------------


def decompose(data, t: GGMLType, n: int):
    """Flat buffer -> (q int8 (n,), s f32 (n/group,), m f32, group).
    Bit-exact with dequantize (the same float ops)."""
    t = GGMLType(t)
    if t != GGMLType.Q4_K:
        raise _not_ported(t)
    b = _blocks(data, t, n)
    nb = b.shape[0]
    d = _f16(b[:, 0:2])
    dmin = _f16(b[:, 2:4])
    sc, mn = _unpack_scale_min_k4(b[:, 4:16])
    qs = b[:, 16:144].reshape(nb, 4, 1, 32)
    # element 64*chunk + 32*hi + pos reads nibble `hi` of byte 32*chunk + pos
    q = np.concatenate([qs & 0xF, qs >> 4], axis=2).view(np.int8)
    s = d * sc.astype(np.float32)
    m = -(dmin * mn.astype(np.float32))
    return q.reshape(-1)[:n], s.reshape(-1), m.reshape(-1), QK


def decompose_factors(data, t: GGMLType, n: int):
    """Factored scale planes of a k-quant: (sd (nb, 1) f32, sub-scales
    (nb, 8) int8, sm = -dmin (nb, 1) f32, sub-mins (nb, 8) int8, group).
    s = sd * sub and m = sm * sub reproduce decompose's planes bit for bit."""
    t = GGMLType(t)
    if t != GGMLType.Q4_K:
        raise _not_ported(t)
    b = _blocks(data, t, n)
    d = _f16(b[:, 0:2])
    dmin = _f16(b[:, 2:4])
    sc, mn = _unpack_scale_min_k4(b[:, 4:16])
    return d, sc.astype(np.int8), -dmin, mn.astype(np.int8), QK
