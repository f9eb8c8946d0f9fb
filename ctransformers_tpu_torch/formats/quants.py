"""GGML block quantization, numpy, limited to the types the port serves.

A copy of ctransformers_tpu/formats/quants.py for F32, F16, the legacy
block types Q4_0, Q4_1, Q5_0, Q5_1 and Q8_0 (block layouts: the
reference's ggml.c; decode: dequantize_row_q*; encode:
quantize_row_q*_reference) and the k-quants Q2_K, Q3_K, Q4_K, Q5_K and
Q6_K of llama Q2_K, Q3_K_S/M/L, Q4_K_M and Q5_K_M files (k_quants.h;
dequantize_row_q{2,3,4,5,6}_K; quantize_row_q{2,3,4,5,6}_K_reference).
Every other block type has its size here, so a GGUF holding it can be
parsed, but decoding it raises NotImplementedError until a later slice
ports it (see ROADMAP).
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


def _unpack_q3k_scales(sc_bytes: np.ndarray) -> np.ndarray:
    """q3_K's 12-byte packed 6-bit scales -> (nb, 16) int32 in [-32, 31]."""
    a = sc_bytes.view("<u4")  # (nb, 3)
    a0, a1, tmp = a[..., 0], a[..., 1], a[..., 2]
    k1, k2 = np.uint32(0x03030303), np.uint32(0x0F0F0F0F)
    n0 = (a0 & k2) | (((tmp >> 0) & k1) << 4)
    n1 = (a1 & k2) | (((tmp >> 2) & k1) << 4)
    n2 = ((a0 >> 4) & k2) | (((tmp >> 4) & k1) << 4)
    n3 = ((a1 >> 4) & k2) | (((tmp >> 6) & k1) << 4)
    words = np.stack([n0, n1, n2, n3], axis=-1).astype("<u4")
    return words.view(np.int8).astype(np.int32) - 32


def _pack_q3k_scales(scales: np.ndarray) -> np.ndarray:
    """Inverse of _unpack_q3k_scales; scales (nb, 16) in [-32, 31]."""
    s = (scales + 32).astype(np.uint8)  # 6-bit
    lo = s & 0xF
    hi = s >> 4  # 2 bits
    out = np.zeros(s.shape[:-1] + (12,), np.uint8)
    out[..., 0:8] = lo[..., 0:8] | (lo[..., 8:16] << 4)
    # byte b of [8:12] packs the high bits of scales b, b+4, b+8, b+12
    for k in range(4):
        out[..., 8:12] |= hi[..., 4 * k : 4 * k + 4] << (2 * k)
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
    if t not in _DEQUANT:
        raise _not_ported(t)
    return _DEQUANT[t](_blocks(data, t, n)).reshape(-1)[:n]


def _dq_from_dc(dc):
    """dequantize_row_q* as q * s + m from the format's decomposition: the
    same f32 products and sums as the reference (d * q + m for the legacy
    types, dl * q - ml for the k-quants)."""
    def dq(b):
        q, s, m, group = dc(b)
        nb = b.shape[0]
        w = q.reshape(nb, -1, group).astype(np.float32) * s.reshape(nb, -1, 1)
        if m is not None:
            w = w + m.reshape(nb, -1, 1)
        return w.reshape(nb, -1)
    return dq


# -- quantization (quantize_row_q*_reference) ------------------------------------


def _signed_absmax(xb):
    """Value with the largest |x| per block, keeping its sign."""
    idx = np.argmax(np.abs(xb), axis=1)
    return xb[np.arange(xb.shape[0]), idx]


def _inverse(d):
    return np.where(d != 0, np.divide(1.0, d, where=d != 0), 0.0)


def _q5_high_word(lo, hi):
    """The 32 fifth bits of a Q5 block as one little-endian u32 (bit j:
    element j, bit j + 16: element j + 16)."""
    qh = np.zeros(lo.shape[0], np.uint32)
    for j in range(16):
        qh |= ((lo[:, j].astype(np.uint32) & 0x10) >> 4) << j
        qh |= ((hi[:, j].astype(np.uint32) & 0x10) >> 4) << (j + 16)
    return qh.astype("<u4").view(np.uint8).reshape(-1, 4)


def _f16_head(x):
    return x.astype("<f2").view(np.uint8).reshape(-1, 2)


def _q_q4_0(xb):
    d = _signed_absmax(xb) / -8.0
    q = np.minimum(15, np.floor(xb * _inverse(d)[:, None] + 8.5).astype(np.int32))
    q = np.maximum(q, 0).astype(np.uint8)
    out = np.empty((xb.shape[0], 18), np.uint8)
    out[:, 0:2] = _f16_head(d)
    out[:, 2:18] = q[:, :16] | (q[:, 16:] << 4)
    return out


def _q_q4_1(xb):
    mn = xb.min(axis=1)
    d = (xb.max(axis=1) - mn) / 15.0
    q = np.minimum(
        15, np.floor((xb - mn[:, None]) * _inverse(d)[:, None] + 0.5).astype(np.int32)
    ).astype(np.uint8)
    out = np.empty((xb.shape[0], 20), np.uint8)
    out[:, 0:2] = _f16_head(d)
    out[:, 2:4] = _f16_head(mn)
    out[:, 4:20] = q[:, :16] | (q[:, 16:] << 4)
    return out


def _q_q5_0(xb):
    d = _signed_absmax(xb) / -16.0
    q = np.minimum(31, np.floor(xb * _inverse(d)[:, None] + 16.5).astype(np.int32))
    q = np.maximum(q, 0).astype(np.uint8)
    lo, hi = q[:, :16], q[:, 16:]
    out = np.empty((xb.shape[0], 22), np.uint8)
    out[:, 0:2] = _f16_head(d)
    out[:, 2:6] = _q5_high_word(lo, hi)
    out[:, 6:22] = (lo & 0xF) | ((hi & 0xF) << 4)
    return out


def _q_q5_1(xb):
    mn = xb.min(axis=1)
    d = (xb.max(axis=1) - mn) / 31.0
    q = np.floor((xb - mn[:, None]) * _inverse(d)[:, None] + 0.5).astype(np.int32)
    q = np.clip(q, 0, 31).astype(np.uint8)
    lo, hi = q[:, :16], q[:, 16:]
    out = np.empty((xb.shape[0], 24), np.uint8)
    out[:, 0:2] = _f16_head(d)
    out[:, 2:4] = _f16_head(mn)
    out[:, 4:8] = _q5_high_word(lo, hi)
    out[:, 8:24] = (lo & 0xF) | ((hi & 0xF) << 4)
    return out


def _q_q8_0(xb):
    d = np.abs(xb).max(axis=1) / 127.0
    q = _round_half_away(xb * _inverse(d)[:, None]).astype(np.int8)
    out = np.empty((xb.shape[0], 34), np.uint8)
    out[:, 0:2] = _f16_head(d)
    out[:, 2:34] = q.view(np.uint8)
    return out


def _round_half_away(x):
    """C roundf semantics: round half away from zero."""
    return np.sign(x) * np.floor(np.abs(x) + 0.5)


def _nearest_int(x):
    return _round_half_away(x).astype(np.int32)


def _make_qkx2_quants(xs, nmax, weights, rmin, rdelta, nstep, use_mad=False):
    """Vectorized make_qkx2_quants: the weighted grid-search min/scale fit;
    x ~= scale*L - the_min with L in [0, nmax]. The fit's error is the
    weighted squared difference, or with `use_mad` (Q2_K) the weighted
    absolute one."""
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
    diff = np.abs(diff) if use_mad else diff * diff
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
        diff = np.abs(diff) if use_mad else diff * diff
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


def _make_qx_quants(xs, nmax):
    """Vectorized make_qx_quants with rmse_type 1 (the Q6_K fit): x = d*q,
    q in [-nmax, nmax-1]. xs: (..., gs) groups; returns (scales, quants)."""
    amax = np.abs(xs).max(axis=-1)
    idx = np.abs(xs).argmax(axis=-1)
    mx = np.take_along_axis(xs, idx[..., None], axis=-1)[..., 0]
    zero = amax == 0
    iscale = np.where(zero, 0.0, -nmax / np.where(zero, 1.0, mx))
    w = xs * xs
    best_q = np.clip(_nearest_int(iscale[..., None] * xs), -nmax, nmax - 1)
    sumlx = (w * xs * best_q).sum(axis=-1)
    suml2 = (w * best_q * best_q).sum(axis=-1)
    best = np.where(suml2 > 0, sumlx * sumlx / np.where(suml2 > 0, suml2, 1), 0.0)
    best_scale = np.where(suml2 > 0, sumlx / np.where(suml2 > 0, suml2, 1), 0.0)
    for is_ in range(-4, 5):
        if is_ == 0:
            continue
        isc = -(nmax + 0.1 * is_) / np.where(zero, 1.0, mx)
        q = np.clip(_nearest_int(isc[..., None] * xs), -nmax, nmax - 1)
        sl = (w * xs * q).sum(axis=-1)
        s2 = (w * q * q).sum(axis=-1)
        cand = np.where(s2 > 0, sl * sl / np.where(s2 > 0, s2, 1), -1.0)
        upd = (s2 > 0) & (cand > best)
        best = np.where(upd, cand, best)
        new_scale = np.where(s2 > 0, sl / np.where(s2 > 0, s2, 1), 0.0)
        best_scale = np.where(upd, new_scale, best_scale)
        best_q = np.where(upd[..., None], q, best_q)
    best_scale = np.where(zero, 0.0, best_scale)
    best_q = np.where(zero[..., None], 0, best_q)
    return best_scale, best_q


def _q_q2_K(xb):
    """4-bit sub-scales and sub-mins per group of 16 (|x|-weighted fit with
    absolute error), f16 d and dmin per superblock, 2-bit grid."""
    nb = xb.shape[0]
    groups = xb.reshape(nb, 16, 16)
    scales, _, mins = _make_qkx2_quants(
        groups, 3, np.abs(groups), rmin=-0.5, rdelta=0.1, nstep=15, use_mad=True
    )
    max_scale = scales.max(axis=1)
    max_min = mins.max(axis=1)
    inv_scale = np.where(max_scale > 0, 15.0 / np.where(max_scale > 0, max_scale, 1), 0.0)
    inv_min = np.where(max_min > 0, 15.0 / np.where(max_min > 0, max_min, 1), 0.0)
    ls = _nearest_int(inv_scale[:, None] * scales).astype(np.uint8)
    lm = _nearest_int(inv_min[:, None] * mins).astype(np.uint8)
    packed_sc = (ls & 0xF) | (lm << 4)
    d = np.where(max_scale > 0, max_scale / 15.0, 0.0).astype(np.float16)
    dmin = np.where(max_min > 0, max_min / 15.0, 0.0).astype(np.float16)
    # the second pass: each group quantized again with its quantized scale
    dl = d.astype(np.float32)[:, None] * (packed_sc & 0xF)
    ml = dmin.astype(np.float32)[:, None] * (packed_sc >> 4)
    with np.errstate(divide="ignore", invalid="ignore"):
        Lq = _nearest_int((groups + ml[..., None]) / np.where(dl == 0, 1, dl)[..., None])
    Lq = np.clip(Lq, 0, 3).astype(np.uint8)
    Lq = np.where((dl == 0)[..., None], 0, Lq)
    # element 128*half + 32*j + pos: bits 2j of byte 32*half + pos
    shifted = Lq.reshape(nb, 2, 4, 32) << (2 * np.arange(4, dtype=np.uint8)).reshape(4, 1)
    out = np.empty((nb, 84), np.uint8)
    out[:, 0:16] = packed_sc
    out[:, 16:80] = np.bitwise_or.reduce(shifted, axis=2).reshape(nb, 64)
    out[:, 80:82] = _f16_head(d)
    out[:, 82:84] = _f16_head(dmin)
    return out


def _q_q3_K(xb):
    """Signed 6-bit sub-scales per group of 16 (the rmse_type 1 fit), an
    f16 d per superblock, and the grid q in [-4, 3] stored as q + 4: two
    bits in qs, the third in hmask."""
    nb = xb.shape[0]
    groups = xb.reshape(nb, 16, 16)
    scales, _ = _make_qx_quants(groups, 4)
    amax_idx = np.abs(scales).argmax(axis=1)
    max_scale = np.take_along_axis(scales, amax_idx[:, None], axis=1)[:, 0]
    nz = max_scale != 0
    iscale = np.where(nz, -32.0 / np.where(nz, max_scale, 1.0), 0.0)
    l6 = np.clip(_nearest_int(iscale[:, None] * scales), -32, 31)
    d = np.where(nz, 1.0 / np.where(iscale == 0, 1.0, iscale), 0.0).astype(np.float16)
    dl = d.astype(np.float32)[:, None] * l6.astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        L = _nearest_int(groups / np.where(dl == 0, 1, dl)[..., None])
    L = np.clip(L, -4, 3)
    L = (np.where((dl == 0)[..., None], 0, L) + 4).astype(np.uint8)
    # element 128*half + 32*j + pos: bits 2j of qs byte 32*half + pos, the
    # high bit at bit 4*half + j of hmask byte pos
    L = L.reshape(nb, 2, 4, 32)
    lo = (L & 3) << (2 * np.arange(4, dtype=np.uint8)).reshape(4, 1)
    hi = ((L >> 2) & 1) << np.arange(8, dtype=np.uint8).reshape(2, 4, 1)
    out = np.empty((nb, 110), np.uint8)
    out[:, 0:32] = np.bitwise_or.reduce(hi.reshape(nb, 8, 32), axis=1)
    out[:, 32:96] = np.bitwise_or.reduce(lo, axis=2).reshape(nb, 64)
    out[:, 96:108] = _pack_q3k_scales(l6)
    out[:, 108:110] = _f16_head(d)
    return out


def _qkx_45(xb, nmax):
    """The shared Q4_K / Q5_K encoder: 6-bit sub-scales and sub-mins per
    group of 32, f16 d and dmin per superblock, and the grid Lq."""
    nb = xb.shape[0]
    groups = xb.reshape(nb, 8, 32)
    weights = np.sqrt((groups * groups).mean(axis=-1, keepdims=True)) + np.abs(groups)
    # Q4_K: (rmin -1, nstep 20); Q5_K: (rmin -0.5, nstep 15)
    rmin, nstep = (-1.0, 20) if nmax == 15 else (-0.5, 15)
    scales, _, mins = _make_qkx2_quants(
        groups, nmax, weights, rmin=rmin, rdelta=0.1, nstep=nstep
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
    Lq = np.clip(Lq, 0, nmax).astype(np.uint8)
    Lq = np.where((dl == 0)[..., None], 0, Lq)
    return d, dmin, _pack_scale_min_k4(ls, lm), Lq.reshape(nb, 4, 2, 32)


def _kquant_head(d, dmin, sc_packed, nbytes):
    out = np.empty((d.shape[0], nbytes), np.uint8)
    out[:, 0:2] = d.astype("<f2").view(np.uint8).reshape(-1, 2)
    out[:, 2:4] = dmin.astype("<f2").view(np.uint8).reshape(-1, 2)
    out[:, 4:16] = sc_packed
    return out


def _q_q4_K(xb):
    d, dmin, sc_packed, Lq = _qkx_45(xb, 15)
    out = _kquant_head(d, dmin, sc_packed, 144)
    out[:, 16:144] = (Lq[:, :, 0] | (Lq[:, :, 1] << 4)).reshape(-1, 128)
    return out


def _q_q5_K(xb):
    d, dmin, sc_packed, Lq = _qkx_45(xb, 31)
    lo, hi = Lq[:, :, 0], Lq[:, :, 1]  # (nb, chunk, 32)
    out = _kquant_head(d, dmin, sc_packed, 176)
    qh = np.zeros((xb.shape[0], 32), np.uint8)
    for chunk in range(4):
        qh |= (lo[:, chunk] >> 4) << (2 * chunk)
        qh |= (hi[:, chunk] >> 4) << (2 * chunk + 1)
    out[:, 16:48] = qh
    out[:, 48:176] = ((lo & 0xF) | ((hi & 0xF) << 4)).reshape(-1, 128)
    return out


def _q_q6_K(xb):
    nb = xb.shape[0]
    groups = xb.reshape(nb, 16, 16)
    scales, _ = _make_qx_quants(groups, 32)
    amax_idx = np.abs(scales).argmax(axis=1)
    max_abs_scale = np.take_along_axis(np.abs(scales), amax_idx[:, None], axis=1)[:, 0]
    max_scale = np.take_along_axis(scales, amax_idx[:, None], axis=1)[:, 0]
    nz = max_abs_scale != 0
    iscale = np.where(nz, -128.0 / np.where(nz, max_scale, 1.0), 0.0)
    d = np.where(nz, 1.0 / np.where(iscale == 0, 1.0, iscale), 0.0).astype(np.float16)
    l8 = np.clip(_nearest_int(iscale[:, None] * scales), -128, 127).astype(np.int8)
    dl = d.astype(np.float32)[:, None] * l8.astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        Lq = _nearest_int(groups / np.where(dl == 0, 1, dl)[..., None])
    Lq = np.clip(Lq, -32, 31)
    Lq = np.where((dl == 0)[..., None], 0, Lq) + 32
    flat = Lq.reshape(nb, 256).astype(np.uint8)
    ql = np.zeros((nb, 128), np.uint8)
    qh = np.zeros((nb, 64), np.uint8)
    for half in range(2):
        q1, q2, q3, q4 = (flat[:, 128 * half + 32 * j : 128 * half + 32 * j + 32] for j in range(4))
        ql[:, 64 * half : 64 * half + 32] = (q1 & 0xF) | ((q3 & 0xF) << 4)
        ql[:, 64 * half + 32 : 64 * half + 64] = (q2 & 0xF) | ((q4 & 0xF) << 4)
        qh[:, 32 * half : 32 * half + 32] = (
            (q1 >> 4) | ((q2 >> 4) << 2) | ((q3 >> 4) << 4) | ((q4 >> 4) << 6)
        )
    out = np.empty((nb, 210), np.uint8)
    out[:, 0:128] = ql
    out[:, 128:192] = qh
    out[:, 192:208] = l8.view(np.uint8)
    out[:, 208:210] = d.astype("<f2").view(np.uint8).reshape(-1, 2)
    return out


_QUANT = {
    GGMLType.Q2_K: _q_q2_K,
    GGMLType.Q3_K: _q_q3_K,
    GGMLType.Q4_0: _q_q4_0,
    GGMLType.Q4_1: _q_q4_1,
    GGMLType.Q5_0: _q_q5_0,
    GGMLType.Q5_1: _q_q5_1,
    GGMLType.Q8_0: _q_q8_0,
    GGMLType.Q4_K: _q_q4_K,
    GGMLType.Q5_K: _q_q5_K,
    GGMLType.Q6_K: _q_q6_K,
}


def quantize(x: np.ndarray, t: GGMLType) -> np.ndarray:
    """Encode float32 array `x` into ggml type `t` (returns uint8 buffer)."""
    t = GGMLType(t)
    x = np.ascontiguousarray(x, np.float32).reshape(-1)
    if t == GGMLType.F32:
        return x.view(np.uint8).copy()
    if t == GGMLType.F16:
        return x.astype("<f2").view(np.uint8).copy()
    if t not in _QUANT:
        raise _not_ported(t)
    bs, _ = _TRAITS[t]
    if x.size % bs:
        raise ValueError(f"{x.size} not a multiple of block size {bs}")
    return _QUANT[t](x.reshape(-1, bs)).reshape(-1)


# -- structured decomposition: x[i] = q[i] * s[i // g] + m[i // g] ---------------


def _q5_highbits(qh_bytes):
    """(nb, 4) uint8 -> (nb, 32) uint8 fifth bit of each element (0 or 16):
    bit e of the little-endian u32 belongs to element e."""
    return np.unpackbits(qh_bytes, axis=1, bitorder="little") << np.uint8(4)


def _nibbles(qs):
    """The 16 bytes of a legacy block -> its 32 elements as uint8 (low
    nibbles are elements 0-15, high nibbles 16-31)."""
    return np.concatenate([qs & 0xF, qs >> 4], axis=1)


def _dc_q4_0(b):
    return _nibbles(b[:, 2:18]).view(np.int8) - np.int8(8), _f16(b[:, 0:2]), None, QK


def _dc_q4_1(b):
    return _nibbles(b[:, 4:20]).view(np.int8), _f16(b[:, 0:2]), _f16(b[:, 2:4]), QK


def _dc_q5_0(b):
    q = (_nibbles(b[:, 6:22]) | _q5_highbits(b[:, 2:6])).view(np.int8) - np.int8(16)
    return q, _f16(b[:, 0:2]), None, QK


def _dc_q5_1(b):
    q = (_nibbles(b[:, 8:24]) | _q5_highbits(b[:, 4:8])).view(np.int8)
    return q, _f16(b[:, 0:2]), _f16(b[:, 2:4]), QK


def _dc_q8_0(b):
    return b[:, 2:34].view(np.int8).copy(), _f16(b[:, 0:2]), None, QK


def _dc_q2_K(b):
    nb = b.shape[0]
    sc = b[:, 0:16]
    d = _f16(b[:, 80:82])
    dmin = _f16(b[:, 82:84])
    # element 128*half + 32*j + pos: bits 2j of qs byte 32*half + pos
    qs = b[:, 16:80].reshape(nb, 2, 1, 32)
    q = ((qs >> (2 * np.arange(4, dtype=np.uint8)).reshape(4, 1)) & 3).view(np.int8)
    # group l // 16 = 8*half + 2*j + pos//16 is the scales' own order
    s = d * (sc & 0xF).astype(np.float32)
    m = -(dmin * (sc >> 4).astype(np.float32))
    return q, s, m, 16


def _dc_q3_K(b):
    nb = b.shape[0]
    hmask = b[:, 0:32].reshape(nb, 1, 1, 32)
    qs = b[:, 32:96].reshape(nb, 2, 1, 32)
    d = _f16(b[:, 108:110])
    # as Q2_K, less 4 where bit 4*half + j of hmask byte pos is clear
    lo = (qs >> (2 * np.arange(4, dtype=np.uint8)).reshape(4, 1)) & 3
    hb = (hmask >> np.arange(8, dtype=np.uint8).reshape(2, 4, 1)) & 1
    q = lo.view(np.int8) - ((hb ^ 1) << 2).view(np.int8)
    s = d * _unpack_q3k_scales(np.ascontiguousarray(b[:, 96:108])).astype(np.float32)
    return q, s, None, 16


def _dc_q4_K(b):
    nb = b.shape[0]
    d = _f16(b[:, 0:2])
    dmin = _f16(b[:, 2:4])
    sc, mn = _unpack_scale_min_k4(b[:, 4:16])
    qs = b[:, 16:144].reshape(nb, 4, 1, 32)
    # element 64*chunk + 32*hi + pos reads nibble `hi` of byte 32*chunk + pos
    q = np.concatenate([qs & 0xF, qs >> 4], axis=2).view(np.int8)
    s = d * sc.astype(np.float32)
    m = -(dmin * mn.astype(np.float32))
    return q, s, m, QK


def _dc_q5_K(b):
    nb = b.shape[0]
    d = _f16(b[:, 0:2])
    dmin = _f16(b[:, 2:4])
    sc, mn = _unpack_scale_min_k4(b[:, 4:16])
    qh = b[:, 16:48].reshape(nb, 1, 1, 32)
    qs = b[:, 48:176].reshape(nb, 4, 1, 32)
    # as Q4_K, plus bit 2*chunk + hi of qh[pos] as the fifth bit
    lo = np.concatenate([qs & 0xF, qs >> 4], axis=2)
    hb = (qh >> np.arange(8, dtype=np.uint8).reshape(4, 2, 1)) & 1
    q = (lo | (hb << 4)).view(np.int8)
    s = d * sc.astype(np.float32)
    m = -(dmin * mn.astype(np.float32))
    return q, s, m, QK


def _dc_q6_K(b):
    nb = b.shape[0]
    ql = b[:, 0:128].reshape(nb, 2, 1, 2, 32)
    qh = b[:, 128:192].reshape(nb, 2, 1, 32)
    d = _f16(b[:, 208:210])
    # element 128*half + 32*grp + pos: nibble grp//2 of ql[64*half +
    # 32*(grp%2) + pos], high bits 2*grp of qh[32*half + pos]
    lo = np.concatenate([ql & 0xF, ql >> 4], axis=2).reshape(nb, 2, 4, 32)
    hi = (qh >> (2 * np.arange(4, dtype=np.uint8)).reshape(4, 1)) & 3
    q = (lo | (hi << 4)).view(np.int8) - np.int8(32)
    # group l // 16 = 8*half + 2*grp + pos//16 is the scales' own order
    s = d * b[:, 192:208].view(np.int8).astype(np.float32)
    return q, s, None, 16


_DECOMP = {
    GGMLType.Q2_K: _dc_q2_K,
    GGMLType.Q3_K: _dc_q3_K,
    GGMLType.Q4_0: _dc_q4_0,
    GGMLType.Q4_1: _dc_q4_1,
    GGMLType.Q5_0: _dc_q5_0,
    GGMLType.Q5_1: _dc_q5_1,
    GGMLType.Q8_0: _dc_q8_0,
    GGMLType.Q4_K: _dc_q4_K,
    GGMLType.Q5_K: _dc_q5_K,
    GGMLType.Q6_K: _dc_q6_K,
}
_DEQUANT = {t: _dq_from_dc(dc) for t, dc in _DECOMP.items()}


def decompose(data, t: GGMLType, n: int):
    """Flat buffer -> (q int8 (n,), s f32 (n/group,), m f32 | None, group).
    Bit-exact with dequantize (the same float ops)."""
    t = GGMLType(t)
    if t not in _DECOMP:
        raise _not_ported(t)
    q, s, m, group = _DECOMP[t](_blocks(data, t, n))
    q = q.reshape(-1)[:n]
    s = np.ascontiguousarray(s, np.float32).reshape(-1)[: n // group]
    if m is not None:
        m = np.ascontiguousarray(m, np.float32).reshape(-1)[: n // group]
    return q, s, m, group


def decompose_factors(data, t: GGMLType, n: int):
    """Factored scale planes of a k-quant: (sd (nb, 1) f32, sub-scales
    (nb, 256/group) int8, sm = -dmin (nb, 1) f32 or None, sub-mins int8 or
    None, group). s = sd * sub and m = sm * sub reproduce decompose's planes
    bit for bit. Q3_K and Q6_K have no mins. None for a type without
    superblocks (the legacy types: their f32 planes are decompose's own)."""
    t = GGMLType(t)
    if t not in _DECOMP:
        raise _not_ported(t)
    if _TRAITS[t][0] != QK_K:
        return None
    b = _blocks(data, t, n)
    if t == GGMLType.Q2_K:
        sc = b[:, 0:16]
        return (_f16(b[:, 80:82]), (sc & 0xF).astype(np.int8), -_f16(b[:, 82:84]),
                (sc >> 4).astype(np.int8), 16)
    if t == GGMLType.Q3_K:
        scales = _unpack_q3k_scales(np.ascontiguousarray(b[:, 96:108]))
        return _f16(b[:, 108:110]), scales.astype(np.int8), None, None, 16
    if t == GGMLType.Q6_K:
        return _f16(b[:, 208:210]), b[:, 192:208].view(np.int8).copy(), None, None, 16
    d = _f16(b[:, 0:2])
    dmin = _f16(b[:, 2:4])
    sc, mn = _unpack_scale_min_k4(b[:, 4:16])
    return d, sc.astype(np.int8), -dmin, mn.astype(np.int8), QK
