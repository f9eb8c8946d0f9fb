"""GPTQ checkpoint format: unpack and repack into the port's QTensor
(ctransformers_tpu/formats/gptq.py).

GPTQ-for-LLaMa tensor layout (per layer):

    qweight (K/8, N)  int32   8 x 4-bit weights packed along K
    qzeros  (G, N/8)  int32   8 x 4-bit zero-points packed along N,
                              stored MINUS ONE (the classic +1 quirk)
    scales  (G, N)    f16     per-(group, column) scale
    g_idx   (K,)      int32   group of each input row (act-order support)

Dequant: w[k, n] = scales[g(k), n] * (q[k, n] - zeros[g(k), n]).

Mapping to QTensor: K is already the leading dim (x @ W needs no
transpose); scale plane s = scales, min plane m = -scales * zeros, both
plain f32 (sfactor 0), group = K / G. Act-order checkpoints are handled by
stably sorting rows by g_idx so groups become contiguous; the row
permutation is applied to activations at matmul time (QTensor.perm)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..ops.qmatmul import QTensor, make_qtensor


def _unpack_nibbles(a: np.ndarray, axis: int) -> np.ndarray:
    """int32 words -> uint8 nibbles in [0, 15], 8 per word along `axis`,
    low nibble first."""
    u = a.astype(np.uint32)
    nib = np.stack(
        [((u >> np.uint32(4 * j)) & np.uint32(0xF)).astype(np.uint8) for j in range(8)],
        axis + 1,
    )
    shape = list(a.shape)
    shape[axis] *= 8
    return nib.reshape(shape)


def unpack_qweight(qweight: np.ndarray) -> np.ndarray:
    """(K/8, N) int32 -> (K, N) uint8 in [0, 15]."""
    return _unpack_nibbles(qweight, 0)


def unpack_qzeros(qzeros: np.ndarray) -> np.ndarray:
    """(G, N/8) int32 -> (G, N) uint8 zero-points (the +1 applied)."""
    return (_unpack_nibbles(qzeros, 1) + 1) & 0xF


def gptq_dequant(
    qweight: np.ndarray,
    qzeros: np.ndarray,
    scales: np.ndarray,
    g_idx: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Reference dense dequant, (K, N) f32: the test oracle."""
    q = unpack_qweight(qweight).astype(np.float32)
    zeros = unpack_qzeros(qzeros).astype(np.float32)
    scales = np.asarray(scales, np.float32)
    k = q.shape[0]
    if g_idx is None:
        group = k // scales.shape[0]
        g_idx = np.arange(k) // group
    return scales[g_idx] * (q - zeros[g_idx])


def gptq_to_qtensor(
    qweight: np.ndarray,
    qzeros: np.ndarray,
    scales: np.ndarray,
    g_idx: Optional[np.ndarray] = None,
) -> QTensor:
    q = unpack_qweight(qweight)
    zeros = unpack_qzeros(qzeros).astype(np.float32)
    s = np.asarray(scales, np.float32)
    k, n = q.shape
    n_groups = s.shape[0]
    group = k // n_groups

    perm = None
    if g_idx is not None:
        g_idx = np.asarray(g_idx, np.int64)
        trivial = np.arange(k) // group
        if not np.array_equal(g_idx, trivial):
            # act-order: stable-sort rows so each group is contiguous
            perm = np.argsort(g_idx, kind="stable").astype(np.int32)
            q = q[perm]
            counts = np.bincount(g_idx, minlength=n_groups)
            if not np.all(counts == group):
                raise ValueError("GPTQ groups are not uniform size")

    m = -(s * zeros)  # additive constant per (group, column)
    return make_qtensor(q.astype(np.int8), s, m, "GPTQ4", group, perm=perm)
