"""Decode attention (T = 1) over the stacked KV cache: the hand-written
Hopper kernel of csrc/attn_decode.cu, its plain PyTorch version and its
launch counter.

decode_attention computes what the JAX package's Pallas decode_attention
(scripts/_attention_kernel.py:decode_attention, kernel _kernel) computes,
for one decode token per slot:

  * q (B, H, dh) f32 is scaled by float32(1) / sqrt(float32(dh)) and rounded
    to the compute dtype cdt BEFORE the QK dot (bf16 for an int8 cache, the
    cache dtype otherwise);
  * layer `il` of the full stacked cache (L, B, S, Hkv, dh) (sequence-major)
    or (L, B, Hkv, S, dh) (head-major) is read over [0, window), each kv
    head serving its rep = H / Hkv query heads (any rep; on the card any
    head width dh whose q rows and scores fit a block's shared memory,
    kernel_smem_bytes: every width up to 1024 at any chunk up to 512, wider
    heads in column slices of 256);
  * the softmax is online over chunks of `chunk` positions counted from 0
    (decode_chunk shrinks the chunk to divide the window, as the Pallas
    function does): scores are summed in f32 (a head wider than 256 as
    the sum of its column slices' dots of 256, in slice order), multiplied
    by the int8 cache's k_scale[s], given slope * kpos with ALiBi, masked to
    kpos <= n_past[b]; l sums the unscaled p = exp(score - running max),
    and p * v_scale[s] is rounded to cdt before the PV dot;
  * the result is acc / max(l, 1e-30), (B, H, dh) f32.

The rounding of p after subtracting the RUNNING max makes a bf16 result
depend on the chunk partition, so the kernel and its plain version share
it; for the same reason they share a wide head's column slices (a score
an ulp apart may round p to the other neighbour: on a tiny 320-wide
llama with an int8 cache one such flip moved a call by 4.8e-4 against a
score summed in one piece). A CUDA tensor launches the kernel or raises;
a CPU tensor takes the plain version. There is no fallback from one to
the other.

On the card the kernel splits the window over the blocks of a
thread-block cluster (decode_plan); each block forms every chunk's running
max from all parts' maxima, in chunk order, so p rounds as here; only the
sums of l and p * v are taken per part and then added in part order.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import qmm_kernels as K

DEFAULT_CHUNK = 512
# the kernel's limit (the plain version has none): the shared memory of one
# block (the card's 227 KB), which holds q * scale for the block's query
# heads (at most MAX_REP of a kv head's; more heads a kv head take more
# blocks) at the head's padded width (64, 128 or 256; a wider head in
# column slices of 256), a span of its part's scores (as many rows as fit
# SCORE_BUDGET), an int8 cache's V scales, the PV pass's sums and four
# numbers a (head, chunk) of the window; csrc/attn_decode.cu:ct_decode_attn
# computes the same
MAX_SMEM_BYTES = 227 * 1024
MAX_REP = 8
SLICE = 256
SCORE_BUDGET = 64 * 1024
THREADS, VEC = 256, 4
# floats of the kernel's `red`: the PV rows' sums, then a part's column sums
RED = max(THREADS * VEC, MAX_REP * SLICE)
# the window's split over a thread-block cluster (decode_plan): at most
# MAX_PARTS blocks a cluster, each part at least MIN_PART rows
MAX_PARTS, MIN_PART = 8, 64
SOURCE = "ctransformers_tpu_torch/csrc/attn_decode.cu"
REPLACES = "scripts/_attention_kernel.py:47"
# cache dtype -> the kernel's dtype code (csrc/attn_decode.cu)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2, torch.int8: 3}

# kernel launches (incremented only where the kernel is launched) and calls
# of the plain version through the wrapper (CPU tensors)
LAUNCHES: Dict[str, int] = {"decode_attn": 0}
PLAIN_CALLS: Dict[str, int] = {"decode_attn": 0}


def reset_counts() -> None:
    LAUNCHES["decode_attn"] = PLAIN_CALLS["decode_attn"] = 0


def score_scale(dh: int) -> float:
    """1 / sqrt(dh) rounded to f32 the way the JAX package computes it."""
    return float(np.float32(1.0) / np.sqrt(np.float32(dh)))


def decode_chunk(win: int, chunk: int = DEFAULT_CHUNK) -> int:
    """The chunk the Pallas function takes for a window: at most `chunk`,
    shrunk by 256 until it divides the window, else the whole window."""
    chunk = min(chunk, win)
    while chunk > 256 and win % chunk:
        chunk -= 256
    return win if win % chunk else chunk


def decode_plan(batch: int, hkv: int, rep: int, win: int, sms: int) -> Tuple[int, int, int]:
    """(P, rows a part, group): the kernel serves a kv head's `rep` query
    heads in groups of `group` (1, 2, 4 or 8) and splits each window over a
    cluster of P blocks a (slot, kv head, group), part i taking rows
    [i * rows, (i + 1) * rows) of the window. P is the largest power of two
    up to MAX_PARTS whose grid still fits two blocks an SM of the card's
    `sms` (three fit: an H100 holds 45 clusters of 8 at once), with parts
    of at least MIN_PART rows; the group is halved while the grid would give
    an SM at most one block (each group reads the kv head's rows again,
    mostly from L2). It never depends on n_past, which the kernel reads on
    the card (a captured graph replays one grid at every n_past).
    csrc/attn_decode.cu:plan computes the same."""
    group = 1
    while group < min(rep, MAX_REP):
        group *= 2
    while True:
        units = batch * hkv * -(-rep // group)
        parts = 1
        while parts < MAX_PARTS and win >= 2 * parts * MIN_PART and units * 2 * parts <= 2 * sms:
            parts *= 2
        if group > 1 and units * parts <= sms:
            group //= 2
            continue
        return parts, -(-win // parts), group


def kernel_smem_bytes(rep: int, dh: int, win: int, chunk: int, quant: bool,
                      scalar: bool, parts: int = 1) -> int:
    """Shared memory of one block of the kernel: `rep` query heads a block
    (a group of decode_plan, at most MAX_REP), width dh, the window and
    chunk it reads, an int8 cache (`quant`), element-wise loads (`scalar`:
    a width or stride that is no multiple of 4 elements), the window split
    in `parts` (decode_plan)."""
    r = min(rep, MAX_REP)
    span = min(-(-win // parts), max(1, SCORE_BUDGET // (4 * r)))
    if dh > SLICE:
        qw = -(-dh // SLICE) * SLICE
    else:
        qw = SLICE if scalar else 64 if dh <= 64 else 128 if dh <= 128 else SLICE
    return 4 * (r * qw + r * span + RED + 4 * r * (win // chunk)
                + (2 * span if quant else 0))


def sm_count(dev: torch.device) -> int:
    """The card's streaming multiprocessors, which decode_plan fills."""
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _head_major_view(a: torch.Tensor, head_major: bool) -> torch.Tensor:
    """One layer's (B, S, Hkv[, dh]) plane as (B, Hkv, S[, dh]) (a view)."""
    return a if head_major else a.transpose(1, 2)


def plain_decode_attention(q, kv_k, kv_v, il: int, n_past, *, window=None, k_scale=None,
                           v_scale=None, alibi_slopes=None, chunk: int = DEFAULT_CHUNK,
                           head_major: bool = False) -> torch.Tensor:
    """decode_attention in torch ops, chunk by chunk as the kernel runs it:
    operands rounded to cdt are upcast to f32 (exactly) and multiplied in
    f32."""
    k = _head_major_view(kv_k[il], head_major)  # (B, Hkv, S, dh)
    v = _head_major_view(kv_v[il], head_major)
    quant = k_scale is not None
    if quant:
        ks = _head_major_view(k_scale[il], head_major)  # (B, Hkv, S)
        vs = _head_major_view(v_scale[il], head_major)
    b, hkv, s, dh = k.shape
    h = q.shape[1]
    rep = h // hkv
    win = s if window is None else min(window, s)
    c = decode_chunk(win, chunk)
    cdt = torch.bfloat16 if quant else k.dtype
    qt = (q.float() * score_scale(dh)).to(cdt).float().reshape(b, hkv, rep, dh)
    npast = n_past.to(device=q.device, dtype=torch.int64).reshape(b, 1, 1, 1)
    m = torch.full((b, hkv, rep), float("-inf"), device=q.device)
    l = torch.zeros((b, hkv, rep), device=q.device)
    acc = torch.zeros((b, hkv, rep, dh), device=q.device)
    for j in range(win // c):
        part = slice(j * c, (j + 1) * c)
        sc = sum(torch.einsum("bgrd,bgcd->bgrc", qt[..., i:i + SLICE],
                              k[:, :, part, i:i + SLICE].float()) for i in range(0, dh, SLICE))
        if quant:
            sc = sc * ks[:, :, None, part]
        kpos = j * c + torch.arange(c, device=q.device)
        if alibi_slopes is not None:
            sc = sc + alibi_slopes.float().reshape(hkv, rep, 1) * kpos.float()
        sc = sc.masked_fill(~(kpos <= npast), float("-inf"))
        m_new = torch.maximum(m, sc.amax(dim=-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
        alpha = torch.exp(
            torch.where(torch.isfinite(m), m - m_safe, torch.full_like(m, float("-inf")))
        )
        p = torch.exp(sc - m_safe[..., None])
        l = l * alpha + p.sum(dim=-1)
        if quant:
            p = p * vs[:, :, None, part]
        pv = torch.einsum("bgrc,bgcd->bgrd", p.to(cdt).float(), v[:, :, part].float())
        acc = acc * alpha[..., None] + pv
        m = m_new
    return (acc / torch.clamp_min(l, 1e-30)[..., None]).reshape(b, h, dh)


def _check(t: torch.Tensor, name: str, dtype, shape, dev) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != dev:
        raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} on {t.device}, "
                         f"expected {dtype} {tuple(shape)} on {dev}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_operands(q, kv_k, kv_v, il, n_past, window, k_scale, v_scale, alibi_slopes,
                    head_major) -> tuple:
    """Raise on anything the kernel does not take; returns (window read,
    kv heads, head width)."""
    dev = kv_k.device
    if kv_k.dim() != 5 or kv_k.dtype not in DTYPE_CODES:
        raise ValueError(f"kv_k: {kv_k.dtype} {tuple(kv_k.shape)}, expected a (L, B, S, Hkv, dh) "
                         "or (L, B, Hkv, S, dh) f32, bf16, f16 or int8 cache")
    _check(kv_k, "kv_k", kv_k.dtype, kv_k.shape, dev)
    _check(kv_v, "kv_v", kv_k.dtype, kv_k.shape, dev)
    n_layer, b, a1, a2, dh = kv_k.shape
    hkv, s = (a1, a2) if head_major else (a2, a1)
    if q.dim() != 3:
        raise ValueError(f"q: shape {tuple(q.shape)}, expected (B, H, dh)")
    h = q.shape[1]
    _check(q, "q", torch.float32, (b, h, dh), dev)
    if h % hkv:
        raise ValueError(f"{h} query heads over {hkv} kv heads")
    if not 0 <= il < n_layer:
        raise ValueError(f"layer {il} of a {n_layer}-layer cache")
    _check(n_past, "n_past", torch.int32, (b,), dev)
    quant = kv_k.dtype == torch.int8
    if (k_scale is None) != (v_scale is None) or (k_scale is not None) != quant:
        raise ValueError("k_scale and v_scale go with an int8 cache, and only with one")
    if quant:
        _check(k_scale, "k_scale", torch.float32, kv_k.shape[:-1], dev)
        _check(v_scale, "v_scale", torch.float32, kv_k.shape[:-1], dev)
    if alibi_slopes is not None:
        _check(alibi_slopes, "alibi_slopes", torch.float32, (h,), dev)
    if window is not None and window < 1:
        raise ValueError(f"window {window}")
    return (s if window is None else min(window, s)), hkv, dh


def decode_attention(q: torch.Tensor, kv_k: torch.Tensor, kv_v: torch.Tensor, il: int,
                     n_past: torch.Tensor, *, window: Optional[int] = None,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None,
                     alibi_slopes: Optional[torch.Tensor] = None, chunk: int = DEFAULT_CHUNK,
                     head_major: bool = False) -> torch.Tensor:
    """The attention context (B, H, dh) f32 of one decode step (see the
    module docstring): q (B, H, dh) f32, the full stacked cache kv_k/kv_v
    (L, B, S, Hkv, dh), or (L, B, Hkv, S, dh) with head_major, n_past (B,)
    int32 per-slot positions, the int8 cache's (L, B, S, Hkv) scale planes
    (layout as the cache), ALiBi slopes (H,) f32. All contiguous, on one
    device."""
    win, hkv, dh = _check_operands(q, kv_k, kv_v, il, n_past, window, k_scale, v_scale,
                                   alibi_slopes, head_major)
    b, h = q.shape[:2]
    dev = kv_k.device
    c = decode_chunk(win, chunk)

    def strides(a):  # elements between (layer, slot, position, kv head) neighbours
        if a is None:
            return (0, 0, 0, 0)
        st = a.stride()
        return (st[0], st[1], st[3], st[2]) if head_major else st[:4]

    scalar = dh % VEC != 0 or any(x % VEC for x in strides(kv_k))
    if dev.type == "cuda":
        parts, _, group = decode_plan(b, hkv, h // hkv, win, sm_count(dev))
        need = kernel_smem_bytes(group, dh, win, c, kv_k.dtype == torch.int8, scalar, parts)
        if need > MAX_SMEM_BYTES:
            raise ValueError(f"head width {dh}, {h // hkv} heads a kv head and a window of {win} "
                             f"in chunks of {c} need {need} bytes of shared memory a block; the "
                             f"decode attention kernel's limit is {MAX_SMEM_BYTES} (227 KB)")
    kw = dict(window=window, k_scale=k_scale, v_scale=v_scale, alibi_slopes=alibi_slopes,
              chunk=chunk, head_major=head_major)
    if dev.type == "cpu":
        PLAIN_CALLS["decode_attn"] += 1
        return plain_decode_attention(q, kv_k, kv_v, il, n_past, **kw)
    if dev.type != "cuda":
        raise ValueError(f"decode_attn: tensors on {dev}; the kernel runs on CUDA only")
    out = torch.empty_like(q)
    fn = K._fn("attn_decode", "ct_decode_attn")
    rc = fn(*K._ptrs(q, kv_k, kv_v, k_scale, v_scale, alibi_slopes, n_past, out),
            DTYPE_CODES[kv_k.dtype], b, h, hkv, dh, win, c, il, score_scale(dh),
            *strides(kv_k), *strides(k_scale), K._stream(dev))
    if rc != 0:
        raise RuntimeError(f"decode_attn: kernel launch failed with CUDA error {rc}")
    LAUNCHES["decode_attn"] += 1
    return out
