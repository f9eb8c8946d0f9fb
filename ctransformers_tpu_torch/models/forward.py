"""Transformer forward pass in PyTorch (ctransformers_tpu/models/forward.py).

Parameters are a dict of tensors with weights pre-transposed to (in, out)
so activations multiply as x @ W (QTensor leaves go through the
quantized-matmul kernels of ops/qmm_kernels.py):

  wte (V, D), ln_f_g (D,), lm_head (D, V)
  layers: list of dicts with ln1_g, ln2_g, w_qkv or wq/wk/wv, wo,
          w_gateup or w_gate/w_up, w_down

The KV cache is a fixed (n_ctx)-capacity buffer written in place at
n_past, in f32, bf16, IEEE f16 or int8 with per-(token, head) scales
(resolve_kv_dtype), sequence-major or head-major (kv_head_major); attention
reads the cache prefix [0, attn_window) only, in the same round_window
buckets as the JAX package. Layers run as a Python loop.

Attention follows the JAX package's compute-dtype rules: the compute dtype
cdt is bf16 for an int8 cache and the cache dtype otherwise; q and the
probabilities are rounded to cdt where the JAX package casts them, and the
dots are taken in f32 over the (exactly) upcast operands, since a torch
bf16 matmul rounds its output to bf16 where JAX keeps the f32 result
(preferred_element_type). f32 matmuls on the card run in full f32:
engine/engine.py sets torch.backends.cuda.matmul.allow_tf32 = False.
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import torch

from ..ops.attention import decode_attention, score_scale
from ..ops.norm import rms_norm
from ..ops.qmatmul import matmul as mm
from ..ops.qmatmul import split_fused
from ..ops.rope import apply_rope_interleaved, apply_rope_neox, rope_angles
from .spec import ArchSpec

Params = Dict[str, Any]
# a chunk's first position: an int, or for a one-token chunk a (1,) int32
# device tensor, which a captured CUDA graph advances without the host
Position = Union[int, torch.Tensor]

# user-facing KV dtype names (the JAX package's, forward.py:resolve_kv_dtype):
# "f16" aliases bf16 as there; "ieee_f16" is IEEE half
KV_DTYPES = {
    None: torch.float32, "f32": torch.float32,
    "bf16": torch.bfloat16, "f16": torch.bfloat16,
    "int8": torch.int8,
    "ieee_f16": torch.float16,
}


def resolve_kv_dtype(name) -> torch.dtype:
    """Map a KV dtype name (or None/'' = CT_KV_DTYPE, else f32) to a torch
    dtype; an unknown name raises ValueError."""
    if not name:
        name = os.environ.get("CT_KV_DTYPE") or None
    if isinstance(name, str):
        name = name.strip().lower() or None
    if name not in KV_DTYPES:
        raise ValueError(
            f"unknown kv_dtype {name!r}; expected one of "
            "'f32', 'bf16', 'f16' (alias of bf16 on TPU), 'int8'"
        )
    return KV_DTYPES[name]


def kv_head_major() -> bool:
    """KV cache layout, read when a cache is created and at every call that
    reads it, from CT_KV_LAYOUT: "sm" (default) keeps the projection order
    (L, B, n_ctx, Hkv, dh); "hm" stores (L, B, Hkv, n_ctx, dh)."""
    return os.environ.get("CT_KV_LAYOUT", "sm") == "hm"


class KVCache(NamedTuple):
    """Per-layer cache: k/v (L, B, n_ctx, Hkv, dh) sequence-major or
    (L, B, Hkv, n_ctx, dh) head-major (kv_head_major). An int8 cache holds
    symmetric per-(token, head) rows (kv_quantize) with f32 scale planes
    ks/vs over the same axes minus dh; float caches have none."""

    k: torch.Tensor
    v: torch.Tensor
    ks: Optional[torch.Tensor] = None
    vs: Optional[torch.Tensor] = None

    @staticmethod
    def create(spec: ArchSpec, batch: int, device, dtype=torch.float32) -> "KVCache":
        if kv_head_major():
            shape = (spec.n_layer, batch, spec.kv_heads, spec.n_ctx, spec.head_dim)
        else:
            shape = (spec.n_layer, batch, spec.n_ctx, spec.kv_heads, spec.head_dim)

        def zeros(shape, dt):
            return torch.zeros(shape, dtype=dt, device=device)

        if dtype == torch.int8:
            return KVCache(zeros(shape, dtype), zeros(shape, dtype),
                           zeros(shape[:-1], torch.float32), zeros(shape[:-1], torch.float32))
        return KVCache(zeros(shape, dtype), zeros(shape, dtype))


def kv_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 row quantization over the last axis: (int8 values,
    f32 scale over the leading axes), x ~= q * scale. The scale is
    max(amax, 1e-8) / 127 by IEEE division (a tensor divisor: on the card
    torch divides by a Python scalar as a product with its reciprocal, which
    can miss the quotient by an ulp); torch.round rounds half to even, as
    jnp.round does."""
    amax = torch.clamp_min(x.abs().amax(dim=-1), 1e-8).float()
    scale = amax / torch.full_like(amax, 127.0)
    return torch.round(x / scale[..., None]).to(torch.int8), scale


def _norm(spec: ArchSpec, x, g):
    if spec.norm != "rmsnorm":
        raise NotImplementedError(f"{spec.norm} is not yet ported, see ROADMAP")
    return rms_norm(x, g, spec.norm_eps)


def _act(layer: Params, h):
    if "w_gateup" in layer:  # engine-fused (one kernel call)
        gate, up = split_fused(mm(h, layer["w_gateup"]), layer["w_gateup"])
    else:
        gate = mm(h, layer["w_gate"])
        up = mm(h, layer["w_up"])
    return torch.nn.functional.silu(gate) * up


def project_qkv(
    spec: ArchSpec,
    layer: Params,
    x: torch.Tensor,  # (B, T, D) normed input
    angles: Optional[torch.Tensor],  # (T, dh//2)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """QKV projection (fused or split), head reshape and rope."""
    b, t, _ = x.shape
    h, hkv, dh = spec.n_head, spec.kv_heads, spec.head_dim
    if "w_qkv" in layer:
        q, k, v = split_fused(mm(x, layer["w_qkv"]), layer["w_qkv"])
    else:
        q = mm(x, layer["wq"])
        k = mm(x, layer["wk"])
        v = mm(x, layer["wv"])
    q = q.reshape(b, t, h, dh)
    k = k.reshape(b, t, hkv, dh)
    v = v.reshape(b, t, hkv, dh)
    if spec.rope_mode == "interleaved":
        q = apply_rope_interleaved(q, angles)
        k = apply_rope_interleaved(k, angles)
    elif spec.rope_mode == "neox":
        q = apply_rope_neox(q, angles, spec.n_rot)
        k = apply_rope_neox(k, angles, spec.n_rot)
    return q, k, v


def block_ffn(spec: ArchSpec, layer: Params, x, attn_out):
    """Serial residual + SwiGLU MLP tail of one llama block."""
    x = x + attn_out
    ln2 = _norm(spec, x, layer["ln2_g"])
    return x + mm(_act(layer, ln2), layer["w_down"])


def _repeat_kv(a: Optional[torch.Tensor], rep: int, head_axis: int):
    return a if a is None or rep == 1 else a.repeat_interleave(rep, dim=head_axis)


def _compute_dtype(cache_dtype: torch.dtype) -> torch.dtype:
    return torch.bfloat16 if cache_dtype == torch.int8 else cache_dtype


def _seq_slice(hm: bool, upto: int, start: int = 0):
    """Index tuple bounding a per-layer cache slab (or its scale plane) to
    the sequence positions [start, upto) under either layout."""
    if hm:
        return (slice(None), slice(None), slice(start, upto))
    return (slice(None), slice(start, upto))


def _scale_bcast(hm: bool, sc: torch.Tensor) -> torch.Tensor:
    """Scale plane -> (B, H, 1, S) broadcast against (B, H, T, S) scores."""
    return (sc if hm else sc.transpose(1, 2))[:, :, None, :]


def _full_scores(spec: ArchSpec, q, k_cache, v_cache, n_past: int, k_scale=None,
                 v_scale=None, hm: bool = False):
    """Materialized (B, H, T, S) attention over a (B, S, Hkv, dh) window
    ((B, Hkv, S, dh) head-major). With an int8 cache the scales factor out
    of both dots: scores are multiplied by k_scale[s] after the QK dot, and
    the probabilities by v_scale[s] before they are rounded for the PV dot."""
    t = q.shape[1]
    rep = spec.n_head // spec.kv_heads
    head_axis = 1 if hm else 2
    cdt = _compute_dtype(k_cache.dtype)
    kf = _repeat_kv(k_cache, rep, head_axis).float()
    vf = _repeat_kv(v_cache, rep, head_axis).float()
    k_scale = _repeat_kv(k_scale, rep, head_axis)
    v_scale = _repeat_kv(v_scale, rep, head_axis)
    s = k_cache.shape[2 if hm else 1]
    scores = torch.einsum("bthd,bhsd->bhts" if hm else "bthd,bshd->bhts",
                          q.to(cdt).float(), kf) * score_scale(spec.head_dim)
    if k_scale is not None:
        scores = scores * _scale_bcast(hm, k_scale)
    qpos = n_past + torch.arange(t, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    scores = scores.masked_fill(~(kpos <= qpos)[None, None], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    if v_scale is not None:
        probs = probs * _scale_bcast(hm, v_scale)
    return torch.einsum("bhts,bhsd->bthd" if hm else "bhts,bshd->bthd",
                        probs.to(cdt).float(), vf)


ATTN_CHUNK = 512


def attn_chunk() -> int:
    """KV positions per chunk of the chunked attention: CT_ATTN_CHUNK, read
    at call time, else ATTN_CHUNK."""
    return int(os.environ.get("CT_ATTN_CHUNK", ATTN_CHUNK))


def _chunked_scores(spec: ArchSpec, q, k_cache, v_cache, n_past: int, k_scale=None,
                    v_scale=None, hm: bool = False):
    """Online-softmax attention over KV chunks of attn_chunk() positions:
    peak memory O(T * chunk) instead of O(T * n_ctx). Int8 scales factor as
    in _full_scores, per chunk: the softmax denominator sums the UNSCALED
    probabilities, v_scale folds into the PV term only."""
    b, t = q.shape[:2]
    h, dh = spec.n_head, spec.head_dim
    rep = h // spec.kv_heads
    head_axis = 1 if hm else 2
    cdt = _compute_dtype(k_cache.dtype)
    c = attn_chunk()
    scale = score_scale(dh)
    qf = q.to(cdt).float()
    qpos = n_past + torch.arange(t, device=q.device)[:, None]
    m = torch.full((b, h, t), float("-inf"), device=q.device)
    l = torch.zeros((b, h, t), device=q.device)
    acc = torch.zeros((b, t, h, dh), device=q.device)
    qk, pv_eq = ("bthd,bhsd->bhts", "bhts,bhsd->bthd") if hm else (
        "bthd,bshd->bhts", "bhts,bshd->bthd")
    for idx in range(k_cache.shape[2 if hm else 1] // c):
        sl = _seq_slice(hm, (idx + 1) * c, idx * c)
        k_c = _repeat_kv(k_cache[sl], rep, head_axis).float()
        v_c = _repeat_kv(v_cache[sl], rep, head_axis).float()
        s_c = torch.einsum(qk, qf, k_c) * scale
        if k_scale is not None:
            s_c = s_c * _scale_bcast(hm, _repeat_kv(k_scale[sl], rep, head_axis))
        kpos = idx * c + torch.arange(c, device=q.device)[None, :]
        s_c = s_c.masked_fill(~(kpos <= qpos)[None, None], float("-inf"))
        m_new = torch.maximum(m, s_c.amax(dim=-1))
        # guard fully-masked rows (m_new = -inf) against NaNs
        m_safe = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
        alpha = torch.exp(
            torch.where(torch.isfinite(m), m - m_safe, torch.full_like(m, float("-inf")))
        )
        p = torch.exp(s_c - m_safe[..., None])
        l = l * alpha + p.sum(dim=-1)
        if v_scale is not None:
            p = p * _scale_bcast(hm, _repeat_kv(v_scale[sl], rep, head_axis))
        pv = torch.einsum(pv_eq, p.to(cdt).float(), v_c)
        acc = acc * alpha.transpose(1, 2)[..., None] + pv
        m = m_new
    l = torch.clamp_min(l, 1e-30)
    return acc / l.transpose(1, 2)[..., None]


def _use_chunked_attention(spec: ArchSpec, t: int) -> bool:
    """Long prefill chunks over long contexts stream the cache in chunks
    rather than materialize the (T, S) score tensor. CT_ATTN=full or
    CT_ATTN=chunked, read at call time, forces one path for every chunk."""
    mode = os.environ.get("CT_ATTN")
    if mode in ("full", "chunked"):
        return mode == "chunked"
    return t >= 256 and spec.n_ctx >= 1024 and spec.n_ctx % attn_chunk() == 0


ATTN_WINDOW_STEP = 256


def round_window(pos: int, n_ctx: int) -> int:
    """Attention-window bucket covering positions [0, pos): the next
    ATTN_WINDOW_STEP multiple, clamped to n_ctx."""
    w = (max(int(pos), 1) + ATTN_WINDOW_STEP - 1) // ATTN_WINDOW_STEP
    return min(w * ATTN_WINDOW_STEP, n_ctx)


def write_kv(kv: KVCache, il: int, n_past: Position, k: torch.Tensor, v: torch.Tensor,
             hm: bool) -> None:
    """Write a chunk's k/v (B, T, Hkv, dh) into layer `il` of the cache IN
    PLACE at n_past (the JAX package returns an updated cache instead):
    cast to a float cache's dtype (round to nearest even), or quantized by
    kv_quantize into an int8 cache's four planes. A tensor n_past (a
    one-token chunk) is a device index: the rows go in by index_copy_ along
    the sequence axis, the same values the int path's slice assignment
    writes."""
    t = k.shape[1]
    if hm:  # (B, Hkv, T, dh) slabs for a head-major cache
        k, v = k.transpose(1, 2), v.transpose(1, 2)
    if kv.ks is None:
        pairs = ((kv.k, k), (kv.v, v))
    else:
        kq, ksc = kv_quantize(k)
        vq, vsc = kv_quantize(v)
        pairs = ((kv.k, kq), (kv.ks, ksc), (kv.v, vq), (kv.vs, vsc))
    if torch.is_tensor(n_past):
        idx = n_past.to(torch.int64)
        for plane, rows in pairs:
            plane[il].index_copy_(2 if hm else 1, idx, rows.to(plane.dtype))
        return
    at = (il,) + _seq_slice(hm, n_past + t, n_past)
    for plane, rows in pairs:
        plane[at] = rows


def _attention(
    spec: ArchSpec,
    layer: Params,
    x: torch.Tensor,  # (B, T, D) normed input
    n_past: Position,
    kv: KVCache,
    il: int,
    angles: Optional[torch.Tensor],
    window: Optional[int] = None,
    n_past_slots: Optional[torch.Tensor] = None,  # (B,) int32; forward builds it once
) -> torch.Tensor:
    """One layer's attention. Writes this chunk's k/v into the cache in
    place (write_kv), then attends over the window. A decode step (T = 1)
    always goes through ops/attention.py:decode_attention, whatever
    CT_ATTN says: the hand-written kernel on the card, its plain version on
    the CPU. CT_ATTN chooses between the full and the chunked scores for
    prompt chunks (T > 1) only."""
    b, t, _ = x.shape
    q, k, v = project_qkv(spec, layer, x, angles)
    hm = kv_head_major()
    write_kv(kv, il, n_past, k, v, hm)
    s_full = kv.k.shape[3 if hm else 2]
    if t == 1:
        if n_past_slots is None:
            n_past_slots = torch.full((b,), n_past, dtype=torch.int32, device=x.device)
        ctx = decode_attention(
            q[:, 0], kv.k, kv.v, il, n_past_slots,
            window=window if window is not None and window < s_full else None,
            k_scale=kv.ks, v_scale=kv.vs, head_major=hm,
        )
    else:
        chunked = _use_chunked_attention(spec, t)
        s = s_full
        if window is not None and window < s:
            s = window
            if chunked:  # the chunked path reads whole chunks
                c = attn_chunk()
                s = min(math.ceil(window / c) * c, s_full)
        sl = _seq_slice(hm, s)
        planes = [None if a is None else a[il][sl] for a in kv]
        scores = _chunked_scores if chunked else _full_scores
        ctx = scores(spec, q, *planes[:2], n_past, *planes[2:], hm=hm)
    return mm(ctx.reshape(b, t, spec.n_head * spec.head_dim), layer["wo"])


def forward(
    spec: ArchSpec,
    params: Params,
    tokens: torch.Tensor,  # (B, T) int64
    n_past: Position,
    kv: KVCache,
    attn_window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (last-token logits (B, V), last hidden state (B, D)); the
    cache `kv` is updated in place. `attn_window` bounds attention reads to
    the cache prefix [0, attn_window), which must cover every live
    position. A one-token chunk may take n_past as a (1,) int32 device
    tensor (the decode step a CUDA graph replays): positions, the cache
    write and the attention's per-slot positions read it there, and the
    logits are bitwise those of the same int."""
    b, t = tokens.shape
    dev = tokens.device
    on_device = torch.is_tensor(n_past)
    if on_device and (t != 1 or tuple(n_past.shape) != (1,) or n_past.dtype != torch.int32):
        raise ValueError("a device n_past is a (1,) int32 tensor and serves one-token chunks "
                         f"only, got {n_past.dtype} {tuple(n_past.shape)} for {t} tokens")
    x = params["wte"][tokens]  # (B, T, D) f32
    angles = None
    if spec.rope_mode != "none":
        first = n_past.to(torch.int64) if on_device else n_past
        positions = first + torch.arange(t, device=dev)
        angles = rope_angles(
            positions, spec.head_dim, spec.n_rot or spec.head_dim,
            spec.rope_base, spec.rope_scale,
        )
    # a decode step's per-slot positions, built once for every layer
    slots = None
    if t == 1:
        slots = (n_past.expand(b).contiguous() if on_device
                 else torch.full((b,), n_past, dtype=torch.int32, device=dev))
    for il, layer in enumerate(params["layers"]):
        ln1 = _norm(spec, x, layer["ln1_g"])
        attn_out = _attention(spec, layer, ln1, n_past, kv, il, angles, attn_window, slots)
        x = block_ffn(spec, layer, x, attn_out)
    if spec.final_norm:
        x = _norm(spec, x, params["ln_f_g"])
    last = x[:, -1, :]
    return mm(last, params["lm_head"]), last
