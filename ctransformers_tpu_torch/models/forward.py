"""Transformer forward pass in PyTorch (ctransformers_tpu/models/forward.py).

Parameters are a dict of tensors with weights pre-transposed to (in, out)
so activations multiply as x @ W (QTensor leaves go through the
quantized-matmul kernels of ops/qmm_kernels.py):

  wte (V, D), ln_f_g (D,), lm_head (D, V)
  layers: list of dicts with ln1_g, ln2_g, w_qkv or wq/wk/wv, wo,
          w_gateup or w_gate/w_up, w_down

The KV cache is a fixed (n_ctx)-capacity buffer written in place at
n_past; attention reads the cache prefix [0, attn_window) only, in the same
round_window buckets as the JAX package. Layers run as a Python loop.
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops.norm import rms_norm
from ..ops.qmatmul import matmul as mm
from ..ops.qmatmul import split_fused
from ..ops.rope import apply_rope_interleaved, apply_rope_neox, rope_angles
from .spec import ArchSpec

Params = Dict[str, Any]


class KVCache(NamedTuple):
    """Per-layer cache, k/v (L, B, n_ctx, Hkv, dh) float32, sequence-major."""

    k: torch.Tensor
    v: torch.Tensor

    @staticmethod
    def create(spec: ArchSpec, batch: int, device) -> "KVCache":
        shape = (spec.n_layer, batch, spec.n_ctx, spec.kv_heads, spec.head_dim)
        return KVCache(
            torch.zeros(shape, dtype=torch.float32, device=device),
            torch.zeros(shape, dtype=torch.float32, device=device),
        )


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


def _score_scale(dh: int) -> float:
    # 1 / sqrt(dh) rounded to f32 the way the JAX package computes it
    return float(np.float32(1.0) / np.sqrt(np.float32(dh)))


def _repeat_kv(a: torch.Tensor, rep: int) -> torch.Tensor:
    return a if rep == 1 else a.repeat_interleave(rep, dim=2)


def _full_scores(spec: ArchSpec, q, k_cache, v_cache, n_past: int):
    """Materialized (B, H, T, S) attention over a (B, S, Hkv, dh) window."""
    t = q.shape[1]
    rep = spec.n_head // spec.kv_heads
    kf, vf = _repeat_kv(k_cache, rep), _repeat_kv(v_cache, rep)
    s = k_cache.shape[1]
    scores = torch.einsum("bthd,bshd->bhts", q, kf) * _score_scale(spec.head_dim)
    qpos = n_past + torch.arange(t, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    scores = scores.masked_fill(~(kpos <= qpos)[None, None], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhts,bshd->bthd", probs, vf)


ATTN_CHUNK = 512


def attn_chunk() -> int:
    """KV positions per chunk of the chunked attention: CT_ATTN_CHUNK, read
    at call time, else ATTN_CHUNK."""
    return int(os.environ.get("CT_ATTN_CHUNK", ATTN_CHUNK))


def _chunked_scores(spec: ArchSpec, q, k_cache, v_cache, n_past: int):
    """Online-softmax attention over KV chunks of attn_chunk() positions:
    peak memory O(T * chunk) instead of O(T * n_ctx)."""
    b, t = q.shape[:2]
    h, dh = spec.n_head, spec.head_dim
    rep = h // spec.kv_heads
    c = attn_chunk()
    scale = _score_scale(dh)
    qpos = n_past + torch.arange(t, device=q.device)[:, None]
    m = torch.full((b, h, t), float("-inf"), device=q.device)
    l = torch.zeros((b, h, t), device=q.device)
    acc = torch.zeros((b, t, h, dh), device=q.device)
    for idx in range(k_cache.shape[1] // c):
        k_c = _repeat_kv(k_cache[:, idx * c : (idx + 1) * c], rep)
        v_c = _repeat_kv(v_cache[:, idx * c : (idx + 1) * c], rep)
        s_c = torch.einsum("bthd,bshd->bhts", q, k_c) * scale
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
        pv = torch.einsum("bhts,bshd->bthd", p, v_c)
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


def _attention(
    spec: ArchSpec,
    layer: Params,
    x: torch.Tensor,  # (B, T, D) normed input
    n_past: int,
    kv: KVCache,
    il: int,
    angles: Optional[torch.Tensor],
    window: Optional[int] = None,
) -> torch.Tensor:
    """One layer's attention. Writes this chunk's k/v into the cache IN
    PLACE at (il, n_past) (the JAX package returns an updated cache
    instead), then attends over the window."""
    b, t, _ = x.shape
    q, k, v = project_qkv(spec, layer, x, angles)
    kv.k[il, :, n_past : n_past + t] = k
    kv.v[il, :, n_past : n_past + t] = v
    chunked = _use_chunked_attention(spec, t)
    s = kv.k.shape[2]
    if window is not None and window < s:
        s = window
        if chunked:  # the chunked path reads whole chunks
            c = attn_chunk()
            s = min(math.ceil(window / c) * c, kv.k.shape[2])
    k_cache, v_cache = kv.k[il, :, :s], kv.v[il, :, :s]
    scores = _chunked_scores if chunked else _full_scores
    ctx = scores(spec, q, k_cache, v_cache, n_past)
    return mm(ctx.reshape(b, t, spec.n_head * spec.head_dim), layer["wo"])


def forward(
    spec: ArchSpec,
    params: Params,
    tokens: torch.Tensor,  # (B, T) int64
    n_past: int,
    kv: KVCache,
    attn_window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (last-token logits (B, V), last hidden state (B, D)); the
    cache `kv` is updated in place. `attn_window` bounds attention reads to
    the cache prefix [0, attn_window), which must cover every live
    position."""
    t = tokens.shape[1]
    x = params["wte"][tokens]  # (B, T, D) f32
    angles = None
    if spec.rope_mode != "none":
        positions = n_past + torch.arange(t, device=tokens.device)
        angles = rope_angles(
            positions, spec.head_dim, spec.n_rot or spec.head_dim,
            spec.rope_base, spec.rope_scale,
        )
    for il, layer in enumerate(params["layers"]):
        ln1 = _norm(spec, x, layer["ln1_g"])
        attn_out = _attention(spec, layer, ln1, n_past, kv, il, angles, attn_window)
        x = block_ffn(spec, layer, x, attn_out)
    if spec.final_norm:
        x = _norm(spec, x, params["ln_f_g"])
    last = x[:, -1, :]
    return mm(last, params["lm_head"]), last
