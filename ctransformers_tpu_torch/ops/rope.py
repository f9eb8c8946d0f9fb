"""Rotary position embeddings with GGML semantics (ctransformers_tpu/ops/rope.py).

theta for successive rotation steps decays by base**(-2/n_dims) per step,
and rotation continues across the full head dimension even when
n_dims < head_dim:

  * interleaved (mode 0, llama GGUF): pairs (x[2i], x[2i+1]) for every
    i < head_dim/2, theta_i = scale * p * base**(-2*i/n_dims).
  * neox (mode 2): head_dim/n_dims blocks; block b, step c rotates
    (x[b*n_dims + c], x[b*n_dims + c + n_dims/2]) with the global step index
    t = b*(n_dims/2) + c.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

# (device, head_dim, n_dims, base) -> (head_dim//2,) f32 frequencies on that
# device: copied to the device once, so that a forward makes no
# host-to-device copy (which a CUDA graph capture refuses)
_FREQS: Dict[Tuple[torch.device, int, int, float], torch.Tensor] = {}


def rope_freqs(device: torch.device, head_dim: int, n_dims: int, base: float) -> torch.Tensor:
    """The rotation frequencies base**(-2 i / n_dims), computed in numpy
    float32 exactly as the JAX package computes them, kept per device."""
    key = (torch.device(device), int(head_dim), int(n_dims), float(base))
    freqs = _FREQS.get(key)
    if freqs is None:
        steps = np.arange(head_dim // 2, dtype=np.float32)
        theta_scale = float(base) ** (-2.0 / n_dims)
        freqs = torch.from_numpy(np.asarray(theta_scale**steps, np.float32)).to(key[0])
        _FREQS[key] = freqs
    return freqs


def rope_angles(positions: torch.Tensor, head_dim: int, n_dims: int,
                base: float, scale: float) -> torch.Tensor:
    """(T,) positions -> (T, head_dim//2) angles, one per rotation step."""
    freqs = rope_freqs(positions.device, head_dim, n_dims, base)
    return (positions.to(torch.float32) * scale)[:, None] * freqs[None, :]


def apply_rope_interleaved(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x: (B, T, H, D); angles: (T, D//2). GGML mode 0."""
    b, t, h, d = x.shape
    x2 = x.reshape(b, t, h, d // 2, 2)
    x0, x1 = x2[..., 0], x2[..., 1]
    cos = torch.cos(angles)[None, :, None, :]
    sin = torch.sin(angles)[None, :, None, :]
    y0 = x0 * cos - x1 * sin
    y1 = x0 * sin + x1 * cos
    return torch.stack([y0, y1], dim=-1).reshape(b, t, h, d)


def apply_rope_neox(x: torch.Tensor, angles: torch.Tensor, n_dims: int) -> torch.Tensor:
    """x: (B, T, H, D); angles: (T, D//2). GGML mode 2 (block structure)."""
    b, t, h, d = x.shape
    n_blocks = d // n_dims
    if n_blocks == 0:
        raise ValueError(f"head_dim {d} < n_dims {n_dims}")
    rot = n_blocks * n_dims
    xr = x[..., :rot].reshape(b, t, h, n_blocks, 2, n_dims // 2)
    x0, x1 = xr[..., 0, :], xr[..., 1, :]  # halves within each block
    a = angles[:, : n_blocks * (n_dims // 2)].reshape(t, n_blocks, n_dims // 2)
    cos = torch.cos(a)[None, :, None, :, :]
    sin = torch.sin(a)[None, :, None, :, :]
    y0 = x0 * cos - x1 * sin
    y1 = x0 * sin + x1 * cos
    yr = torch.stack([y0, y1], dim=-2).reshape(b, t, h, rot)
    if rot < d:
        yr = torch.cat([yr, x[..., rot:]], dim=-1)
    return yr
