"""Normalization (GGML_OP_RMS_NORM semantics; ctransformers_tpu/ops/norm.py)."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    """ggml_rms_norm: x / sqrt(mean(x^2) + eps), scale only."""
    ms = torch.mean(x * x, dim=-1, keepdim=True)
    return x / torch.sqrt(ms + eps) * g
