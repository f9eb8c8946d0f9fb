"""Architecture specification (a copy of ctransformers_tpu/models/spec.py).

Per-architecture differences are fields here rather than separate forward
implementations. This slice of the port serves the llama fields: RMSNorm,
SwiGLU, rope and grouped-query attention via n_head_kv.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    name: str
    n_vocab: int
    n_ctx: int
    n_embd: int
    n_head: int
    n_layer: int

    n_head_kv: Optional[int] = None  # None -> n_head (MHA)
    n_ff: Optional[int] = None  # None -> 4*n_embd
    # training context (GGUF %s.context_length) when n_ctx was overridden;
    # 0 -> same as n_ctx. Needed for byte-compatible GGSN session hparams
    # (llama.cpp:849, 1563) and the n_ctx_train vs n_ctx distinction.
    n_ctx_train: int = 0

    # positions
    learned_pos: bool = False  # wpe table
    rope_mode: str = "none"  # "none" | "interleaved" | "neox"
    n_rot: int = 0
    rope_base: float = 10000.0
    rope_scale: float = 1.0
    alibi_bias_max: float = 0.0  # > 0 enables alibi

    # block structure
    norm: str = "layernorm"  # "layernorm" | "rmsnorm"
    norm_eps: float = 1e-5
    parallel_residual: bool = False
    # parallel-residual variant: True -> single shared input LN feeding both
    # attn and mlp (falcon-style); False -> separate ln1/ln2 (gptj/neox)
    shared_parallel_ln: bool = False
    act: str = "gelu"  # "gelu" | "silu_gate"
    clip_qkv: float = 0.0

    # head
    final_norm: bool = True
    tied_lm_head: bool = False  # logits reuse wte

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    @property
    def kv_heads(self) -> int:
        return self.n_head_kv if self.n_head_kv is not None else self.n_head

    @property
    def ff_dim(self) -> int:
        return self.n_ff if self.n_ff is not None else 4 * self.n_embd

    def replace(self, **kw) -> "ArchSpec":
        return dataclasses.replace(self, **kw)
