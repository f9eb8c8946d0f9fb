"""Synthetic llama GGUF files written with the port's own GGUF writer: the
tiny test model and the llama-2-7B-width Q4_K model that chip_smoke.py
serves. Weights are random, made from a seed; nothing is downloaded."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..formats.gguf import write_gguf
from ..formats.quants import GGMLType, quantize

LLAMA2_7B = dict(
    n_vocab=32000, n_ctx=4096, n_embd=4096, n_head=32, n_head_kv=32,
    n_layer=32, n_ff=11008,
)


def spm_vocab(n_vocab: int) -> Tuple[List[str], List[float], List[int]]:
    """SPM vocab: <unk> <s> </s>, the 256 byte tokens, scored word pieces,
    then filler pieces up to n_vocab."""
    pieces = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
    types = [2, 3, 3] + [6] * 256
    scores = [0.0] * len(pieces)
    letters = "abcdefghijklmnopqrstuvwxyz"
    words = list(letters) + ["▁" + c for c in letters] + [
        "▁", "he", "ll", "lo", "el", "hell", "hello", "▁hello", "wo", "or",
        "ld", "wor", "world", "▁world", "th", "the", "▁the", "ing", "er",
        "▁a", "▁is", "▁cat", "▁big", "▁tell", "▁me", "▁story", "▁once",
    ]
    for i, w in enumerate(words):
        pieces.append(w)
        scores.append(-float(i) / 10.0 - 1.0)
        types.append(1)
    i = 0
    while len(pieces) < n_vocab:
        pieces.append(f"▁tok{i}")
        scores.append(-100.0 - i)
        types.append(1)
        i += 1
    return pieces[:n_vocab], scores[:n_vocab], types[:n_vocab]


def random_q4k_blocks(rng: np.random.Generator, n_elements: int) -> np.ndarray:
    """Valid Q4_K blocks (144 bytes per 256 weights) drawn directly: small
    positive f16 d and dmin, random 6-bit scales and nibbles. Running
    billions of weights through the quantizer would take the host most of
    an hour; the matmul kernels' work does not depend on the values."""
    nb = n_elements // 256
    buf = rng.integers(0, 256, (nb, 144), dtype=np.uint8)
    d = (rng.random(nb, np.float32) * 9e-4 + 1e-4).astype("<f2")
    dm = (rng.random(nb, np.float32) * 1e-3).astype("<f2")
    buf[:, 0:2] = d.view(np.uint8).reshape(nb, 2)
    buf[:, 2:4] = dm.view(np.uint8).reshape(nb, 2)
    return buf.reshape(-1)


def write_llama_gguf(
    path: str,
    n_vocab: int = 512,
    n_ctx: int = 128,
    n_embd: int = 256,
    n_head: int = 4,
    n_head_kv: int = 2,
    n_layer: int = 2,
    n_ff: int = 512,
    wtype: GGMLType = GGMLType.Q4_K,
    embed_type: GGMLType = GGMLType.F32,
    synthesize_blocks: bool = False,
    seed: int = 0,
) -> dict:
    """Write a llama GGUF. Matmul weights are `wtype`: quantized from
    N(0, 0.08^2) draws, or (synthesize_blocks, Q4_K only) random blocks
    generated one tensor at a time while the file is written."""
    rng = np.random.default_rng(seed)
    pieces, scores, types = spm_vocab(n_vocab)
    dh = n_embd // n_head
    kv = {
        "general.architecture": "llama",
        "general.name": "synthetic-llama",
        "general.quantization_version": 2,
        "llama.context_length": n_ctx,
        "llama.embedding_length": n_embd,
        "llama.block_count": n_layer,
        "llama.feed_forward_length": n_ff,
        "llama.attention.head_count": n_head,
        "llama.attention.head_count_kv": n_head_kv,
        "llama.attention.layer_norm_rms_epsilon": 1e-5,
        "llama.rope.dimension_count": dh,
        "tokenizer.ggml.model": "llama",
        "tokenizer.ggml.tokens": pieces,
        "tokenizer.ggml.scores": np.asarray(scores, np.float32),
        "tokenizer.ggml.token_type": np.asarray(types, np.int32),
        "tokenizer.ggml.bos_token_id": 1,
        "tokenizer.ggml.eos_token_id": 2,
        "tokenizer.ggml.unknown_token_id": 0,
    }
    tensors = {}

    def dense(name, shape, t, scale=0.08, offset=0.0):
        w = rng.standard_normal(shape, np.float32) * scale + offset
        tensors[name] = (t, tuple(reversed(shape)), quantize(w, t))

    def weight(name, n_out, n_in):
        ne = (n_in, n_out)  # GGML order: blocks along the input dim
        if synthesize_blocks:
            if wtype != GGMLType.Q4_K:
                raise ValueError("synthesized blocks are Q4_K")
            tensors[name] = (wtype, ne, lambda: random_q4k_blocks(rng, n_in * n_out))
        else:
            dense(name, (n_out, n_in), wtype)

    dense("token_embd.weight", (n_vocab, n_embd), embed_type, scale=0.02 if synthesize_blocks else 0.08)
    dense("output_norm.weight", (n_embd,), GGMLType.F32, offset=1.0)
    weight("output.weight", n_vocab, n_embd)
    for i in range(n_layer):
        p = f"blk.{i}"
        dense(f"{p}.attn_norm.weight", (n_embd,), GGMLType.F32, offset=1.0)
        weight(f"{p}.attn_q.weight", n_head * dh, n_embd)
        weight(f"{p}.attn_k.weight", n_head_kv * dh, n_embd)
        weight(f"{p}.attn_v.weight", n_head_kv * dh, n_embd)
        weight(f"{p}.attn_output.weight", n_embd, n_head * dh)
        dense(f"{p}.ffn_norm.weight", (n_embd,), GGMLType.F32, offset=1.0)
        weight(f"{p}.ffn_gate.weight", n_ff, n_embd)
        weight(f"{p}.ffn_up.weight", n_ff, n_embd)
        weight(f"{p}.ffn_down.weight", n_embd, n_ff)
    write_gguf(path, kv, tensors)
    return dict(n_vocab=n_vocab, n_ctx=n_ctx, n_layer=n_layer)
