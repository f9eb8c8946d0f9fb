"""Synthetic llama checkpoints written with the port's own writers: the
tiny test models and the llama-2-7B-width models that chip_smoke.py serves.
GGUF files are all-Q4_K or laid out tensor for tensor as llama.cpp lays out
a Q2_K, Q3_K_S, Q3_K_M, Q3_K_L, Q4_K_M, Q5_K_M, Q4_0, Q4_1, Q5_0, Q5_1 or
Q8_0 file; GPTQ directories are
laid out as a public 4-bit GPTQ-for-LLaMa checkpoint is. Weights are
random, made from a seed; nothing is downloaded."""

from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple

import numpy as np

from ..formats.gguf import write_gguf
from ..formats.quants import _TRAITS, GGMLType, quantize, row_nbytes
from ..formats.safetensors import write_safetensors
from ..tokenizers.spm_model import write_spm_model

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


def _f16_bytes(rng: np.random.Generator, nb: int, lo: float, hi: float) -> np.ndarray:
    return (rng.random(nb, np.float32) * (hi - lo) + lo).astype("<f2").view(np.uint8).reshape(nb, 2)


def random_q4k_blocks(rng: np.random.Generator, n_elements: int) -> np.ndarray:
    """Valid Q4_K blocks (144 bytes per 256 weights) drawn directly: small
    positive f16 d and dmin, random 6-bit scales and nibbles. Running
    billions of weights through the quantizer would take the host most of
    an hour; the matmul kernels' work does not depend on the values."""
    nb = n_elements // 256
    buf = rng.integers(0, 256, (nb, 144), dtype=np.uint8)
    buf[:, 0:2] = _f16_bytes(rng, nb, 1e-4, 1e-3)
    buf[:, 2:4] = _f16_bytes(rng, nb, 0.0, 1e-3)
    return buf.reshape(-1)


def random_q5k_blocks(rng: np.random.Generator, n_elements: int) -> np.ndarray:
    """Valid Q5_K blocks (176 bytes per 256 weights), as random_q4k_blocks;
    the 5-bit grid spans twice the 4-bit one, so d is halved to keep the
    weights, and the activations through many layers, at Q4_K's scale."""
    nb = n_elements // 256
    buf = rng.integers(0, 256, (nb, 176), dtype=np.uint8)
    buf[:, 0:2] = _f16_bytes(rng, nb, 5e-5, 5e-4)
    buf[:, 2:4] = _f16_bytes(rng, nb, 0.0, 1e-3)
    return buf.reshape(-1)


def random_q6k_blocks(rng: np.random.Generator, n_elements: int) -> np.ndarray:
    """Valid Q6_K blocks (210 bytes per 256 weights): random 6-bit grids
    (q - 32 in [-32, 31]), int8 sub-scales in [-64, 63] and a small positive
    f16 d, so that the weights' spread matches random_q4k_blocks'."""
    nb = n_elements // 256
    buf = rng.integers(0, 256, (nb, 210), dtype=np.uint8)
    buf[:, 192:208] = rng.integers(-64, 64, (nb, 16), dtype=np.int8).view(np.uint8)
    buf[:, 208:210] = _f16_bytes(rng, nb, 2e-5, 2e-4)
    return buf.reshape(-1)


# the planes of the group-16 k-quants as their random blocks decode: sub-scale
# range [lo, hi) (what any scale bytes decode to; Q2_K's sub-mins share it),
# the f16 d range drawn and dmin's upper bound (None: no mins). The card
# tests and chip_smoke.py draw their random QTensors of these kinds from here.
K16_PLANE_RANGES = {
    "Q2_K": dict(sub=(0, 16), d=(1.73e-3, 1.73e-2), dmin=3.5e-3),
    "Q3_K": dict(sub=(-32, 32), d=(4e-4, 4e-3), dmin=None),
}


def random_q2k_blocks(rng: np.random.Generator, n_elements: int) -> np.ndarray:
    """Valid Q2_K blocks (84 bytes per 256 weights): random 2-bit grids and
    4-bit sub-scales and sub-mins (each in [0, 16)), f16 d and dmin scaled
    from random_q4k_blocks' by the grids' spread (a group's weights spread
    as a Q4_K group's: d * E[sub] * std(q) of 7.5 * 1.12 against 31.5 *
    4.6)."""
    r = K16_PLANE_RANGES["Q2_K"]
    nb = n_elements // 256
    buf = rng.integers(0, 256, (nb, 84), dtype=np.uint8)
    buf[:, 80:82] = _f16_bytes(rng, nb, *r["d"])
    buf[:, 82:84] = _f16_bytes(rng, nb, 0.0, r["dmin"])
    return buf.reshape(-1)


def random_q3k_blocks(rng: np.random.Generator, n_elements: int) -> np.ndarray:
    """Valid Q3_K blocks (110 bytes per 256 weights): random 3-bit grids
    (q in [-4, 3]), 6-bit sub-scales in [-32, 32) (any 12 bytes decode to
    such) and a small positive f16 d, scaled as random_q2k_blocks' (E|sub|
    16, std(q) 2.3)."""
    nb = n_elements // 256
    buf = rng.integers(0, 256, (nb, 110), dtype=np.uint8)
    buf[:, 108:110] = _f16_bytes(rng, nb, *K16_PLANE_RANGES["Q3_K"]["d"])
    return buf.reshape(-1)


def _random_legacy(t: GGMLType, d_range: Tuple[float, float]):
    """A drawer of valid blocks of legacy type `t` (32 weights each), drawn
    directly as random_q4k_blocks draws Q4_K's: random grid bytes, a small
    positive f16 d from `d_range` and, for the types with a min (Q4_1, Q5_1,
    grid [0, nmax]), an f16 min m in [-nmax d, 0], where a real block's
    m = min(x) lies when the block spans 0."""
    bs, ts = _TRAITS[t]
    nmax = {GGMLType.Q4_1: 15.0, GGMLType.Q5_1: 31.0}.get(t)

    def draw(rng: np.random.Generator, n_elements: int) -> np.ndarray:
        nb = n_elements // bs
        buf = rng.integers(0, 256, (nb, ts), dtype=np.uint8)
        d = rng.random(nb, np.float32) * (d_range[1] - d_range[0]) + d_range[0]
        buf[:, 0:2] = d.astype("<f2").view(np.uint8).reshape(nb, 2)
        if nmax is not None:
            m = -rng.random(nb, np.float32) * nmax * d
            buf[:, 2:4] = m.astype("<f2").view(np.uint8).reshape(nb, 2)
        return buf.reshape(-1)

    return draw


RANDOM_BLOCKS = {
    GGMLType.Q2_K: random_q2k_blocks,
    GGMLType.Q3_K: random_q3k_blocks,
    GGMLType.Q4_K: random_q4k_blocks,
    GGMLType.Q5_K: random_q5k_blocks,
    GGMLType.Q6_K: random_q6k_blocks,
    # d scaled to each grid's spread (4-bit 4.6, 5-bit 9.2, 8-bit 74 steps),
    # so that a block's weights spread as random_q4k_blocks' and
    # random_q6k_blocks' do (std within a block 0.088 against their 0.10
    # and 0.082)
    GGMLType.Q4_0: _random_legacy(GGMLType.Q4_0, (6e-3, 3e-2)),
    GGMLType.Q4_1: _random_legacy(GGMLType.Q4_1, (6e-3, 3e-2)),
    GGMLType.Q5_0: _random_legacy(GGMLType.Q5_0, (3e-3, 1.5e-2)),
    GGMLType.Q5_1: _random_legacy(GGMLType.Q5_1, (3e-3, 1.5e-2)),
    GGMLType.Q8_0: _random_legacy(GGMLType.Q8_0, (3.75e-4, 1.875e-3)),
}

# llama.cpp's mixes: the base type of every other matmul weight (the
# k-quant mixes and the legacy ftypes, named as llama.cpp's quantize names
# them)
MIXES = {
    "Q2_K": GGMLType.Q2_K, "Q3_K_S": GGMLType.Q3_K, "Q3_K_M": GGMLType.Q3_K,
    "Q3_K_L": GGMLType.Q3_K, "Q4_K_M": GGMLType.Q4_K, "Q5_K_M": GGMLType.Q5_K,
    "Q4_0": GGMLType.Q4_0, "Q4_1": GGMLType.Q4_1, "Q5_0": GGMLType.Q5_0,
    "Q5_1": GGMLType.Q5_1, "Q8_0": GGMLType.Q8_0,
}
# the k-quant mixes below Q4_K_M: the types of attn_v, attn_output and
# ffn_down in every layer, as llama.cpp's llama_model_quantize_internal of
# the GGUF era gives them and TheBloke/Llama-2-7B-GGUF's model card lists
# them (Q2_K: "GGML_TYPE_Q4_K for the attention.vw and feed_forward.w2
# tensors, GGML_TYPE_Q2_K for the other tensors"; attention.wo Q3_K)
LOW_K_MIXES = {
    "Q2_K": (GGMLType.Q4_K, GGMLType.Q3_K, GGMLType.Q4_K),
    "Q3_K_S": (GGMLType.Q3_K, GGMLType.Q3_K, GGMLType.Q3_K),
    "Q3_K_M": (GGMLType.Q4_K, GGMLType.Q4_K, GGMLType.Q4_K),
    "Q3_K_L": (GGMLType.Q5_K, GGMLType.Q5_K, GGMLType.Q5_K),
}


def use_more_bits(i_layer: int, n_layer: int) -> bool:
    """use_more_bits of llama_model_quantize_internal (ggerganov/llama.cpp):
    the layers whose attn_v and ffn_down get Q6_K in a *_K_M file."""
    return (
        i_layer < n_layer // 8
        or i_layer >= 7 * n_layer // 8
        or (i_layer - n_layer // 8) % 3 == 2
    )


def mix_type(mix: str, name: str, n_layer: int, row_len: int) -> GGMLType:
    """The type llama.cpp's llama_model_quantize_internal gives tensor
    `name`, whose rows are `row_len` long, in a file of `mix`: in a k-quant
    file output.weight Q6_K; in a K_M file attn_v and ffn_down Q6_K in
    use_more_bits layers; in the mixes below Q4_K_M attn_v, attn_output and
    ffn_down as LOW_K_MIXES gives them; in a legacy file output.weight Q6_K
    where its rows are a 256-multiple, except in a Q8_0 file, which keeps it
    Q8_0. token_embd and every other matmul weight take the mix's base
    type."""
    base = MIXES[mix]
    if name == "output.weight":
        if (mix.endswith("_K_M") or mix in LOW_K_MIXES
                or (base != GGMLType.Q8_0 and row_len % 256 == 0)):
            return GGMLType.Q6_K
        return base
    if mix in LOW_K_MIXES:
        for suffix, t in zip((".attn_v.weight", ".attn_output.weight", ".ffn_down.weight"),
                             LOW_K_MIXES[mix]):
            if name.endswith(suffix):
                return t
        return base
    if mix.endswith("_K_M") and name.endswith((".attn_v.weight", ".ffn_down.weight")):
        i_layer = int(name.split(".")[1])
        if use_more_bits(i_layer, n_layer):
            return GGMLType.Q6_K
    return base


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
    mix: Optional[str] = None,
) -> dict:
    """Write a llama GGUF. Matmul weights are `wtype`, or with `mix` (a key
    of MIXES: "Q2_K", "Q3_K_S", "Q3_K_M", "Q3_K_L", "Q4_K_M", "Q5_K_M",
    "Q4_0", "Q4_1", "Q5_0", "Q5_1", "Q8_0")
    the types llama.cpp gives them in such a file (mix_type; the token
    embedding then takes the mix's base type and `wtype` and `embed_type`
    are not read). Weights are quantized from N(0, 0.08^2) draws, or
    (synthesize_blocks, the types of RANDOM_BLOCKS) random blocks generated
    one tensor at a time while the file is written."""
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

    def weight(name, n_out, n_in, t=None):
        if t is None:  # GGMLType.F32 is 0, so not `or`
            t = mix_type(mix, name, n_layer, n_in) if mix else wtype
        ne = (n_in, n_out)  # GGML order: blocks along the input dim
        if synthesize_blocks and t not in (GGMLType.F32, GGMLType.F16):
            if t not in RANDOM_BLOCKS:
                raise ValueError(f"no synthesized blocks for {t.name}")
            tensors[name] = (t, ne, lambda: RANDOM_BLOCKS[t](rng, n_in * n_out))
        else:
            dense(name, (n_out, n_in), t, scale=0.02 if synthesize_blocks else 0.08)

    for name, n_out, n_in in llama_tensors(n_vocab, n_embd, n_head, n_head_kv, n_layer, n_ff):
        if n_in is None:
            dense(name, (n_out,), GGMLType.F32, offset=1.0)
        elif name == "token_embd.weight":
            weight(name, n_out, n_in, None if mix else embed_type)
        else:
            weight(name, n_out, n_in)
    write_gguf(path, kv, tensors)
    return dict(n_vocab=n_vocab, n_ctx=n_ctx, n_layer=n_layer)


def llama_tensors(n_vocab: int, n_embd: int, n_head: int, n_head_kv: int, n_layer: int,
                  n_ff: int) -> List[Tuple[str, int, Optional[int]]]:
    """(name, rows, row length) of every tensor of a llama GGUF in the
    order write_llama_gguf writes them; a norm vector has row length None."""
    dh = n_embd // n_head
    out = [("token_embd.weight", n_vocab, n_embd), ("output_norm.weight", n_embd, None),
           ("output.weight", n_vocab, n_embd)]
    for i in range(n_layer):
        p = f"blk.{i}"
        out += [
            (f"{p}.attn_norm.weight", n_embd, None),
            (f"{p}.attn_q.weight", n_head * dh, n_embd),
            (f"{p}.attn_k.weight", n_head_kv * dh, n_embd),
            (f"{p}.attn_v.weight", n_head_kv * dh, n_embd),
            (f"{p}.attn_output.weight", n_embd, n_head * dh),
            (f"{p}.ffn_norm.weight", n_embd, None),
            (f"{p}.ffn_gate.weight", n_ff, n_embd),
            (f"{p}.ffn_up.weight", n_ff, n_embd),
            (f"{p}.ffn_down.weight", n_embd, n_ff),
        ]
    return out


def mix_nbytes(mix: str, n_vocab: int, n_ctx: int, n_embd: int, n_head: int, n_head_kv: int,
               n_layer: int, n_ff: int) -> int:
    """The tensor bytes of a llama GGUF file of `mix` (norms f32), as
    write_llama_gguf would write it, without writing it (the GGUF header
    and vocab add well under a megabyte). With **LLAMA2_7B it is the size
    of a llama-2-7B file of that mix."""
    del n_ctx  # a key of LLAMA2_7B that sizes no tensor
    total = 0
    for name, n_out, n_in in llama_tensors(n_vocab, n_embd, n_head, n_head_kv, n_layer, n_ff):
        t = GGMLType.F32 if n_in is None else mix_type(mix, name, n_layer, n_in)
        total += row_nbytes(t, n_out * (n_in or 1))
    return total


def write_llama_gptq(
    path: str,
    n_vocab: int = 512,
    n_ctx: int = 128,
    n_embd: int = 256,
    n_head: int = 4,
    n_head_kv: Optional[int] = None,
    n_layer: int = 2,
    n_ff: int = 512,
    seed: int = 0,
    group: int = 128,
    act_order: bool = False,
) -> dict:
    """Write a llama GPTQ 4-bit checkpoint directory `path` in the
    GPTQ-for-LLaMa layout (formats/gptq.py), as the public 4-bit llama-2
    checkpoints are laid out: config.json, quantize_config.json,
    tokenizer.model and model.safetensors with, per projection, qweight
    (K/8, N) int32, qzeros (K/group, N/8) int32, f16 scales (K/group, N) and
    g_idx (K,) int32; f16 embeddings, norms and dense lm_head. The packed
    words are drawn directly (every bit pattern is a valid grid), the scales
    from [0.25, 1] * 0.25 / sqrt(K). With `act_order` (desc_act) g_idx is a
    random permutation of the rows' groups, drawn per tensor. Tensors are
    generated one at a time while the file is written. Raises ValueError
    when a projection's K is not a multiple of `group`."""
    n_head_kv = n_head_kv or n_head
    dh = n_embd // n_head
    shapes = {  # projection -> (K, N)
        "self_attn.q_proj": (n_embd, n_head * dh),
        "self_attn.k_proj": (n_embd, n_head_kv * dh),
        "self_attn.v_proj": (n_embd, n_head_kv * dh),
        "self_attn.o_proj": (n_head * dh, n_embd),
        "mlp.gate_proj": (n_embd, n_ff),
        "mlp.up_proj": (n_embd, n_ff),
        "mlp.down_proj": (n_ff, n_embd),
    }
    for name, (k, n) in shapes.items():
        if k % group or k % 8 or n % 8:
            raise ValueError(
                f"{name}: K = {k} must be a multiple of the group {group} (and "
                f"of 8), N = {n} a multiple of 8"
            )
    rng = np.random.default_rng(seed)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({
            "model_type": "llama", "architectures": ["LlamaForCausalLM"],
            "vocab_size": n_vocab, "hidden_size": n_embd,
            "intermediate_size": n_ff, "num_hidden_layers": n_layer,
            "num_attention_heads": n_head, "num_key_value_heads": n_head_kv,
            "rms_norm_eps": 1e-5, "max_position_embeddings": n_ctx,
            "rope_theta": 10000.0, "bos_token_id": 1, "eos_token_id": 2,
        }, f)
    with open(os.path.join(path, "quantize_config.json"), "w") as f:
        json.dump({"bits": 4, "group_size": group, "desc_act": act_order,
                   "sym": False, "true_sequential": True}, f)
    write_spm_model(os.path.join(path, "tokenizer.model"), *spm_vocab(n_vocab))

    tensors = {}

    def f16(name, shape, scale, offset=0.0):
        tensors[name] = (np.float16, shape, lambda: (
            rng.standard_normal(shape, np.float32) * scale + offset).astype(np.float16))

    def words(name, shape):
        tensors[name] = (np.int32, shape, lambda: rng.integers(
            0, 2**32, shape, dtype=np.uint32).view(np.int32))

    def projection(prefix, k, n):
        words(f"{prefix}.qweight", (k // 8, n))
        words(f"{prefix}.qzeros", (k // group, n // 8))
        hi = 0.25 / np.sqrt(k)
        tensors[f"{prefix}.scales"] = (np.float16, (k // group, n), lambda: (
            rng.random((k // group, n), np.float32) * (0.75 * hi) + 0.25 * hi
        ).astype(np.float16))
        g_idx = (np.arange(k) // group).astype(np.int32)
        tensors[f"{prefix}.g_idx"] = (np.int32, (k,), lambda: (
            rng.permutation(g_idx) if act_order else g_idx))

    f16("model.embed_tokens.weight", (n_vocab, n_embd), 0.02 if n_embd >= 1024 else 0.1)
    f16("model.norm.weight", (n_embd,), 0.08, offset=1.0)
    f16("lm_head.weight", (n_vocab, n_embd), 0.02 if n_embd >= 1024 else 0.1)
    for i in range(n_layer):
        p = f"model.layers.{i}"
        f16(f"{p}.input_layernorm.weight", (n_embd,), 0.08, offset=1.0)
        f16(f"{p}.post_attention_layernorm.weight", (n_embd,), 0.08, offset=1.0)
        for name, (k, n) in shapes.items():
            projection(f"{p}.{name}", k, n)
    write_safetensors(os.path.join(path, "model.safetensors"), tensors)
    return dict(n_vocab=n_vocab, n_ctx=n_ctx, n_layer=n_layer, group=group,
                act_order=act_order)
