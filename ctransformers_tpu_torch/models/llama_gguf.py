"""GGUF llama loader (ctransformers_tpu/models/llama_gguf.py, llama branch).

Quantized 2-D weights are repacked into QTensor planes (ops/qmatmul.py),
weights for x @ W are transposed at load, and the token embedding stays at
file precision (the engine upcasts it on the device). Llama GGUF q/k
weights are stored pre-permuted for interleaved (mode 0) rope.

Matmul weights load as F32, F16, the legacy block types Q4_0, Q4_1, Q5_0,
Q5_1 and Q8_0 (the llama files of those ftypes, whose output tensor is
Q6_K except in a Q8_0 file), or Q4_K, Q5_K and Q6_K (the types of llama
Q4_K_M and Q5_K_M files, whose output, attn_v and ffn_down tensors are
partly Q6_K), or Q2_K and Q3_K (llama Q2_K and Q3_K_S/M/L files, whose
attn_v, attn_output and ffn_down tensors may be Q3_K, Q4_K or Q5_K and
whose output tensor is Q6_K). The token embedding loads in any type the port's codecs
decode (F32 and F16 stay at file precision, a quantized table becomes f32
on the host). Any other quantized type raises NotImplementedError.
"""

from __future__ import annotations

import os

import numpy as np

from ..formats.gguf import GGUFReader
from ..formats.quants import GGMLType
from ..ops.qmatmul import repack
from ..ops.qmm_kernels import LAYOUTS
from .spec import ArchSpec
from .vocab import GGUFVocab

# quantized matmul weight types with kernels in ops/qmm_kernels.py
SERVED_TYPES = tuple(GGMLType[kind] for kind in LAYOUTS if kind in GGMLType.__members__)


def _kv(r: GGUFReader, key: str, default=None, required: bool = False):
    if key in r.kv:
        return r.kv[key]
    if required:
        raise ValueError(f"GGUF: missing required key {key}")
    return default


def _load_vocab(r: GGUFReader):
    from ..tokenizers.spm import SPMTokenizer

    model = _kv(r, "tokenizer.ggml.model", "llama")
    if model == "gpt2":  # BPE vocab (falcon)
        raise NotImplementedError(
            f"tokenizer model {model!r} is not yet ported, see ROADMAP"
        )
    vocab = GGUFVocab(
        _kv(r, "tokenizer.ggml.tokens", required=True),
        _kv(r, "tokenizer.ggml.scores"),
        _kv(r, "tokenizer.ggml.token_type"),
        vocab_type="spm",
        bos_id=int(_kv(r, "tokenizer.ggml.bos_token_id", 1)),
        eos_id=int(_kv(r, "tokenizer.ggml.eos_token_id", 2)),
        unk_id=int(_kv(r, "tokenizer.ggml.unknown_token_id", 0)),
        pad_id=int(_kv(r, "tokenizer.ggml.padding_token_id", -1)),
    )
    return vocab, SPMTokenizer(vocab)


def _weight(r: GGUFReader, name: str):
    """2-D matmul weight for x @ W: QTensor when quantized, dense .T else."""
    info = r.tensors[name]
    rows, cols = info.numpy_shape  # (out, in)
    if info.type in (GGMLType.F32, GGMLType.F16):
        return np.ascontiguousarray(r.tensor_f32(name).T)
    if info.type not in SERVED_TYPES:
        raise NotImplementedError(
            f"{name}: {info.type.name} weights are not yet ported, see ROADMAP"
        )
    return repack(r.tensor_bytes(name), info.type, rows, cols)


def _dense(r: GGUFReader, name: str):
    return r.tensor_f32(name)


def _embed(r: GGUFReader, name: str):
    """Embedding table at file precision (f16 stays f16); a quantized table
    (Q4_0 or Q8_0 in a legacy file, Q4_K or Q5_K in a K_M file) is
    dequantized to f32 on the host, as the JAX loader does (the codecs raise
    NotImplementedError on a type not yet ported)."""
    return r.tensor_storage(name)


def load_bundle(path: str, context_length: int = -1, progress_callback=None):
    """progress_callback(fraction) is called as layers finish loading."""
    from ..utils import is_gguf
    from .registry import ModelBundle

    if not is_gguf(path):
        raise NotImplementedError(
            "pre-GGUF llama files (GGML/GGJT) are not yet ported, see ROADMAP"
        )
    r = GGUFReader(path)
    arch = _kv(r, "general.architecture", required=True)
    if arch != "llama":
        raise NotImplementedError(f"architecture {arch!r} is not yet ported, see ROADMAP")

    vocab, tokenizer = _load_vocab(r)
    n_ctx_train = int(_kv(r, "llama.context_length", 2048, required=True))
    n_embd = int(_kv(r, "llama.embedding_length", required=True))
    n_layer = int(_kv(r, "llama.block_count", required=True))
    n_head = int(_kv(r, "llama.attention.head_count", required=True))
    head_dim = n_embd // n_head
    scale_linear = float(_kv(r, "llama.rope.scale_linear", 1.0))
    spec = ArchSpec(
        name="llama",
        n_vocab=len(vocab),
        n_ctx=context_length if context_length > 0 else n_ctx_train,
        n_ctx_train=n_ctx_train,
        n_embd=n_embd,
        n_head=n_head,
        n_layer=n_layer,
        n_head_kv=int(_kv(r, "llama.attention.head_count_kv", n_head)),
        n_ff=int(_kv(r, "llama.feed_forward_length", required=True)),
        rope_mode="interleaved",  # weights pre-permuted at conversion
        n_rot=head_dim,
        rope_base=float(_kv(r, "llama.rope.freq_base", 10000.0)),
        rope_scale=1.0 / scale_linear if scale_linear != 0 else 1.0,
        norm="rmsnorm",
        norm_eps=float(_kv(r, "llama.attention.layer_norm_rms_epsilon", 1e-5)),
        act="silu_gate",
    )

    # the per-tensor decode + repack is numpy work that releases the GIL:
    # a thread pool spreads it over the host's cores (CT_LOAD_THREADS of
    # them, else up to 8; one: no pool, each tensor loads where it is named)
    from concurrent.futures import ThreadPoolExecutor

    threads = int(os.environ.get("CT_LOAD_THREADS", "0")) or min(8, os.cpu_count() or 1)
    pool = ThreadPoolExecutor(threads) if threads > 1 else None

    def W(name):
        return pool.submit(_weight, r, name) if pool else _weight(r, name)

    params = {
        "wte": _embed(r, "token_embd.weight"),
        "ln_f_g": _dense(r, "output_norm.weight"),
        "layers": [],
    }
    params["lm_head"] = (
        W("output.weight")
        if "output.weight" in r.tensors
        else np.ascontiguousarray(np.asarray(params["wte"], np.float32).T)  # tied
    )
    for i in range(n_layer):
        p = f"blk.{i}"
        params["layers"].append(
            {
                "ln1_g": _dense(r, f"{p}.attn_norm.weight"),
                "wq": W(f"{p}.attn_q.weight"),
                "wk": W(f"{p}.attn_k.weight"),
                "wv": W(f"{p}.attn_v.weight"),
                "wo": W(f"{p}.attn_output.weight"),
                "ln2_g": _dense(r, f"{p}.ffn_norm.weight"),
                "w_gate": W(f"{p}.ffn_gate.weight"),
                "w_up": W(f"{p}.ffn_up.weight"),
                "w_down": W(f"{p}.ffn_down.weight"),
            }
        )

    def res(v):
        return v.result() if hasattr(v, "result") else v

    try:
        params["lm_head"] = res(params["lm_head"])
        for i, layer in enumerate(params["layers"]):
            for k in list(layer):
                layer[k] = res(layer[k])
            if progress_callback:
                progress_callback((i + 1) / max(1, n_layer))
    finally:
        if pool:
            pool.shutdown(cancel_futures=True)
    return ModelBundle(
        spec, params, vocab, tokenizer, architecture=arch, sampler="llama",
        supports_embeddings=True,
    )
