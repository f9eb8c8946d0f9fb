"""GPTQ backend (ctransformers_tpu/gptq/llm.py): a GPTQ-for-LLaMa /
AutoGPTQ int4 checkpoint directory (the smallest .safetensors, config.json
and tokenizer.model), act-order included, unpacked into QTensor planes
(formats/gptq.py) and served by the same engine as the GGUF path, so the
low-level API (eval / sample / logits) works here too.
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import numpy as np

from ..engine import sampler as samplers
from ..formats.gptq import gptq_to_qtensor
from ..formats.safetensors import SafetensorsReader
from ..llm import LLM as _BaseLLM
from ..llm import Config, get
from ..models.registry import ModelBundle
from ..models.spec import ArchSpec
from ..models.vocab import GGUFVocab
from ..tokenizers.spm import SPMTokenizer
from ..tokenizers.spm_model import parse_spm_model
from ..utils import resolve_device

_EXTENDED = ("tfs_z", "typical_p", "frequency_penalty", "presence_penalty", "mirostat")


def _find_safetensors(path: Path) -> Path:
    # the smallest model file wins
    files = sorted((f.stat().st_size, f) for f in path.glob("*.safetensors"))
    if not files:
        raise ValueError(f"No .safetensors file found in '{path}'")
    return files[0][1]


def _layer_weight(st: SafetensorsReader, prefix: str):
    """Quantized (qweight/qzeros/scales[/g_idx]) or dense weight -> x @ W."""
    if f"{prefix}.qweight" in st:
        return gptq_to_qtensor(
            st.tensor(f"{prefix}.qweight"),
            st.tensor(f"{prefix}.qzeros"),
            st.tensor_f32(f"{prefix}.scales"),
            st.tensor(f"{prefix}.g_idx") if f"{prefix}.g_idx" in st else None,
        )
    # dense (K, N) for x @ W: HF stores (out, in)
    return np.ascontiguousarray(st.tensor_f32(f"{prefix}.weight").T)


def load_bundle(model_dir: str, context_length: int = -1) -> ModelBundle:
    path = Path(model_dir)
    with open(path / "config.json") as f:
        cfg = json.load(f)
    st = SafetensorsReader(str(_find_safetensors(path)))

    n_head = cfg["num_attention_heads"]
    spec = ArchSpec(
        name="llama",
        n_vocab=cfg["vocab_size"],
        n_ctx=context_length
        if context_length > 0
        else cfg.get("max_position_embeddings", 2048),
        n_embd=cfg["hidden_size"],
        n_head=n_head,
        n_layer=cfg["num_hidden_layers"],
        n_head_kv=cfg.get("num_key_value_heads", n_head),
        n_ff=cfg["intermediate_size"],
        # HF llama rotate_half == ggml neox-mode rope over the full head
        rope_mode="neox",
        n_rot=cfg["hidden_size"] // n_head,
        rope_base=float(cfg.get("rope_theta", 10000.0)),
        norm="rmsnorm",
        norm_eps=float(cfg.get("rms_norm_eps", 1e-6)),
        act="silu_gate",
    )

    # unpacking and repacking a tensor is numpy work that releases the GIL:
    # a thread pool spreads it over the host's cores
    pool = ThreadPoolExecutor(min(8, os.cpu_count() or 1))

    def W(prefix):
        return pool.submit(_layer_weight, st, prefix)

    params = {
        "wte": st.tensor_f32("model.embed_tokens.weight"),
        "ln_f_g": st.tensor_f32("model.norm.weight"),
        "lm_head": W("lm_head")
        if "lm_head.qweight" in st or "lm_head.weight" in st
        else np.ascontiguousarray(st.tensor_f32("model.embed_tokens.weight").T),
        "layers": [],
    }
    for i in range(spec.n_layer):
        p = f"model.layers.{i}"
        params["layers"].append(
            {
                "ln1_g": st.tensor_f32(f"{p}.input_layernorm.weight"),
                "wq": W(f"{p}.self_attn.q_proj"),
                "wk": W(f"{p}.self_attn.k_proj"),
                "wv": W(f"{p}.self_attn.v_proj"),
                "wo": W(f"{p}.self_attn.o_proj"),
                "ln2_g": st.tensor_f32(f"{p}.post_attention_layernorm.weight"),
                "w_gate": W(f"{p}.mlp.gate_proj"),
                "w_up": W(f"{p}.mlp.up_proj"),
                "w_down": W(f"{p}.mlp.down_proj"),
            }
        )

    def res(v):
        return v.result() if hasattr(v, "result") else v

    try:
        params["lm_head"] = res(params["lm_head"])
        for layer in params["layers"]:
            for k in list(layer):
                layer[k] = res(layer[k])
    finally:
        pool.shutdown(cancel_futures=True)

    pieces, scores, types = parse_spm_model(str(path / "tokenizer.model"))
    vocab = GGUFVocab(pieces, scores, types, vocab_type="spm")
    tokenizer = SPMTokenizer(vocab)
    return ModelBundle(
        spec,
        params,
        vocab,
        tokenizer,
        architecture="gptq",
        sampler="llama",
        supports_embeddings=True,
    )


class LLM(_BaseLLM):
    def __init__(
        self,
        model_path: str,
        model_type: Optional[str] = None,
        *,
        config: Optional[Config] = None,
        lib: Optional[str] = None,
        device="cuda",
    ):
        """Load a GPTQ model from a local directory onto `device` ("cuda"
        by default; raises when CUDA is absent unless the caller asks for
        "cpu"). `model_type` and `lib` are accepted for API compatibility:
        GPTQ checkpoints describe themselves."""
        del model_type, lib
        config = config or Config()
        self._model_path = model_path
        self._config = config
        self._context = []
        if not Path(model_path).is_dir():
            raise ValueError(f"Model path '{model_path}' doesn't exist.")
        device = resolve_device(device)  # before the (long) load
        bundle = load_bundle(model_path, context_length=config.context_length)
        self._init_from_bundle(bundle, "gptq", device)

    def sample(self, **kwargs) -> int:
        """GPTQ sampling: the repetition penalty follows the decaying
        schedule of the GPTQ backend (penalty_max = repetition_penalty,
        sustain = last_n_tokens, decay = last_n_tokens // 2): it fades
        linearly to 1.0 for tokens older than the sustain window. The
        extended sampler's arguments go to the base class, which raises
        until that sampler is ported."""
        if any(kwargs.get(k) is not None for k in _EXTENDED):
            return super().sample(**kwargs)
        cfg = self.config
        last_n = get(kwargs.get("last_n_tokens"), cfg.last_n_tokens)
        if last_n < 0:
            last_n = self.context_length
        sustain, decay = last_n, last_n // 2
        if self._engine.logits is None:
            return self.eos_token_id
        return samplers.sample_llama_decayed(
            self._engine.logits,
            top_k=get(kwargs.get("top_k"), cfg.top_k),
            top_p=get(kwargs.get("top_p"), cfg.top_p),
            temperature=get(kwargs.get("temperature"), cfg.temperature),
            repetition_penalty=get(kwargs.get("repetition_penalty"), cfg.repetition_penalty),
            # the decay window extends past the sustain window
            last_tokens=self._context[-(sustain + decay):] if sustain + decay else [],
            seed=get(kwargs.get("seed"), cfg.seed),
            sustain=sustain,
            decay=decay,
        )
