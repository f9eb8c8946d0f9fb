"""Model-type dispatch (ctransformers_tpu/models/registry.py).

Model type strings are normalized by dropping non-alphanumerics and mapped
to a loader; GGUF files override the requested type. This slice registers
the GGUF llama loader only.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from ..utils import is_gguf
from .spec import ArchSpec

_LOADERS: Dict[str, str] = {
    "gguf": "llama_gguf",
    "llama": "llama_gguf",
}


def normalize_type(model_type: str) -> str:
    return "".join(c for c in model_type if c.isalnum()).lower()


@dataclass
class ModelBundle:
    spec: ArchSpec
    params: dict
    vocab: object
    tokenizer: object
    architecture: str = ""  # GGUF-reported architecture
    sampler: str = "gpt"  # "gpt" | "llama"
    supports_embeddings: bool = False


def load_model(
    model_path: str,
    model_type: str,
    context_length: int = -1,
    progress_callback=None,
) -> ModelBundle:
    import importlib

    mtype = normalize_type(model_type or "")
    if mtype != "gguf" and is_gguf(model_path):
        mtype = "gguf"  # GGUF magic overrides the requested type
    if mtype not in _LOADERS:
        raise NotImplementedError(
            f"Model type '{model_type}' is not yet ported, see ROADMAP"
        )
    module = importlib.import_module(f".{_LOADERS[mtype]}", __package__)
    return module.load_bundle(
        model_path, context_length, progress_callback=progress_callback
    )
