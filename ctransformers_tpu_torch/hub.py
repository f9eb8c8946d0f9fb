"""Model resolution for the port: a local file or directory -> `LLM`
(ctransformers_tpu/hub.py, local sources only).

* ``config.json`` in a directory supplies ``model_type`` plus the
  ``text-generation`` sampling defaults, which explicit kwargs override;
  unknown kwargs raise ``TypeError``.
* When no ``model_file`` is given, the smallest ``*.bin``/``*.gguf`` file in
  the directory wins.

* ``model_type="gptq"``, or "gptq" anywhere in the path, routes a local
  GPTQ checkpoint directory (``*.safetensors``, ``config.json``,
  ``tokenizer.model``) to the GPTQ backend (gptq/hub.py).

Served: llama GGUF files with Q4_0, Q4_1, Q5_0, Q5_1, Q8_0, Q4_K, Q5_K and
Q6_K matmul weights, and llama GPTQ 4-bit directories (groups 32, 64 and
128, with or without act-order).
Hub repo ids and the 🤗 wrapper (``hf=True``) are not yet ported.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Optional

from .llm import LLM, Config

_WEIGHT_SUFFIXES = (".bin", ".gguf")
_SAMPLING_KEYS = ("top_k", "top_p", "temperature", "repetition_penalty", "last_n_tokens")


def _local(path: str) -> Path:
    p = Path(path)
    if not (p.is_file() or p.is_dir()):
        raise ValueError(
            f"Model path '{path}' doesn't exist (the port loads local files only)."
        )
    return p


def _config_dict(p: Path) -> Dict[str, Any]:
    cfg = p / "config.json"
    if not p.is_dir() or not cfg.is_file():
        return {}
    with open(cfg) as f:
        return json.load(f)


def _weight_file(p: Path, model_file: Optional[str]) -> str:
    if p.is_file():
        return str(p)
    if model_file:
        candidate = (p / model_file).resolve()
        if not candidate.is_file():
            raise ValueError(f"Model file '{model_file}' not found in '{p}'")
        return str(candidate)
    ranked = sorted(
        (f.stat().st_size, str(f.resolve()))
        for f in p.iterdir()
        if f.is_file() and f.name.endswith(_WEIGHT_SUFFIXES)
    )
    if not ranked:
        raise ValueError(f"No model file found in directory '{p}'")
    return ranked[0][1]


@dataclass
class AutoConfig:
    config: Config
    model_type: Optional[str] = None

    @classmethod
    def from_pretrained(cls, model_path: str, **kwargs) -> "AutoConfig":
        """Config from a directory's config.json plus overrides (explicit
        kwargs > config.json text-generation params > Config defaults)."""
        raw = _config_dict(_local(model_path))
        config = Config()
        sampling = raw.get("task_specific_params", {}).get("text-generation", {})
        for key in _SAMPLING_KEYS:
            if sampling.get(key) is not None:
                setattr(config, key, sampling[key])
        for key, value in kwargs.items():
            if not hasattr(config, key):
                raise TypeError(
                    f"'{key}' is an invalid keyword argument for from_pretrained()"
                )
            setattr(config, key, value)
        return cls(config=config, model_type=raw.get("model_type"))


class AutoModelForCausalLM:
    @classmethod
    def from_pretrained(
        cls, model_path: str, *,
        model_type: Optional[str] = None, model_file: Optional[str] = None,
        config: Optional[AutoConfig] = None, lib: Optional[str] = None,
        lora: Optional[str] = None, local_files_only: bool = True,
        revision: Optional[str] = None, hf: bool = False,
        kv_dtype: Optional[str] = None, progress_callback=None,
        device="cuda", **kwargs,
    ) -> LLM:
        """Load a local weight file (or the smallest one in a directory)
        onto `device`: "cuda" by default, "cpu" only when asked."""
        del local_files_only, revision  # local sources only
        if hf:
            raise NotImplementedError("hf=True is not yet ported, see ROADMAP")
        if model_type == "gptq" or (
            model_type is None and "gptq" in str(model_path).lower()
        ):
            from . import gptq

            return gptq.AutoModelForCausalLM.from_pretrained(
                model_path, device=device, **kwargs)
        if config is None:
            config = AutoConfig.from_pretrained(model_path, **kwargs)
        return LLM(
            model_path=_weight_file(_local(model_path), model_file),
            model_type=model_type or config.model_type,
            config=config.config,
            lib=lib,
            lora=lora,
            kv_dtype=kv_dtype,
            progress_callback=progress_callback,
            device=device,
        )
