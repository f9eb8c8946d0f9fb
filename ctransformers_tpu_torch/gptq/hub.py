"""GPTQ model resolution (ctransformers_tpu/gptq/hub.py, local
directories only): validate Config overrides and hand the directory to the
GPTQ-backed :class:`LLM`. A Hub repo id raises, as the port's hub.py does
for GGUF sources.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

from ..llm import Config
from .llm import LLM


class AutoModelForCausalLM:
    @classmethod
    def from_pretrained(
        cls, model_path: str, *,
        model_type: Optional[str] = None, local_files_only: bool = True,
        revision: Optional[str] = None, device="cuda", **kwargs,
    ) -> LLM:
        """Load a local GPTQ checkpoint directory onto `device`: "cuda" by
        default, "cpu" only when asked."""
        del local_files_only, revision  # local sources only
        config = Config()
        for key, value in kwargs.items():
            if not hasattr(config, key):
                raise TypeError(
                    f"'{key}' is an invalid keyword argument for from_pretrained()"
                )
            setattr(config, key, value)
        if not Path(model_path).is_dir():
            raise ValueError(
                f"Model path '{model_path}' doesn't exist (the port loads local "
                "directories only)."
            )
        return LLM(str(model_path), model_type, config=config, device=device)
