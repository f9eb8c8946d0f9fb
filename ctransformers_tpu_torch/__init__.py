"""ctransformers API on PyTorch and CUDA: the port of ctransformers_tpu to
one NVIDIA H100. Entry points run on the card unless the caller passes
device="cpu". The package imports torch and numpy, never jax."""

from .hub import AutoConfig, AutoModelForCausalLM
from .llm import LLM, Config

__version__ = "0.1.0"
__all__ = ["Config", "LLM", "AutoConfig", "AutoModelForCausalLM"]
