from .hub import AutoModelForCausalLM
from .llm import LLM

__all__ = ["AutoModelForCausalLM", "LLM"]
