"""The tiny GPTQ llama at group 128 with act-order through both packages'
AutoModelForCausalLM on the CPU (tests/test_torch_gptq.py:
gptq_llm_matches_jax), the longest of them: a file of its own, so that the
test workers, which take a file each, share its minutes."""

import pytest

from .test_torch_gptq import adjk, gptq_llm_matches_jax  # noqa: F401 (autouse fixture)


@pytest.mark.parametrize("size,act_order", [("d256-g128", True)], ids=["d256-g128-actorder"])
def test_gptq_llm_matches_jax(tmp_path, size, act_order, monkeypatch):
    gptq_llm_matches_jax(tmp_path, size, act_order, monkeypatch)
