"""The tiny GPTQ llamas of tests/test_torch_gptq.py through both packages'
AutoModelForCausalLM on the CPU (gptq_llm_matches_jax): group 32 with and
without act-order, group 128 without; group 128 with act-order, the
longest, is tests/test_torch_gptq_llm_actorder.py. A file of their own, so
that the test workers, which take a file each, share their minutes."""

import pytest

from .test_torch_gptq import adjk, gptq_llm_matches_jax  # noqa: F401 (autouse fixture)


@pytest.mark.parametrize("size,act_order", [("d64-g32", False), ("d64-g32", True),
                                             ("d256-g128", False)],
                         ids=["d64-g32-plain", "d64-g32-actorder", "d256-g128-plain"])
def test_gptq_llm_matches_jax(tmp_path, size, act_order, monkeypatch):
    gptq_llm_matches_jax(tmp_path, size, act_order, monkeypatch)
