"""A tiny GPTQ directory packed ksplit (CT_PACK4_LAYOUT=ksplit, the autouse
fixture of tests/test_torch_ksplit.py) through both packages on the CPU. A
file of its own, so that the test workers, which take a file each, share
its minutes."""

import ctransformers_tpu as J
import ctransformers_tpu_torch as T
import numpy as np
from ctransformers_tpu_torch.ops import qmm_kernels as K

from .test_torch_gptq import _gptq_dir
from .test_torch_ksplit import CALL_TOL, GPTQ_SEED, LOGIT_CLASS, _adjk_tokens, _greedy_tokens, _held
from .test_torch_ksplit import ksplit  # noqa: F401 (the autouse fixture)
from .test_torch_llm import _greedy_errs


def test_tiny_ksplit_gptq_llama_matches_jax(tmp_path, monkeypatch):
    """A tiny GPTQ directory (group 128) packed ksplit through both
    packages on the CPU: every matmul call equals the JAX Pallas kernel of
    the picked mode (sb), the logits sit within the wiring class of the JAX
    package's exact path, the greedy tokens agree, and they equal those of
    the directory packed adjk."""
    path = _gptq_dir(tmp_path, "d256-g128", False, seed=GPTQ_SEED)
    jl = J.AutoModelForCausalLM.from_pretrained(path)
    tl = T.AutoModelForCausalLM.from_pretrained(path, device="cpu")
    assert tl._engine.params["layers"][0]["wo"].pack_layout == "ksplit"
    toks = [1] + [int(t) for t in np.random.RandomState(1).randint(3, jl.vocab_size, 72)]
    worst = {}
    _held(monkeypatch, worst)
    K.reset_counts()
    exact = _greedy_errs(jl, tl, toks)
    assert {k for k, v in K.PLAIN_CALLS.items() if v} == {"qmm_sb_ks"}, K.PLAIN_CALLS
    assert sum(K.LAUNCHES.values()) == 0
    assert set(worst) == {"sb"} and max(worst.values()) <= CALL_TOL, worst
    print(f"ksplit GPTQ4 g128: calls vs Pallas {worst}; logits vs JAX exact {exact}")
    assert max(exact) < LOGIT_CLASS, exact
    ks_tokens, margins = _greedy_tokens(tl, toks)
    assert min(margins) > LOGIT_CLASS, margins
    assert _adjk_tokens(path, toks, monkeypatch)[0] == ks_tokens
