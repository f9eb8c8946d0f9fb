"""A tiny Q4_K_M llama packed ksplit (CT_PACK4_LAYOUT=ksplit, the autouse
fixture of tests/test_torch_ksplit.py) through the JAX package and the
port's from_pretrained on the CPU. A file of its own, so that the test
workers, which take a file each, share its minutes."""

import ctransformers_tpu as J
import ctransformers_tpu_torch as T
import numpy as np
import torch
from ctransformers_tpu.ops import qmatmul as jqm
from ctransformers_tpu_torch.ops import qmm_kernels as K

from .test_torch_ksplit import (CALL_TOL, LOGIT_CLASS, Q4KM_KERNELS, Q4KM_SEED, _adjk_tokens,
                                _greedy_tokens, _held)
from .test_torch_ksplit import ksplit  # noqa: F401 (the autouse fixture)
from .test_torch_llm import _greedy_errs, _mix_file, _pallas_as_port


def test_tiny_ksplit_q4km_llama_matches_jax(tmp_path, monkeypatch):
    """A tiny Q4_K_M llama packed ksplit through the JAX package and the
    port's from_pretrained on the CPU: every matmul call equals the JAX
    package's Pallas kernel of the mode the port picks (sb on the ksplit
    nibbles, q8 and b on the Q6_K grids), the logits sit within the wiring
    class of the JAX package on its exact path and on those kernels, the
    greedy tokens agree, and they equal those of the same file packed adjk."""
    from ctransformers_tpu_torch.models import forward

    path = _mix_file(tmp_path, "Q4_K_M", seed=Q4KM_SEED)
    jl = J.AutoModelForCausalLM.from_pretrained(path)
    tl = T.AutoModelForCausalLM.from_pretrained(path, device="cpu")
    layers = tl._engine.params["layers"]
    assert layers[0]["w_qkv"].pack_layout == "ksplit" and "w_gateup" in layers[1]
    assert layers[0]["w_qkv"].qs.dtype == torch.uint8
    toks = [1] + [int(t) for t in np.random.RandomState(1).randint(3, jl.vocab_size, 72)]
    worst = {}
    mm = _held(monkeypatch, worst)
    K.reset_counts()
    exact = _greedy_errs(jl, tl, toks)
    assert {k for k, v in K.PLAIN_CALLS.items() if v} == Q4KM_KERNELS, K.PLAIN_CALLS
    assert sum(K.LAUNCHES.values()) == 0
    assert set(worst) == {"sb", "q8", "b"} and max(worst.values()) <= CALL_TOL, worst
    monkeypatch.setattr(forward, "mm", mm)
    monkeypatch.setattr(jqm, "_qmm_jnp", _pallas_as_port)
    tl.reset()
    jl = J.AutoModelForCausalLM.from_pretrained(path)
    same = _greedy_errs(jl, tl, toks)
    print(f"ksplit Q4_K_M: calls vs Pallas {worst}; logits vs JAX exact {exact}, same {same}")
    assert max(exact) < LOGIT_CLASS and max(same) < LOGIT_CLASS, (exact, same)
    ks_tokens, margins = _greedy_tokens(tl, toks)
    assert min(margins) > LOGIT_CLASS, margins
    assert _adjk_tokens(path, toks, monkeypatch)[0] == ks_tokens
