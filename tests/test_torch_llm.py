"""The slice as a whole on the CPU: the port's AutoModelForCausalLM ->
LLM path against the JAX package's on the tiny llama GGUF fixtures."""

import numpy as np
import pytest

import ctransformers_tpu as J
import ctransformers_tpu_torch as T
from ctransformers_tpu.formats.quants import GGMLType
from ctransformers_tpu_torch.ops import qmm_kernels as K

from .fixtures import build_llama_gguf


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def f32_pair(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("f32") / "llama.gguf")
    build_llama_gguf(path, n_ctx=128, wtype=GGMLType.F32, seed=11)
    return (J.AutoModelForCausalLM.from_pretrained(path),
            T.AutoModelForCausalLM.from_pretrained(path, device="cpu"))


def test_f32_logits_across_chunks_and_decode(f32_pair):
    jl, tl = f32_pair
    rng = np.random.RandomState(0)
    for n in (13, 40):  # chunks 8 + 4 + 1, then 32 + 8
        toks = [1] + [int(t) for t in rng.randint(3, jl.vocab_size, n - 1)]
        for llm in f32_pair:
            llm.reset()
            llm.eval(toks)
        assert _rel(tl.logits, jl.logits) < 1e-4
        for _ in range(3):
            nxt = int(np.argmax(jl.logits))
            jl.eval([nxt])
            tl.eval([nxt])
            assert _rel(tl.logits, jl.logits) < 1e-4


def test_f32_greedy_and_seeded_tokens(f32_pair):
    jl, tl = f32_pair
    toks = jl.tokenize("hello world")
    assert tl.tokenize("hello world") == toks
    for kw in (dict(temperature=0.0), dict(top_k=40, temperature=0.8, seed=5)):
        got = [list(_take(llm.generate(toks, **kw), 16)) for llm in (jl, tl)]
        assert got[1] == got[0], kw


def _take(gen, n):
    for i, t in enumerate(gen):
        if i >= n:
            break
        yield t


def test_f32_text_with_stop(f32_pair):
    jl, tl = f32_pair
    ref = jl("hello", max_new_tokens=24, temperature=0.0)
    assert tl("hello", max_new_tokens=24, temperature=0.0) == ref
    stop = ref[3:5] if len(ref) >= 5 else "zz"
    kw = dict(max_new_tokens=24, top_k=40, temperature=0.8, seed=3, stop=[stop])
    assert tl("the cat", **kw) == jl("the cat", **kw)
    chunks = list(tl("the cat", stream=True, **kw))
    assert "".join(chunks) == jl("the cat", **kw)


def test_q4k_slice_runs_all_four_plain_versions(tmp_path):
    path = str(tmp_path / "llama_q4k.gguf")
    build_llama_gguf(path, n_embd=256, n_ff=512, n_ctx=128, wtype=GGMLType.Q4_K, seed=11)
    jl = J.AutoModelForCausalLM.from_pretrained(path)
    tl = T.AutoModelForCausalLM.from_pretrained(path, device="cpu")
    toks = [1] + [int(t) for t in np.random.RandomState(1).randint(3, jl.vocab_size, 72)]
    K.reset_counts()
    jl.eval(toks)  # chunks 64 + 8 + 1
    tl.eval(toks)
    errs = [_rel(tl.logits, jl.logits)]
    for _ in range(3):
        nxt = int(np.argmax(jl.logits))
        jl.eval([nxt])
        tl.eval([nxt])
        errs.append(_rel(tl.logits, jl.logits))
    assert all(v > 0 for v in K.PLAIN_CALLS.values()), K.PLAIN_CALLS
    assert sum(K.LAUNCHES.values()) == 0
    # the JAX package multiplies exactly in f32 on a CPU; the port's plain
    # versions round activations to int8 (qx, q) or bf16 (si, i) as the
    # kernels do. Measured 2.5-3.1% here; a wrong bias fold or split reads
    # 10-100%.
    assert max(errs) < 0.05, errs


def test_from_jax_params_serves_the_same_model(tmp_path, monkeypatch):
    """The JAX loader's params (ksplit planes on a CPU host), carried across
    with from_jax_params, give bit-identical logits to the port's own
    loader: the converted planes are the port's adjk planes."""
    from ctransformers_tpu.models.llama_gguf import load_bundle as jload
    from ctransformers_tpu_torch.engine.engine import Engine
    from ctransformers_tpu_torch.models.convert import from_jax_params
    from ctransformers_tpu_torch.models.llama_gguf import load_bundle as tload

    monkeypatch.setenv("CT_PACK4_LAYOUT", "ksplit")
    path = str(tmp_path / "llama_q4k.gguf")
    build_llama_gguf(path, n_embd=256, n_ff=512, n_ctx=128, wtype=GGMLType.Q4_K, seed=4)
    jb, tb = jload(path), tload(path)
    assert jb.params["layers"][0]["wq"].pack_layout == "ksplit"
    toks = [1] + [int(t) for t in np.random.RandomState(2).randint(3, 300, 40)]
    logits = []
    for params in (from_jax_params(jb.params), tb.params):
        eng = Engine(tb.spec, params, device="cpu")
        eng.eval(toks)
        logits.append(eng.logits)
    np.testing.assert_array_equal(logits[0], logits[1])
