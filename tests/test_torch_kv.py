"""KV caches in f32, bf16, IEEE f16 and int8, sequence- and head-major, on
the CPU: the port's kv_quantize, resolve_kv_dtype and KVCache against the
JAX package's, and the port's LLM against the JAX LLM with the same
kv_dtype (and CT_KV_LAYOUT) on the tiny llama fixtures."""

import numpy as np
import pytest
import torch

import ctransformers_tpu as J
import ctransformers_tpu_torch as T
from ctransformers_tpu.formats.quants import GGMLType
from ctransformers_tpu.models import forward as jf
from ctransformers_tpu_torch.models import forward as tf
from ctransformers_tpu_torch.ops import attention as A

from .fixtures import build_llama_gguf

KV_DTYPES = ("f32", "bf16", "f16", "int8", "ieee_f16")
# port LLM against JAX LLM, same kv_dtype: f32 as tests/test_torch_llm.py
# holds it. With bf16, f16 and int8 (and ieee_f16) the prompt chunks follow
# the JAX package's roundings (measured <= 1.8e-6), while a decode step
# goes through decode_attention, which rounds q * scale before the dot and
# the unnormalized p per chunk where the JAX LLM's full scores round the
# normalized probabilities: 1.1e-4..1.8e-3 measured on this fixture.
LOGIT_CLASS = {"f32": 1e-4, "bf16": 1e-2, "f16": 1e-2, "int8": 1e-2, "ieee_f16": 1e-2}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def f32_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("kv") / "llama.gguf")
    build_llama_gguf(path, n_ctx=128, wtype=GGMLType.F32, seed=11)
    return path


@pytest.fixture(scope="module")
def long_file(tmp_path_factory):
    """n_ctx 512, for the chunked prompt path (CT_ATTN=chunked)."""
    path = str(tmp_path_factory.mktemp("kv_long") / "llama.gguf")
    build_llama_gguf(path, n_ctx=512, wtype=GGMLType.F32, seed=12)
    return path


def test_kv_quantize_is_byte_equal_to_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 2, 16)).astype(np.float32) * 4
    x[0, 0, 0] = 0.0  # an all-zero row: the 1e-8 floor
    x[1, 2, 1, 3] = 127 * 0.5  # a half-way quotient: rounds to even
    jq, js = jf.kv_quantize(x)
    tq, ts = tf.kv_quantize(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32), np.asarray(js).view(np.uint32))


def test_resolve_kv_dtype_names_errors_and_env(monkeypatch):
    monkeypatch.delenv("CT_KV_DTYPE", raising=False)
    want = {None: torch.float32, "": torch.float32, "f32": torch.float32, " BF16 ": torch.bfloat16,
            "f16": torch.bfloat16, "int8": torch.int8, "ieee_f16": torch.float16}
    for name, dt in want.items():
        assert tf.resolve_kv_dtype(name) == dt
        assert np.dtype(jf.resolve_kv_dtype(name)).itemsize == torch.empty(0, dtype=dt).element_size()
    monkeypatch.setenv("CT_KV_DTYPE", "int8")
    assert tf.resolve_kv_dtype(None) == torch.int8 and jf.resolve_kv_dtype(None) == np.int8
    assert tf.resolve_kv_dtype("bf16") == torch.bfloat16  # a name beats the variable
    for bad in ("fp8", "float32", "q8"):
        with pytest.raises(ValueError) as te:
            tf.resolve_kv_dtype(bad)
        with pytest.raises(ValueError) as je:
            jf.resolve_kv_dtype(bad)
        assert str(te.value) == str(je.value)
    monkeypatch.setenv("CT_KV_DTYPE", "fp8")
    with pytest.raises(ValueError):
        tf.resolve_kv_dtype(None)


@pytest.mark.parametrize("hm", [False, True])
def test_cache_shapes_follow_the_layout(hm, monkeypatch):
    from ctransformers_tpu.models.synthetic import LLAMA_TINY
    from ctransformers_tpu_torch.models.spec import ArchSpec

    monkeypatch.setenv("CT_KV_LAYOUT", "hm" if hm else "sm")
    spec = ArchSpec(**{f: getattr(LLAMA_TINY, f) for f in ArchSpec.__dataclass_fields__})
    for name in KV_DTYPES:
        want = jf.KVCache.create(LLAMA_TINY, 2, jf.resolve_kv_dtype(name))
        got = tf.KVCache.create(spec, 2, "cpu", tf.resolve_kv_dtype(name))
        for a, b in zip(got, want):
            assert (a is None) == (b is None)
            if a is not None:
                assert tuple(a.shape) == b.shape
                assert a.element_size() == np.dtype(b.dtype).itemsize


def _greedy_pair(jl, tl, toks, steps=4):
    """Both models over `toks`, then `steps` greedy steps (the JAX model's
    token fed to both): the worst logits class and both greedy paths."""
    for llm in (jl, tl):
        llm.reset()
        llm.eval(toks)
    errs, jtok, ttok = [_rel(tl.logits, jl.logits)], [], []
    for _ in range(steps):
        jtok.append(int(np.argmax(jl.logits)))
        ttok.append(int(np.argmax(tl.logits)))
        jl.eval([jtok[-1]])
        tl.eval([jtok[-1]])
        errs.append(_rel(tl.logits, jl.logits))
    return max(errs), jtok, ttok


@pytest.mark.parametrize("name", KV_DTYPES)
@pytest.mark.parametrize("layout", ["sm", "hm"])
def test_llm_matches_jax_for_each_kv_dtype(f32_file, name, layout, monkeypatch):
    """A 40-token prompt (chunks 32 + 8) and four decode steps."""
    monkeypatch.setenv("CT_KV_LAYOUT", layout)
    jl = J.AutoModelForCausalLM.from_pretrained(f32_file, kv_dtype=name)
    tl = T.AutoModelForCausalLM.from_pretrained(f32_file, kv_dtype=name, device="cpu")
    kv = tl._engine.kv
    assert kv.k.dtype == tf.resolve_kv_dtype(name) and (kv.ks is not None) == (name == "int8")
    assert kv.k.shape[2 if layout == "sm" else 3] == 128
    toks = [1] + [int(t) for t in np.random.RandomState(0).randint(3, jl.vocab_size, 39)]
    A.reset_counts()
    worst, jtok, ttok = _greedy_pair(jl, tl, toks)
    # every decode step's layers went through decode_attention (the plain
    # version on the CPU), no prompt chunk did
    assert A.PLAIN_CALLS["decode_attn"] == 4 * tl._bundle.spec.n_layer
    assert ttok == jtok
    assert worst < LOGIT_CLASS[name], worst


@pytest.mark.parametrize("name,layout", [("bf16", "sm"), ("int8", "hm"), ("f32", "hm")])
def test_chunked_prompt_matches_jax(long_file, name, layout, monkeypatch):
    """CT_ATTN=chunked with 64-position chunks over a 300-token prompt
    (chunks 256 + 32 + 8 + 4, windows up to 512) and decode."""
    monkeypatch.setenv("CT_KV_LAYOUT", layout)
    monkeypatch.setenv("CT_ATTN", "chunked")
    monkeypatch.setenv("CT_ATTN_CHUNK", "64")
    jl = J.AutoModelForCausalLM.from_pretrained(long_file, kv_dtype=name)
    tl = T.AutoModelForCausalLM.from_pretrained(long_file, kv_dtype=name, device="cpu")
    toks = [1] + [int(t) for t in np.random.RandomState(3).randint(3, jl.vocab_size, 299)]
    worst, jtok, ttok = _greedy_pair(jl, tl, toks, steps=3)
    assert ttok == jtok
    assert worst < LOGIT_CLASS[name], worst


def test_int8_cache_stays_within_the_jax_packages_class_of_f32(f32_file):
    """int8 against f32 on the port alone, in the class tests/test_kv_int8.py
    holds the JAX package to (5%), with equal greedy tokens."""
    toks = [1] + [int(t) for t in np.random.RandomState(4).randint(3, 300, 30)]
    runs = {}
    for name in ("f32", "int8"):
        llm = T.AutoModelForCausalLM.from_pretrained(f32_file, kv_dtype=name, device="cpu")
        llm.eval(toks)
        out = [np.array(llm.logits)]
        for _ in range(4):
            llm.eval([int(np.argmax(out[-1]))])
            out.append(np.array(llm.logits))
        runs[name] = np.stack(out)
    assert np.array_equal(runs["f32"].argmax(-1), runs["int8"].argmax(-1))
    np.testing.assert_allclose(runs["int8"], runs["f32"], atol=0.05, rtol=0.05)


def test_unknown_kv_dtype_raises(f32_file):
    with pytest.raises(ValueError, match="unknown kv_dtype"):
        T.AutoModelForCausalLM.from_pretrained(f32_file, kv_dtype="fp8", device="cpu")


def test_env_sets_the_kv_dtype_and_reset_rewind_keep_it(f32_file, monkeypatch):
    monkeypatch.setenv("CT_KV_DTYPE", "bf16")
    llm = T.AutoModelForCausalLM.from_pretrained(f32_file, device="cpu")
    eng = llm._engine
    assert eng.kv_dtype == torch.bfloat16 and eng.kv.k.dtype == torch.bfloat16
    llm.eval([1, 5, 9, 14])
    eng.rewind(2)
    eng.reset()
    assert eng.kv_dtype == torch.bfloat16 and eng.kv.k.dtype == torch.bfloat16


def test_gptq_directory_honours_ct_kv_dtype(tmp_path, monkeypatch):
    from ctransformers_tpu_torch.models.synthetic import write_llama_gptq

    path = str(tmp_path / "llama-gptq")
    write_llama_gptq(path, seed=1, group=32, n_embd=64, n_ff=128, n_vocab=300)
    monkeypatch.setenv("CT_KV_DTYPE", "int8")
    monkeypatch.setenv("CT_KV_LAYOUT", "hm")
    llm = T.AutoModelForCausalLM.from_pretrained(path, device="cpu")
    kv = llm._engine.kv
    assert kv.k.dtype == torch.int8 and kv.ks is not None
    spec = llm._bundle.spec
    assert tuple(kv.k.shape) == (spec.n_layer, 1, spec.kv_heads, spec.n_ctx, spec.head_dim)
    toks = llm("hello", max_new_tokens=4, temperature=0.0)
    assert isinstance(toks, str)


@pytest.mark.parametrize("name,layout", [("f32", "sm"), ("int8", "hm"), ("bf16", "sm")])
def test_jax_cache_carried_across_decodes_alike(f32_file, name, layout, monkeypatch):
    """A cache filled by the JAX engine's prefill, carried across with
    from_jax_params, then one decode step in both packages."""
    from ctransformers_tpu.engine.engine import Engine as JEngine
    from ctransformers_tpu.models.llama_gguf import load_bundle as jload
    from ctransformers_tpu_torch.engine.engine import Engine as TEngine
    from ctransformers_tpu_torch.models.convert import from_jax_params
    from ctransformers_tpu_torch.models.llama_gguf import load_bundle as tload

    monkeypatch.setenv("CT_KV_LAYOUT", layout)
    jb, tb = jload(f32_file), tload(f32_file)
    toks = [1] + [int(t) for t in np.random.RandomState(5).randint(3, 300, 20)]
    je = JEngine(jb.spec, jb.params, kv_dtype=jf.resolve_kv_dtype(name))
    je.eval(toks)
    te = TEngine(tb.spec, tb.params, device="cpu", kv_dtype=tf.resolve_kv_dtype(name))
    kv = from_jax_params(je.kv)
    assert isinstance(kv, tf.KVCache) and kv.k.dtype == te.kv.k.dtype
    assert kv.k.shape == te.kv.k.shape and (kv.ks is None) == (name != "int8")
    te.kv, te.n_past = kv, len(toks)
    nxt = int(np.argmax(je.logits))
    je.eval([nxt])
    te.eval([nxt])
    assert _rel(te.logits, je.logits) < LOGIT_CLASS[name]
