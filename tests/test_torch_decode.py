"""The fused decode entry point of the port on the CPU (where the decode
step runs eagerly; the card replays it from a CUDA graph): LLM.generate_fast,
Engine.decode / decode_chunked and the device sampler against the port's
eval/argmax loop and the JAX package, the stop, EOS, rewind and abort
rules, the device position of a one-token forward, the logits rule, the
timings and the graph key."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ctransformers_tpu as J
import ctransformers_tpu_torch as T
from ctransformers_tpu.engine import sampler as jsampler
from ctransformers_tpu.formats.quants import GGMLType
from ctransformers_tpu_torch.engine import engine as E
from ctransformers_tpu_torch.engine import sampler as tsampler
from ctransformers_tpu_torch.models import forward as F
from ctransformers_tpu_torch.ops import rope

from .fixtures import build_llama_gguf


@pytest.fixture(scope="module")
def f32_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("decode") / "llama.gguf")
    build_llama_gguf(path, n_ctx=128, wtype=GGMLType.F32, seed=11)
    return path


@pytest.fixture(scope="module")
def q4k_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("decode_q4k") / "llama_q4k.gguf")
    build_llama_gguf(path, n_embd=256, n_ff=512, n_ctx=128, wtype=GGMLType.Q4_K, seed=11)
    return path


def _port(path):
    return T.AutoModelForCausalLM.from_pretrained(path, device="cpu")


def _eager_greedy(llm, prompt, n):
    """The eval/argmax loop from an empty context; stops after EOS as
    generate_fast does (the EOS token dropped)."""
    llm._context.clear()
    llm._engine.reset()
    llm.eval(llm.tokenize(prompt))
    out = []
    for _ in range(n):
        t = int(np.argmax(llm.logits))
        if llm.is_eos_token(t):
            break
        out.append(t)
        llm.eval([t])
    return out


@pytest.mark.parametrize("path_fixture,chunk", [("f32_path", 4), ("f32_path", 0),
                                                ("q4k_path", 8)])
def test_greedy_generate_fast_equals_the_eager_loop(path_fixture, chunk, request):
    """Greedy generate_fast (segments of `chunk`; 0: one segment) gives the
    eval/argmax loop's tokens and text, and its last logits bitwise."""
    path = request.getfixturevalue(path_fixture)
    fast, slow = _port(path), _port(path)
    text = fast.generate_fast("hello world", max_new_tokens=12, temperature=0.0,
                              repetition_penalty=1.0, chunk=chunk)
    got = fast._context[len(fast.tokenize("hello world")):]
    want = _eager_greedy(slow, "hello world", 12)
    assert got == want and text == slow.detokenize(want)
    if len(want) == 12:
        np.testing.assert_array_equal(fast.logits, slow.logits)


def test_greedy_generate_fast_equals_the_jax_packages(f32_path):
    """The port's generate_fast and the JAX package's on the same file:
    the same greedy text (f32 weights; logits within 1e-4)."""
    jl = J.AutoModelForCausalLM.from_pretrained(f32_path)
    tl = _port(f32_path)
    kw = dict(max_new_tokens=10, temperature=0.0, repetition_penalty=1.0, chunk=5)
    want = jl.generate_fast("the cat", **kw)
    assert tl.generate_fast("the cat", **kw) == want
    assert tl._context == jl._context
    rel = np.linalg.norm(tl.logits - jl.logits) / np.linalg.norm(jl.logits)
    assert rel < 1e-4


def test_stop_string_early_rewind_and_abort(f32_path):
    """The JAX package's stop, rewind and abort rules on a llama file: the
    fast text equals the host loop's under a stop string; generation ends
    within a segment of the stop and the cache is rewound past the dropped
    tail; an abort before the first segment generates nothing, one after the
    first stops there."""
    llm = _port(f32_path)
    ref = llm("hello", max_new_tokens=24, temperature=0.0, repetition_penalty=1.0)
    assert len(ref) >= 6
    stop = ref[4:6]
    slow = llm("hello", max_new_tokens=24, temperature=0.0, repetition_penalty=1.0, stop=[stop])
    fast = llm.generate_fast("hello", max_new_tokens=24, temperature=0.0,
                             repetition_penalty=1.0, stop=[stop], chunk=2)
    assert fast == slow and stop not in fast
    base = len(llm.tokenize("hello"))
    llm.generate_fast("hello", max_new_tokens=64, temperature=0.0, repetition_penalty=1.0,
                      stop=[stop], chunk=4)
    used = llm._engine.n_past - base
    assert used < 64 and used == len(llm._context) - base
    assert llm.generate_fast("hello", max_new_tokens=8, abort_callback=lambda: True) == ""
    calls = []

    def abort_after_one():
        calls.append(1)
        return len(calls) > 1

    llm.generate_fast("hello", max_new_tokens=64, temperature=0.0, repetition_penalty=1.0,
                      chunk=2, abort_callback=abort_after_one)
    assert len(llm._context) - base == 2 and llm._engine.n_past == len(llm._context)


def test_eos_drops_itself_and_the_rest_of_the_segment(f32_path, monkeypatch):
    """A segment holding EOS keeps the tokens before it; the cache rewinds
    to them, so the next prompt reuses exactly those rows."""
    llm = _port(f32_path)
    want = _eager_greedy(llm, "hello", 8)
    eos = want[3]
    monkeypatch.setattr(llm, "is_eos_token", lambda t: t == eos)
    text = llm.generate_fast("hello", max_new_tokens=8, temperature=0.0,
                             repetition_penalty=1.0, chunk=8)
    base = len(llm.tokenize("hello"))
    assert llm._context[base:] == want[:want.index(eos)]
    assert llm._engine.n_past == len(llm._context)
    assert text == llm.detokenize(want[:want.index(eos)])


def test_the_same_seed_gives_the_same_text(q4k_path):
    llm = _port(q4k_path)
    kw = dict(max_new_tokens=12, top_k=0, top_p=1.0, temperature=3.0, chunk=5)
    a = llm.generate_fast("hello", seed=4, **kw)
    toks_a = list(llm._context)
    assert llm.generate_fast("hello", seed=4, **kw) == a and llm._context == toks_a
    others = {llm.generate_fast("hello", seed=s, **kw) for s in (5, 6, 7)}
    assert len(others | {a}) > 1


def test_ct_decode_chunk_sets_the_segment(f32_path, monkeypatch):
    """chunk defaults to CT_DECODE_CHUNK (else 32); 0 takes the budget in
    one segment."""
    llm = _port(f32_path)
    seen = []
    decode = llm._engine.decode

    def spy(n, **kw):
        seen.append(n)
        return decode(n, **kw)

    monkeypatch.setattr(llm._engine, "decode", spy)
    monkeypatch.setenv("CT_DECODE_CHUNK", "3")
    llm.generate_fast("hi", max_new_tokens=7, temperature=0.0, repetition_penalty=1.0)
    assert seen == [3, 3, 1]
    seen.clear()
    monkeypatch.setenv("CT_DECODE_CHUNK", "0")
    llm.generate_fast("hi", max_new_tokens=7, temperature=0.0, repetition_penalty=1.0)
    assert seen == [7]
    seen.clear()
    monkeypatch.delenv("CT_DECODE_CHUNK")
    llm.generate_fast("hi", max_new_tokens=40, temperature=0.0, repetition_penalty=1.0)
    assert seen[0] == 32


def test_grammar_goes_to_the_host_loop(f32_path):
    with pytest.raises(NotImplementedError):
        _port(f32_path).generate_fast("x", max_new_tokens=3, grammar='root ::= "a"')


# -- the device sampler against the JAX chain ----------------------------------


class _Kept:
    """What a stubbed jax.random.categorical returns: the logits it got."""

    def __init__(self, l):
        self.l = l

    def astype(self, dtype):
        return self


def _jax_chain_probs(logits, last, monkeypatch, **cfg):
    """The probabilities the JAX package's sample_device draws from: its
    chain up to the categorical, then softmax."""
    monkeypatch.setattr(jax.random, "categorical", lambda key, l: _Kept(l))
    kept = jsampler.sample_device(jnp.asarray(logits), None, jnp.asarray(last), **cfg)
    l = np.asarray(kept.l, np.float64)
    p = np.exp(l - l.max())
    return p / p.sum()


CHAINS = [
    dict(top_k=10, top_p=0.8, temperature=0.7, repetition_penalty=1.3),
    dict(top_k=0, top_p=0.9, temperature=1.2, repetition_penalty=1.0),
    dict(top_k=5, top_p=1.0, temperature=0.5, repetition_penalty=0.8),
]


@pytest.mark.parametrize("cfg", CHAINS)
def test_sample_device_draws_follow_the_jax_chain(cfg, monkeypatch):
    """20,000 draws of sample_device over fixed logits (Gumbel noise from
    gumbel_noise, one row a draw) against the JAX chain's probabilities:
    total-variation distance <= 0.02, and no draw outside its support."""
    rng = np.random.RandomState(3)
    v, n = 64, 20000
    logits = (rng.randn(v) * 2).astype(np.float32)
    last = np.array([-1, -1, 3, 7, int(np.argmax(logits)), 11], np.int32)
    want = _jax_chain_probs(logits, last, monkeypatch, **cfg)
    noise = tsampler.gumbel_noise(torch.empty(n, v), seed=7, segment=0)
    lt, lastt = torch.from_numpy(logits), torch.from_numpy(last)
    draws = np.array([int(tsampler.sample_device(lt, noise[i], lastt, **cfg)) for i in range(n)])
    got = np.bincount(draws, minlength=v) / n
    assert set(np.flatnonzero(got)) <= set(np.flatnonzero(want))
    assert 0.5 * np.abs(got - want).sum() <= 0.02


def test_sample_device_keeps_ties_at_the_kth_value_and_argmax_when_cold(monkeypatch):
    """top-k keeps every token tied with the k-th value, as the JAX chain;
    temperature <= 0 takes the argmax of the raw logits (no penalty)."""
    logits = np.array([5.0, 3.0, 3.0, 3.0, 1.0, 0.5, 4.0, -2.0], np.float32)
    last = np.array([-1, -1], np.int32)
    cfg = dict(top_k=3, top_p=1.0, temperature=1.0, repetition_penalty=1.0)
    want = _jax_chain_probs(logits, last, monkeypatch, **cfg)
    assert set(np.flatnonzero(want)) == {0, 1, 2, 3, 6}
    noise = tsampler.gumbel_noise(torch.empty(4000, 8), seed=1, segment=3)
    draws = {int(tsampler.sample_device(torch.from_numpy(logits), noise[i],
                                        torch.from_numpy(last), **cfg)) for i in range(4000)}
    assert draws == {0, 1, 2, 3, 6}
    cold = dict(cfg, temperature=0.0, repetition_penalty=2.0)
    pen = torch.tensor([0, -1], dtype=torch.int32)
    tok = tsampler.sample_device(torch.from_numpy(logits), noise[0], pen, **cold)
    assert tok.dtype == torch.int32 and tok.shape == (1,) and int(tok) == 0


def test_segments_draw_from_different_noise():
    a = tsampler.gumbel_noise(torch.empty(2, 16), seed=3, segment=0)
    b = tsampler.gumbel_noise(torch.empty(2, 16), seed=3, segment=1)
    c = tsampler.gumbel_noise(torch.empty(2, 16), seed=3, segment=0)
    assert torch.equal(a, c) and not torch.equal(a, b) and torch.isfinite(a).all()


# -- the device position of a one-token forward ---------------------------------


@pytest.mark.parametrize("kv_dtype", ["f32", "bf16", "ieee_f16", "int8"])
@pytest.mark.parametrize("layout", ["sm", "hm"])
def test_a_device_n_past_gives_the_int_paths_logits(q4k_path, kv_dtype, layout, monkeypatch):
    """A one-token forward at n_past given as a (1,) int32 tensor (rope
    positions, the cache write and the attention's slots read it on the
    device) gives bitwise the logits and the cache of the same int."""
    monkeypatch.setenv("CT_KV_LAYOUT", layout)
    llm = T.AutoModelForCausalLM.from_pretrained(q4k_path, device="cpu", kv_dtype=kv_dtype)
    eng = llm._engine
    eng.eval([1] + list(range(5, 17)))  # chunks 8 + 4 + 1
    kv_a = F.KVCache(*(None if a is None else a.clone() for a in eng.kv))
    kv_b = F.KVCache(*(None if a is None else a.clone() for a in eng.kv))
    tok = torch.tensor([[42]])
    with torch.inference_mode():
        want, _ = F.forward(eng.spec, eng.params, tok, 13, kv_a, attn_window=256)
        got, _ = F.forward(eng.spec, eng.params, tok, torch.tensor([13], dtype=torch.int32),
                           kv_b, attn_window=256)
    assert torch.equal(got, want)
    for a, b in zip(kv_a, kv_b):
        assert (a is None and b is None) or torch.equal(a, b)
    with pytest.raises(ValueError):
        F.forward(eng.spec, eng.params, torch.tensor([[4, 5]]),
                  torch.tensor([13], dtype=torch.int32), kv_b)


def test_rope_frequencies_are_kept_per_device_and_bit_identical():
    rope._FREQS.clear()
    pos = torch.arange(5)
    a = rope.rope_angles(pos, 128, 128, 10000.0, 1.0)
    freqs = rope._FREQS[(torch.device("cpu"), 128, 128, 10000.0)]
    b = rope.rope_angles(pos, 128, 128, 10000.0, 1.0)
    assert torch.equal(a, b) and rope.rope_freqs("cpu", 128, 128, 10000.0) is freqs
    steps = np.arange(64, dtype=np.float32)
    want = np.asarray((10000.0 ** (-2.0 / 128)) ** steps, np.float32)
    np.testing.assert_array_equal(freqs.numpy(), want)


# -- the engine's rules -------------------------------------------------------------


def test_an_edited_host_logits_copy_steers_the_next_draw(f32_path):
    """decode() draws from the device copy while the host copy is as it was
    downloaded, from the host copy once it is edited."""
    llm = _port(f32_path)
    eng = llm._engine
    eng.eval([1, 5, 9])
    first = eng.logits  # downloaded, untouched
    greedy = int(np.argmax(first))
    assert eng.decode(1, temperature=0.0) == [greedy]
    eng.rewind(3)
    logits = eng.logits
    pick = (int(np.argmax(logits)) + 7) % len(logits)
    logits[pick] = logits.max() + 10.0
    assert eng.decode(1, temperature=0.0) == [pick]


def test_clearing_logits_makes_decode_raise_until_eval(f32_path):
    eng = _port(f32_path)._engine
    eng.eval([1, 5, 9])
    eng.logits = None
    with pytest.raises(RuntimeError, match="eval"):
        eng.decode(2)
    with pytest.raises(RuntimeError, match="eval"):
        eng.decode_chunked(4, chunk=2)
    eng.eval([4])
    assert len(eng.decode(2, temperature=0.0)) == 2


def test_timings_count_decode_samples_and_captures(f32_path):
    """timings() has the JAX package's keys; a decode counts its tokens as
    eval runs and samples; the CPU captures nothing."""
    llm = _port(f32_path)
    eng = llm._engine
    keys = {"t_p_eval_ms", "t_eval_ms", "t_sample_ms", "t_compile_ms", "n_p_eval", "n_eval",
            "n_sample", "n_compile"}
    assert set(eng.timings()) == keys
    llm.generate_fast("hello", max_new_tokens=6, seed=1, chunk=4)
    t = eng.timings()
    assert t["n_sample"] == 6 and t["n_eval"] == 6 and t["t_eval_ms"] > 0
    assert t["n_compile"] == 0 and t["t_compile_ms"] == 0 and t["t_sample_ms"] > 0
    llm.generate_fast("hello", max_new_tokens=4, temperature=0.0, chunk=4)
    assert eng.timings()["n_sample"] == 10


class _Recording(dict):
    """os.environ that records the names read."""

    def __init__(self, env):
        super().__init__(env)
        self.read = set()

    def get(self, key, default=None):
        self.read.add(key)
        return super().get(key, default)

    def __getitem__(self, key):
        self.read.add(key)
        return super().__getitem__(key)

    def __contains__(self, key):
        self.read.add(key)
        return super().__contains__(key)


def test_the_graph_key_holds_every_setting_a_step_reads(q4k_path, monkeypatch):
    """Every environment variable the decode step reads (what a capture
    bakes in) is in GRAPH_SETTINGS, and the graph key changes with each of
    them, with the cache dtype and with each sampler setting."""
    llm = _port(q4k_path)
    eng = llm._engine
    eng.eval([1, 5, 9])
    st = eng._state(4, 32)
    st.logits.copy_(eng._logits_dev)
    st.aux[0] = eng.n_past
    rec = _Recording(os.environ)
    monkeypatch.setattr(os, "environ", rec)
    with torch.inference_mode():
        eng._decode_step(st, (40, 0.95, 0.8, 1.1), 128)
    assert rec.read and rec.read <= set(E.GRAPH_SETTINGS), rec.read
    base = eng.graph_key(32, 128, 4, (40, 0.95, 0.8, 1.1))
    for name in E.GRAPH_SETTINGS:
        monkeypatch.setitem(rec, name, "changed")
        assert eng.graph_key(32, 128, 4, (40, 0.95, 0.8, 1.1)) != base, name
        monkeypatch.delitem(rec, name)
    assert eng.graph_key(32, 128, 4, (40, 0.95, 0.8, 1.1)) == base
    for cfg in ((20, 0.95, 0.8, 1.1), (40, 0.9, 0.8, 1.1), (40, 0.95, 0.0, 1.1),
                (40, 0.95, 0.8, 1.0)):
        assert eng.graph_key(32, 128, 4, cfg) != base
    assert eng.graph_key(64, 128, 4, (40, 0.95, 0.8, 1.1)) != base
    assert eng.graph_key(32, 256, 4, (40, 0.95, 0.8, 1.1)) != base
    assert eng.graph_key(32, 128, 8, (40, 0.95, 0.8, 1.1)) != base
    monkeypatch.setattr(eng, "kv_dtype", torch.int8)
    assert eng.graph_key(32, 128, 4, (40, 0.95, 0.8, 1.1)) != base
