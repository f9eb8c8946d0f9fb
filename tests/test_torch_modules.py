"""The port's modules against their JAX counterparts on the CPU: norms,
rope, attention, the forward pass on dense weights, the GGUF reader and
writer, the tokenizer, the samplers and the text streamer."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctransformers_tpu.engine import sampler as jsamp
from ctransformers_tpu.formats import gguf as jgguf
from ctransformers_tpu.models import forward as jfwd
from ctransformers_tpu.models.llama_gguf import load_bundle as jload
from ctransformers_tpu.ops import norm as jnorm
from ctransformers_tpu.ops import rope as jrope
from ctransformers_tpu.utils import TextStreamer as JStreamer
from ctransformers_tpu_torch.engine import sampler as tsamp
from ctransformers_tpu_torch.engine.engine import Engine
from ctransformers_tpu_torch.formats import gguf as tgguf
from ctransformers_tpu_torch.formats import quants as tquants
from ctransformers_tpu_torch.models import forward as tfwd
from ctransformers_tpu_torch.models.llama_gguf import load_bundle as tload
from ctransformers_tpu_torch.models.spec import ArchSpec
from ctransformers_tpu_torch.ops import norm as tnorm
from ctransformers_tpu_torch.ops import rope as trope
from ctransformers_tpu_torch.utils import TextStreamer as TStreamer

from .fixtures import build_llama_gguf


def _rng(seed=0):
    return np.random.RandomState(seed)


def _close(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol)


def test_rms_norm():
    x = _rng(1).randn(3, 5, 64).astype(np.float32)
    g = _rng(2).randn(64).astype(np.float32)
    _close(tnorm.rms_norm(torch.from_numpy(x), torch.from_numpy(g), 1e-5),
           jnorm.rms_norm(jnp.asarray(x), jnp.asarray(g), 1e-5), 1e-6)


@pytest.mark.parametrize("mode,n_dims", [("neox", 32), ("neox", 16), ("interleaved", 32)])
def test_rope(mode, n_dims):
    x = _rng(3).randn(2, 7, 4, 32).astype(np.float32)
    pos = np.arange(5, 12)
    ja = jrope.rope_angles(jnp.asarray(pos), 32, n_dims, 10000.0, 1.0)
    ta = trope.rope_angles(torch.from_numpy(pos), 32, n_dims, 10000.0, 1.0)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    if mode == "neox":
        j = jrope.apply_rope_neox(jnp.asarray(x), ja, n_dims)
        t = trope.apply_rope_neox(torch.from_numpy(x), ta, n_dims)
    else:
        j = jrope.apply_rope_interleaved(jnp.asarray(x), ja)
        t = trope.apply_rope_interleaved(torch.from_numpy(x), ta)
    _close(t, j, 1e-6)


SPEC = ArchSpec(
    name="llama", n_vocab=64, n_ctx=1024, n_embd=64, n_head=4, n_layer=2,
    n_head_kv=2, n_ff=96, rope_mode="interleaved", n_rot=16, norm="rmsnorm",
    act="silu_gate",
)


def _jspec():
    from ctransformers_tpu.models.spec import ArchSpec as JSpec

    return JSpec(**{f: getattr(SPEC, f) for f in SPEC.__dataclass_fields__})


def _dense_params(seed=0):
    rng = _rng(seed)
    d, f, dh = SPEC.n_embd, SPEC.n_ff, SPEC.head_dim
    w = lambda *s: (rng.randn(*s) * 0.08).astype(np.float32)  # noqa: E731
    layers = [
        dict(ln1_g=1 + w(d), wq=w(d, SPEC.n_head * dh), wk=w(d, SPEC.kv_heads * dh),
             wv=w(d, SPEC.kv_heads * dh), wo=w(SPEC.n_head * dh, d), ln2_g=1 + w(d),
             w_gate=w(d, f), w_up=w(d, f), w_down=w(f, d))
        for _ in range(SPEC.n_layer)
    ]
    return dict(wte=w(SPEC.n_vocab, d), ln_f_g=1 + w(d), lm_head=w(d, SPEC.n_vocab),
                layers=layers)


def _torch_params(p):
    return {k: ([{lk: torch.from_numpy(lv) for lk, lv in l.items()} for l in v]
                if k == "layers" else torch.from_numpy(v)) for k, v in p.items()}


def test_project_qkv_dense():
    p = _dense_params(1)["layers"][0]
    x = _rng(4).randn(1, 6, 64).astype(np.float32)
    pos = np.arange(3, 9)
    ja = jrope.rope_angles(jnp.asarray(pos), 16, 16, 10000.0, 1.0)
    ta = trope.rope_angles(torch.from_numpy(pos), 16, 16, 10000.0, 1.0)
    j = jfwd.project_qkv(_jspec(), {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), ja)
    t = tfwd.project_qkv(SPEC, {k: torch.from_numpy(v) for k, v in p.items()},
                         torch.from_numpy(x), ta)
    for a, b in zip(t, j):
        _close(a, b, 1e-4)


@pytest.mark.parametrize("t,n_past,window", [(8, 0, 256), (1, 20, 256), (256, 0, 512)])
def test_attention_dense(t, n_past, window):
    """One layer's attention with its cache write; t=256 over n_ctx 1024
    takes the chunked online-softmax path in both packages."""
    p = _dense_params(2)["layers"][0]
    x = _rng(5).randn(1, t, 64).astype(np.float32)
    pos = np.arange(n_past, n_past + t)
    ja = jrope.rope_angles(jnp.asarray(pos), 16, 16, 10000.0, 1.0)
    ta = trope.rope_angles(torch.from_numpy(pos), 16, 16, 10000.0, 1.0)
    kv_np = _rng(6).randn(2, 1, 1024, 2, 16).astype(np.float32)
    kv_np[:, :, n_past:] = 0
    jkv = jfwd.KVCache(jnp.asarray(kv_np), jnp.asarray(kv_np))
    tkv = tfwd.KVCache(torch.from_numpy(kv_np.copy()), torch.from_numpy(kv_np.copy()))
    assert tfwd._use_chunked_attention(SPEC, t) == jfwd._use_chunked_attention(_jspec(), t)
    jout, jkv = jfwd._attention(_jspec(), {k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(x), jnp.int32(n_past), jkv, 0, ja, window)
    tout = tfwd._attention(SPEC, {k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(x), n_past, tkv, 0, ta, window)
    _close(tout, jout, 1e-4)
    _close(tkv.k, jkv.k, 1e-4)
    _close(tkv.v, jkv.v, 1e-4)


def test_forward_dense_prefill_then_decode():
    p = _dense_params(3)
    jp = {k: ([{lk: jnp.asarray(lv) for lk, lv in l.items()} for l in v]
              if k == "layers" else jnp.asarray(v)) for k, v in p.items()}
    tp = _torch_params(p)
    jkv = jfwd.KVCache.create(_jspec(), 1)
    tkv = tfwd.KVCache.create(SPEC, 1, "cpu")
    toks = _rng(7).randint(0, 64, size=(1, 12))
    n_past = 0
    for chunk in (toks[:, :8], toks[:, 8:12], toks[:, 11:12]):
        w = tfwd.round_window(n_past + chunk.shape[1], SPEC.n_ctx)
        assert w == jfwd.round_window(n_past + chunk.shape[1], SPEC.n_ctx)
        jl, jh, jkv = jfwd.forward(_jspec(), jp, jnp.asarray(chunk), jnp.int32(n_past), jkv,
                                   attn_window=w)
        tl, th = tfwd.forward(SPEC, tp, torch.from_numpy(chunk), n_past, tkv, attn_window=w)
        _close(tl, jl, 1e-4)
        _close(th, jh, 1e-4)
        n_past += chunk.shape[1]


def test_engine_chunks_match_jax():
    from ctransformers_tpu.engine.engine import Engine as JEngine

    for n in (1, 7, 137, 300):
        assert Engine._chunks(n, 256) == JEngine._chunks(n, 256)


def test_gguf_writer_bytes_and_reader(tmp_path):
    rng = _rng(8)
    kv = {"general.architecture": "llama", "a.int": 7, "a.float": 0.5,
          "a.strs": ["x", "yy"], "a.arr": np.arange(5, dtype=np.int32)}
    w = rng.randn(4, 256).astype(np.float32)
    tensors = {
        "t.q4k": (tquants.GGMLType.Q4_K, (256, 4), bytes(tquants.quantize(w, tquants.GGMLType.Q4_K))),
        "t.f16": (tquants.GGMLType.F16, (3, 2), w[0, :6].astype("<f2").tobytes()),
    }
    jp, tp = str(tmp_path / "j.gguf"), str(tmp_path / "t.gguf")
    jgguf.write_gguf(jp, kv, tensors)
    tgguf.write_gguf(tp, kv, tensors)
    assert open(jp, "rb").read() == open(tp, "rb").read()
    jr, tr = jgguf.GGUFReader(jp), tgguf.GGUFReader(tp)
    assert jr.kv.keys() == tr.kv.keys()
    for name in tensors:
        np.testing.assert_array_equal(tr.tensor_f32(name), jr.tensor_f32(name))
    np.testing.assert_array_equal(tr.tensor_storage("t.f16"), jr.tensor_storage("t.f16"))


def test_q4k_codec_matches_jax():
    from ctransformers_tpu.formats import quants as jquants

    x = _rng(9).randn(8 * 256).astype(np.float32) * 0.3
    buf = tquants.quantize(x, tquants.GGMLType.Q4_K)
    np.testing.assert_array_equal(buf, jquants.quantize(x, jquants.GGMLType.Q4_K))
    np.testing.assert_array_equal(
        tquants.dequantize(buf, tquants.GGMLType.Q4_K, x.size),
        jquants.dequantize(buf, jquants.GGMLType.Q4_K, x.size),
    )
    for a, b in zip(tquants.decompose(buf, tquants.GGMLType.Q4_K, x.size),
                    jquants.decompose(buf, jquants.GGMLType.Q4_K, x.size)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(NotImplementedError):  # a type not yet ported
        tquants.dequantize(bytes(292), tquants.GGMLType.Q8_K, 256)


def test_loader_and_tokenizer_match_jax(tmp_path):
    path = str(tmp_path / "llama.gguf")
    build_llama_gguf(path)
    jb, tb = jload(path), tload(path)
    for f in jb.spec.__dataclass_fields__:
        assert getattr(tb.spec, f) == getattr(jb.spec, f), f
    for text in ("hello world", "the cat is a hat", "xyzzy", " leading space", "a\nb", ""):
        assert tb.tokenizer.tokenize(text, True) == jb.tokenizer.tokenize(text, True), text
    for tid in range(len(jb.vocab)):
        assert tb.vocab.detokenize(tid) == jb.vocab.detokenize(tid)
    np.testing.assert_array_equal(np.asarray(tb.params["layers"][1]["w_down"]),
                                  np.asarray(jb.params["layers"][1]["w_down"]))


@pytest.mark.parametrize("fn", ["sample_llama", "sample_gpt"])
@pytest.mark.parametrize("temperature,top_k,top_p", [(0.8, 40, 0.95), (0.0, 40, 0.95), (1.2, 0, 0.5)])
def test_samplers_match_seed_for_seed(fn, temperature, top_k, top_p):
    logits = _rng(10).randn(300).astype(np.float32) * 3
    for seed in range(5):
        kw = dict(top_k=top_k, top_p=top_p, temperature=temperature, repetition_penalty=1.1,
                  last_tokens=[3, 5, 3, 250], seed=seed)
        assert getattr(tsamp, fn)(logits, **kw) == getattr(jsamp, fn)(logits, **kw)
    np.testing.assert_array_equal(tsamp.rep_penalty_mask(20, [1, 2, 3, 2], 1.3, 2, 2),
                                  jsamp.rep_penalty_mask(20, [1, 2, 3, 2], 1.3, 2, 2))


@pytest.mark.parametrize("pieces,stops", [
    ([b"hel", b"lo wo", b"rld"], ["wor"]),
    ([b"\xe2\x82", b"\xac ok", b"!"], ["!"]),
    ([b"abc", b"def"], []),
])
def test_text_streamer_matches_jax(pieces, stops):
    js, ts = JStreamer(stops), TStreamer(stops)
    assert [ts.feed(p) for p in pieces] == [js.feed(p) for p in pieces]
    assert ts.flush() == js.flush() and ts.stopped == js.stopped


def test_no_cuda_build_on_import():
    """Importing the port builds nothing: kernels compile at first use on
    a CUDA tensor."""
    from ctransformers_tpu_torch.ops import qmm_kernels as K

    assert not K._LIBS
    assert os.path.isdir(K.CSRC)


@pytest.mark.parametrize("kind", ["Q5_K", "Q6_K"])
def test_kquant_codecs_match_jax(kind):
    """The Q5_K and Q6_K codecs of a llama K_M mix, bit for bit: quantize,
    dequantize, decompose and the factored scale planes."""
    from ctransformers_tpu.formats import quants as jquants

    x = _rng(12).randn(8 * 256).astype(np.float32) * 0.3
    jt, tt = jquants.GGMLType[kind], tquants.GGMLType[kind]
    buf = tquants.quantize(x, tt)
    np.testing.assert_array_equal(buf, jquants.quantize(x, jt))
    np.testing.assert_array_equal(tquants.dequantize(buf, tt, x.size),
                                  jquants.dequantize(buf, jt, x.size))
    pairs = list(zip(tquants.decompose(buf, tt, x.size), jquants.decompose(buf, jt, x.size)))
    pairs += zip(tquants.decompose_factors(buf, tt, x.size),
                 jquants.decompose_factors(buf, jt, x.size))
    for a, b in pairs:
        if b is None:  # Q6_K has no mins
            assert a is None
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
