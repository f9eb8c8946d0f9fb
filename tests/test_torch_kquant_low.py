"""The group-16 k-quants Q2_K and Q3_K in the port against the JAX package
on the CPU: codecs and repacked planes byte for byte, every candidate
kernel's plain version against the Pallas kernel of its mode (interpret
mode, as tests/test_qmatmul.py runs it), the llama.cpp mixes Q2_K and
Q3_K_S/M/L (types, file sizes, fusion), tiny llama files of those mixes
through from_pretrained, and the device-neutral knobs CT_ATTN,
CT_ATTN_CHUNK, CT_LOAD_THREADS and CT_NO_SFAC."""

import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ctransformers_tpu as J
import ctransformers_tpu_torch as T
from ctransformers_tpu.formats import quants as jquants
from ctransformers_tpu.formats.gguf import GGUFReader
from ctransformers_tpu.models import forward as jfwd
from ctransformers_tpu.models.llama_gguf import load_bundle as jload
from ctransformers_tpu.ops import qmatmul as jqm
from ctransformers_tpu_torch.formats import quants as tquants
from ctransformers_tpu_torch.models import forward as tfwd
from ctransformers_tpu_torch.models import synthetic
from ctransformers_tpu_torch.models.convert import from_jax_params
from ctransformers_tpu_torch.models.llama_gguf import load_bundle as tload
from ctransformers_tpu_torch.ops import qmatmul as tqm
from ctransformers_tpu_torch.ops import qmm_kernels as K

from .fixtures import build_llama_gguf
from .test_torch_legacy import _both, _fro, _greedy, _meta, _weights
from .test_torch_llm import _as_jax, _pallas_as_port, _rel

KINDS = ("Q2_K", "Q3_K")
LOW_MIXES = ("Q2_K", "Q3_K_S", "Q3_K_M", "Q3_K_L")
PLANES = ("qs", "scales", "mins", "sd", "sm")
K_IN, N_OUT = 512, 256
TINY = dict(n_vocab=512, n_ctx=128, n_embd=256, n_ff=512, n_layer=2)


def _same_bytes(a, b, what):
    """Equal dtype, shape and bytes (f16-derived planes of random blocks may
    hold NaNs, so values are compared as bytes)."""
    assert (a is None) == (b is None), what
    if a is None:
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8), err_msg=what)


@pytest.mark.parametrize("kind", KINDS)
def test_codecs_byte_equal_to_jax(kind):
    """quantize, dequantize, decompose and decompose_factors give the JAX
    package's bytes: on quantized weights with a flat superblock (d = 0)
    and a constant one, and on random block bytes."""
    x = _weights(1).reshape(-1)
    x[:256] = 0.0
    x[256:512] = 0.01
    jt, tt = jquants.GGMLType[kind], tquants.GGMLType[kind]
    buf = tquants.quantize(x, tt)
    np.testing.assert_array_equal(buf, jquants.quantize(x, jt))
    n = x.size
    _same_bytes(tquants.dequantize(buf, tt, n), jquants.dequantize(buf, jt, n), "dequantize")
    raw = np.random.RandomState(5).randint(0, 256, buf.size).astype(np.uint8)
    for data in (buf, raw):
        with np.errstate(invalid="ignore"):
            for f, (a, b) in enumerate(zip(tquants.decompose(data, tt, n),
                                           jquants.decompose(data, jt, n))):
                if isinstance(b, int):
                    assert a == b == 16
                else:
                    _same_bytes(a, b, f"decompose[{f}]")
            for f, (a, b) in enumerate(zip(tquants.decompose_factors(data, tt, n),
                                           jquants.decompose_factors(data, jt, n))):
                if isinstance(b, int):
                    assert a == b == 16
                else:
                    _same_bytes(a, b, f"decompose_factors[{f}]")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k,n", [(512, 256), (1280, 96)])
def test_repack_planes_byte_equal_to_jax(kind, k, n, monkeypatch):
    """adjk nibbles at the type's zero point (Q2_K: q - 8, Q3_K: q as it
    is), int8 sub-scales (and Q2_K's sub-mins) at group 16 over f32
    superblock factors (sfactor 16), padded as the JAX package pads them."""
    jq, tq = _both(kind, k + n, monkeypatch, k, n)
    for f in PLANES:
        b = getattr(tq, f)
        _same_bytes(None if b is None else b.numpy(), getattr(jq, f), f)
    assert (tq.kind, tq.group, tq.shape, tq.packed, tq.zp, tq.sfactor) == (
        jq.kind, jq.group, jq.shape, jq.packed, jq.zp, jq.sfactor)
    assert tq.zp == K.zero_point(kind) == {"Q2_K": 0, "Q3_K": 8}[kind]
    assert (tq.group, tq.sfactor, tq.packed) == (16, 16, True)
    np.testing.assert_array_equal(tqm.dequantize_qtensor(tq).numpy(),
                                  np.asarray(jqm.dequantize_qtensor(jq)))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mode", ("i", "si", "g", "q", "qx"))
def test_plain_versions_match_pallas_kernels(kind, mode, monkeypatch):
    """Each candidate's plain version against the Pallas kernel of its mode
    on the same planes, at each batch size where mode_candidates offers it:
    the same algorithm and roundings, only f32 sums in another order. Both
    also hold the error classes of tests/test_qmatmul.py against the exact
    product: 3.5% for the int8-activation modes, 2.5% for the bf16 ones."""
    jq, tq = _both(kind, 7, monkeypatch)
    name = f"qmm_{mode}_k16"
    assert K.kernel_name(mode, tq) == name
    sizes = [m for m in (1, 8, 64) if mode in dict(tqm.mode_candidates(tq, m))]
    assert sizes
    rows, npad = jq.qs.shape
    tk, tn, inner, _ = next(c for c in jqm._tile_candidates(rows, npad, jq.packed, jq.pack_layout)
                            if c[3] == mode)
    kp = rows * 2
    for m in sizes:
        x = (np.random.RandomState(m).randn(m, K_IN) * 0.5).astype(np.float32)
        xp = np.zeros((max(8, m), kp), np.float32)
        xp[:m, :K_IN] = x
        ref = np.asarray(jqm._qmm_pallas_tiled(jnp.asarray(xp), jq, tk, tn, inner,
                                               interpret=True, mode=mode, rm=m))
        xt = torch.from_numpy(xp[:m])
        before = dict(K.PLAIN_CALLS), dict(K.LAUNCHES)
        fn = getattr(K, name)
        args = K.quantize_activations(xt, tq.group) if name in K.PREQUANTIZED else (xt,)
        out = fn(*args, tq)
        assert K.PLAIN_CALLS[name] == before[0][name] + 1
        assert K.LAUNCHES == before[1]  # no kernel launch on a CPU tensor
        got, ref = out[:, :N_OUT].numpy(), ref[:m, :N_OUT]
        assert _fro(got, ref) <= 1e-4, (m, _fro(got, ref))
        exact = np.asarray(jqm._qmm_jnp(x, jq))
        bound = 0.035 if "q" in mode else 0.025
        assert _fro(got, exact) < bound and _fro(ref, exact) < bound, m


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k,n,big", [(4096, 4096, "i"), (4096, 22016, "si"), (11008, 4096, "i")])
def test_select_mode_and_candidates_keep_the_q4k_rules(kind, k, n, big):
    """Q4_K's fixed rule (qx at m = 1, q up to 32, si where N is more than
    twice K else i) and the nibble candidates, each served by a _k16
    wrapper in its launch configuration; the layouts differ from Q4_K's,
    GPTQ4's and Q6_K's keys."""
    qt = _meta(kind, *tqm.padded_shape(k, n))
    assert tuple(tqm.select_mode(m, qt) for m in (1, 8, 32, 128)) == ("qx", "q", "q", big)
    assert tuple(c[0] for c in tqm.mode_candidates(qt, 8)) == tqm._NIBBLE_MODES
    assert tuple(c[0] for c in tqm.mode_candidates(qt, 128)) == ("i", "si")
    for mode, config in tqm.mode_candidates(qt, 8) + tqm.mode_candidates(qt, 128):
        assert K.kernel_name(mode, qt) == f"qmm_{mode}_k16"
        assert config == K.CONFIG_OF[K.kernel_name(mode, qt)]
    others = {tqm.cache_key(1, _meta(o, *tqm.padded_shape(k, n))) for o in ("Q4_K", "Q2_K", "Q3_K")}
    assert len(others) == 3


def test_wrappers_take_only_their_layout(monkeypatch):
    """A Q2_K or Q3_K weight reaches only the _k16 kernels, and they take no
    other layout: anything else raises NotImplementedError."""
    _, q2 = _both("Q2_K", 3, monkeypatch)
    _, q3 = _both("Q3_K", 3, monkeypatch)
    _, q4 = _both("Q4_K", 3, monkeypatch)
    x = torch.zeros(2, q2.qs.shape[0] * 2)
    for name, qt in (("qmm_qx", q2), ("qmm_si", q3), ("qmm_g_q4_0", q3), ("qmm_i_gptq", q2),
                     ("qmm_qx_k16", q4), ("qmm_g_k16", q4)):
        with pytest.raises(NotImplementedError):
            getattr(K, name)(x, qt)
    with pytest.raises(NotImplementedError):  # Q3_K planes at the wrong zero point
        K.qmm_qx_k16(x, dataclasses.replace(q3, zp=0))
    with pytest.raises(NotImplementedError):  # Q2_K planes without their mins
        K.qmm_g_k16(x, dataclasses.replace(q2, mins=None, sm=None))
    with pytest.raises(ValueError):  # sub-scales of another group
        K.qmm_i_k16(x, dataclasses.replace(q3, scales=q3.scales[::2].contiguous()))


def test_repack_refuses_ct_no_sfac(monkeypatch):
    """CT_NO_SFAC asks for unfactored k-quant planes, which no port kernel
    reads: repack raises NotImplementedError on every k-quant instead of
    ignoring the knob; a legacy type (unfactored anyway) loads as without
    it, as in the JAX package."""
    monkeypatch.setenv("CT_NO_SFAC", "1")
    for kind in ("Q2_K", "Q3_K", "Q4_K", "Q6_K"):
        buf = tquants.quantize(_weights(2).T.copy(), tquants.GGMLType[kind])
        with pytest.raises(NotImplementedError, match="CT_NO_SFAC"):
            tqm.repack(buf, tquants.GGMLType[kind], N_OUT, K_IN)
    jq, tq = _both("Q4_0", 2, monkeypatch)
    assert tq.sfactor == jq.sfactor == 0
    np.testing.assert_array_equal(tq.scales.numpy(), np.asarray(jq.scales))


# the card's sizes of TheBloke/Llama-2-7B-GGUF (GB) for each mix
CARD_GB = {"Q2_K": 2.83, "Q3_K_S": 2.95, "Q3_K_M": 3.30, "Q3_K_L": 3.60}


@pytest.mark.parametrize("mix", LOW_MIXES)
def test_mix_types_and_7b_size(mix):
    """llama.cpp's rule for the mix (attn_v, attn_output and ffn_down of
    LOW_K_MIXES, output Q6_K, token_embd and the rest the base type) gives
    a llama-2-7B file within 3% of the size the model card lists (a wrong
    tensor type moves it by 4% or more)."""
    base = synthetic.MIXES[mix]
    v, o, down = synthetic.LOW_K_MIXES[mix]
    want = {"token_embd.weight": base, "output.weight": tquants.GGMLType.Q6_K,
            "blk.3.attn_q.weight": base, "blk.3.attn_k.weight": base, "blk.3.attn_v.weight": v,
            "blk.3.attn_output.weight": o, "blk.3.ffn_gate.weight": base,
            "blk.3.ffn_up.weight": base, "blk.3.ffn_down.weight": down}
    for name, t in want.items():
        assert synthetic.mix_type(mix, name, 32, 4096) == t, name
    gb = synthetic.mix_nbytes(mix, **synthetic.LLAMA2_7B) / 1e9
    assert abs(gb / CARD_GB[mix] - 1) < 0.03, gb


@pytest.mark.parametrize("mix", LOW_MIXES)
def test_mix_files_fuse_as_jax(tmp_path, mix, monkeypatch):
    """A tiny file of each mix: the JAX loader reads the types the rule
    gave, and the port fuses QKV and gate/up where the JAX package does
    (QKV only where attn_v is the base type: Q3_K_S), byte for byte."""
    monkeypatch.setenv("CT_PACK4_LAYOUT", "adjk")
    path = str(tmp_path / f"{mix}.gguf")
    synthetic.write_llama_gguf(path, seed=2, mix=mix, **TINY)
    types = {n: t.type.name for n, t in GGUFReader(path).tensors.items() if "norm" not in n}
    for name, t in types.items():
        assert t == synthetic.mix_type(mix, name, 2, 512 if "ffn_down" in name else 256).name
    jp, tp = jload(path).params, tload(path).params
    for layer in (jp["layers"][1], tp["layers"][1]):
        assert jqm.fuse_layer_params({"layers": [layer]}) if layer is jp["layers"][1] else \
            tqm.fuse_layer_params({"layers": [layer]})
    jl, tl = jp["layers"][1], tp["layers"][1]
    assert set(jl) == set(tl) and ("w_qkv" in tl) == (mix == "Q3_K_S") and "w_gateup" in tl
    for name in tl:
        if isinstance(tl[name], tqm.QTensor):
            for f in PLANES:
                b = getattr(tl[name], f)
                _same_bytes(None if b is None else b.numpy(), getattr(jl[name], f), (name, f))


# the plain versions a tiny file's prompt (chunks 64 + 8 + 1) and decode run
# under the fixed rule: the group-16 nibbles at qx, q, and i or si (si on
# the fused gate/up, four times as wide as deep), the Q4_K attn_v /
# ffn_down likewise, and the Q6_K output at m = 1
_K16 = {"qmm_qx_k16", "qmm_q_k16", "qmm_i_k16", "qmm_si_k16"}
MIX_KERNELS = {
    "Q2_K": _K16 | {"qmm_qx", "qmm_q", "qmm_i", "qmm_q8"},
    "Q3_K_S": _K16 | {"qmm_q8"},
    "Q3_K_M": _K16 | {"qmm_qx", "qmm_q", "qmm_i", "qmm_q8"},
}
# logits of the port against the JAX package running the same Pallas
# kernels (each call agrees to <= 1e-4; int8 and bf16 rounding of the
# activations amplify the ~1e-7 differences of the other ops), and against
# its exact f32 path: the wiring class of the all-Q4_K test (a wrong bias
# fold or split reads 10-100%). Q2_K's 2-bit grid is stored uncentred (q in
# [0, 3] as w4 = q - 8, the bias folded apart), so the reference's int8
# activation rounding errs more, as on Q5_K and Q5_1 (ROADMAP, "Numerics
# properties"): 10% against the same kernels (measured 2.5-6.1%) and 20%
# against the exact path (7.4-16.2%), where a greedy step may rightly flip
# (seed 11, step 2: a 0.95% margin), so Q2_K's greedy tokens are held
# against the JAX package's kernels only. The exact-path class is a sanity
# bound, not the parity check: on chip_smoke.py's tiny Q2_K llama the
# fixed rule reads 11.8-32.6% from the exact path across seeds 1-16, and a
# Q2_K bias with its mins dropped or its sub-mins one group off reads
# 140-161% (scripts/torch_tiny_spread.py)
SAME_CLASS = {"Q2_K": 0.10, "Q3_K_S": 0.05, "Q3_K_M": 0.05}
EXACT_CLASS = {"Q2_K": 0.20, "Q3_K_S": 0.05, "Q3_K_M": 0.05}
# each file's seed: the first from 11 whose greedy path keeps every top-2
# margin of the JAX package's logits above 2.5% (chip_smoke.py's rule) in
# each run whose greedy tokens the test holds
SEEDS = {"Q2_K": 11, "Q3_K_S": 16, "Q3_K_M": 15}
MIN_MARGIN = 0.025


@pytest.mark.parametrize("mix", sorted(MIX_KERNELS))
def test_tiny_low_k_llama_matches_jax(tmp_path, mix, monkeypatch):
    """A tiny llama file of the mix through the JAX package's Engine and
    through the port's from_pretrained on the CPU: every matmul call of the
    port equals the JAX package's Pallas kernel of its mode on the same
    operands (<= 1e-4); with the JAX package running those kernels the
    greedy tokens are equal and the logits within SAME_CLASS; against its
    exact path the logits lie within EXACT_CLASS (and, for Q3_K, the greedy
    tokens are equal); every expected plain version ran and no kernel was
    launched."""
    from ctransformers_tpu_torch.models import forward

    monkeypatch.setenv("CT_PACK4_LAYOUT", "adjk")
    path = str(tmp_path / f"llama_{mix}.gguf")
    synthetic.write_llama_gguf(path, mix=mix, seed=SEEDS[mix], **TINY)
    tl = T.AutoModelForCausalLM.from_pretrained(path, device="cpu")
    worst = {}
    mm = forward.mm

    def held(x, w):
        out = mm(x, w)
        if isinstance(w, tqm.QTensor):
            xm = x.reshape(-1, w.shape[0]).numpy()
            ref = np.asarray(_pallas_as_port(xm, _as_jax(w)))
            key = K.kernel_name(tqm.select_mode(xm.shape[0], w), w)
            worst[key] = max(worst.get(key, 0.0), _rel(out.reshape(ref.shape), ref))
        return out

    monkeypatch.setattr(forward, "mm", held)
    toks = [1] + [int(t) for t in np.random.RandomState(1).randint(3, TINY["n_vocab"], 72)]
    K.reset_counts()
    exact = _greedy(J.AutoModelForCausalLM.from_pretrained(path), tl, toks)
    assert {k for k, v in K.PLAIN_CALLS.items() if v} == MIX_KERNELS[mix], K.PLAIN_CALLS
    assert sum(K.LAUNCHES.values()) == 0
    assert set(worst) == MIX_KERNELS[mix] and max(worst.values()) <= 1e-4, worst
    monkeypatch.setattr(forward, "mm", mm)
    monkeypatch.setattr(jqm, "_qmm_jnp", _pallas_as_port)
    tl.reset()
    same = _greedy(J.AutoModelForCausalLM.from_pretrained(path), tl, toks)
    print(f"{mix}: each matmul call vs the Pallas kernel of its mode, worst {worst}; logits "
          f"rel err, margins, same token: exact path {exact}, same kernels {same}")
    held_runs = [same] if mix == "Q2_K" else [same, exact]
    assert all(min(run[1]) > MIN_MARGIN and all(run[2]) for run in held_runs), held_runs
    assert max(same[0]) < SAME_CLASS[mix], same[0]
    assert max(exact[0]) < EXACT_CLASS[mix], exact[0]


@pytest.mark.parametrize("kind", KINDS)
def test_from_jax_params_carries_low_k_planes(kind, monkeypatch):
    """The JAX package's ksplit planes of a Q2_K or Q3_K weight (what it
    packs on a host without the TPU int4 bitcast), carried across with
    from_jax_params: the port's own adjk planes byte for byte."""
    monkeypatch.setenv("CT_PACK4_LAYOUT", "ksplit")
    buf = tquants.quantize(np.ascontiguousarray(_weights(4).T), tquants.GGMLType[kind])
    jq = jqm.repack(buf, jquants.GGMLType[kind], N_OUT, K_IN)
    assert jq.pack_layout == "ksplit"
    got = from_jax_params({"w": jq})["w"]
    want = tqm.repack(buf, tquants.GGMLType[kind], N_OUT, K_IN)
    assert (got.kind, got.zp, got.sfactor, got.group) == (want.kind, want.zp, want.sfactor, 16)
    for f in PLANES:
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None and b is None) or torch.equal(a, b), f


@pytest.mark.parametrize("kind", KINDS)
def test_random_blocks_decode_in_their_ranges(kind):
    """The synthesized blocks of the 7B-width files are valid: Q2_K
    sub-scales and sub-mins in [0, 16), Q3_K sub-scales in [-32, 32), a
    finite positive d, and weights spread as a synthesized Q4_K block's."""
    rng = np.random.default_rng(0)
    t = tquants.GGMLType[kind]
    buf = synthetic.RANDOM_BLOCKS[t](rng, 64 * 256)
    sd, sq, sm, mq, group = tquants.decompose_factors(buf, t, buf.size // (
        tquants._TRAITS[t][1]) * 256)
    lo, hi = (0, 16) if kind == "Q2_K" else (-32, 32)
    assert group == 16 and sq.min() >= lo and sq.max() < hi
    assert (mq is None) == (kind == "Q3_K")
    if mq is not None:
        assert mq.min() >= 0 and mq.max() < 16 and (sm <= 0).all()
    assert np.isfinite(sd).all() and (sd > 0).all()
    w = tquants.dequantize(buf, t, 64 * 256).reshape(-1, 16)
    q4k = tquants.dequantize(synthetic.random_q4k_blocks(rng, 64 * 256), tquants.GGMLType.Q4_K,
                             64 * 256).reshape(-1, 32)
    ratio = w.std(axis=1).mean() / q4k.std(axis=1).mean()
    assert 0.5 < ratio < 2.0, ratio


# -- device-neutral knobs ----------------------------------------------------------


def _jax_params(params):
    return jax.tree_util.tree_map(jnp.asarray, params)


@pytest.mark.parametrize("env", [
    {"CT_ATTN": "full"},
    {"CT_ATTN": "chunked", "CT_ATTN_CHUNK": "32"},
    {"CT_ATTN": "chunked", "CT_ATTN_CHUNK": "64"},
])
def test_attention_knobs_match_jax(tmp_path, monkeypatch, env):
    """CT_ATTN forces the full or the chunked attention for every chunk and
    CT_ATTN_CHUNK sets the chunk, read at call time as the JAX package
    reads them: on the fixture llama, a prompt (chunks 32 + 8), a short
    chunk and decode steps give the JAX forward's logits and cache under
    the same settings."""
    path = str(tmp_path / "llama.gguf")
    build_llama_gguf(path, n_ctx=128, seed=11)
    jb, tb = jload(path), tload(path)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    chunked = env["CT_ATTN"] == "chunked"
    for t in (1, 8, 32):
        assert tfwd._use_chunked_attention(tb.spec, t) == chunked
        assert jfwd._use_chunked_attention(jb.spec, t) == chunked
    assert tfwd.attn_chunk() == jfwd._attn_chunk() == int(env.get("CT_ATTN_CHUNK", 512))
    jp, tp = _jax_params(jb.params), from_jax_params(tb.params)
    jkv = jfwd.KVCache.create(jb.spec, 1)
    tkv = tfwd.KVCache.create(tb.spec, 1, "cpu")
    toks = np.random.RandomState(3).randint(3, tb.spec.n_vocab, size=(1, 44))
    n_past = 0
    for t in (32, 8, 1, 1, 1, 1):
        chunk = toks[:, n_past:n_past + t]
        w = tfwd.round_window(n_past + t, tb.spec.n_ctx)
        jl, _, jkv = jfwd.forward(jb.spec, jp, jnp.asarray(chunk), jnp.int32(n_past), jkv,
                                  attn_window=w)
        tl, _ = tfwd.forward(tb.spec, tp, torch.from_numpy(chunk), n_past, tkv, attn_window=w)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
        n_past += t
    np.testing.assert_allclose(tkv.k.numpy(), np.asarray(jkv.k), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("threads", [None, "1", "3"])
def test_load_threads_knob_as_jax(tmp_path, monkeypatch, threads):
    """CT_LOAD_THREADS sets the loader's thread pool as in the JAX package
    (int(env) or min(8, cpu_count); one thread: no pool), and the loaded
    planes are the same at every setting."""
    path = str(tmp_path / "llama.gguf")
    synthetic.write_llama_gguf(path, seed=1, mix="Q3_K_M", n_vocab=512, n_ctx=64, n_embd=256,
                               n_ff=512, n_layer=2)
    if threads is not None:
        monkeypatch.setenv("CT_LOAD_THREADS", threads)
    pools = []
    real = concurrent.futures.ThreadPoolExecutor

    class Spy(real):
        def __init__(self, n=None, *a, **kw):
            pools.append(n)
            super().__init__(n, *a, **kw)

    monkeypatch.setattr(concurrent.futures, "ThreadPoolExecutor", Spy)
    jb = jload(path)
    jpools, pools[:] = list(pools), []
    tb = tload(path)
    assert pools == jpools
    if threads == "3":
        assert pools == [3]
    if threads == "1":
        assert pools == []
    monkeypatch.undo()
    ref = tload(path).params["layers"][1]["wq"]
    got = tb.params["layers"][1]["wq"]
    assert all(torch.equal(getattr(got, f), getattr(ref, f)) for f in ("qs", "scales", "sd"))
    assert jb.params["layers"][1]["wq"].kind == got.kind == "Q3_K"
