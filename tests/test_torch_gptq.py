"""The port's GPTQ path against the JAX package on the CPU: the container
and tokenizer-model codecs, the GPTQ unpack and QTensor planes byte for
byte, the plain versions of the three GPTQ kernels against the Pallas
kernels they replace (interpret mode), and the slice as a whole on
checkpoint directories written by the port's own writer.
"""

import contextlib
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ctransformers_tpu as J
import ctransformers_tpu_torch as T
from ctransformers_tpu.engine import sampler as jsampler
from ctransformers_tpu.formats import gptq as jgq
from ctransformers_tpu.formats import safetensors as jst
from ctransformers_tpu.ops import qmatmul as jqm
from ctransformers_tpu.tokenizers import spm_model as jspm
from ctransformers_tpu_torch.engine import sampler as tsampler
from ctransformers_tpu_torch.formats import gptq as tgq
from ctransformers_tpu_torch.formats import safetensors as tst
from ctransformers_tpu_torch.models.convert import convert_qtensor
from ctransformers_tpu_torch.models.synthetic import spm_vocab, write_llama_gptq
from ctransformers_tpu_torch.ops import qmatmul as tqm
from ctransformers_tpu_torch.ops import qmm_kernels as K
from ctransformers_tpu_torch.tokenizers import spm_model as tspm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLANES = ("qs", "scales", "mins", "perm")
# one matmul call of the port against the Pallas kernel of the same mode on
# the same operands: same algorithm and roundings, f32 sums in another order
CALL_TOL = 1e-4


@pytest.fixture(autouse=True)
def adjk(monkeypatch):
    """The JAX package packs nibbles as the port does (its layout on a
    backend with the int4 bitcast)."""
    monkeypatch.setenv("CT_PACK4_LAYOUT", "adjk")


def _fro(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _pack_qweight(q):  # (K, N) ints [0, 15] -> (K/8, N) int32
    out = np.zeros((q.shape[0] // 8, q.shape[1]), np.uint32)
    for j in range(8):
        out |= q[j::8].astype(np.uint32) << (4 * j)
    return out.view(np.int32)


def _pack_qzeros(z):  # (G, N) zero-points -> (G, N/8) int32, stored minus one
    zm1 = (z.astype(np.int64) - 1).astype(np.uint32) & 0xF
    out = np.zeros((z.shape[0], z.shape[1] // 8), np.uint32)
    for j in range(8):
        out |= zm1[:, j::8] << (4 * j)
    return out.view(np.int32)


def _random_gptq(seed, k, n, group, act_order):
    """A random GPTQ-for-LLaMa tensor (qweight, qzeros, f16 scales, g_idx)."""
    rng = np.random.RandomState(seed)
    q = rng.randint(0, 16, size=(k, n)).astype(np.uint8)
    z = rng.randint(0, 16, size=(k // group, n)).astype(np.uint8)
    s = (rng.rand(k // group, n).astype(np.float32) * 0.02 + 0.005).astype(np.float16)
    g_idx = np.arange(k) // group
    if act_order:
        g_idx = rng.permutation(g_idx)
    return _pack_qweight(q), _pack_qzeros(z), s, g_idx.astype(np.int32)


def _both(seed, k, n, group, act_order):
    """The same GPTQ tensor as the JAX package's QTensor and the port's."""
    qw, qz, s, g_idx = _random_gptq(seed, k, n, group, act_order)
    return jgq.gptq_to_qtensor(qw, qz, s, g_idx), tgq.gptq_to_qtensor(qw, qz, s, g_idx)


def _assert_planes_equal(jq, tq):
    for f in PLANES:
        a, b = getattr(jq, f), getattr(tq, f)
        if a is None or b is None:
            assert a is None and b is None, f
            continue
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, (f, a.dtype, b.dtype)
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8), err_msg=f)
    assert tq.sd is None and tq.sm is None and jq.sd is None and jq.sm is None
    assert (tq.kind, tq.group, tq.shape, tq.packed, tq.zp, tq.sfactor, tq.pack_layout) == (
        jq.kind, jq.group, jq.shape, jq.packed, jq.zp, jq.sfactor, jq.pack_layout
    )


# -- containers ----------------------------------------------------------------


def test_safetensors_matches_jax(tmp_path):
    rng = np.random.RandomState(0)
    tensors = {
        "a": rng.randn(4, 8).astype(np.float32),
        "b": rng.randint(-5, 5, (3, 3)).astype(np.int32),
        "c": rng.randn(7).astype(np.float16),
        "d": rng.randint(0, 255, (2, 5)).astype(np.uint8),
    }
    ours, theirs, lazy = (str(tmp_path / f"{n}.safetensors") for n in ("t", "j", "l"))
    tst.write_safetensors(ours, tensors)
    jst.write_safetensors(theirs, tensors)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    # a lazy (dtype, shape, make) entry writes the same bytes
    tst.write_safetensors(lazy, {k: (v.dtype, v.shape, lambda v=v: v) for k, v in tensors.items()})
    assert open(lazy, "rb").read() == open(ours, "rb").read()
    for path in (ours, theirs):
        tr, jr = tst.SafetensorsReader(path), jst.SafetensorsReader(path)
        assert tr.names() == jr.names() and "a" in tr and "zz" not in tr
        for name, arr in tensors.items():
            np.testing.assert_array_equal(tr.tensor(name), arr)
            np.testing.assert_array_equal(tr.tensor_f32(name), jr.tensor_f32(name))
            assert tr.shape(name) == arr.shape
    with pytest.raises(ValueError):
        tst.write_safetensors(lazy, {"a": (np.float32, (2,), lambda: np.zeros(3, np.float32))})


def test_spm_model_matches_jax(tmp_path):
    pieces, scores, types = spm_vocab(300)
    ours, theirs = str(tmp_path / "t.model"), str(tmp_path / "j.model")
    tspm.write_spm_model(ours, pieces, scores, types)
    jspm.write_spm_model(theirs, pieces, scores, types)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    got, want = tspm.parse_spm_model(theirs), jspm.parse_spm_model(ours)
    assert got[0] == want[0] == pieces and got[2] == want[2] == types
    np.testing.assert_array_equal(np.float32(got[1]), np.float32(scores))
    np.testing.assert_array_equal(np.float32(want[1]), np.float32(scores))


# -- unpack and planes -------------------------------------------------------


@pytest.mark.parametrize("act_order", [False, True])
@pytest.mark.parametrize("group", [32, 128])
def test_unpack_and_dequant_match_jax(group, act_order):
    qw, qz, s, g_idx = _random_gptq(1, 256, 128, group, act_order)
    np.testing.assert_array_equal(tgq.unpack_qweight(qw), jgq.unpack_qweight(qw))
    np.testing.assert_array_equal(tgq.unpack_qzeros(qz), jgq.unpack_qzeros(qz))
    # the stored-minus-one quirk: a stored nibble 15 is zero-point 0
    assert tgq.unpack_qzeros(np.array([[-1]], np.int32)).tolist() == [[0] * 8]
    dense = tgq.gptq_dequant(qw, qz, s, g_idx)
    np.testing.assert_array_equal(dense, jgq.gptq_dequant(qw, qz, s, g_idx))
    if not act_order:
        np.testing.assert_array_equal(dense, tgq.gptq_dequant(qw, qz, s))
    tq = tgq.gptq_to_qtensor(qw, qz, s, g_idx)
    np.testing.assert_allclose(tqm.dequantize_qtensor(tq).numpy(), dense, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("act_order", [False, True])
@pytest.mark.parametrize("k,n,group", [(256, 128, 32), (512, 384, 128), (256, 96, 64),
                                       (11008, 128, 128)])
def test_gptq_to_qtensor_planes_match_jax(k, n, group, act_order):
    """Planes and perm equal the JAX package's byte for byte, through the
    padding too (K 11008 -> 11264: 88 groups of 128, the last two zero)."""
    jq, tq = _both(k + n, k, n, group, act_order)
    _assert_planes_equal(jq, tq)
    assert (tq.perm is not None) == act_order and tq.group == group
    if k == 11008:
        assert tq.qs.shape == (11264 // 2, 128) and tq.scales.shape == (88, 128)
        # padding rows hold q = 0 (stored nibbles q - 8: bytes 0x88) under zero planes
        assert not tq.scales[86:].any() and not tq.mins[86:].any()
        assert (tq.qs[11008 // 2:] == -120).all()
    np.testing.assert_array_equal(
        tqm.dequantize_qtensor(tq).numpy(), np.asarray(jqm.dequantize_qtensor(jq))
    )
    K.check_gptq_qtensor(tq)


def test_gptq_rejects_ragged_groups():
    qw, qz, s, g_idx = _random_gptq(2, 256, 128, 32, True)
    g_idx = g_idx.copy()
    g_idx[g_idx == 1] = 0
    with pytest.raises(ValueError, match="not uniform"):
        tgq.gptq_to_qtensor(qw, qz, s, g_idx)


@pytest.mark.parametrize("layout", ["adjk", "ksplit"])
@pytest.mark.parametrize("act_order", [False, True])
def test_convert_qtensor_carries_gptq(layout, act_order, monkeypatch):
    """A JAX GPTQ4 QTensor (either nibble layout) converts to the planes the
    port's own gptq_to_qtensor makes under the same CT_PACK4_LAYOUT, perm
    and sfactor = 0 included, which its layout's kernels take."""
    monkeypatch.setenv("CT_PACK4_LAYOUT", layout)
    jq, tq = _both(5, 512, 256, 128, act_order)
    assert jq.pack_layout == layout
    got = convert_qtensor(jq)
    assert (got.kind, got.group, got.sfactor, got.packed, got.pack_layout, got.shape) == (
        "GPTQ4", 128, 0, True, layout, (512, 256))
    for f in PLANES + ("sd", "sm"):
        a, b = getattr(got, f), getattr(tq, f)
        assert (a is None and b is None) or (a.dtype == b.dtype and torch.equal(a, b)), f
    (K.check_ksplit_qtensor if layout == "ksplit" else K.check_gptq_qtensor)(got)


# -- plain versions against the Pallas kernels ---------------------------------


def _pallas(mode, x, jq, m):
    """The Pallas kernel of `mode` in interpret mode on x (already gathered
    for an act-order weight), zero-padded to 8 rows and the storage rows."""
    rows, npad = jq.qs.shape
    tk, tn, inner, _ = next(
        c for c in jqm._tile_candidates(rows, npad, jq.packed, jq.pack_layout)
        if c[3] == mode
    )
    # jnp throughout: the JAX package also calls this under a trace
    xp = jnp.pad(jnp.asarray(x, jnp.float32), ((0, max(8, m) - m), (0, 2 * rows - x.shape[1])))
    out = jqm._qmm_pallas_tiled(xp, jq, tk, tn, inner, interpret=True, mode=mode, rm=m)
    return out[:m, : jq.shape[1]]


def _port(mode, x, tq):
    xp = torch.zeros((x.shape[0], 2 * tq.qs.shape[0]))
    xp[:, : x.shape[1]] = torch.from_numpy(x)
    name = K.kernel_name(mode, tq)
    assert name == f"qmm_{mode}_gptq"
    fn = getattr(K, name)
    if name in K.PREQUANTIZED:
        out = fn(*K.quantize_activations(xp, tq.group), tq)
    else:
        out = fn(xp, tq)
    return out[:, : tq.shape[1]].numpy()


@pytest.mark.parametrize("mode", ["qx", "q", "i", "g", "si"])
@pytest.mark.parametrize("group", [32, 64, 128])
@pytest.mark.parametrize("m", [1, 3, 8, 64])
@pytest.mark.parametrize("k,n", [(512, 384), (256, 256)])
def test_gptq_plain_version_matches_pallas_kernel(mode, group, m, k, n):
    """plain_qx, plain_q, plain_i, plain_g and plain_si on GPTQ4 planes
    against the sfactor == 0 branches of _qmm_qx_kernel, _qmm_q_kernel,
    _qmm_i4_kernel, _qmm_g_kernel and _qmm_i4_s_kernel."""
    jq, tq = _both(7, k, n, group, False)
    x = (np.random.RandomState(m).randn(m, k) * 0.5).astype(np.float32)
    name = f"qmm_{mode}_gptq"
    before = dict(K.PLAIN_CALLS), dict(K.LAUNCHES)
    got = _port(mode, x, tq)
    assert K.PLAIN_CALLS[name] == before[0][name] + 1
    assert K.LAUNCHES == before[1]  # no kernel launch on a CPU tensor
    ref = np.asarray(_pallas(mode, x, jq, m))
    # same algorithm, same roundings: only the f32 summation order differs.
    # qx/q: the class of tests/test_gptq.py (2e-4), measured ~1e-7; i, si and
    # g: bf16 operands, 2.5% class, measured ~1e-5 or below
    err = _fro(got, ref)
    print(f"GPTQ4 g{group} {mode} m={m} K={k} N={n}: vs Pallas {err:.2e}")
    assert err <= (2e-4 if "q" in mode else 0.025)
    assert err <= CALL_TOL
    # error classes of tests/test_qmatmul.py against the exact f32 product:
    # int8 activations (q, qx) 3.5%, bf16 operands (i, si, g) 2.5%
    exact = np.asarray(jqm._qmm_jnp(x, jq))
    bound = 0.035 if "q" in mode else 0.025
    assert _fro(got, exact) < bound
    assert _fro(ref, exact) < bound


@pytest.mark.parametrize("group", [32, 128])
def test_qmatmul_with_perm_matches_dense(group):
    """qmatmul gathers x by the act-order perm before the kernel. The
    activations are integers with 127 in every group, so that their int8
    quantization is exact (sx = 1) and the product can be held to the 2e-3
    of tests/test_gptq.py against x @ gptq_dequant; a random x is held to
    the int8 class, and to the Pallas kernel on the gathered x."""
    k, n = 256, 128
    qw, qz, s, g_idx = _random_gptq(1, k, n, group, True)
    dense = tgq.gptq_dequant(qw, qz, s, g_idx)
    jq, tq = jgq.gptq_to_qtensor(qw, qz, s, g_idx), tgq.gptq_to_qtensor(qw, qz, s, g_idx)
    assert tq.perm is not None
    rng = np.random.RandomState(0)
    x = rng.randint(-127, 128, (3, k)).astype(np.float32)
    # 127 at the first sorted row of every group, wherever the perm put it
    x[:, np.asarray(tq.perm)[::group]] = 127.0
    out = tqm.qmatmul(torch.from_numpy(x), tq).numpy()
    np.testing.assert_allclose(out, x @ dense, atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(np.asarray(jqm.qmatmul(x, jq)), x @ dense, atol=2e-3, rtol=2e-3)
    for m in (1, 3, 40):  # qx, q, i
        xr = rng.randn(m, k).astype(np.float32)
        got = tqm.qmatmul(torch.from_numpy(xr), tq).numpy()
        assert _fro(got, xr @ dense) < 0.035
        mode = tqm.select_mode(m, tq)
        ref = np.asarray(_pallas(mode, xr[:, np.asarray(tq.perm)], jq, m))
        assert _fro(got, ref) <= CALL_TOL, mode


def test_gptq_wrappers_check_operands():
    _, tq = _both(1, 256, 128, 128, False)
    with pytest.raises(ValueError):
        K.qmm_qx_gptq(torch.zeros(1, 255), tq)  # not the padded K
    with pytest.raises(ValueError):
        K.qmm_i_gptq(torch.zeros(2, 256, dtype=torch.float64), tq)
    with pytest.raises(ValueError):  # sx per group of 32, weight group 128
        K.qmm_q_gptq(*K.quantize_activations(torch.zeros(2, 256), 32), tq)
    with pytest.raises(ValueError):  # int8 planes where f32 ones belong
        K.qmm_qx_gptq(torch.zeros(1, 256), dataclasses.replace(tq, scales=tq.scales.to(torch.int8)))
    with pytest.raises(NotImplementedError):  # a group no kernel is built for
        K.qmm_qx_gptq(torch.zeros(1, 256), dataclasses.replace(tq, group=256))
    with pytest.raises(NotImplementedError):  # the Q4_K wrapper refuses GPTQ planes
        K.qmm_qx(torch.zeros(1, 256), tq)
    with pytest.raises(NotImplementedError):  # GPTQ4's "si" is qmm_si_gptq
        K.qmm_si(torch.zeros(64, 256), tq)


# -- the sampler -----------------------------------------------------------------


def test_sample_llama_decayed_matches_jax():
    rng = np.random.RandomState(4)
    for seed in range(40):
        logits = (rng.randn(97) * 3).astype(np.float32)
        last = [int(t) for t in rng.randint(0, 97, rng.randint(0, 30))]
        kw = dict(
            top_k=int(rng.choice([0, 5, 40])), top_p=float(rng.choice([1.0, 0.9, 0.5])),
            temperature=float(rng.choice([0.0, 0.7, 1.3])),
            repetition_penalty=float(rng.choice([1.0, 1.1, 1.5])), last_tokens=last,
            seed=seed, sustain=int(rng.choice([0, 4, 16])), decay=int(rng.choice([0, 2, 8])),
        )
        assert tsampler.sample_llama_decayed(logits, **kw) == jsampler.sample_llama_decayed(
            logits, **kw), kw
        np.testing.assert_array_equal(
            tsampler.rep_penalty_mask(97, last, 1.3, kw["sustain"], kw["decay"]),
            jsampler.rep_penalty_mask(97, last, 1.3, kw["sustain"], kw["decay"]),
        )


# -- the slice as a whole ------------------------------------------------------

# (n_embd, n_ff, group): two widths, the smallest and the public group
TINY = {"d64-g32": dict(n_embd=64, n_ff=96, group=32),
        "d256-g128": dict(n_embd=256, n_ff=512, group=128)}


EXACT_CLASS = {"d64-g32": 0.05, "d256-g128": 0.10}


def _gptq_dir(tmp_path, size, act_order, seed=3):
    d = tmp_path / f"llama-{size}-gptq"
    write_llama_gptq(str(d), n_vocab=320, n_ctx=128, n_head=4, n_layer=2, seed=seed,
                     act_order=act_order, **TINY[size])
    return str(d)


def _as_jax(qt):
    arr = lambda t: None if t is None else jnp.asarray(t.numpy())  # noqa: E731
    return jqm.QTensor(arr(qt.qs), arr(qt.scales), arr(qt.mins), qt.kind, qt.group,
                       qt.shape, qt.packed, qt.zp, perm=arr(qt.perm), sfactor=qt.sfactor,
                       pack_layout=qt.pack_layout)


def _pallas_as_port(x, qt, compute_dtype=None, mode=None):
    """x @ qt through the Pallas kernel (interpret mode) of `mode`, by
    default the mode the port's select_mode picks, x already gathered; has
    the signature of the JAX package's exact _qmm_jnp, which it replaces in
    the tests below."""
    return _pallas(mode or tqm.select_mode(x.shape[0], qt), x, qt, x.shape[0])


def gptq_llm_matches_jax(tmp_path, size, act_order, monkeypatch):
    """A tiny GPTQ directory written by the port's writer through both
    packages' AutoModelForCausalLM ('gptq' in the name routes): the same
    greedy text and tokens, every matmul call of the port equal to the
    Pallas kernel of the picked mode on the same operands, and logits
    within the wiring class of the JAX package on its exact path and
    running those Pallas kernels (int8 and bf16 rounding of the activations
    amplify f32 differences, as for the k-quant mixes)."""
    from ctransformers_tpu_torch import gptq as tgptq
    from ctransformers_tpu_torch.models import forward

    path = _gptq_dir(tmp_path, size, act_order)
    jl = J.AutoModelForCausalLM.from_pretrained(path)
    tl = T.AutoModelForCausalLM.from_pretrained(path, device="cpu")
    assert isinstance(tl, tgptq.LLM) and tl.model_type == jl.model_type == "gptq"
    assert tl.context_length == jl.context_length == 128
    spec = tl._engine.spec
    assert (spec.rope_mode, spec.n_rot) == ("neox", spec.head_dim)
    layers = tl._engine.params["layers"]
    # desc_act=False fuses QKV and gate/up (4 calls a layer); perms stay apart (7)
    assert ("w_qkv" in layers[0]) == (not act_order) == ("w_gateup" in layers[0])
    assert layers[0]["wo"].group == TINY[size]["group"]
    assert (layers[0]["wo"].perm is not None) == act_order
    assert tl.tokenize("hello world") == jl.tokenize("hello world")
    text = jl("hello world", max_new_tokens=8, temperature=0.0)
    assert tl("hello world", max_new_tokens=8, temperature=0.0) == text

    worst = {}
    mm = forward.mm

    def held(x, w):
        out = mm(x, w)
        if isinstance(w, tqm.QTensor):
            xm = x.reshape(-1, w.shape[0]).numpy()
            if w.perm is not None:
                xm = xm[:, w.perm.numpy()]
            ref = np.asarray(_pallas_as_port(xm, _as_jax(w)))
            mode = tqm.select_mode(xm.shape[0], w)
            worst[mode] = max(worst.get(mode, 0.0), _fro(out.reshape(ref.shape), ref))
        return out

    def greedy_errs(jl):
        """Prompt (chunks 64 + 8 + 1) and three greedy steps on the JAX
        package's tokens; the port's greedy token is the JAX package's."""
        for llm in (jl, tl):
            llm.reset()
            llm.eval(toks)
        errs = [_fro(tl.logits, jl.logits)]
        for _ in range(3):
            nxt = int(np.argmax(jl.logits))
            assert int(np.argmax(tl.logits)) == nxt
            jl.eval([nxt])
            tl.eval([nxt])
            errs.append(_fro(tl.logits, jl.logits))
        return errs

    monkeypatch.setattr(forward, "mm", held)
    toks = [1] + [int(t) for t in np.random.RandomState(1).randint(3, jl.vocab_size, 72)]
    K.reset_counts()
    with pytest.warns(UserWarning):
        exact = greedy_errs(jl)
    gptq_kernels = {"qmm_qx_gptq", "qmm_q_gptq", "qmm_i_gptq"}
    assert {k for k, v in K.PLAIN_CALLS.items() if v} == gptq_kernels, K.PLAIN_CALLS
    per_layer = 7 if act_order else 4
    assert K.PLAIN_CALLS == dict(dict.fromkeys(K.PLAIN_CALLS, 0), qmm_i_gptq=2 * per_layer,
                                 qmm_q_gptq=2 * per_layer, qmm_qx_gptq=2 * per_layer * 4)
    assert sum(K.LAUNCHES.values()) == 0
    print(f"{size} act_order={act_order}: each matmul call vs the Pallas kernel, worst {worst}")
    assert set(worst) == {"qx", "q", "i"} and max(worst.values()) <= CALL_TOL, worst

    monkeypatch.setattr(forward, "mm", mm)
    monkeypatch.setattr(jqm, "_qmm_jnp", _pallas_as_port)
    # eagerly for the unfused 256-wide act-order weights: compiled as one
    # program, XLA's CPU backend refuses the bf16 dot of the interpreted "i"
    # kernel at their shapes
    refused = act_order and size == "d256-g128"
    eager = jax.disable_jit() if refused else contextlib.nullcontext()
    with pytest.warns(UserWarning), eager:
        same = greedy_errs(J.AutoModelForCausalLM.from_pretrained(path))
    print(f"{size} act_order={act_order}: logits rel err vs the JAX package, exact {exact}, "
          f"same kernels {same}")
    # against the same kernels the logits stay in the 5% wiring class
    # (measured up to 1.1%). Against the exact f32 path the int8 activations
    # count too: one absmax per group of 128 is a coarser grid than one per
    # 32, so the group-128 models take the 10% class that Q5_K_M has
    # (measured up to 5.7% on one decode step; 0.8-1.7% at group 32)
    assert max(same) < 0.05, same
    assert max(exact) < EXACT_CLASS[size], exact


# test_gptq_llm_matches_jax runs gptq_llm_matches_jax in files of its own
# (tests/test_torch_gptq_llm.py, tests/test_torch_gptq_llm_actorder.py), so
# that the test workers, which take a file each, share its minutes


def test_gptq_llm_uses_decayed_penalty(tmp_path):
    """gptq.LLM.sample routes through the decayed schedule: a token in the
    decay region (older than last_n_tokens but inside last_n + last_n // 2)
    still draws a partial penalty; the base constant-penalty chain never
    looks past last_n_tokens."""
    from ctransformers_tpu_torch import gptq

    llm = gptq.LLM(_gptq_dir(tmp_path, "d64-g32", False), device="cpu")
    llm.eval(llm.tokenize("he"))
    logits = np.asarray(llm.logits)
    best = int(np.argmax(logits))
    assert logits[best] > 0
    fill = int(np.argmin(logits))  # filler that can't win either way
    llm._context.extend([best] + [fill] * 4)
    kw = dict(temperature=0.0, repetition_penalty=1e6, last_n_tokens=4, top_k=0, top_p=1.0)
    assert llm.sample(**kw) != best
    base = tsampler.sample_llama(
        logits, top_k=0, top_p=1.0, temperature=0.0, repetition_penalty=1e6,
        last_tokens=llm._context[-4:], seed=0,
    )
    assert base == best
    # seed for seed with the JAX package's GPTQ sampler on the same state
    from ctransformers_tpu import gptq as jgptq

    jl = jgptq.LLM(llm.model_path)
    jl.eval(jl.tokenize("he"))
    jl._context.extend([best] + [fill] * 4)
    for seed in range(5):
        kw = dict(seed=seed, last_n_tokens=4, repetition_penalty=1.3)
        llm._engine.logits = np.asarray(jl.logits)  # the same logits to both
        assert llm.sample(**kw) == jl.sample(**kw)
    with pytest.raises(NotImplementedError):
        llm.sample(mirostat=2)


def test_gptq_routing(tmp_path):
    """'gptq' in the path, or model_type='gptq', routes to the GPTQ backend;
    unknown kwargs raise; a path that is no directory raises."""
    from ctransformers_tpu_torch import gptq

    path = _gptq_dir(tmp_path, "d64-g32", False)
    llm = T.AutoModelForCausalLM.from_pretrained(path, device="cpu", top_k=7)
    assert isinstance(llm, gptq.LLM) and llm.model_type == "gptq" and llm.config.top_k == 7
    plain = tmp_path / "checkpoint"
    os.rename(path, plain)
    llm = T.AutoModelForCausalLM.from_pretrained(str(plain), model_type="gptq", device="cpu")
    assert isinstance(llm, gptq.LLM)
    a = llm("he", max_new_tokens=4, seed=5)
    assert a == llm("he", max_new_tokens=4, seed=5)
    llm.eval(llm.tokenize("he"))
    assert llm.logits.shape == (320,)
    with pytest.raises(TypeError):
        T.AutoModelForCausalLM.from_pretrained(str(plain), model_type="gptq", device="cpu", nope=1)
    with pytest.raises(ValueError):
        T.AutoModelForCausalLM.from_pretrained("TheBloke/Llama-2-7B-GPTQ", device="cpu")
    with pytest.raises(ValueError, match="No .safetensors"):
        os.remove(plain / "model.safetensors")
        gptq.LLM(str(plain), device="cpu")


def test_gptq_entry_points_default_to_cuda(tmp_path, monkeypatch):
    from ctransformers_tpu_torch import gptq

    path = _gptq_dir(tmp_path, "d64-g32", False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.AutoModelForCausalLM.from_pretrained(path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gptq.LLM(path)


def test_fresh_process_serves_gptq_without_jax(tmp_path):
    path = _gptq_dir(tmp_path, "d64-g32", True)
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {ROOT!r})
        import ctransformers_tpu_torch as T
        llm = T.AutoModelForCausalLM.from_pretrained({path!r}, device="cpu")
        print(llm("hello", max_new_tokens=3, temperature=0.0))
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "ctransformers_tpu"))
        assert not bad, bad
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env=env, cwd=str(tmp_path), timeout=120)
    assert r.returncode == 0, r.stderr


# -- the writer ------------------------------------------------------------------


def test_write_llama_gptq_layout(tmp_path):
    """The directory is laid out as a GPTQ-for-LLaMa checkpoint: packed
    int32 words, f16 scales and dense tensors, g_idx trivial without
    act-order and a per-tensor permutation with it."""
    for act_order in (False, True):
        d = _gptq_dir(tmp_path / str(act_order), "d256-g128", act_order)
        assert sorted(os.listdir(d)) == ["config.json", "model.safetensors",
                                         "quantize_config.json", "tokenizer.model"]
        st = jst.SafetensorsReader(os.path.join(d, "model.safetensors"))
        p = "model.layers.1.mlp.down_proj"
        assert st.tensor(f"{p}.qweight").dtype == np.int32 and st.shape(f"{p}.qweight") == (64, 256)
        assert st.shape(f"{p}.qzeros") == (4, 32) and st.shape(f"{p}.scales") == (4, 256)
        assert st.tensor(f"{p}.scales").dtype == np.float16
        assert st.tensor("lm_head.weight").dtype == np.float16
        g_idx = st.tensor(f"{p}.g_idx")
        trivial = np.arange(512) // 128
        assert np.array_equal(g_idx, trivial) != act_order
        np.testing.assert_array_equal(np.sort(g_idx), trivial)
        other = st.tensor("model.layers.0.mlp.down_proj.g_idx")
        assert np.array_equal(other, g_idx) != act_order  # drawn per tensor


@pytest.mark.parametrize("n_ff,group", [(96, 64), (11008 // 16, 128)])
def test_write_llama_gptq_rejects_a_k_the_group_does_not_divide(tmp_path, n_ff, group):
    with pytest.raises(ValueError, match="multiple of the group"):
        write_llama_gptq(str(tmp_path / "g"), n_embd=128, n_head=4, n_ff=n_ff, group=group)
