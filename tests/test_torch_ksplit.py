"""The K-split nibble layout (CT_PACK4_LAYOUT=ksplit) in the port against the
JAX package on the CPU: the ksplit planes of every nibble kind byte for
byte, unpacking, from_jax_params carrying them, each ksplit and
reshape-broadcast plain version against the Pallas kernel it replaces
(interpret mode, as tests/test_qmatmul.py runs it), the layout checks and
kernel selection, and tiny ksplit llamas served through from_pretrained.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ctransformers_tpu_torch as T
from ctransformers_tpu.formats import gptq as jgq
from ctransformers_tpu.formats import quants as jquants
from ctransformers_tpu.ops import qmatmul as jqm
from ctransformers_tpu_torch.formats import gptq as tgq
from ctransformers_tpu_torch.formats import quants as tquants
from ctransformers_tpu_torch.models.convert import convert_qtensor, from_jax_params
from ctransformers_tpu_torch.ops import qmatmul as tqm
from ctransformers_tpu_torch.ops import qmm_kernels as K

from .test_torch_gptq import _random_gptq
from .test_torch_llm import _as_jax, _pallas_as_port, _rel

PLANES = ("qs", "scales", "mins", "sd", "sm")
NIBBLE_KINDS = ("Q4_0", "Q4_1", "Q4_K", "Q2_K", "Q3_K")
GRID_KINDS = ("Q6_K", "Q5_K", "Q8_0", "Q5_1")
# every (kind, mode) of the ksplit kernels and the wrapper serving it
KSPLIT_MODES = {"": "qmm_f_ks", "s": "qmm_s_ks", "b": "qmm_b_ks", "sb": "qmm_sb_ks",
                "r": "qmm_r_ks", "rb": "qmm_rb_ks"}
# the error classes of tests/test_qmatmul.py:147-185: the f32 modes' sums in
# another order, the bf16-operand modes' products rounded at the same places
F32_TOL = 2e-4
BF16_FRO = 0.025
# one matmul call against the Pallas kernel of its mode on the same operands
CALL_TOL = 1e-4
# tiny models' logits against the JAX package: the wiring class the port's
# tests hold the bf16-operand modes to (tests/test_torch_llm.py
# MIX_LOGIT_CLASS for Q4_K_M, tests/test_torch_table_models.py for GPTQ):
# "sb" rounds both operands to bf16 (2**-9 relative), which these random
# 2-layer models amplify to about 1%, while a wrong half, nibble or bias
# reads 10-100%
LOGIT_CLASS = 0.05


@pytest.fixture(autouse=True)
def ksplit(monkeypatch):
    """Both packages pack nibbles ksplit."""
    monkeypatch.setenv("CT_PACK4_LAYOUT", "ksplit")


def _weights(seed, k, n):
    return (np.random.RandomState(seed).randn(k, n) * 0.3).astype(np.float32)


def _both(kind, k, n, seed=0):
    """The same weight as the JAX package's QTensor and the port's, both
    packed under the environment's layout: GGML blocks of `kind`, or a
    GPTQ tensor ("GPTQ4/<group>")."""
    if kind.startswith("GPTQ4"):
        qw, qz, s, g_idx = _random_gptq(seed, k, n, int(kind.split("/")[1]), False)
        return jgq.gptq_to_qtensor(qw, qz, s, g_idx), tgq.gptq_to_qtensor(qw, qz, s, g_idx)
    buf = tquants.quantize(np.ascontiguousarray(_weights(seed, k, n).T), tquants.GGMLType[kind])
    return (jqm.repack(buf, jquants.GGMLType[kind], n, k),
            tqm.repack(buf, tquants.GGMLType[kind], n, k))


def _same_planes(jq, tq):
    for f in PLANES:
        a, b = getattr(jq, f), getattr(tq, f)
        assert (a is None) == (b is None), f
        if a is not None:
            a, b = np.asarray(a), b.numpy()
            assert a.dtype == b.dtype and a.shape == b.shape, (f, a.dtype, b.dtype)
            np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8), err_msg=f)
    assert (tq.kind, tq.group, tq.shape, tq.packed, tq.zp, tq.sfactor, tq.pack_layout) == (
        jq.kind, jq.group, jq.shape, jq.packed, jq.zp, jq.sfactor, jq.pack_layout)


# -- planes and unpacking ------------------------------------------------------


@pytest.mark.parametrize("kind", NIBBLE_KINDS + ("GPTQ4/32", "GPTQ4/128"))
@pytest.mark.parametrize("k,n", [(256, 384), (512, 96), (1280, 256)])
def test_ksplit_planes_byte_equal_to_jax(kind, k, n):
    """Every nibble kind packs ksplit as the JAX package does (uint8 bytes,
    rows paired on the padded K, the high nibble sign-biased), and unpacks
    and dequantizes to its grid and weights exactly."""
    jq, tq = _both(kind, k, n, seed=k + n)
    assert tq.pack_layout == "ksplit" and tq.qs.dtype == torch.uint8
    _same_planes(jq, tq)
    np.testing.assert_array_equal(tqm.unpack_grid(tq).numpy(), np.asarray(jqm.unpack_grid(jq)))
    np.testing.assert_array_equal(tqm.dequantize_qtensor(tq).numpy(),
                                  np.asarray(jqm.dequantize_qtensor(jq)))


def test_pack_layout_rule(monkeypatch):
    """CT_PACK4_LAYOUT names the layout when it names one; anything else,
    and no setting, gives adjk (the port's capability answer), where the
    JAX package falls back to ksplit on a CPU host. Grids are unaffected."""
    w = _weights(1, 256, 128)
    for env, want in (("ksplit", "ksplit"), ("adjk", "adjk"), ("int4", "adjk"), (None, "adjk")):
        if env is None:
            monkeypatch.delenv("CT_PACK4_LAYOUT")
        else:
            monkeypatch.setenv("CT_PACK4_LAYOUT", env)
        buf = tquants.quantize(np.ascontiguousarray(w.T), tquants.GGMLType.Q4_K)
        qt = tqm.repack(buf, tquants.GGMLType.Q4_K, 128, 256)
        assert qt.pack_layout == want and qt.qs.dtype == (
            torch.uint8 if want == "ksplit" else torch.int8), env
    q6 = tqm.repack(tquants.quantize(np.ascontiguousarray(w.T), tquants.GGMLType.Q6_K),
                    tquants.GGMLType.Q6_K, 128, 256)
    assert not q6.packed and q6.pack_layout == "adjk"


@pytest.mark.parametrize("kind", NIBBLE_KINDS + ("GPTQ4/128",))
def test_from_jax_params_carries_or_converts_the_layout(kind, monkeypatch):
    """pack_layout="ksplit" carries the JAX package's ksplit planes across
    byte for byte; "adjk" converts them to the port's adjk planes; None
    follows the port's rule (CT_PACK4_LAYOUT at conversion time), either way
    round."""
    jq, tq = _both(kind, 512, 256, seed=3)
    got = from_jax_params({"w": jq}, pack_layout="ksplit")["w"]
    _same_planes(jq, got)
    monkeypatch.setenv("CT_PACK4_LAYOUT", "adjk")
    jq_adjk, tq_adjk = _both(kind, 512, 256, seed=3)
    for conv in (convert_qtensor(jq, pack_layout="adjk"), convert_qtensor(jq)):
        assert conv.pack_layout == "adjk"
        for f in PLANES:
            a, b = getattr(conv, f), getattr(tq_adjk, f)
            assert (a is None and b is None) or (a.dtype == b.dtype and torch.equal(a, b)), f
    back = convert_qtensor(jq_adjk, pack_layout="ksplit")  # adjk -> ksplit
    for f in PLANES:
        a, b = getattr(back, f), getattr(tq, f)
        assert (a is None and b is None) or (a.dtype == b.dtype and torch.equal(a, b)), f


# -- plain versions against the Pallas kernels ---------------------------------


def _pallas(mode, x, jq, m):
    """The Pallas kernel of `mode` in interpret mode with the tile of the
    JAX list's "" candidate for "r" and "rb" (no list offers them), else of
    the mode's own candidate."""
    rows, npad = jq.qs.shape
    want = "" if mode in ("r", "rb") else mode
    tk, tn, inner, _ = next(
        c for c in jqm._tile_candidates(rows, npad, jq.packed, jq.pack_layout) if c[3] == want)
    kp = rows * (2 if jq.packed else 1)
    xp = np.zeros((max(8, m), kp), np.float32)
    xp[:m, : x.shape[1]] = x
    out = jqm._qmm_pallas_tiled(jnp.asarray(xp), jq, tk, tn, inner, interpret=True, mode=mode,
                                rm=m)
    return np.asarray(out)[:m, : jq.shape[1]]


def _port(mode, x, tq):
    kp = tq.qs.shape[0] * (2 if tq.packed else 1)
    xp = torch.zeros((x.shape[0], kp))
    xp[:, : x.shape[1]] = torch.from_numpy(x)
    return getattr(K, K.kernel_name(mode, tq))(xp, tq)[:, : tq.shape[1]].numpy()


def _check(mode, got, want):
    err = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    if mode.endswith("b"):
        assert err < BF16_FRO, (mode, err)
    else:
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL * np.abs(want).max())
    return err


@pytest.mark.parametrize("mode", sorted(KSPLIT_MODES))
@pytest.mark.parametrize("kind", NIBBLE_KINDS + ("GPTQ4/32", "GPTQ4/128"))
@pytest.mark.parametrize("k,n", [(256, 384), (1280, 256)])
def test_ksplit_plain_matches_pallas(kind, mode, k, n):
    """Each ksplit plain version against _qmm_pack4_kernel ("", "b"),
    _qmm_pack4_s_kernel ("s", "sb") or _qmm_pack4_rb_kernel ("r", "rb") at
    m = 3 and 40: at K_pad 256 a superblock spans both halves (the JAX
    package then runs on materialized f32 planes), at 2048 it does not;
    Q4_0 and Q3_K have a low-half bias and none in the high half."""
    jq, tq = _both(kind, k, n, seed=k + n + 1)
    assert K.kernel_name(mode, tq) == KSPLIT_MODES[mode]
    for m in (3, 40):
        x = np.random.RandomState(m).randn(m, k).astype(np.float32)
        _check(mode, _port(mode, x, tq), _pallas(mode, x, jq, m))


@pytest.mark.parametrize("mode", ["r", "rb"])
@pytest.mark.parametrize("kind", GRID_KINDS)
def test_rb_grid_plain_matches_pallas(kind, mode):
    """qmm_r8 / qmm_rb8 (and their _legacy forms) against _qmm_rb_kernel in
    modes "r" and "rb", factored (Q6_K, Q5_K) and plain (Q8_0, Q5_1) planes,
    with and without mins; at m 1 and 8 (the card's K split times these),
    3, 33 (the GEMM core's first ragged m) and 40."""
    jq, tq = _both(kind, 512, 256, seed=7)
    name = K.kernel_name(mode, tq)
    assert name == {"r": "qmm_r8", "rb": "qmm_rb8"}[mode] + ("_legacy" if kind in ("Q8_0", "Q5_1")
                                                             else "")
    for m in (3, 40, 1, 8, 33):
        x = np.random.RandomState(m).randn(m, 512).astype(np.float32)
        _check(mode, _port(mode, x, tq), _pallas(mode, x, jq, m))


@pytest.mark.parametrize("kind", GRID_KINDS + ("Q5_0",))
def test_rb_grid_names_and_entries_stay(kind, tmp_path, monkeypatch):
    """Mode "rb" on an int8 grid is qmm_rb8 (qmm_rb8_legacy on the plain
    planes): the K split at m <= 32 and the GEMM core above, one name and
    config for both. rb_mode_entries still sends the grid's keys to "r" at
    m <= 32 and "rb" above; a user's table naming "rb" at m = 8 serves
    through the wrapper (its plain version here), as it does at 128."""
    _, tq = _both(kind, 512, 256, seed=3)
    name = "qmm_rb8" + ("_legacy" if tq.sfactor == 0 else "")
    assert K.kernel_name("rb", tq) == name and K.kernel_name("r", tq) == name.replace("rb8", "r8")
    assert name in K.SPLIT_KERNELS
    assert K.CONFIG_OF[name] == f"{K.SPLIT_CONFIG}|{K.WGMMA_CONFIG}"
    assert K.SOURCE_OF[name] == "ctransformers_tpu_torch/csrc/qmm_splitk.cuh"
    entries = tqm.rb_mode_entries([tq], (1, 8, 128))
    assert {m: entries[tqm.cache_key(m, tq)]["pick"] for m in (1, 8, 128)} == {
        1: ("r", K.R_CONFIG), 8: ("r", K.R_CONFIG), 128: ("rb", K.CONFIG_OF[name])}
    table = str(tmp_path / "rb.json")
    tqm.save_table(table, "cpu", {tqm.cache_key(m, tq): {"pick": ("rb", K.CONFIG_OF[name])}
                                  for m in (8, 128)})
    monkeypatch.setenv("CT_QMM_TILE_CACHE", table)
    monkeypatch.setenv("CT_QMM_AUTOTUNE", "precompiled")
    k, n = tq.shape
    for m in (8, 128):
        x = torch.from_numpy(np.random.RandomState(m).randn(m, k).astype(np.float32))
        before = K.PLAIN_CALLS[name]
        got = tqm.qmatmul(x, tq)
        assert K.PLAIN_CALLS[name] == before + 1 and got.shape == (m, n)


# -- layout checks and kernel selection ----------------------------------------


def test_layout_checks_keep_the_layouts_apart(monkeypatch):
    """The ksplit kernels refuse an adjk weight and the adjk kernels a
    ksplit one; the ksplit check refuses a wrong zero point, group or mins,
    and a mode the layout has no kernel for."""
    jq, ks = _both("Q4_K", 512, 256)
    _, q40 = _both("Q4_0", 512, 256)
    monkeypatch.setenv("CT_PACK4_LAYOUT", "adjk")
    _, adjk = _both("Q4_K", 512, 256)
    x = torch.randn(2, 512)
    assert K.check_ksplit_qtensor(ks) == (512, 256)
    with pytest.raises(NotImplementedError):
        K.qmm_f_ks(x, adjk)
    for name in ("qmm_qx", "qmm_i", "qmm_si", "qmm_g"):
        with pytest.raises(NotImplementedError):
            K.KERNELS[name](x, ks)
    for bad in (dict(zp=8), dict(group=16), dict(mins=None)):
        with pytest.raises(NotImplementedError):
            K.check_ksplit_qtensor(dataclasses.replace(ks, **bad))
    with pytest.raises(ValueError):
        K.check_ksplit_qtensor(dataclasses.replace(ks, qs=ks.qs.view(torch.int8)))
    for mode in ("g", "q", "qx", "i", "si"):
        with pytest.raises(ValueError, match="adjk"):
            K.kernel_name(mode, ks)
    assert K.check_ksplit_qtensor(q40) and q40.zp == 8
    with pytest.raises(NotImplementedError):
        K.check_ksplit_qtensor(dataclasses.replace(q40, zp=0))


@pytest.mark.parametrize("m", [1, 8, 32, 33, 128])
@pytest.mark.parametrize("kind", ["Q4_K", "Q3_K", "GPTQ4/128", "Q4_0"])
def test_ksplit_candidates_equal_the_jax_list(kind, m):
    """The ksplit mode axis of _tile_candidates in its order ("", s, b, sb;
    b and sb above m = 32), no grouped mode, sum-fold kept on every kind;
    the fixed rule takes its heuristic's last candidate, sb; every
    candidate names a ksplit kernel and its configuration."""
    _, tq = _both(kind, 512, 4096 if m > 8 else 256)
    rows, npad = tq.qs.shape
    want = []
    for c in jqm._tile_candidates(rows, npad, True, "ksplit", mp=jqm._round_up(m, 8)):
        if c[3] not in want:
            want.append(c[3])
    got = tqm.mode_candidates(tq, m)
    assert [mode for mode, _ in got] == want == (["", "s", "b", "sb"] if m <= 32 else ["b", "sb"])
    for mode, config in got:
        name = K.kernel_name(mode, tq)
        assert name.endswith("_ks") and config == K.CONFIG_OF[name]
    assert tqm.select_mode(m, tq) == "sb" == want[-1]
    assert tqm.cache_key(m, tq)[-1] == "ksplit"


def test_rb_mode_entries_name_r_and_rb(monkeypatch):
    """rb_mode_entries steers every ksplit and int8-grid key to "r" at
    m <= 32 and "rb" above, and leaves adjk nibble keys to the rule."""
    _, ks = _both("Q4_K", 512, 256)
    _, grid = _both("Q6_K", 512, 256)
    _, legacy = _both("Q8_0", 512, 256)
    monkeypatch.setenv("CT_PACK4_LAYOUT", "adjk")
    _, adjk = _both("Q4_K", 512, 256)
    entries = tqm.rb_mode_entries([ks, grid, legacy, adjk], (128, 8, 1))
    assert len(entries) == 9
    for w, names in ((ks, ("qmm_r_ks", "qmm_rb_ks")), (grid, ("qmm_r8", "qmm_rb8")),
                     (legacy, ("qmm_r8_legacy", "qmm_rb8_legacy"))):
        for m in (128, 8, 1):
            mode, config = entries[tqm.cache_key(m, w)]["pick"]
            assert K.kernel_name(mode, w) == names[m > 32] and config == K.CONFIG_OF[names[m > 32]]
    assert not any(tqm.cache_key(m, adjk) in entries for m in (128, 8, 1))
    modes = {m: tqm.float_mode_entries([ks], (128, 8, 1))[tqm.cache_key(m, ks)]["pick"][0]
             for m in (128, 8, 1)}
    assert modes == {128: "b", 8: "s", 1: ""}


# -- tiny models ---------------------------------------------------------------


# the plain versions a tiny ksplit Q4_K_M llama (Q4_K nibbles, Q6_K grids)
# runs over a 64 + 8 + 1 prompt and decode under the fixed rule
Q4KM_KERNELS = {"qmm_sb_ks", "qmm_q8", "qmm_b"}
# greedy steps after the prompt whose tokens the ksplit and adjk models must
# share; each seed is the first from 1 whose top-2 margins on the port's
# ksplit logits exceed the logit class at every step (checked below), so
# that no token may rightly flip between the two layouts
GREEDY_STEPS = 4
Q4KM_SEED = 5
GPTQ_SEED = 5


def _held(monkeypatch, worst):
    """Wrap forward.mm: each QTensor call is held against the JAX Pallas
    kernel of the mode the port picks, on the same operands."""
    from ctransformers_tpu_torch.models import forward

    mm = forward.mm

    def held(x, w):
        out = mm(x, w)
        if isinstance(w, tqm.QTensor):
            xm = x.reshape(-1, w.shape[0]).numpy()
            if w.perm is not None:
                xm = xm[:, w.perm.numpy()]
            ref = np.asarray(_pallas_as_port(xm, _as_jax(w)))
            mode = tqm.select_mode(xm.shape[0], w)
            worst[mode] = max(worst.get(mode, 0.0), _rel(out.reshape(ref.shape), ref))
        return out

    monkeypatch.setattr(forward, "mm", held)
    return mm


def _greedy_tokens(llm, toks, steps=GREEDY_STEPS):
    llm.reset()
    llm.eval(toks)
    out, margins = [], []
    for _ in range(steps + 1):
        a = np.sort(np.asarray(llm.logits, np.float64))[-2:]
        margins.append(float((a[1] - a[0]) / abs(a[1])))
        out.append(int(np.argmax(llm.logits)))
        llm.eval([out[-1]])
    return out, margins


def _adjk_tokens(path, toks, monkeypatch, **kw):
    monkeypatch.setenv("CT_PACK4_LAYOUT", "adjk")
    llm = T.AutoModelForCausalLM.from_pretrained(path, device="cpu", **kw)
    assert llm._engine.params["layers"][0]["wo"].pack_layout == "adjk"
    got = _greedy_tokens(llm, toks)
    monkeypatch.setenv("CT_PACK4_LAYOUT", "ksplit")
    return got


# the tiny ksplit llamas through from_pretrained are files of their own
# (tests/test_torch_ksplit_q4km_llm.py, tests/test_torch_ksplit_gptq_llm.py),
# so that the test workers, which take a file each, share their minutes
