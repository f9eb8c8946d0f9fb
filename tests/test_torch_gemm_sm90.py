"""The prompt GEMMs of the Hopper core (csrc/qmm_wgmma.cuh: qmm_b and qmm_sb
on Q6_K and Q5_K, qmm_b_legacy and qmm_sb_legacy on Q5_1, Q8_0 and Q5_0,
qmm_si and qmm_i on Q4_K, qmm_si_gptq and qmm_i_gptq on GPTQ4 at groups 32,
64 and 128 and on Q4_1, qmm_si_k16 and qmm_i_k16 on Q2_K and Q3_K,
qmm_si_q4_0 and qmm_i_q4_0 on Q4_0, qmm_sb_ks, qmm_b_ks and qmm_rb_ks on
the ksplit nibbles of every kind)
on the CPU: what the core makes of x
(bf16 rounding, group sums) against numpy, the plain versions at ragged m
against the Pallas kernels in interpret mode, the launch configuration the
candidate lists name, and tiny llamas of head width 80 with 16 query heads
over one kv head and of width 320 through the port against the JAX LLM
(every decode step through decode_attention's plain version). The kernels
themselves run in tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import ctransformers_tpu as J
import ctransformers_tpu_torch as T
from ctransformers_tpu.formats.quants import GGMLType
from ctransformers_tpu.ops import qmatmul as jqm
from ctransformers_tpu_torch.ops import attention as A
from ctransformers_tpu_torch.ops import qmatmul as tqm
from ctransformers_tpu_torch.ops import qmm_kernels as K

from . import test_torch_ksplit as TK
from .fixtures import build_llama_gguf
from .test_torch_qmatmul import _both, _fro, _pallas, _port


def _bf16_rne(a: np.ndarray) -> np.ndarray:
    """f32 -> bf16 -> f32, round to nearest even, in integer arithmetic."""
    u = a.astype(np.float32).view(np.uint32).astype(np.uint64)
    r = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return r.astype(np.uint32).view(np.float32)


@pytest.mark.parametrize("m,kp,group", [(1, 256, 32), (33, 512, 32), (100, 256, 16),
                                         (33, 512, 64), (100, 256, 128)])
def test_x_operands_match_numpy(m, kp, group):
    rng = np.random.default_rng(m)
    x = (rng.standard_normal((m, kp)) * 3).astype(np.float32)
    x[0, :4] = [1.00390625, 1.01171875, -2.00781250, 3.0e-39]  # ties to even, a subnormal
    xb, xs = K.x_operands(torch.from_numpy(x), group)
    assert xb.dtype == xs.dtype == torch.float32 and xs.shape == (m, kp // group)
    np.testing.assert_array_equal(xb.numpy().view(np.uint32), _bf16_rne(x).view(np.uint32))
    want = x.reshape(m, kp // group, group).astype(np.float64).sum(-1)
    # f32 sums of 16 to 128 values in some order: a few ulps of the largest term
    np.testing.assert_allclose(xs.numpy(), want, rtol=0, atol=1e-5 * np.abs(x).max())


# (weight type, port mode, Pallas mode): the core's instantiations; "ks:"
# the ksplit nibbles of a kind (qmm_sb_ks against _qmm_pack4_s_kernel,
# qmm_b_ks against _qmm_pack4_kernel mode "b" and qmm_rb_ks against
# _qmm_pack4_rb_kernel mode "rb": the core's ksplit tile without the fold);
# GPTQ4 and Q4_1 adjk nibbles (qmm_si_gptq against _qmm_i4_s_kernel,
# qmm_i_gptq against _qmm_i4_kernel); Q2_K and Q3_K adjk nibbles at group 16
# (qmm_si_k16 against _qmm_i4_s_kernel: Q2_K's bias folded four groups a
# stage, Q3_K without one; qmm_i_k16 against _qmm_i4_kernel: Q2_K's bias
# added to each weight); Q4_K adjk nibbles at group 32 with factored
# scales (qmm_si, its bias folded two groups a stage, and qmm_i); Q4_0 adjk
# nibbles with the plain s plane and no bias (qmm_i_q4_0 and qmm_si_q4_0,
# the reference's `b is None` branches)
CORE_CASES = [("Q6_K", "b", "b"), ("Q5_K", "b", "b"), ("Q8_0", "b", "b"), ("Q5_1", "b", "b"),
              ("Q5_1", "sb", "sb"), ("Q8_0", "sb", "sb"), ("Q5_0", "sb", "sb"),
              ("Q5_K", "sb", "sb"), ("Q6_K", "sb", "sb")] + [
    (kind, mode, mode) for mode in ("si", "i")
    for kind in ("GPTQ4/32", "GPTQ4/64", "GPTQ4/128", "Q4_1")] + [
    (kind, "si", "si") for kind in ("Q2_K", "Q3_K")] + [
    ("Q4_K", "si", "si"), ("Q4_K", "i", "i")] + [
    ("Q4_0", "i", "i"), ("Q4_0", "si", "si"), ("Q2_K", "i", "i"), ("Q3_K", "i", "i")] + [
    (f"ks:{kind}", "sb", "sb") for kind in ("Q4_K", "Q2_K", "Q3_K", "GPTQ4/128", "Q4_0")] + [
    (f"ks:{kind}", "b", "b") for kind in ("Q4_K", "Q2_K", "Q3_K", "GPTQ4/128", "Q4_0")] + [
    ("ks:Q4_K", "rb", "rb")]


@pytest.mark.parametrize("kind,mode,pallas_mode", CORE_CASES)
@pytest.mark.parametrize("m", [33, 100])
def test_core_plain_versions_match_pallas_at_ragged_m(kind, mode, pallas_mode, m, monkeypatch):
    """plain_b, plain_sb, plain_si, plain_i, plain_sb_ks and plain_b_ks (the
    functions of qmm_b, qmm_sb, qmm_b_legacy, qmm_sb_legacy, qmm_si, qmm_i,
    qmm_si_gptq, qmm_si_k16, qmm_i_k16, qmm_i_gptq, qmm_si_q4_0, qmm_i_q4_0,
    qmm_sb_ks, qmm_b_ks and qmm_rb_ks) at m that fill no 128-row tile,
    against _qmm_kernel, _qmm_s_kernel, _qmm_i4_s_kernel, _qmm_i4_kernel,
    _qmm_pack4_s_kernel, _qmm_pack4_kernel and _qmm_pack4_rb_kernel."""
    k, n = 256, 256
    x = (np.random.RandomState(m).randn(m, k) * 0.5).astype(np.float32)
    if kind.startswith("ks:"):
        monkeypatch.setenv("CT_PACK4_LAYOUT", "ksplit")
        jq, tq = TK._both(kind[3:], k, n, seed=5)
        port, pallas = TK._port, TK._pallas
    elif kind.startswith("GPTQ4"):
        monkeypatch.setenv("CT_PACK4_LAYOUT", "adjk")
        jq, tq = TK._both(kind, k, n, seed=5)
        port, pallas = _port, _pallas
    else:
        jq, tq = _both(k, n, seed=5, monkeypatch=monkeypatch, kind=kind)
        port, pallas = _port, _pallas
    name = K.kernel_name(mode, tq)
    assert name in K.WGMMA_KERNELS
    before = K.PLAIN_CALLS[name]
    got = port(mode, x, tq)
    assert K.PLAIN_CALLS[name] == before + 1
    ref = pallas(pallas_mode, x, jq, m)
    # same algorithm, same roundings: only the f32 summation order differs
    assert _fro(got, ref) <= 1e-4
    # the bf16-operand class of tests/test_qmatmul.py against the exact product
    exact = np.asarray(jqm._qmm_jnp(x, jq))
    assert _fro(got, exact) < 0.025 and _fro(ref, exact) < 0.025


def _real(kind, k=512, n=384):
    from ctransformers_tpu_torch.formats.quants import GGMLType as TG
    from ctransformers_tpu_torch.formats.quants import quantize as tquantize

    if kind.startswith("GPTQ4"):
        return TK._both(kind, k, n, seed=1)[1]
    w = (np.random.RandomState(1).randn(k, n) * 0.3).astype(np.float32)
    return tqm.repack(tquantize(np.ascontiguousarray(w.T), TG[kind]), TG[kind], n, k)


# qmm_sb_ks: the ksplit float design ("n32k512") at m <= 32, the core above
SB_KS_CONFIG = "n32k512|wg128n128c3"
# qmm_g8, qmm_f, qmm_q8 and qmm_q8_legacy: the K split ("n128k16r2c8") at
# m <= 32, the decode design ("n32k1024") above
GRID_SPLIT_CONFIG = "n128k16r2c8|n32k1024"
# the int8 grids' "rb" (qmm_rb8, qmm_rb8_legacy): the same split at m <= 32,
# the Hopper core above
RB8_CONFIG = "n128k16r2c8|wg128n128c3"
# qmm_qx and qmm_g on Q4_K: the nibble K split ("n128k32r2c8") at m <= 32,
# the decode design above
NIBBLE_SPLIT_CONFIG = "n128k32r2c8|n32k1024"
# qmm_f_ks and qmm_s_ks: the ksplit K split ("n128k16h2r2c8") at m <= 32,
# the ksplit float design above
KSPLIT_SPLIT_CONFIG = "n128k16h2r2c8|n32k512"
# the ksplit "b" and "rb" (qmm_b_ks, qmm_rb_ks): the same split at m <= 32,
# the Hopper core above
B_KS_CONFIG = "n128k16h2r2c8|wg128n128c3"


@pytest.mark.parametrize("kind,m,want", [
    ("Q6_K", 128, {"b": K.WGMMA_CONFIG}),
    ("Q6_K", 8, {"b": K.WGMMA_CONFIG, "g": GRID_SPLIT_CONFIG, "q8": GRID_SPLIT_CONFIG,
                 "": GRID_SPLIT_CONFIG}),
    ("Q5_K", 128, {"b": K.WGMMA_CONFIG, "sb": K.WGMMA_CONFIG}),
    ("Q4_K", 128, {"i": K.WGMMA_CONFIG, "si": K.WGMMA_CONFIG}),
    ("Q4_K", 8, {"g": NIBBLE_SPLIT_CONFIG, "qx": NIBBLE_SPLIT_CONFIG, "q": K.DECODE_CONFIG}),
    ("GPTQ4/128", 128, {"i": K.WGMMA_CONFIG, "si": K.WGMMA_CONFIG}),
    ("GPTQ4/32", 128, {"i": K.WGMMA_CONFIG, "si": K.WGMMA_CONFIG}),
    ("Q4_1", 128, {"i": K.WGMMA_CONFIG, "si": K.WGMMA_CONFIG}),
    # Q2_K, Q3_K and Q4_0: "si" and "i" on the core
    ("Q2_K", 128, {"i": K.WGMMA_CONFIG, "si": K.WGMMA_CONFIG}),
    ("Q3_K", 128, {"i": K.WGMMA_CONFIG, "si": K.WGMMA_CONFIG}),
    ("Q4_0", 128, {"i": K.WGMMA_CONFIG, "si": K.WGMMA_CONFIG}),
    ("Q5_1", 128, {"b": K.WGMMA_CONFIG, "sb": K.WGMMA_CONFIG}),
    ("Q8_0", 128, {"b": K.WGMMA_CONFIG}),
    ("ks:Q4_K", 128, {"b": B_KS_CONFIG, "sb": SB_KS_CONFIG}),
    ("ks:Q3_K", 8, {"": KSPLIT_SPLIT_CONFIG, "s": KSPLIT_SPLIT_CONFIG, "b": B_KS_CONFIG,
                    "sb": SB_KS_CONFIG}),
])
def test_candidates_name_the_core_config(kind, m, want, monkeypatch):
    if kind.startswith("ks:"):
        monkeypatch.setenv("CT_PACK4_LAYOUT", "ksplit")
        kind = kind[3:]
    qt = _real(kind)
    got = dict(tqm.mode_candidates(qt, m))
    assert {mode: got[mode] for mode in want} == want
    assert K.WGMMA_CONFIG == "wg128n128c3" and K.CONFIG_OF["qmm_b"] == K.WGMMA_CONFIG
    assert K.CONFIG_OF["qmm_sb_legacy"] == K.CONFIG_OF["qmm_b_legacy"] == K.WGMMA_CONFIG
    assert K.CONFIG_OF["qmm_sb"] == K.CONFIG_OF["qmm_si_gptq"] == K.WGMMA_CONFIG
    assert K.CONFIG_OF["qmm_i_gptq"] == K.CONFIG_OF["qmm_si_k16"] == K.WGMMA_CONFIG
    assert K.CONFIG_OF["qmm_si"] == K.CONFIG_OF["qmm_i"] == K.WGMMA_CONFIG
    assert K.CONFIG_OF["qmm_i_k16"] == K.WGMMA_CONFIG
    assert K.CONFIG_OF["qmm_i_q4_0"] == K.CONFIG_OF["qmm_si_q4_0"] == K.WGMMA_CONFIG
    assert K.CONFIG_OF["qmm_sb_ks"] == SB_KS_CONFIG
    for name in ("qmm_b", "qmm_sb", "qmm_b_legacy", "qmm_sb_legacy", "qmm_si", "qmm_i",
                 "qmm_si_gptq", "qmm_i_gptq", "qmm_si_k16", "qmm_i_k16", "qmm_i_q4_0",
                 "qmm_si_q4_0"):
        assert K.SOURCE_OF[name] == "ctransformers_tpu_torch/csrc/qmm_wgmma.cuh"
    assert K.SOURCE_OF["qmm_sb_ks"] == "ctransformers_tpu_torch/csrc/qmm_float.cu"
    # the ksplit "b" GEMMs: the split at m <= 32, the core above
    for name in ("qmm_b_ks", "qmm_rb_ks"):
        assert K.CONFIG_OF[name] == B_KS_CONFIG, name
        assert K.SOURCE_OF[name] == "ctransformers_tpu_torch/csrc/qmm_splitk.cuh", name


@pytest.mark.parametrize("name,kind,other", [("qmm_g8", "Q6_K", "Q4_K"), ("qmm_f", "Q5_K", "Q4_K"),
                                             ("qmm_qx", "Q4_K", "Q6_K"), ("qmm_g", "Q4_K", "Q5_K"),
                                             ("qmm_q8", "Q6_K", "Q4_K"), ("qmm_q8", "Q5_K", "Q4_K"),
                                             ("qmm_q8_legacy", "Q8_0", "Q6_K"),
                                             ("qmm_f_ks", "ks:Q4_K", "Q4_K"),
                                             ("qmm_f_ks", "ks:GPTQ4/128", "GPTQ4/128"),
                                             ("qmm_s_ks", "ks:Q4_K", "Q4_K"),
                                             ("qmm_s_ks", "ks:GPTQ4/128", "GPTQ4/128"),
                                             ("qmm_rb8", "Q6_K", "Q4_K"),
                                             ("qmm_rb8", "Q5_K", "Q4_K"),
                                             ("qmm_rb8_legacy", "Q8_0", "Q6_K"),
                                             ("qmm_b_ks", "ks:Q4_K", "Q4_K"),
                                             ("qmm_rb_ks", "ks:GPTQ4/128", "GPTQ4/128")])
def test_split_kernels_name_their_design(name, kind, other, monkeypatch):
    """The kernels that split K over a cluster at m <= 32 name
    csrc/qmm_splitk.cuh and their split configuration (the int8 grids'
    "rb" and the ksplit "b" and "rb" the Hopper core's above); the plan
    asks the card, so a weight on the CPU raises, as do another kind's
    weight (for a ksplit kernel the same kind packed adjk) and a kernel
    that the split does not serve."""
    assert name in K.SPLIT_KERNELS
    assert K.SOURCE_OF[name] == "ctransformers_tpu_torch/csrc/qmm_splitk.cuh"
    assert K.CONFIG_OF[name] == (B_KS_CONFIG if name in ("qmm_b_ks", "qmm_rb_ks") else
                                 KSPLIT_SPLIT_CONFIG if kind.startswith("ks:") else
                                 NIBBLE_SPLIT_CONFIG if kind == "Q4_K" else
                                 RB8_CONFIG if name.startswith("qmm_rb8") else GRID_SPLIT_CONFIG)
    monkeypatch.setenv("CT_PACK4_LAYOUT", "adjk")
    other = _real(other)
    if kind.startswith("ks:"):
        monkeypatch.setenv("CT_PACK4_LAYOUT", "ksplit")
        kind = kind[3:]
    qt = _real(kind)
    assert qt.pack_layout != other.pack_layout or qt.kind != other.kind
    with pytest.raises(ValueError, match="asks the card"):
        K.grid_split_plan(name, qt, 1)
    with pytest.raises(NotImplementedError):
        K.grid_split_plan(name, other, 1)
    with pytest.raises(ValueError, match="serves"):
        K.grid_split_plan("qmm_s", qt, 1)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# port against JAX with the same kv_dtype, as tests/test_torch_kv.py holds
# them: f32 1e-4; bf16 in the 5% wiring class: decode_attention rounds
# q * scale and the unnormalized p per chunk where the JAX LLM's full scores
# round the normalized probabilities, which on this 1280-wide model with 16
# heads a kv head read 8.3e-4 after the prompt and 1.0e-2..1.9e-2 over the
# decode steps, with equal greedy tokens (tests/test_torch_kv.py's smaller
# fixture reads 1.1e-4..1.8e-3 and keeps 1e-2)
# and width 320 (4 query heads over one kv head), past the kernel's 256
# templates: on the card in column slices of 256
HEAD_CASES = [(1280, 16, 1, "f32"), (1280, 16, 1, "bf16"), (384, 8, 2, "f32"),
              (1280, 4, 1, "f32")]
LOGIT_CLASS = {"f32": 1e-4, "bf16": 5e-2}


@pytest.mark.parametrize("n_embd,n_head,n_head_kv,kv_dtype", HEAD_CASES)
def test_llm_matches_jax_at_wide_gqa_and_odd_widths(tmp_path, n_embd, n_head, n_head_kv,
                                                    kv_dtype):
    """Head width 80 with 16 query heads over one kv head, width 48 and
    width 320: shapes outside the decode attention kernel's first templates
    (widths 64, 128, 256; at most 8 heads a kv head). A 40-token prompt
    (chunks 32 + 8), then four greedy decode steps."""
    path = str(tmp_path / "llama.gguf")
    build_llama_gguf(path, n_ctx=128, n_embd=n_embd, n_head=n_head, n_head_kv=n_head_kv,
                     wtype=GGMLType.F32, seed=13)
    jl = J.AutoModelForCausalLM.from_pretrained(path, kv_dtype=kv_dtype)
    tl = T.AutoModelForCausalLM.from_pretrained(path, kv_dtype=kv_dtype, device="cpu")
    spec = tl._bundle.spec
    assert (spec.n_embd // spec.n_head, spec.n_head // spec.n_head_kv) == (
        n_embd // n_head, n_head // n_head_kv)
    toks = [1] + [int(t) for t in np.random.RandomState(0).randint(3, jl.vocab_size, 39)]
    A.reset_counts()
    for llm in (jl, tl):
        llm.eval(toks)
    errs, jtok, ttok = [_rel(tl.logits, jl.logits)], [], []
    for _ in range(4):
        jtok.append(int(np.argmax(jl.logits)))
        ttok.append(int(np.argmax(tl.logits)))
        jl.eval([jtok[-1]])
        tl.eval([jtok[-1]])
        errs.append(_rel(tl.logits, jl.logits))
    assert A.PLAIN_CALLS["decode_attn"] == 4 * spec.n_layer
    assert ttok == jtok
    assert max(errs) < LOGIT_CLASS[kv_dtype], errs
