"""The legacy GGML block types Q4_0, Q4_1, Q5_0, Q5_1 and Q8_0 in the port
against the JAX package on the CPU: codecs byte for byte, repacked planes
byte for byte, every candidate kernel's plain version against the Pallas
kernel of its mode (interpret mode, as tests/test_qmatmul.py runs it), and
tiny llama files of those ftypes through from_pretrained."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ctransformers_tpu as J
import ctransformers_tpu_torch as T
from ctransformers_tpu.formats import quants as jquants
from ctransformers_tpu.formats.gguf import GGUFReader
from ctransformers_tpu.ops import qmatmul as jqm
from ctransformers_tpu_torch.formats import quants as tquants
from ctransformers_tpu_torch.models.synthetic import write_llama_gguf
from ctransformers_tpu_torch.ops import qmatmul as tqm
from ctransformers_tpu_torch.ops import qmm_kernels as K

LEGACY = ("Q4_0", "Q4_1", "Q5_0", "Q5_1", "Q8_0")
PLANES = ("qs", "scales", "mins", "sd", "sm")
K_IN, N_OUT = 512, 256


def _weights(seed: int, k: int = K_IN, n: int = N_OUT) -> np.ndarray:
    return (np.random.RandomState(seed).randn(k, n) * 0.3).astype(np.float32)


@pytest.mark.parametrize("kind", LEGACY)
def test_codecs_byte_equal_to_jax(kind):
    """quantize, dequantize and decompose give the JAX package's bytes, a
    flat block (d = 0) included; decompose_factors has no factors for them."""
    x = _weights(1).reshape(-1)
    x[:32] = 0.0
    jt, tt = jquants.GGMLType[kind], tquants.GGMLType[kind]
    buf = tquants.quantize(x, tt)
    np.testing.assert_array_equal(buf, jquants.quantize(x, jt))
    n = x.size
    np.testing.assert_array_equal(tquants.dequantize(buf, tt, n).view(np.uint32),
                                  jquants.dequantize(buf, jt, n).view(np.uint32))
    for a, b in zip(tquants.decompose(buf, tt, n), jquants.decompose(buf, jt, n)):
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b
    assert tquants.decompose_factors(buf, tt, n) is None


def _both(kind, seed, monkeypatch, k=K_IN, n=N_OUT):
    """The same blocks repacked by the JAX package (adjk nibbles) and by
    the port."""
    monkeypatch.setenv("CT_PACK4_LAYOUT", "adjk")
    buf = tquants.quantize(np.ascontiguousarray(_weights(seed, k, n).T), tquants.GGMLType[kind])
    return (jqm.repack(buf, jquants.GGMLType[kind], n, k),
            tqm.repack(buf, tquants.GGMLType[kind], n, k))


@pytest.mark.parametrize("kind", LEGACY)
@pytest.mark.parametrize("k,n", [(512, 256), (1280, 96)])
def test_repack_planes_byte_equal_to_jax(kind, k, n, monkeypatch):
    """Unfactored f32 planes (sfactor 0), adjk nibbles at the type's zero
    point or the int8 grid, padded as the JAX package pads them."""
    jq, tq = _both(kind, k + n, monkeypatch, k, n)
    for f in PLANES:
        a, b = getattr(jq, f), getattr(tq, f)
        assert (a is None) == (b is None), f
        if a is not None:
            a = np.asarray(a)
            assert a.dtype == b.numpy().dtype and a.shape == tuple(b.shape), f
            np.testing.assert_array_equal(a.view(np.uint8), b.numpy().view(np.uint8), err_msg=f)
    assert (tq.kind, tq.group, tq.shape, tq.packed, tq.zp, tq.sfactor) == (
        jq.kind, jq.group, jq.shape, jq.packed, jq.zp, jq.sfactor)
    assert tq.zp == K.zero_point(kind) and tq.sfactor == 0
    np.testing.assert_array_equal(tqm.dequantize_qtensor(tq).numpy(),
                                  np.asarray(jqm.dequantize_qtensor(jq)))


def _fro(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# every (kind, mode) that mode_candidates offers, with the wrapper that
# serves it: Q4_1 is GPTQ4's layout at group 32, Q4_0 has the bias-free
# nibble kernels, the grids the unfactored-plane ("_legacy") kernels
CANDIDATES = [
    (kind, mode, f"qmm_{mode}_q4_0" if kind == "Q4_0" else f"qmm_{mode}_gptq")
    for kind in ("Q4_0", "Q4_1") for mode in ("i", "si", "g", "q", "qx")
] + [
    (kind, mode, f"qmm_{name}_legacy")
    for kind, modes in (("Q8_0", ("", "b", "g", "q8")), ("Q5_0", ("", "b", "g", "q8")),
                        ("Q5_1", ("", "s", "b", "sb", "g", "q8")))
    for mode, name in ((x, {"": "f", "g": "g8"}.get(x, x)) for x in modes)
]


@pytest.mark.parametrize("kind,mode,name", CANDIDATES)
def test_plain_versions_match_pallas_kernels(kind, mode, name, monkeypatch):
    """Each candidate's plain version against the Pallas kernel of its mode
    on the same planes, at each batch size where mode_candidates offers it:
    the same algorithm and roundings, only f32 sums in another order
    (measured <= 8e-7)."""
    jq, tq = _both(kind, 7, monkeypatch)
    assert K.kernel_name(mode, tq) == name
    sizes = [m for m in (1, 8, 64) if mode in dict(tqm.mode_candidates(tq, m))]
    assert sizes
    pallas_mode = "q" if mode == "q8" else mode  # one Pallas kernel, packed4=False
    rows, npad = jq.qs.shape
    tk, tn, inner, _ = next(c for c in jqm._tile_candidates(rows, npad, jq.packed, jq.pack_layout)
                            if c[3] == pallas_mode)
    kp = rows * (2 if jq.packed else 1)
    for m in sizes:
        x = (np.random.RandomState(m).randn(m, K_IN) * 0.5).astype(np.float32)
        xp = np.zeros((max(8, m), kp), np.float32)
        xp[:m, :K_IN] = x
        ref = np.asarray(jqm._qmm_pallas_tiled(jnp.asarray(xp), jq, tk, tn, inner,
                                               interpret=True, mode=pallas_mode, rm=m))
        xt = torch.from_numpy(xp[:m])
        before = dict(K.PLAIN_CALLS), dict(K.LAUNCHES)
        fn = getattr(K, name)
        args = K.quantize_activations(xt, tq.group) if name in K.PREQUANTIZED else (xt,)
        out = fn(*args, tq)
        assert K.PLAIN_CALLS[name] == before[0][name] + 1
        assert K.LAUNCHES == before[1]  # no kernel launch on a CPU tensor
        got, ref = out[:, :N_OUT].numpy(), ref[:m, :N_OUT]
        assert _fro(got, ref) <= 1e-4, (m, _fro(got, ref))
        # the error classes of tests/test_qmatmul.py against the exact product
        exact = np.asarray(jqm._qmm_jnp(x, jq))
        bound = 0.035 if "q" in mode else 2e-4 if mode in ("", "s") else 0.025
        assert _fro(got, exact) < bound and _fro(ref, exact) < bound, m


def _meta(kind, kp, npad):
    """A QTensor of `kind`'s layout at padded (kp, npad), planes on the meta
    device (select_mode, mode_candidates and kernel_name read the layout)."""
    group, sfactor, has_mins, packed = K.LAYOUTS[kind]
    e = lambda *s: torch.empty(s, dtype=torch.float32, device="meta")  # noqa: E731
    return tqm.QTensor(torch.empty((kp // 2 if packed else kp, npad), dtype=torch.int8,
                                   device="meta"),
                       e(kp // group, npad), e(kp // group, npad) if has_mins else None,
                       kind, group, (kp, npad), packed, K.zero_point(kind), sfactor=sfactor)


@pytest.mark.parametrize("kind,rule,cands", [
    ("Q4_0", ("qx", "q", "q", "i"), ("i", "si", "g", "q", "qx")),
    ("Q4_1", ("qx", "q", "q", "i"), ("i", "si", "g", "q", "qx")),
    ("Q8_0", ("q8", "q8", "q8", "b"), ("", "b", "g", "q8")),
    ("Q5_0", ("q8", "q8", "q8", "b"), ("", "b", "g", "q8")),
    ("Q5_1", ("q8", "q8", "q8", "sb"), ("", "s", "b", "sb", "g", "q8")),
])
def test_select_mode_and_candidates_keep_the_jax_rules(kind, rule, cands):
    """The fixed rule at m = 1, 8, 32, 128 and the raced candidates: Q4_0
    keeps "si" (no bias, as the JAX list keeps it on packed weights), the
    grids without mins drop the sum-fold modes; above 32 only the bf16
    tensor-core modes remain."""
    qt = _meta(kind, 4096, 4096)
    assert tuple(tqm.select_mode(m, qt) for m in (1, 8, 32, 128)) == rule
    assert tuple(c[0] for c in tqm.mode_candidates(qt, 8)) == cands
    big = tuple(c[0] for c in tqm.mode_candidates(qt, 128))
    assert big == tuple(x for x in cands if x.endswith("b") or x in ("i", "si"))
    for mode, config in tqm.mode_candidates(qt, 8) + tqm.mode_candidates(qt, 128):
        assert config == K.CONFIG_OF[K.kernel_name(mode, qt)]


def test_wrappers_take_only_their_layout(monkeypatch):
    """A weight reaches only the kernels built for its layout: anything else
    raises NotImplementedError instead of being served another way."""
    _, q40 = _both("Q4_0", 3, monkeypatch)
    _, q80 = _both("Q8_0", 3, monkeypatch)
    _, q41 = _both("Q4_1", 3, monkeypatch)
    x = torch.zeros(2, q40.qs.shape[0] * 2)
    for name, qt in (("qmm_qx_gptq", q40), ("qmm_qx", q40), ("qmm_i_q4_0", q41),
                     ("qmm_f", q80), ("qmm_g8", q80), ("qmm_b_legacy", q40)):
        with pytest.raises(NotImplementedError):
            getattr(K, name)(x if qt.packed else torch.zeros(2, qt.qs.shape[0]), qt)
    with pytest.raises(NotImplementedError):  # Q4_0 planes at the wrong zero point
        K.qmm_qx_q4_0(x, dataclasses.replace(q40, zp=0))
    with pytest.raises(NotImplementedError):  # an unfactored grid of a group not built
        K.qmm_f_legacy(torch.zeros(2, q80.qs.shape[0]), dataclasses.replace(
            q80, group=16, scales=torch.zeros(q80.qs.shape[0] // 16, q80.qs.shape[1])))


@pytest.mark.parametrize("mix", LEGACY)
def test_fusion_keeps_unfactored_planes(mix, monkeypatch):
    """QKV and gate/up fuse on the unfactored planes as the JAX package
    fuses them, byte for byte."""
    jqs, tqs = zip(*(_both(mix, s, monkeypatch, 512, n) for s, n in ((1, 256), (2, 128), (3, 128))))
    jlayer, tlayer = dict(zip(("wq", "wk", "wv"), jqs)), dict(zip(("wq", "wk", "wv"), tqs))
    assert jqm.fuse_layer_params({"layers": [jlayer]}) == 1
    assert tqm.fuse_layer_params({"layers": [tlayer]}) == 1
    jf, tf = jlayer["w_qkv"], tlayer["w_qkv"]
    assert tf.splits == jf.splits and tf.sfactor == 0 and tf.zp == jf.zp
    for f in PLANES:
        a, b = getattr(jf, f), getattr(tf, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a).view(np.uint8), b.numpy().view(np.uint8))


# the plain versions a legacy file's prompt (chunks 64 + 8 + 1) and decode
# run under the fixed rule; the output tensor (Q6_K except in a Q8_0 file)
# runs at m = 1 only, on the last token
LEGACY_KERNELS = {
    "Q4_0": {"qmm_qx_q4_0", "qmm_q_q4_0", "qmm_i_q4_0", "qmm_q8"},
    "Q4_1": {"qmm_qx_gptq", "qmm_q_gptq", "qmm_i_gptq", "qmm_q8"},
    "Q5_0": {"qmm_q8_legacy", "qmm_b_legacy", "qmm_q8"},
    "Q5_1": {"qmm_q8_legacy", "qmm_sb_legacy", "qmm_q8"},
    "Q8_0": {"qmm_q8_legacy", "qmm_b_legacy"},
}
# logits against the JAX package's exact path: the wiring class of the
# all-Q4_K test; Q5_1's grid is stored uncentred ([0, 31], the mins folded
# apart) like Q5_K's, so its int8 activation rounding errs more (ROADMAP
# Queue 3), the 10% class of Q5_K_M
LOGIT_CLASS = {"Q4_0": 0.05, "Q4_1": 0.05, "Q5_0": 0.05, "Q5_1": 0.10, "Q8_0": 0.05}
# each file's seed: the first from 11 whose greedy path keeps every top-2
# margin of the JAX package's logits above 2.5% (chip_smoke.py's rule), so
# that rounding cannot rightly flip a near-tie (Q5_1 seed 11: 0.96%, Q8_0
# seed 11: 2.3%)
SEEDS = {"Q4_0": 11, "Q4_1": 11, "Q5_0": 11, "Q5_1": 12, "Q8_0": 12}
MIN_MARGIN = 0.025


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - b) / np.linalg.norm(b))


def _greedy(jl, tl, toks, steps=3):
    """Prompt (chunks 64 + 8 + 1), then greedy steps on the JAX package's
    tokens: per step the logits' relative error, the JAX top-2 margin
    (relative to the top logit), and whether both pick the same token."""
    jl.eval(toks)
    tl.eval(toks)
    errs, margins, same = [], [], []
    for i in range(steps + 1):
        ref = np.asarray(jl.logits, np.float64)
        top2 = np.sort(ref)[-2:]
        errs.append(_rel(tl.logits, ref))
        margins.append(float((top2[1] - top2[0]) / abs(top2[1])))
        same.append(int(np.argmax(tl.logits)) == int(np.argmax(ref)))
        if i < steps:
            nxt = int(np.argmax(ref))
            jl.eval([nxt])
            tl.eval([nxt])
    return errs, margins, same


@pytest.mark.parametrize("mix", LEGACY)
def test_tiny_legacy_llama_matches_jax(tmp_path, mix, monkeypatch):
    """A tiny llama file of each legacy ftype (llama.cpp's layout: every
    2-D weight the ftype's type, output.weight Q6_K where its rows are a
    256-multiple, except in a Q8_0 file) through the JAX package and
    through the port's from_pretrained on the CPU: the same greedy tokens,
    logits within the wiring class, every expected plain version run and
    no kernel launched."""
    monkeypatch.setenv("CT_PACK4_LAYOUT", "adjk")
    path = str(tmp_path / f"llama_{mix}.gguf")
    write_llama_gguf(path, n_vocab=512, n_ctx=128, n_embd=256, n_ff=512, n_layer=2,
                     mix=mix, seed=SEEDS[mix])
    types = {n: t.type.name for n, t in GGUFReader(path).tensors.items() if "norm" not in n}
    assert types.pop("output.weight") == ("Q8_0" if mix == "Q8_0" else "Q6_K")
    assert set(types.values()) == {mix}  # token_embd included
    jl = J.AutoModelForCausalLM.from_pretrained(path)
    tl = T.AutoModelForCausalLM.from_pretrained(path, device="cpu")
    layers = tl._engine.params["layers"]
    assert all("w_qkv" in layer and "w_gateup" in layer for layer in layers)
    assert {layer["w_qkv"].kind for layer in layers} == {mix}
    toks = [1] + [int(t) for t in np.random.RandomState(1).randint(3, jl.vocab_size, 72)]
    K.reset_counts()
    errs, margins, same = _greedy(jl, tl, toks)
    assert {k for k, v in K.PLAIN_CALLS.items() if v} == LEGACY_KERNELS[mix], K.PLAIN_CALLS
    assert sum(K.LAUNCHES.values()) == 0
    print(f"{mix}: logits rel err vs the JAX package {errs}, JAX top-2 margins {margins}")
    assert min(margins) > MIN_MARGIN, margins
    assert all(same), same
    assert max(errs) < LOGIT_CLASS[mix], errs


@pytest.mark.parametrize("mix", LEGACY)
def test_from_jax_params_carries_legacy_planes(tmp_path, mix, monkeypatch):
    """The JAX loader's params of a legacy file, its nibbles in the ksplit
    layout of a host without the TPU int4 bitcast, carried across with
    from_jax_params: the port's own loader's planes byte for byte (Q4_0's
    zero point 8 included)."""
    from ctransformers_tpu.models.llama_gguf import load_bundle as jload
    from ctransformers_tpu_torch.models.convert import from_jax_params
    from ctransformers_tpu_torch.models.llama_gguf import load_bundle as tload

    monkeypatch.setenv("CT_PACK4_LAYOUT", "ksplit")
    path = str(tmp_path / f"llama_{mix}.gguf")
    write_llama_gguf(path, n_vocab=512, n_ctx=128, n_embd=256, n_ff=512, n_layer=1,
                     mix=mix, seed=4)
    jb, tb = jload(path), tload(path)
    got, want = from_jax_params(jb.params)["layers"][0], tb.params["layers"][0]
    if mix in ("Q4_0", "Q4_1"):
        assert jb.params["layers"][0]["wq"].pack_layout == "ksplit"
    for name in ("wq", "wo", "w_gate", "w_down"):
        a, b = got[name], want[name]
        assert (a.kind, a.zp, a.sfactor, a.packed) == (b.kind, b.zp, b.sfactor, b.packed), name
        for f in PLANES:
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None and y is None) or torch.equal(x, y), (name, f)
