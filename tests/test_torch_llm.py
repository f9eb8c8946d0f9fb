"""The slice as a whole on the CPU: the port's AutoModelForCausalLM ->
LLM path against the JAX package's on the tiny llama GGUF fixtures."""

import numpy as np
import pytest

import chip_smoke
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
    q4k = ("qmm_qx", "qmm_q", "qmm_si", "qmm_i")
    assert {k for k, v in K.PLAIN_CALLS.items() if v} == set(q4k), K.PLAIN_CALLS
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


# the kernels each K_M mix runs over a 64 + 8 + 1 prompt and decode: Q4_K_M
# has Q4_K and Q6_K matmuls (no mins on the int8 grid, so no "sb"), Q5_K_M
# has Q5_K and Q6_K (no nibble-packed weights)
MIX_KERNELS = {
    "Q4_K_M": {"qmm_qx", "qmm_q", "qmm_si", "qmm_i", "qmm_q8", "qmm_b"},
    "Q5_K_M": {"qmm_q8", "qmm_b", "qmm_sb"},
}
# logits against the JAX package's exact f32 path, and against the JAX
# package running the same Pallas kernels as the port: the wiring class (a
# wrong bias fold or split reads 10-100%)
MIX_LOGIT_CLASS = {"Q4_K_M": 0.05, "Q5_K_M": 0.10}
# one matmul call of the port against the Pallas kernel of the same mode on
# the same operands: same algorithm and roundings, f32 sums in another order
CALL_TOL = 1e-4


def _mix_file(tmp_path, mix, seed):
    from ctransformers_tpu_torch.models.synthetic import write_llama_gguf

    path = str(tmp_path / f"llama_{mix}.gguf")
    write_llama_gguf(path, n_vocab=512, n_ctx=128, n_embd=256, n_ff=512, n_layer=2,
                     mix=mix, seed=seed)
    return path


def _pallas_as_port(x, qt, compute_dtype=None, mode=None):
    """The JAX package's product x @ qt through the Pallas kernel (interpret
    mode) of `mode`, by default the mode the port's select_mode picks for
    this m and weight. Has the signature of the JAX package's exact
    _qmm_jnp, which it replaces in the tests below."""
    import jax.numpy as jnp

    from ctransformers_tpu.ops import qmatmul as jqm
    from ctransformers_tpu_torch.ops.qmatmul import select_mode

    m = x.shape[0]
    mode = select_mode(m, qt) if mode is None else mode
    mode = "q" if mode == "q8" else mode  # one Pallas kernel, packed4=False
    rows, npad = qt.qs.shape
    tk, tn, inner, _ = next(
        c for c in jqm._tile_candidates(rows, npad, qt.packed, qt.pack_layout)
        if c[3] == mode
    )
    kp = rows * (2 if qt.packed else 1)
    xp = jnp.pad(jnp.asarray(x, jnp.float32), ((0, max(8, m) - m), (0, kp - x.shape[1])))
    out = jqm._qmm_pallas_tiled(xp, qt, tk, tn, inner, interpret=True, mode=mode, rm=m)
    return out[:m, : qt.shape[1]]


def _as_jax(qt):
    """The port's QTensor as the JAX package's, on the same planes (they
    are byte-equal to its adjk repack)."""
    import jax.numpy as jnp

    from ctransformers_tpu.ops import qmatmul as jqm

    arr = lambda t: None if t is None else jnp.asarray(t.numpy())  # noqa: E731
    return jqm.QTensor(arr(qt.qs), arr(qt.scales), arr(qt.mins), qt.kind, qt.group,
                       qt.shape, qt.packed, qt.zp, sd=arr(qt.sd), sm=arr(qt.sm),
                       sfactor=qt.sfactor, pack_layout=qt.pack_layout)


def _greedy_errs(jl, tl, toks):
    """Prompt (chunks 64 + 8 + 1) and three greedy steps on the JAX
    package's tokens: the logits' relative errors; the port's greedy token
    must be the JAX package's at every step."""
    jl.eval(toks)
    tl.eval(toks)
    errs = [_rel(tl.logits, jl.logits)]
    for _ in range(3):
        nxt = int(np.argmax(jl.logits))
        assert int(np.argmax(tl.logits)) == nxt
        jl.eval([nxt])
        tl.eval([nxt])
        errs.append(_rel(tl.logits, jl.logits))
    assert int(np.argmax(tl.logits)) == int(np.argmax(jl.logits))
    return errs


@pytest.mark.parametrize("mix", sorted(MIX_KERNELS))
def test_kquant_mix_matches_jax(tmp_path, mix, monkeypatch):
    """A tiny Q4_K_M / Q5_K_M llama (layer 1 is a more-bits layer, output
    is Q6_K, token_embd takes the base type) through the JAX package and
    the port on the CPU. The JAX loader reads the types llama.cpp's rule
    gave each tensor. Every matmul call of the port equals the JAX
    package's Pallas kernel of the same mode on the same operands; the
    logits agree within the wiring class with the JAX package, both on
    its exact path and running those Pallas kernels."""
    from ctransformers_tpu.formats.gguf import GGUFReader
    from ctransformers_tpu.ops import qmatmul as jqm
    from ctransformers_tpu_torch.models import forward
    from ctransformers_tpu_torch.ops.qmatmul import QTensor, select_mode

    monkeypatch.setenv("CT_PACK4_LAYOUT", "adjk")  # the port's Q4_K layout
    path = _mix_file(tmp_path, mix, seed=11)
    types = {n: t.type.name for n, t in GGUFReader(path).tensors.items()}
    base = mix[:4]
    assert types["output.weight"] == "Q6_K" and types["token_embd.weight"] == base
    assert types["blk.0.attn_v.weight"] == types["blk.0.ffn_down.weight"] == base
    assert types["blk.1.attn_v.weight"] == types["blk.1.ffn_down.weight"] == "Q6_K"
    assert types["blk.1.attn_q.weight"] == types["blk.1.ffn_up.weight"] == base
    jl = J.AutoModelForCausalLM.from_pretrained(path)
    tl = T.AutoModelForCausalLM.from_pretrained(path, device="cpu")
    layers = tl._engine.params["layers"]
    assert "w_qkv" in layers[0] and "w_qkv" not in layers[1]  # mixed kinds stay apart
    assert "w_gateup" in layers[1]

    worst = {}
    mm = forward.mm

    def held(x, w):
        out = mm(x, w)
        if isinstance(w, QTensor):
            xm = x.reshape(-1, w.shape[0]).numpy()
            ref = np.asarray(_pallas_as_port(xm, _as_jax(w)))
            mode = select_mode(xm.shape[0], w)
            worst[mode] = max(worst.get(mode, 0.0), _rel(out.reshape(ref.shape), ref))
        return out

    monkeypatch.setattr(forward, "mm", held)
    toks = [1] + [int(t) for t in np.random.RandomState(1).randint(3, jl.vocab_size, 72)]
    K.reset_counts()
    exact = _greedy_errs(jl, tl, toks)
    assert {k for k, v in K.PLAIN_CALLS.items() if v} == MIX_KERNELS[mix], K.PLAIN_CALLS
    assert sum(K.LAUNCHES.values()) == 0
    print(f"{mix}: each matmul call vs the Pallas kernel of its mode, worst {worst}")
    assert {"qmm_" + k for k in worst} == MIX_KERNELS[mix]
    assert max(worst.values()) <= CALL_TOL, worst

    # the JAX package running the port's kernels for every matmul
    monkeypatch.setattr(forward, "mm", mm)
    monkeypatch.setattr(jqm, "_qmm_jnp", _pallas_as_port)
    tl.reset()
    same = _greedy_errs(J.AutoModelForCausalLM.from_pretrained(path), tl, toks)
    # The logits cannot agree much closer than the exact path's: int8 and
    # bf16 rounding of the activations turn the ~1e-7 differences of the
    # two packages' other f32 ops into whole rounding steps here and
    # there, and these random 2-layer models amplify them (measured
    # 0.7-0.9% for Q4_K_M and 1.6-3.0% for Q5_K_M, while each call agrees
    # to <= 7e-7). Q4_K_M
    # keeps the 5% class of the all-Q4_K test against the exact path
    # (measured 1.8-2.7%). Q5_K_M's int8 grid is not centred (q in [0, 31],
    # the mins folded apart), so the reference's "q" algorithm rounds a
    # larger product: 1.4% per matmul against Q4_K's 0.55%, and 4.2-6.5%
    # against the exact path here.
    print(f"{mix}: logits rel err vs the JAX package, exact {exact}, same kernels {same}")
    assert max(exact) < MIX_LOGIT_CLASS[mix], exact
    assert max(same) < MIX_LOGIT_CLASS[mix], same


@pytest.mark.parametrize("mix", sorted(MIX_KERNELS))
def test_from_jax_params_serves_the_mixes(tmp_path, monkeypatch, mix):
    """The JAX loader's params for a K_M mix (ksplit Q4_K planes, int8 grids
    with and without mins), carried across with from_jax_params, give
    bit-identical logits to the port's own loader."""
    from ctransformers_tpu.models.llama_gguf import load_bundle as jload
    from ctransformers_tpu_torch.engine.engine import Engine
    from ctransformers_tpu_torch.models.convert import from_jax_params
    from ctransformers_tpu_torch.models.llama_gguf import load_bundle as tload

    monkeypatch.setenv("CT_PACK4_LAYOUT", "ksplit")
    path = _mix_file(tmp_path, mix, seed=4)
    jb, tb = jload(path), tload(path)
    assert not jb.params["lm_head"].packed  # Q6_K int8 grid
    toks = [1] + [int(t) for t in np.random.RandomState(2).randint(3, 300, 40)]
    logits = []
    for params in (from_jax_params(jb.params), tb.params):
        eng = Engine(tb.spec, params, device="cpu")
        eng.eval(toks)
        eng.eval([7])
        logits.append(eng.logits)
    np.testing.assert_array_equal(logits[0], logits[1])


@pytest.mark.parametrize("label,mix", chip_smoke.TINY_MODELS)
def test_tiny_smoke_models_pick_a_seed_without_near_ties(tmp_path, label, mix, capsys):
    """chip_smoke.py phase 4 serves each tiny model at the first seed whose
    greedy path on the CPU keeps every top-2 margin above its minimum
    (TINY_MIN_MARGIN_OF, else TINY_MIN_MARGIN); the rule finds such a seed,
    its log lists every seed it tried, and the search of phase 4 starts at
    it (TINY_FIRST_SEED)."""
    path = chip_smoke.model_path(str(tmp_path), f"tiny_{label}", mix)
    seed = chip_smoke.pick_tiny_seed(path, label, mix)
    tried = [line for line in capsys.readouterr().out.splitlines() if " seed " in line]
    assert len(tried) == seed
    assert chip_smoke.TINY_FIRST_SEED.get(label, 1) == seed
    _, _, margins = chip_smoke.greedy_margins(T.AutoModelForCausalLM.from_pretrained(path, device="cpu"))
    assert min(margins) > chip_smoke.TINY_MIN_MARGIN_OF.get(label, chip_smoke.TINY_MIN_MARGIN)
    with capsys.disabled():
        print("\n" + "\n".join(tried))
