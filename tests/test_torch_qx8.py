"""The int8-grid branch of the JAX package's _qmm_qx_kernel (mode "qx" with
packed4=False: the activations quantized inside the kernel) in the port on
the CPU: plain_qx8, the plain version of qmm_qx8 and qmm_qx8_legacy,
against the Pallas kernel in interpret mode on Q6_K, Q5_K, Q8_0, Q5_0 and
Q5_1 planes; the table entries that serve it (qx_mode_entries), since no
candidate list offers it; and tiny llamas served under such a table against
the JAX package running the same Pallas kernel."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ctransformers_tpu as J
import ctransformers_tpu_torch as T
from ctransformers_tpu.formats import quants as jquants
from ctransformers_tpu.ops import qmatmul as jqm
from ctransformers_tpu_torch.formats import quants as tquants
from ctransformers_tpu_torch.ops import qmatmul as tqm
from ctransformers_tpu_torch.ops import qmm_kernels as K

from . import test_torch_llm as L

GRIDS = ("Q6_K", "Q5_K", "Q8_0", "Q5_0", "Q5_1")
K_IN, N_OUT = 512, 256


def _both(kind, seed, k=K_IN, n=N_OUT):
    """The same blocks of `kind` repacked by the JAX package and the port."""
    w = (np.random.RandomState(seed).randn(k, n) * 0.3).astype(np.float32)
    buf = tquants.quantize(np.ascontiguousarray(w.T), tquants.GGMLType[kind])
    return (jqm.repack(buf, jquants.GGMLType[kind], n, k),
            tqm.repack(buf, tquants.GGMLType[kind], n, k))


def _pallas_qx(x, jq, m):
    """The Pallas kernel of mode "qx" in interpret mode on x (m, K), with
    the tile of the grid's "q" candidate: no JAX list offers "qx" on an
    unpacked grid."""
    rows, npad = jq.qs.shape
    tk, tn, inner, _ = next(
        c for c in jqm._tile_candidates(rows, npad, jq.packed, jq.pack_layout) if c[3] == "q")
    xp = np.zeros((max(8, m), rows), np.float32)
    xp[:m, : x.shape[1]] = x
    out = jqm._qmm_pallas_tiled(jnp.asarray(xp), jq, tk, tn, inner, interpret=True, mode="qx",
                                rm=m)
    return np.asarray(out)[:m, : jq.shape[1]]


def _fro(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("kind", GRIDS)
@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("k", [K_IN, 1280])
def test_plain_qx8_matches_the_pallas_kernel(kind, m, k):
    """plain_qx8 through its wrapper (a CPU tensor takes the plain version,
    no launch) against the Pallas "qx" kernel on the same planes: the same
    quantization, integer dots and roundings, f32 sums in another order; and
    within the "q" error class of the exact product."""
    jq, tq = _both(kind, k + m, k=k)
    name = K.kernel_name("qx", tq)
    assert name == ("qmm_qx8" if kind in ("Q6_K", "Q5_K") else "qmm_qx8_legacy")
    x = (np.random.RandomState(m).randn(m, k) * 0.5).astype(np.float32)
    ref = _pallas_qx(x, jq, m)
    xp = torch.zeros((m, tq.qs.shape[0]))
    xp[:, :k] = torch.from_numpy(x)
    before = dict(K.PLAIN_CALLS), dict(K.LAUNCHES)
    got = getattr(K, name)(xp, tq)[:, :N_OUT].numpy()
    assert K.PLAIN_CALLS[name] == before[0][name] + 1 and K.LAUNCHES == before[1]
    assert _fro(got, ref) <= 1e-4, _fro(got, ref)
    exact = np.asarray(jqm._qmm_jnp(x, jq))
    assert _fro(got, exact) < 0.035 and _fro(ref, exact) < 0.035


@pytest.mark.parametrize("kind", GRIDS)
def test_qx8_is_q8_on_activations_quantized_outside(kind):
    """The in-kernel quantization is quantize_activations' own: plain_qx8
    equals plain_q8 on quantize_activations(x) bit for bit."""
    _, tq = _both(kind, 3)
    x = torch.randn(8, K_IN, generator=torch.Generator().manual_seed(5))
    want = K.plain_q8(*K.quantize_activations(x, tq.group), tq)
    assert torch.equal(K.plain_qx8(x, tq), want)


def _meta(kind, kp, npad, layout="adjk"):
    """A QTensor of `kind`'s layout at padded (kp, npad) on the meta device."""
    group, sfactor, has_mins, packed = K.LAYOUTS[kind]
    e = lambda shape, dt: torch.empty(shape, dtype=dt, device="meta")  # noqa: E731
    plane = torch.int8 if sfactor else torch.float32
    qs = e((kp // 2 if packed else kp, npad), torch.uint8 if layout == "ksplit" else torch.int8)
    return tqm.QTensor(
        qs, e((kp // group, npad), plane), e((kp // group, npad), plane) if has_mins else None,
        kind, group, (kp, npad), packed=packed, zp=K.zero_point(kind),
        sd=e((kp // 256, npad), torch.float32) if sfactor else None,
        sm=e((kp // 256, npad), torch.float32) if sfactor and has_mins else None,
        sfactor=sfactor, pack_layout=layout)


def test_qx_mode_entries_name_qx_on_every_grid_key_up_to_32():
    """qx for every int8-grid key at m <= 32, nothing for nibble keys (adjk
    or ksplit) or above 32; every entry's pick is its kernel."""
    grids = [_meta(kind, 4096, 4096) for kind in GRIDS] + [_meta("Q6_K", 11264, 4096)]
    nibbles = [_meta("Q4_K", 4096, 4096), _meta("Q2_K", 4096, 4096),
               _meta("Q4_0", 4096, 4096, "ksplit"), _meta("GPTQ4", 4096, 4096)]
    sizes = (1, 8, 32, 33, 128)
    entries = tqm.qx_mode_entries(grids + nibbles, sizes)
    want = {tqm.cache_key(m, w) for w in grids for m in sizes if m <= 32}
    assert set(entries) == want
    for key, v in entries.items():
        assert v["pick"] == v["kernel"] == ("qx", K.CONFIG_OF["qmm_qx8"]) and v["ms"] == {}
    assert "qx" not in tqm._GRID_MODES  # never raced, as in the JAX lists
    for w in grids:
        assert all(c[0] != "qx" for m in sizes for c in tqm.mode_candidates(w, m))


@pytest.mark.parametrize("kind", GRIDS)
def test_a_qx_table_steers_qmatmul_to_plain_qx8(kind, tmp_path, monkeypatch):
    """Under a user's table of qx_mode_entries (precompiled) qmatmul on a
    grid weight takes plain_qx8 at m <= 32 and the fixed rule above."""
    _, tq = _both(kind, 11)
    table = str(tmp_path / f"qx_{kind}.json")
    tqm.save_table(table, "cpu", tqm.qx_mode_entries([tq], (1, 8, 64)))
    monkeypatch.setenv("CT_QMM_TILE_CACHE", table)
    monkeypatch.setenv("CT_QMM_AUTOTUNE", "precompiled")
    name = K.kernel_name("qx", tq)
    K.reset_counts()
    for m in (1, 8, 64):
        out = tqm.qmatmul(torch.randn(m, K_IN), tq)
        assert out.shape == (m, N_OUT) and torch.isfinite(out).all()
    assert K.PLAIN_CALLS[name] == 2 and K.PLAIN_CALLS[K.kernel_name("q8", tq)] == 0
    assert sum(K.PLAIN_CALLS.values()) == 3 and sum(K.LAUNCHES.values()) == 0


# the grid kernels each tiny llama runs under the qx table (the nibbles and
# the 64-token chunk keep the fixed rule's kernels)
QX_MODELS = {
    "Q4_K_M": {"qmm_qx", "qmm_q", "qmm_si", "qmm_i", "qmm_qx8", "qmm_b"},
    "Q8_0": {"qmm_qx8_legacy", "qmm_b_legacy"},
}


@pytest.mark.parametrize("mix", sorted(QX_MODELS))
def test_tiny_llama_under_a_qx_table_matches_jax(tmp_path, mix, monkeypatch):
    """A tiny Q4_K_M and a tiny Q8_0 llama served under a user's table of
    qx_mode_entries against the JAX package running the Pallas kernels of
    the same modes ("qx" on the grid keys the table names, the port's fixed
    rule elsewhere): the same greedy tokens, logits within the wiring class,
    and only those kernels' plain versions run; then generate_fast (the
    fused loop, eager on the CPU) gives the eager loop's greedy tokens."""
    monkeypatch.setenv("CT_PACK4_LAYOUT", "adjk")
    path = L._mix_file(tmp_path, mix, seed=11)
    base = T.AutoModelForCausalLM.from_pretrained(path, device="cpu")
    entries = tqm.qx_mode_entries(tqm.qtensors(base._engine.params), (64, 8, 1))
    table = str(tmp_path / "qx.json")
    tqm.save_table(table, "cpu", entries)
    monkeypatch.setenv("CT_QMM_TILE_CACHE", table)
    monkeypatch.setenv("CT_QMM_AUTOTUNE", "precompiled")
    tl = T.AutoModelForCausalLM.from_pretrained(path, device="cpu")

    def pallas_by_table(x, qt, compute_dtype=None):
        key = (qt.qs.shape[0], qt.qs.shape[1], qt.group, qt.mins is not None, x.shape[0],
               qt.packed, qt.sfactor, qt.pack_layout)
        if key in entries:
            return _pallas_qx(np.asarray(x, np.float32), qt, x.shape[0])
        return L._pallas_as_port(x, qt)

    monkeypatch.setattr(jqm, "_qmm_jnp", pallas_by_table)
    jl = J.AutoModelForCausalLM.from_pretrained(path)
    toks = [1] + [int(t) for t in np.random.RandomState(1).randint(3, jl.vocab_size, 72)]
    K.reset_counts()
    errs = L._greedy_errs(jl, tl, toks)
    assert {k for k, v in K.PLAIN_CALLS.items() if v} == QX_MODELS[mix], K.PLAIN_CALLS
    assert sum(K.LAUNCHES.values()) == 0 and K.DENSE_CALLS["dense"] == 0
    assert max(errs) < 0.05, errs
    tl.reset()
    text = tl.generate_fast("the cat", max_new_tokens=6, temperature=0.0,
                            repetition_penalty=1.0, chunk=4)
    fast = tl._context[len(tl.tokenize("the cat")):]
    tl.reset()
    tl.eval(tl.tokenize("the cat"))
    slow = []
    for _ in range(len(fast)):
        slow.append(int(np.argmax(tl.logits)))
        tl.eval([slow[-1]])
    assert fast == slow and isinstance(text, str)
