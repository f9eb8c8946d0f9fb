"""Tiny models served under a user's table file (CT_QMM_TILE_CACHE with
CT_QMM_AUTOTUNE=precompiled) that names the modes the race adds, against
the JAX package running the Pallas kernels of those modes (interpret mode)
on the CPU."""

import numpy as np
import pytest

import ctransformers_tpu as J
import ctransformers_tpu_torch as T
from ctransformers_tpu.ops import qmatmul as jqm
from ctransformers_tpu_torch.ops import qmatmul as tqm
from ctransformers_tpu_torch.ops import qmm_kernels as K

from . import test_torch_gptq as G
from . import test_torch_llm as L


@pytest.fixture(autouse=True)
def adjk(monkeypatch):
    """The port's nibble layout on the JAX side too."""
    monkeypatch.setenv("CT_PACK4_LAYOUT", "adjk")


# the kernels each K_M mix runs under float_mode_entries' table of the modes the
# race adds (g on nibbles and grids, "" and s on grids at m <= 32; si on
# Q4_K and sb on Q5_K above; Q6_K's GEMM stays by the fixed rule)
NEW_MODE_KERNELS = {
    "Q4_K_M": {"qmm_g", "qmm_si", "qmm_g8", "qmm_f", "qmm_b"},
    "Q5_K_M": {"qmm_g8", "qmm_f", "qmm_s", "qmm_b", "qmm_sb"},
}


@pytest.mark.parametrize("mix", sorted(NEW_MODE_KERNELS))
def test_kquant_mix_under_a_seeded_table_matches_jax(tmp_path, mix, monkeypatch):
    """The tiny K_M llamas served under a user's table file that names the
    modes g, "" and s (CT_QMM_TILE_CACHE with CT_QMM_AUTOTUNE=precompiled),
    against the JAX package running the Pallas kernels of those modes: the
    same greedy tokens and logits within the wiring class."""
    path = L._mix_file(tmp_path, mix, seed=11)
    base = T.AutoModelForCausalLM.from_pretrained(path, device="cpu")
    entries = tqm.float_mode_entries(tqm.qtensors(base._engine.params), (64, 8, 1))
    table = str(tmp_path / "modes.json")
    tqm.save_table(table, "cpu", entries)
    monkeypatch.setenv("CT_QMM_TILE_CACHE", table)
    monkeypatch.setenv("CT_QMM_AUTOTUNE", "precompiled")
    tl = T.AutoModelForCausalLM.from_pretrained(path, device="cpu")

    def pallas_by_table(x, qt, compute_dtype=None):
        # the same key from the JAX package's QTensor: the planes are equal
        key = (qt.qs.shape[0], qt.qs.shape[1], qt.group, qt.mins is not None, x.shape[0],
               qt.packed, qt.sfactor, qt.pack_layout)
        mode = entries[key]["pick"][0] if key in entries else None
        return L._pallas_as_port(x, qt, mode=mode)

    monkeypatch.setattr(jqm, "_qmm_jnp", pallas_by_table)
    jl = J.AutoModelForCausalLM.from_pretrained(path)
    toks = [1] + [int(t) for t in np.random.RandomState(1).randint(3, jl.vocab_size, 72)]
    K.reset_counts()
    errs = L._greedy_errs(jl, tl, toks)
    assert {k for k, v in K.PLAIN_CALLS.items() if v} == NEW_MODE_KERNELS[mix], K.PLAIN_CALLS
    assert sum(K.LAUNCHES.values()) == 0 and K.DENSE_CALLS["dense"] == 0
    print(f"{mix} under the table of new modes: logits rel err vs the JAX package on the "
          f"same kernels {errs}")
    assert max(errs) < L.MIX_LOGIT_CLASS[mix], errs


@pytest.mark.parametrize("size", sorted(G.TINY))
def test_gptq_llm_under_a_seeded_table_matches_jax(tmp_path, size, monkeypatch):
    """A tiny GPTQ directory served under a user's table file that names g
    at m <= 32 and si above (CT_QMM_TILE_CACHE with
    CT_QMM_AUTOTUNE=precompiled), against the JAX package running the
    Pallas kernels of those modes: the same greedy tokens, logits within the
    wiring class, and only the kernels the table names."""
    path = G._gptq_dir(tmp_path, size, False)
    base = T.AutoModelForCausalLM.from_pretrained(path, device="cpu")
    entries = tqm.float_mode_entries(tqm.qtensors(base._engine.params), (64, 8, 1))
    table = str(tmp_path / "modes.json")
    tqm.save_table(table, "cpu", entries)
    monkeypatch.setenv("CT_QMM_TILE_CACHE", table)
    monkeypatch.setenv("CT_QMM_AUTOTUNE", "precompiled")
    tl = T.AutoModelForCausalLM.from_pretrained(path, device="cpu")
    monkeypatch.setattr(jqm, "_qmm_jnp", lambda x, qt, compute_dtype=None: G._pallas_as_port(
        x, qt, mode="g" if x.shape[0] <= 32 else "si"))
    jl = J.AutoModelForCausalLM.from_pretrained(path)
    toks = [1] + [int(t) for t in np.random.RandomState(1).randint(3, jl.vocab_size, 72)]
    K.reset_counts()
    for llm in (jl, tl):
        llm.eval(toks)
    errs = [G._fro(tl.logits, jl.logits)]
    for _ in range(3):
        nxt = int(np.argmax(jl.logits))
        assert int(np.argmax(tl.logits)) == nxt
        jl.eval([nxt])
        tl.eval([nxt])
        errs.append(G._fro(tl.logits, jl.logits))
    assert K.PLAIN_CALLS == dict(dict.fromkeys(K.PLAIN_CALLS, 0), qmm_si_gptq=8,
                                 qmm_g_gptq=8 + 8 * 4)
    assert sum(K.LAUNCHES.values()) == 0 and K.DENSE_CALLS["dense"] == 0
    print(f"{size} under the table of new modes: logits rel err vs the JAX package on the "
          f"same kernels {errs}")
    assert max(errs) < 0.05, errs
