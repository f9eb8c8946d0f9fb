"""Kernel selection of the port (ops/qmatmul.py) on the CPU: the candidate
lists against the JAX package's, the table files, and the dispatch they
steer. Races run on the card only (tests/test_torch_cuda.py)."""

import builtins
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import ctransformers_tpu_torch as T
from ctransformers_tpu.formats.quants import GGMLType, quantize
from ctransformers_tpu.ops import qmatmul as jqm
from ctransformers_tpu_torch.engine.engine import Engine
from ctransformers_tpu_torch.models.llama_gguf import load_bundle
from ctransformers_tpu_torch.ops import qmatmul as qm
from ctransformers_tpu_torch.ops import qmm_kernels as K

from .fixtures import build_llama_gguf

H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture(autouse=True)
def fresh_tables(tmp_path, monkeypatch):
    """Every test starts without tables in memory, with the user's table in
    its own directory and the default environment."""
    monkeypatch.setenv("CT_QMM_TILE_CACHE", str(tmp_path / "user_modes.json"))
    for name in ("CT_QMM_AUTOTUNE", "CT_QMATMUL"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(qm, "_TILE_CACHE", {})
    monkeypatch.setattr(qm, "_TAINTED_KEYS", set())


def _meta_qtensor(kind, kp, npad, group=None):
    """A QTensor of `kind`'s layout at padded (kp, npad), planes on the meta
    device (the candidate lists read only the layout)."""
    g, sfactor, has_mins, packed = K.LAYOUTS[kind]
    group = group or g
    e = lambda *s: torch.empty(s, dtype=torch.int8, device="meta")  # noqa: E731
    mins = e(kp // group, npad) if has_mins else None
    return qm.QTensor(e(kp // 2 if packed else kp, npad), e(kp // group, npad), mins,
                      kind, group, (kp, npad), packed, sfactor=sfactor)


def _real_qtensor(kind, k=512, n=384, seed=0):
    w = (np.random.RandomState(seed).randn(k, n) * 0.3).astype(np.float32)
    buf = quantize(np.ascontiguousarray(w.T), GGMLType[kind])
    return qm.repack(buf, GGMLType[kind], n, k)


def _gptq_qtensor(k=512, n=384, group=128, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randint(0, 16, (k, n)).astype(np.int8)
    s = (rng.rand(k // group, n) * 3e-3 + 1e-3).astype(np.float32)
    z = rng.randint(0, 16, (k // group, n)).astype(np.float32)
    return qm.make_qtensor(q, s, -(s * z), "GPTQ4", group)


def _entry(mode, qt):
    choice = qm.DENSE if mode == "dense" else (mode, K.CONFIG_OF[K.kernel_name(mode, qt)])
    kernel = None if mode == "dense" else choice
    return {"pick": choice, "kernel": kernel, "ms": {}}


# -- candidate lists ---------------------------------------------------------------


@pytest.mark.parametrize("m", [1, 8, 32, 128])
@pytest.mark.parametrize("kind,group", [("Q4_K", None), ("Q6_K", None), ("Q5_K", None),
                                        ("GPTQ4", 32), ("GPTQ4", 128)])
@pytest.mark.parametrize("kp,npad", [(4096, 12288), (11264, 4096)])
def test_candidate_modes_equal_the_jax_lists(kind, group, kp, npad, m):
    """The mode axis of _tile_candidates for the weight's layout at this m
    (its m > 32 pruning included), in its order, less the sum-fold modes
    where _pick_tiles drops them; the port names "q" on an int8 grid "q8"."""
    qt = _meta_qtensor(kind, kp, npad, group)
    rows = qt.qs.shape[0]
    want = []
    for c in jqm._tile_candidates(rows, npad, qt.packed, "adjk", mp=jqm._round_up(m, 8)):
        if c[3] not in want:
            want.append(c[3])
    if not (qt.packed or qt.mins is not None):
        want = [x for x in want if "s" not in x]
    got = qm.mode_candidates(qt, m)
    assert ["q" if mode == "q8" else mode for mode, _ in got] == want
    # every candidate names a kernel of the port and its one configuration
    for mode, config in got:
        name = K.kernel_name(mode, qt)
        assert name in K.KERNELS and config == K.CONFIG_OF[name]
    # the rule that decides without a measurement picks a member
    assert qm.select_mode(m, qt) in [mode for mode, _ in got]


def test_candidate_pruning_rules():
    q4k, q6k, q5k = (_meta_qtensor(k, 4096, 4096) for k in ("Q4_K", "Q6_K", "Q5_K"))
    modes = lambda qt, m: [x for x, _ in qm.mode_candidates(qt, m)]  # noqa: E731
    assert modes(q4k, 32) == ["i", "si", "g", "q", "qx"] and modes(q4k, 33) == ["i", "si"]
    assert modes(q5k, 32) == ["", "s", "b", "sb", "g", "q8"] and modes(q5k, 33) == ["b", "sb"]
    # no mins and no nibble re-bias: nothing to fold
    assert modes(q6k, 8) == ["", "b", "g", "q8"] and modes(q6k, 128) == ["b"]
    gptq = _meta_qtensor("GPTQ4", 4096, 4096, 64)
    assert modes(gptq, 1) == modes(q4k, 1) and modes(gptq, 128) == ["i", "si"]
    assert K.kernel_name("si", gptq) == "qmm_si_gptq" and K.kernel_name("g", q6k) == "qmm_g8"
    assert K.kernel_name("", q5k) == "qmm_f" and K.kernel_name("s", q5k) == "qmm_s"


def test_keys_tell_layouts_and_fusion_apart():
    q4k, gptq = _meta_qtensor("Q4_K", 4096, 4096), _meta_qtensor("GPTQ4", 4096, 4096, 32)
    a, b = qm.cache_key(1, q4k), qm.cache_key(1, gptq)
    assert a[:6] == b[:6] and a != b  # only sfactor differs
    assert qm.cache_key(1, q4k) != qm.cache_key(1, _meta_qtensor("Q4_K", 4096, 12288))
    assert qm.cache_key(1, q4k) != qm.cache_key(8, q4k)
    assert a == (2048, 4096, 32, True, 1, True, 8, "adjk")  # the JAX package's key


# -- table files -------------------------------------------------------------------


def test_table_round_trip(tmp_path):
    q4k, q5k = _meta_qtensor("Q4_K", 4096, 4096), _meta_qtensor("Q5_K", 4096, 4096)
    entries = {
        qm.cache_key(1, q4k): dict(_entry("g", q4k), ms={"g": 0.02, "qx": 0.03, "dense": 1.5}),
        qm.cache_key(8, q5k): _entry("", q5k),
        qm.cache_key(128, q5k): dict(_entry("dense", q5k), kernel=("sb", K.WGMMA_CONFIG)),
    }
    path = str(tmp_path / "t.json")
    qm.save_table(path, H100, entries, "700.00 W")
    assert qm._parse_cache_file(path, H100) == entries
    doc = json.load(open(path))
    assert doc["card"] == H100 and doc["power_limit"] == "700.00 W"
    assert doc["source_hash"] == K._source_hash() and doc["format"] == qm.TABLE_FORMAT


def test_table_of_another_card_or_other_sources_is_ignored(tmp_path):
    q4k = _meta_qtensor("Q4_K", 4096, 4096)
    path = str(tmp_path / "t.json")
    qm.save_table(path, H100, {qm.cache_key(1, q4k): _entry("g", q4k)})
    assert len(qm._parse_cache_file(path, H100)) == 1
    assert qm._parse_cache_file(path, "NVIDIA H200") == {}
    assert qm._parse_cache_file(path, "cpu") == {}
    doc = json.load(open(path))
    doc["source_hash"] = "0" * 16  # a kernel was rewritten since
    json.dump(doc, open(path, "w"))
    assert qm._parse_cache_file(path, H100) == {}


def test_user_entries_win_over_shipped_ones(tmp_path, monkeypatch):
    q4k = _meta_qtensor("Q4_K", 4096, 4096)
    both, only = qm.cache_key(1, q4k), qm.cache_key(8, q4k)
    shipped = str(tmp_path / "shipped.json")
    qm.save_table(shipped, "cpu", {both: _entry("qx", q4k), only: _entry("q", q4k)})
    qm.save_table(qm.table_path(), "cpu", {both: _entry("g", q4k)})
    monkeypatch.setattr(qm, "shipped_table_path", lambda card: shipped)
    assert qm.pick_mode(1, _cpu(q4k))[0] == "g"
    assert qm.pick_mode(8, _cpu(q4k))[0] == "q"
    assert set(qm.table(torch.device("cpu"))) == {both, only}
    # a card no table was shipped for (a cold start): the user's entries alone
    monkeypatch.setattr(qm, "_TILE_CACHE", {})
    monkeypatch.setattr(qm, "shipped_table_path", lambda card: None)
    assert set(qm.table(torch.device("cpu"))) == {both}


def test_tables_are_kept_per_card_and_user_file(tmp_path, monkeypatch):
    """A second user file (or another card) gets a table of its own; going
    back finds the first as it was left, entries added in memory included,
    without reading its file again."""
    q4k = _cpu(_meta_qtensor("Q4_K", 4096, 4096))
    key = qm.cache_key(1, q4k)
    qm.save_table(qm.table_path(), "cpu", {key: _entry("g", q4k)})
    first = qm.table(q4k.qs.device)
    first[qm.cache_key(8, q4k)] = _entry("q", q4k)  # as a race would add
    os.remove(qm.table_path())
    monkeypatch.setenv("CT_QMM_TILE_CACHE", str(tmp_path / "other.json"))
    assert qm.table(q4k.qs.device) == {} and qm.pick_mode(1, q4k)[0] == "qx"
    monkeypatch.setenv("CT_QMM_TILE_CACHE", str(tmp_path / "user_modes.json"))
    assert qm.table(q4k.qs.device) is first and len(first) == 2
    assert qm.pick_mode(1, q4k)[0] == "g" and qm.pick_mode(8, q4k)[0] == "q"


def test_a_settled_choice_is_kept_on_the_weight(monkeypatch):
    """pick_mode resolves a (weight, m) once per environment: the second
    call reads no table (a miss that took the rule included); a changed
    environment resolves again; a copy of the weight starts empty."""
    q4k = _cpu(_meta_qtensor("Q4_K", 4096, 4096))
    qm.save_table(qm.table_path(), "cpu", {qm.cache_key(1, q4k): _entry("g", q4k)})
    assert qm.pick_mode(1, q4k)[0] == "g" and set(q4k.picks) == {1}
    assert qm.pick_mode(8, q4k)[0] == "q"  # a miss: the rule
    assert qm.cache_key(8, q4k) not in qm.table(q4k.qs.device)
    monkeypatch.setattr(qm, "table", lambda device: pytest.fail("the table was read again"))
    assert qm.pick_mode(1, q4k)[0] == "g" and qm.pick_mode(8, q4k)[0] == "q"
    monkeypatch.setenv("CT_QMM_AUTOTUNE", "0")
    assert qm.pick_mode(1, q4k)[0] == "qx"
    monkeypatch.setenv("CT_QMATMUL", "dense")
    assert qm.pick_mode(1, q4k) == qm.DENSE
    real = _real_qtensor("Q4_K")
    qm.pick_mode(1, real)
    assert real.picks and real.to("cpu").picks == {} and _cpu(q4k).picks == {}


def _cpu(qt):
    """The meta QTensor with its grid on the CPU (pick_mode reads the device)."""
    import dataclasses

    return dataclasses.replace(qt, qs=torch.empty(qt.qs.shape, dtype=torch.int8))


def test_tainted_keys_never_persist(monkeypatch):
    """A pick that is not the champion of a full race (raced without the
    dense candidate) stays in memory."""
    q4k = _meta_qtensor("Q4_K", 4096, 4096)
    good, bad = qm.cache_key(1, q4k), qm.cache_key(128, q4k)
    ident = ("cpu", qm.table_path())
    monkeypatch.setattr(qm, "_TILE_CACHE",
                        {ident: {good: _entry("qx", q4k), bad: _entry("si", q4k)}})
    monkeypatch.setattr(qm, "_TAINTED_KEYS", {ident + (bad,)})
    monkeypatch.setattr(qm, "power_limit", lambda: None)
    qm._save_disk_cache("cpu")
    assert set(qm._parse_cache_file(qm.table_path(), "cpu")) == {good}


def test_the_port_never_reads_the_jax_packages_table(tmp_path, monkeypatch):
    v5e = os.path.join(os.path.dirname(jqm.__file__), "..", "data", "qmm_tiles_v5e.json")
    assert os.path.exists(v5e)
    # neither package can read the other's file
    for card in (H100, "cpu", "TPU v5 lite"):
        assert qm._parse_cache_file(v5e, card) == {}
    ours = str(tmp_path / "t.json")
    q4k = _meta_qtensor("Q4_K", 4096, 4096)
    qm.save_table(ours, H100, {qm.cache_key(1, q4k): _entry("g", q4k)}, "700.00 W")
    assert jqm._parse_cache_file(ours) == {}
    assert "qmm_tiles" not in qm.shipped_table_path(H100) and "qmm_tiles" not in qm.table_path()
    # and a served model opens no such file
    opened = []
    real_open = builtins.open

    def spy(file, *a, **kw):
        opened.append(str(file))
        return real_open(file, *a, **kw)

    path = str(tmp_path / "llama.gguf")
    build_llama_gguf(path, n_embd=256, n_ff=512, wtype=GGMLType.Q4_K)
    monkeypatch.setattr(builtins, "open", spy)
    llm = T.AutoModelForCausalLM.from_pretrained(path, device="cpu")
    llm.eval([1, 5, 9, 11])
    assert opened and not [p for p in opened if "qmm_tiles" in p or "v5e" in p]


def test_a_non_qmm_source_moves_the_build_hash_not_the_table_hash(tmp_path, monkeypatch):
    """The tables are tied to the qmm kernels' sources only: an edit to the
    decode attention source rebuilds the kernels (a new build directory)
    but leaves every table in force; an edit to a qmm source does both."""
    import shutil

    csrc = tmp_path / "csrc"
    shutil.copytree(K.CSRC, csrc)
    monkeypatch.setattr(K, "CSRC", str(csrc))
    table, build = K._source_hash(), K._source_hash("")
    assert "attn_decode.cu" in K.SOURCES and (csrc / "attn_decode.cu").exists()
    with open(csrc / "attn_decode.cu", "a") as f:
        f.write("// an edit\n")
    assert K._source_hash() == table and K._source_hash("") != build
    build = K._source_hash("")
    with open(csrc / "qmm_common.cuh", "a") as f:
        f.write("// an edit\n")
    assert K._source_hash() != table and K._source_hash("") != build


def test_shipped_table_serves_this_checkout():
    """The table under data/ was raced on an H100 from these kernel sources:
    its header names the card, its power limit and the source hash, so it
    is in force (a changed kernel source without a new race fails here
    rather than leave the table silently ignored), and every entry is a
    candidate of its key with the times of the race."""
    path = qm.shipped_table_path(H100)
    assert path.endswith(os.path.join("ctransformers_tpu_torch", "data", "qmm_modes_h100.json"))
    doc = json.load(open(path))
    assert doc["card"] == H100 and doc["power_limit"].endswith(" W")
    assert doc["source_hash"] == K._source_hash()
    text = open(path).read().lower()
    assert "tpu" not in text.replace("ctransformers_tpu_torch", "") and "v5e" not in text
    entries = qm._parse_cache_file(path, H100)
    assert len(entries) == len(doc["modes"]) >= 129
    assert {k[4] for k in entries} == {1, 8, 128}
    for key, v in entries.items():
        rows, npad, group, has_mins, m, packed, sfactor, layout = key
        # the layout of each key (Q4_1 has GPTQ4 group 32's keys, Q5_0 Q8_0's)
        kind = {(True, 8, True): "Q4_K", (True, 0, True): "GPTQ4", (False, 16, False): "Q6_K",
                (False, 8, True): "Q5_K", (True, 0, False): "Q4_0", (False, 0, False): "Q8_0",
                (False, 0, True): "Q5_1", (True, 16, True): "Q2_K",
                (True, 16, False): "Q3_K"}[(packed, sfactor, has_mins)]
        qt = dataclasses.replace(_meta_qtensor(kind, rows * (2 if packed else 1), npad, group),
                                 pack_layout=layout)
        cands = qm.mode_candidates(qt, m)
        assert v["pick"] in cands + [qm.DENSE] and v["kernel"] in cands
        assert set(v["ms"]) == {qm.label(c) for c in cands} | {"dense"}
        assert v["ms"][qm.label(v["pick"])] == min(v["ms"].values())


# -- dispatch ----------------------------------------------------------------------


def test_autotune_races_nothing_on_the_cpu(tmp_path):
    path = str(tmp_path / "llama.gguf")
    build_llama_gguf(path, n_embd=256, n_ff=512, wtype=GGMLType.Q4_K)
    b = load_bundle(path)
    eng = Engine(b.spec, b.params, device="cpu")
    assert {"autotune_s", "autotune_raced", "autotune_warm"} <= set(eng.init_timings)
    assert eng.init_timings["autotune_raced"] == eng.init_timings["autotune_warm"] == 0
    races = qm.N_RACES
    assert qm.autotune(eng.params, (1, 8, 128)) == {"raced": 0, "warm": 0, "seconds": 0.0}
    eng.eval(list(range(1, 12)))  # chunks 8 + 2 + 1: each size tuned once, before its first chunk
    assert set(eng.autotuned) == {1, 8, 2} and qm.N_RACES == races
    assert not os.path.exists(qm.table_path())
    with pytest.raises(ValueError, match="CUDA only"):
        qm.race(1, eng.params["layers"][0]["wo"])


@pytest.mark.parametrize("kind,mode,m,kernel", [
    ("Q4_K", "g", 1, "qmm_g"), ("Q4_K", "g", 8, "qmm_g"), ("Q6_K", "", 1, "qmm_f"),
    ("Q6_K", "g", 8, "qmm_g8"), ("Q5_K", "s", 8, "qmm_s"), ("Q5_K", "", 3, "qmm_f"),
    ("Q5_K", "g", 1, "qmm_g8"), ("GPTQ4", "si", 64, "qmm_si_gptq"),
    ("GPTQ4", "g", 8, "qmm_g_gptq"), ("Q4_K", "dense", 8, "dense"),
])
def test_a_seeded_table_steers_qmatmul(kind, mode, m, kernel, monkeypatch):
    """The users' mechanism: a table file named by CT_QMM_TILE_CACHE, served
    under CT_QMM_AUTOTUNE=precompiled. The named mode runs (its plain
    version on the CPU), CT_QMM_AUTOTUNE=0 ignores the table, and a key the
    table does not hold takes select_mode's pick."""
    qt = _gptq_qtensor() if kind == "GPTQ4" else _real_qtensor(kind)
    qm.save_table(qm.table_path(), "cpu", {qm.cache_key(m, qt): _entry(mode, qt)})
    monkeypatch.setenv("CT_QMM_AUTOTUNE", "precompiled")
    x = torch.from_numpy(np.random.RandomState(m).randn(m, 512).astype(np.float32))
    exact = x @ qm.dequantize_qtensor(qt)

    def calls():
        return {k: v for k, v in dict(K.PLAIN_CALLS, **K.DENSE_CALLS).items() if v}

    K.reset_counts()
    out = qm.qmatmul(x, qt)
    assert calls() == {kernel: 1} and sum(K.LAUNCHES.values()) == 0
    err = float(torch.linalg.norm(out - exact) / torch.linalg.norm(exact))
    assert err < (2e-4 if mode in ("", "s") else 0.025), err
    rule = K.kernel_name(qm.select_mode(m, qt), qt)
    K.reset_counts()
    qm.qmatmul(x[:1].repeat(2, 1), qt)  # m = 2: not in the table
    assert calls() == {K.kernel_name(qm.select_mode(2, qt), qt): 1}
    monkeypatch.setenv("CT_QMM_AUTOTUNE", "0")
    K.reset_counts()
    qm.qmatmul(x, qt)
    assert calls() == {rule: 1}


def test_ct_qmatmul_keeps_its_meaning(monkeypatch):
    """dense: never a kernel; kernels: never the dense candidate, a key whose
    champion is dense takes its best hand-written kernel."""
    qt = _real_qtensor("Q5_K")
    x = torch.from_numpy(np.random.RandomState(0).randn(64, 512).astype(np.float32))
    exact = x @ qm.dequantize_qtensor(qt)
    entry = dict(_entry("dense", qt), kernel=("b", K.CONFIG_OF["qmm_b"]))
    qm.save_table(qm.table_path(), "cpu", {qm.cache_key(64, qt): entry})
    monkeypatch.setenv("CT_QMM_AUTOTUNE", "precompiled")
    K.reset_counts()
    out = qm.qmatmul(x, qt)
    assert K.DENSE_CALLS["dense"] == 1 and sum(K.PLAIN_CALLS.values()) == 0
    assert float(torch.linalg.norm(out - exact) / torch.linalg.norm(exact)) < 0.025
    monkeypatch.setenv("CT_QMATMUL", "kernels")
    qm.qmatmul(x, qt)
    assert K.DENSE_CALLS["dense"] == 1 and K.PLAIN_CALLS["qmm_b"] == 1
    monkeypatch.setenv("CT_QMATMUL", "dense")
    monkeypatch.setenv("CT_QMM_AUTOTUNE", "0")
    qm.qmatmul(x[:1], qt)
    assert K.DENSE_CALLS["dense"] == 2 and sum(K.PLAIN_CALLS.values()) == 1


@pytest.mark.parametrize("kind", ["Q4_K", "Q6_K", "Q5_K", "GPTQ4"])
@pytest.mark.parametrize("m", [1, 8, 64])
def test_dense_candidate_matches_the_jax_bf16_path(kind, m):
    """_qmm_dense against the JAX package's _qmm_jnp in bf16 (its XLA
    candidate) on the same planes: bf16 operands, f32 sums."""
    import jax.numpy as jnp

    qt = _gptq_qtensor() if kind == "GPTQ4" else _real_qtensor(kind)
    arr = lambda t: None if t is None else jnp.asarray(t.numpy())  # noqa: E731
    jq = jqm.QTensor(arr(qt.qs), arr(qt.scales), arr(qt.mins), qt.kind, qt.group, qt.shape,
                     qt.packed, qt.zp, sd=arr(qt.sd), sm=arr(qt.sm), sfactor=qt.sfactor,
                     pack_layout=qt.pack_layout)
    x = np.random.RandomState(m).randn(m, 512).astype(np.float32)
    got = qm._qmm_dense(torch.from_numpy(x), qt)[:, :384].numpy()
    ref = np.asarray(jqm._qmm_jnp(jnp.asarray(x), jq, compute_dtype=jnp.bfloat16))
    assert float(np.linalg.norm(got - ref) / np.linalg.norm(ref)) < 1e-5
