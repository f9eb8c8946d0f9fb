"""The port's QTensor repack and the kernels' plain versions against the JAX
package: planes byte for byte (Q4_K, Q6_K, Q5_K), and each plain version
against the Pallas kernel it replaces, run in interpret mode as
tests/test_qmatmul.py runs it.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctransformers_tpu.formats.quants import GGMLType, quantize
from ctransformers_tpu.ops import qmatmul as jqm
from ctransformers_tpu_torch.models.convert import from_jax_params
from ctransformers_tpu_torch.ops import qmatmul as tqm
from ctransformers_tpu_torch.ops import qmm_kernels as K

PLANES = ("qs", "scales", "mins", "sd", "sm")


def _kq_bytes(k, n, seed, kind="Q4_K"):
    rng = np.random.RandomState(seed)
    w = (rng.randn(k, n) * 0.3).astype(np.float32)
    return quantize(np.ascontiguousarray(w.T), GGMLType[kind])  # (n rows, k cols)


def _both(k, n, seed, monkeypatch, layout="adjk", kind="Q4_K"):
    """The same k-quant bytes repacked by the JAX package and by the port."""
    monkeypatch.setenv("CT_PACK4_LAYOUT", layout)
    buf = _kq_bytes(k, n, seed, kind)
    jq = jqm.repack(buf, GGMLType[kind], n, k)
    if kind == "Q4_K":
        assert jq.pack_layout == layout
    return jq, tqm.repack(buf, GGMLType[kind], n, k)


def _assert_planes_equal(jq, tq):
    for f in PLANES:
        a, b = getattr(jq, f), getattr(tq, f)
        if a is None or b is None:  # Q6_K has no mins
            assert a is None and b is None, f
            continue
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8), err_msg=f)
    assert (tq.kind, tq.group, tq.shape, tq.packed, tq.zp, tq.sfactor) == (
        jq.kind, jq.group, jq.shape, jq.packed, jq.zp, jq.sfactor
    )


@pytest.mark.parametrize("k,n", [(256, 384), (512, 256), (512, 96)])
def test_repack_planes_and_dequantize_bit_exact(k, n, monkeypatch):
    jq, tq = _both(k, n, seed=k + n, monkeypatch=monkeypatch)
    _assert_planes_equal(jq, tq)
    np.testing.assert_array_equal(
        tqm.dequantize_qtensor(tq).numpy(), np.asarray(jqm.dequantize_qtensor(jq))
    )
    np.testing.assert_array_equal(
        tqm.unpack_grid(tq).numpy(), np.asarray(jqm.unpack_grid(jq))
    )


@pytest.mark.parametrize("kind", ["Q6_K", "Q5_K"])
@pytest.mark.parametrize("k,n", [(256, 384), (512, 96), (1280, 256)])
def test_grid_repack_planes_and_dequantize_bit_exact(kind, k, n, monkeypatch):
    """int8-grid planes equal the JAX repack's byte for byte, with and
    without mins (Q5_K, Q6_K), including the 1024-padding of a long K."""
    jq, tq = _both(k, n, seed=k + n, monkeypatch=monkeypatch, kind=kind)
    assert not tq.packed and tq.qs.shape[0] == jq.qs.shape[0]
    _assert_planes_equal(jq, tq)
    np.testing.assert_array_equal(
        tqm.dequantize_qtensor(tq).numpy(), np.asarray(jqm.dequantize_qtensor(jq))
    )
    np.testing.assert_array_equal(tqm.unpack_grid(tq).numpy(), np.asarray(jqm.unpack_grid(jq)))


@pytest.mark.parametrize("kind", ["Q6_K", "Q5_K"])
def test_from_jax_params_carries_int8_grids(kind, monkeypatch):
    jq, tq = _both(512, 384, seed=9, monkeypatch=monkeypatch, kind=kind)
    got = from_jax_params({"lm_head": jq})["lm_head"]
    assert (got.kind, got.group, got.sfactor, got.packed) == (tq.kind, tq.group, tq.sfactor, False)
    for f in PLANES:
        a, b = getattr(got, f), getattr(tq, f)
        assert (a is None and b is None) or torch.equal(a, b), f


def test_from_jax_params_converts_ksplit_to_adjk(monkeypatch):
    _, tq = _both(512, 384, seed=5, monkeypatch=monkeypatch)
    jq_ksplit, _ = _both(512, 384, seed=5, monkeypatch=monkeypatch, layout="ksplit")
    jq_adjk, _ = _both(512, 384, seed=5, monkeypatch=monkeypatch, layout="adjk")
    params = {"layers": [{"wq": jq_ksplit, "ln1_g": np.ones(4, np.float32)}],
              "lm_head": jq_adjk}
    conv = from_jax_params(params)
    for got in (conv["layers"][0]["wq"], conv["lm_head"]):
        assert got.pack_layout == "adjk"
        for f in PLANES:
            assert torch.equal(getattr(got, f), getattr(tq, f)), f
    assert torch.equal(conv["layers"][0]["ln1_g"], torch.ones(4))


def _pallas(mode, x, jq, m):
    """The Pallas kernel of `mode` in interpret mode on x zero-padded to 8
    rows and the storage rows, with a tile of that mode's candidates."""
    rows, npad = jq.qs.shape
    tk, tn, inner, _ = next(
        c for c in jqm._tile_candidates(rows, npad, jq.packed, jq.pack_layout)
        if c[3] == mode
    )
    xp = np.zeros((max(8, m), rows * (2 if jq.packed else 1)), np.float32)
    xp[:m, : x.shape[1]] = x
    out = jqm._qmm_pallas_tiled(
        jnp.asarray(xp), jq, tk, tn, inner, interpret=True, mode=mode, rm=m
    )
    return np.asarray(out)[:m, : jq.shape[1]]


def _port(mode, x, tq):
    xp = torch.zeros((x.shape[0], tq.qs.shape[0] * (2 if tq.packed else 1)))
    xp[:, : x.shape[1]] = torch.from_numpy(x)
    fn = getattr(K, K.kernel_name(mode, tq))
    if mode in ("q", "q8"):
        out = fn(*K.quantize_activations(xp, tq.group), tq)
    else:
        out = fn(xp, tq)
    return out[:, : tq.shape[1]].numpy()


def _fro(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("mode", ["qx", "q", "si", "i"])
@pytest.mark.parametrize("m", [1, 3, 8, 64])
@pytest.mark.parametrize("k,n", [(512, 384), (256, 256)])
def test_plain_version_matches_pallas_kernel(mode, m, k, n, monkeypatch):
    jq, tq = _both(k, n, seed=7, monkeypatch=monkeypatch)
    x = (np.random.RandomState(m).randn(m, k) * 0.5).astype(np.float32)
    name = f"qmm_{mode}"
    before = dict(K.PLAIN_CALLS), dict(K.LAUNCHES)
    got = _port(mode, x, tq)
    assert K.PLAIN_CALLS[name] == before[0][name] + 1
    assert K.LAUNCHES == before[1]  # no kernel launch on a CPU tensor
    ref = _pallas(mode, x, jq, m)
    # same algorithm, same roundings: only the f32 summation order differs
    # (measured ~1e-7)
    assert _fro(got, ref) <= 1e-4
    # error classes of tests/test_qmatmul.py against the exact f32 product:
    # int8 activations (q, qx) 3.5%, bf16 operands (i, si) 2.5%
    exact = np.asarray(jqm._qmm_jnp(x, jq))
    bound = 0.035 if "q" in mode else 0.025
    assert _fro(got, exact) < bound
    assert _fro(ref, exact) < bound


@pytest.mark.parametrize("kind", ["Q6_K", "Q5_K"])
@pytest.mark.parametrize("m", [1, 3, 8, 64])
@pytest.mark.parametrize("k,n", [(512, 384), (256, 256)])
def test_grid_plain_versions_match_pallas_kernels(kind, m, k, n, monkeypatch):
    """plain_q8, plain_b and plain_sb against _qmm_q_kernel (packed4=False),
    _qmm_kernel and _qmm_s_kernel on the same int8-grid planes."""
    jq, tq = _both(k, n, seed=7, monkeypatch=monkeypatch, kind=kind)
    x = (np.random.RandomState(m).randn(m, k) * 0.5).astype(np.float32)
    exact = np.asarray(jqm._qmm_jnp(x, jq))
    for mode, pallas_mode in (("q8", "q"), ("b", "b"), ("sb", "sb")):
        name = f"qmm_{mode}"
        before = dict(K.PLAIN_CALLS), dict(K.LAUNCHES)
        got = _port(mode, x, tq)
        assert K.PLAIN_CALLS[name] == before[0][name] + 1
        assert K.LAUNCHES == before[1]  # no kernel launch on a CPU tensor
        ref = _pallas(pallas_mode, x, jq, m)
        # same algorithm, same roundings: only the f32 summation order differs
        assert _fro(got, ref) <= 1e-4, mode
        # error classes of tests/test_qmatmul.py against the exact f32 product
        bound = 0.035 if mode == "q8" else 0.025
        print(f"{kind} {mode} m={m} K={k} N={n}: vs Pallas {_fro(got, ref):.2e}, "
              f"vs exact {_fro(got, exact):.4f}")
        assert _fro(got, exact) < bound, mode
        assert _fro(ref, exact) < bound, mode


@pytest.mark.parametrize("kind,mode", [("Q4_K", "g"), ("Q6_K", "g"), ("Q5_K", "g"),
                                       ("Q6_K", ""), ("Q5_K", ""), ("Q5_K", "s")])
@pytest.mark.parametrize("m", [1, 3, 8, 32])
@pytest.mark.parametrize("k,n", [(512, 384), (256, 256)])
def test_raced_modes_plain_versions_match_pallas_kernels(kind, mode, m, k, n, monkeypatch):
    """plain_g, plain_f and plain_s (the candidates the race adds at m <=
    32) against _qmm_g_kernel, _qmm_kernel and _qmm_s_kernel with f32 dots,
    in interpret mode on the same planes."""
    jq, tq = _both(k, n, seed=7, monkeypatch=monkeypatch, kind=kind)
    x = (np.random.RandomState(m).randn(m, k) * 0.5).astype(np.float32)
    name = K.kernel_name(mode, tq)
    assert name == {"g": "qmm_g" if tq.packed else "qmm_g8", "": "qmm_f", "s": "qmm_s"}[mode]
    before = dict(K.PLAIN_CALLS), dict(K.LAUNCHES)
    got = _port(mode, x, tq)
    assert K.PLAIN_CALLS[name] == before[0][name] + 1
    assert K.LAUNCHES == before[1]  # no kernel launch on a CPU tensor
    ref = _pallas(mode, x, jq, m)
    exact = np.asarray(jqm._qmm_jnp(x, jq))
    print(f"{kind} {mode!r} m={m} K={k} N={n}: vs Pallas {_fro(got, ref):.2e}, "
          f"vs exact {_fro(got, exact):.2e}")
    # the classes of tests/test_qmatmul.py: 2e-4 for the f32-dequant modes,
    # the bf16 class for the grouped dot (x rounded to bf16); the same
    # algorithm and roundings, so far inside both (only f32 sums reorder)
    assert _fro(got, ref) <= (0.025 if mode == "g" else 2e-4)
    assert _fro(got, ref) <= 1e-4
    bound = 0.025 if mode == "g" else 2e-4
    assert _fro(got, exact) < bound
    assert _fro(ref, exact) < bound


def _meta_qtensor(kind, kp, npad):
    """A QTensor of `kind`'s layout at padded (kp, npad), planes on the meta
    device (select_mode reads only the layout)."""
    group, sfactor, has_mins, packed = K.LAYOUTS[kind]
    e = lambda *s: torch.empty(s, dtype=torch.int8, device="meta")  # noqa: E731
    mins = e(kp // group, npad) if has_mins else None
    return tqm.QTensor(e(kp // 2 if packed else kp, npad), e(kp // group, npad), mins,
                       kind, group, (kp, npad), packed, sfactor=sfactor)


def _case(m, kp, npad, mode, kind="Q4_K"):
    # the Q4_K cases keep the ids they had before select_mode took the weight
    tag = f"{m}-{kp}-{npad}-{mode}" + ("" if kind == "Q4_K" else f"-{kind}")
    return pytest.param(m, kp, npad, mode, kind, id=tag)


@pytest.mark.parametrize(
    "m,kp,npad,mode,kind",
    [_case(1, 4096, 12288, "qx"), _case(8, 4096, 4096, "q"), _case(32, 11264, 4096, "q"),
     _case(33, 4096, 22528, "si"), _case(128, 4096, 4096, "i"), _case(128, 11264, 4096, "i"),
     _case(1, 4096, 32768, "q8", "Q6_K"), _case(8, 11264, 4096, "q8", "Q6_K"),
     _case(32, 4096, 4096, "q8", "Q5_K"), _case(33, 4096, 4096, "b", "Q6_K"),
     _case(128, 11264, 4096, "b", "Q6_K"), _case(128, 4096, 12288, "sb", "Q5_K"),
     _case(128, 11264, 4096, "sb", "Q5_K"),
     _case(1, 4096, 12288, "qx", "GPTQ4"), _case(2, 4096, 4096, "q", "GPTQ4"),
     _case(32, 11264, 4096, "q", "GPTQ4"), _case(33, 4096, 22528, "i", "GPTQ4"),
     _case(128, 11264, 4096, "i", "GPTQ4")],
)
def test_select_mode(m, kp, npad, mode, kind):
    assert tqm.select_mode(m, _meta_qtensor(kind, kp, npad)) == mode


def test_qmatmul_pads_and_slices(monkeypatch):
    jq, tq = _both(512, 96, seed=3, monkeypatch=monkeypatch)
    x = np.random.RandomState(0).randn(2, 5, 512).astype(np.float32)
    got = tqm.matmul(torch.from_numpy(x), tq)
    assert got.shape == (2, 5, 96)
    exact = np.asarray(jqm._qmm_jnp(x.reshape(10, 512), jq)).reshape(2, 5, 96)
    assert _fro(got.numpy(), exact) < 0.035


def test_fuse_layer_params_matches_jax(monkeypatch):
    jqs, tqs = zip(*(_both(512, n, seed=n, monkeypatch=monkeypatch) for n in (256, 128, 128)))
    jlayer = {"wq": jqs[0], "wk": jqs[1], "wv": jqs[2]}
    tlayer = {"wq": tqs[0], "wk": tqs[1], "wv": tqs[2]}
    assert jqm.fuse_layer_params({"layers": [jlayer]}) == 1
    assert tqm.fuse_layer_params({"layers": [tlayer]}) == 1
    jf, tf = jlayer["w_qkv"], tlayer["w_qkv"]
    _assert_planes_equal(jf, tf)
    assert tf.splits == jf.splits
    out = torch.arange(3 * 512.0).reshape(3, 512)
    parts = tqm.split_fused(out, tf)
    assert [p.shape[-1] for p in parts] == [256, 128, 128]


def test_wrappers_check_operands(monkeypatch):
    _, tq = _both(256, 128, seed=1, monkeypatch=monkeypatch)
    with pytest.raises(ValueError):
        K.qmm_qx(torch.zeros(1, 255), tq)  # not the padded K
    with pytest.raises(ValueError):
        K.qmm_i(torch.zeros(2, 256, dtype=torch.float64), tq)
    with pytest.raises(NotImplementedError):
        K.qmm_si(torch.zeros(2, 256), dataclasses.replace(tq, kind="Q6_K"))
