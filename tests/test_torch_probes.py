"""The probe kernels of the port (ops/probes.py) against the Pallas kernels of
scripts/probe_*.py on the CPU: the same seeded numpy inputs go through each
Pallas kernel in interpret mode and through the port's plain version (the
function its Hopper kernel computes). Module-level kernels are called as
they are; the kernels built inside a cheap main() (probe_int8_dot.py,
probe_bf16_dot.py) are recorded while main() runs with pl.pallas_call (or
the script's probe()) forced to interpret mode; the kernels that are
closures of a main() that builds 7B planes (probe_mmvq.py, probe_q3.py,
probe_q5.py, probe_q5b.py, probe_dma.py) are taken from the script's
source by name and run at a small shape. Then the port's probe scripts
(scripts/torch_probe_*.py) run end to end on the CPU at small shapes.

Classes: integer results and the qp forms against the q form bit for bit;
f32 sums in another order 1e-6 and bf16-operand dots 1e-5 of the largest
reference value; the byte stream 1e-5 of a float64 sum (the Pallas kernel
sums in f32, inexact above 2**24)."""

import ast
import functools
import importlib.util
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from ctransformers_tpu_torch.ops import probes as P
from ctransformers_tpu_torch.ops import qmm_kernels as K

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")


def load_script(name: str):
    spec = importlib.util.spec_from_file_location(f"_probe_script_{name}",
                                                  os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def nested_fn(script: str, name: str, **env):
    """The function `name` defined inside a function of scripts/<script>.py,
    compiled from the script's own source with the names of its enclosing
    scope given in env (the script itself is not edited)."""
    path = os.path.join(SCRIPTS, f"{script}.py")
    src = open(path).read()
    hits = [n for n in ast.walk(ast.parse(src)) if isinstance(n, ast.FunctionDef) and n.name == name]
    assert len(hits) == 1, (script, name, len(hits))
    ns = dict(jax=jax, jnp=jnp, pl=pl, pltpu=pltpu, np=np, **env)
    exec(compile(textwrap.dedent(ast.get_source_segment(src, hits[0])), path, "exec"), ns)
    return ns[name]


def T(a) -> torch.Tensor:
    """A numpy (or jax) array as a CPU tensor; bf16 by way of exact f32."""
    a = np.asarray(a)
    if str(a.dtype) == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def assert_close(port: torch.Tensor, pallas, tol: float) -> None:
    ref = np.asarray(pallas)
    got = port.numpy() if port.dtype != torch.bfloat16 else port.float().numpy()
    if tol == 0:
        assert got.dtype == ref.dtype and np.array_equal(got, ref), np.abs(
            got.astype(np.float64) - ref).max()
        return
    d = np.abs(got.astype(np.float64) - ref.astype(np.float64)).max()
    assert d <= tol * np.abs(ref.astype(np.float64)).max(), d


# -- probe_int8_dot.py: main() with the script's probe() in interpret mode ----


@pytest.fixture(scope="module")
def int8_dot_calls():
    mod = load_script("probe_int8_dot")
    calls = {}

    def probe(name, kernel, out_shape, *args):  # probe_int8_dot.py:27-37, interpreted
        out = pl.pallas_call(kernel, out_shape=out_shape, interpret=True)(*args)
        calls[name] = (args, out)
        return True

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod, "probe", probe)
        mod.main()
    return calls


INT8_DOT = {
    "int8 x int8 -> int32 dot": (lambda x, w: P.plain_probe_dot(x, w, "s8"), 0),
    "int8 x int8 -> f32 dot": (
        lambda x, w: P.plain_probe_dot(x, w, "s8", out_dtype=torch.float32), 0),
    "f32 x int8 mixed dot": (lambda x, w: P.plain_probe_dot(x, w, "f32"), 1e-6),
    "batched per-group f32 dot (ng,M,G)x(ng,G,N)": (lambda x, w: P.plain_probe_dot(x, w, "f32"), 1e-6),
    "batched per-group dot, i8 w cast in-kernel": (lambda x, w: P.plain_probe_dot(x, w, "f32"), 1e-6),
    "bf16 x bf16 -> f32 dot": (lambda x, w: P.plain_probe_dot(x, w, "bf16"), 1e-5),
    "f32-cast-to-bf16 dot": (lambda x, w: P.plain_probe_dot(x, w, "bf16"), 1e-5),
    "per-group rescale epilogue sum": (P.plain_probe_rescale, 1e-6),
}


@pytest.mark.parametrize("name", list(INT8_DOT))
def test_int8_dot_probe_matches_pallas(int8_dot_calls, name):
    args, out = int8_dot_calls[name]
    fn, tol = INT8_DOT[name]
    assert_close(fn(*(T(a) for a in args)), out, tol)


def test_int8_dot_records_every_probe(int8_dot_calls):
    assert set(int8_dot_calls) == set(INT8_DOT)


# -- probe_bf16_dot.py: main() with pl.pallas_call forced to interpret ------


@pytest.fixture(scope="module")
def bf16_dot_calls():
    mod = load_script("probe_bf16_dot")
    calls = {}
    real = pl.pallas_call

    def pallas_call(kernel, **kw):
        f = real(kernel, interpret=True, **kw)

        def call(*args):
            out = f(*args)
            calls[kernel.__name__] = (args, out)
            return out

        return call

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", pallas_call)
        mod.main()
    return calls


TK = 1024
BF16_DOT = {  # kA-kF (probe_bf16_dot.py:34-125) as probe_dot's steps and rhs
    "kA": dict(k_step=TK),
    "kB": dict(steps=2, k_step=TK // 2, x_step=TK // 2, w_step=TK // 2),
    "kC": dict(k_step=TK, floor=True),
    "kD": dict(steps=2, k_step=TK, x_step=TK, w_step=TK),
    "kE": dict(steps=2, k_step=TK, x_step=TK, twice=True),
    "kF": dict(k_step=TK),
}


@pytest.mark.parametrize("kernel", list(BF16_DOT))
def test_bf16_dot_probe_matches_pallas(bf16_dot_calls, kernel):
    (x, w), out = bf16_dot_calls[kernel]
    assert_close(P.plain_probe_dot(T(x), T(w), "bf16", **BF16_DOT[kernel]), out, 1e-5)


# -- probe_int4.py: its module-level kernels --------------------------------


@pytest.fixture(scope="module")
def int4():
    mod = load_script("probe_int4")
    rng = np.random.default_rng(0)  # probe_int4.py:121-133
    kb, n = 256, 1024
    w4 = rng.integers(-8, 8, (2 * kb, n), dtype=np.int32)
    qs = mod.pack_adjacent_k(w4)
    xf = rng.standard_normal((8, 2 * kb)).astype(np.float32)
    x = jnp.asarray(xf, jnp.bfloat16)
    xi8 = np.clip(np.round(xf * 10), -127, 127).astype(np.int8)
    return mod, w4, qs, x, xi8


def test_int4_host_helpers_match(int4):
    mod, w4, qs, _, _ = int4
    assert np.array_equal(P.pack_adjacent_k(w4), qs)
    assert np.array_equal(K.unpack_w4(T(qs)).numpy(), mod.unpack_ref(qs))
    assert np.array_equal(P.unpack_s8_grid(T(qs)).numpy(),
                          load_script("probe_q3").pltpu_unpack(qs))


INT4 = {  # kernel -> (consumer, unpack, activations, out rows, class)
    "_kernel_i4_cast": ("colsum", "i4", None, 1, 0),
    "_kernel_i4_cast_bf16": ("colsum", "i4", None, 1, 0),
    "_kernel_i4_dot": ("dot_bf16", "i4", "x", 8, 1e-5),
    "_kernel_i4_dot_int8": ("dot_s8", "i4", "xi8", 8, 0),
    "_kernel_floor_dot": ("dot_bf16", "floor", "x", 8, 1e-5),
}


@pytest.mark.parametrize("kernel", list(INT4))
def test_int4_probe_matches_pallas(int4, kernel):
    mod, _, qs, x, xi8 = int4
    consumer, unpack, act, rows, tol = INT4[kernel]
    a = {"x": x, "xi8": xi8}.get(act)
    args = (jnp.asarray(qs),) if a is None else (jnp.asarray(a), jnp.asarray(qs))
    out = pl.pallas_call(getattr(mod, kernel), interpret=True,
                         out_shape=jax.ShapeDtypeStruct((rows, qs.shape[1]), jnp.float32))(*args)
    assert_close(P.plain_probe_nibble(T(qs), unpack, consumer, None if a is None else T(a)), out, tol)


@pytest.mark.parametrize("kernel", ["_kernel_i4_dot", "_kernel_floor_dot"])
def test_int4_tiled_probe_matches_pallas(int4, kernel):
    """The timed call (probe_int4.py:159-168): column tiles of 1408 over a
    wider tile, here 64 byte rows by two tiles."""
    mod = int4[0]
    rng = np.random.default_rng(1)
    kb, n = 64, 2 * 1408
    qs = rng.integers(-128, 128, (kb, n), dtype=np.int8)
    x = jnp.asarray(rng.standard_normal((8, 2 * kb)).astype(np.float32), jnp.bfloat16)
    out = pl.pallas_call(
        getattr(mod, kernel), grid=(n // 1408,), interpret=True,
        in_specs=[pl.BlockSpec((8, 2 * kb), lambda i: (0, 0)),
                  pl.BlockSpec((kb, 1408), lambda i: (0, i))],
        out_specs=pl.BlockSpec((8, 1408), lambda i: (0, i)),
        out_shape=jax.ShapeDtypeStruct((8, n), jnp.float32))(x, jnp.asarray(qs))
    unpack = "i4" if kernel == "_kernel_i4_dot" else "floor"
    assert_close(P.plain_probe_nibble(T(qs), unpack, "dot_bf16", T(x)), out, 1e-5)


# -- probe_q5.py: the SWAR planes and the int16 dots --------------------------


def test_swar_planes_match_pallas():
    mod = load_script("probe_q5")

    def k_swar(q_ref, o_ref):  # probe_q5.py:95-97
        lo, hi = mod.swar_planes(pl, pltpu, q_ref[...])
        o_ref[...] = lo.astype(jnp.int32) + hi.astype(jnp.int32)

    q = np.random.default_rng(0).integers(-128, 128, (32, 128), dtype=np.int8)
    out = pl.pallas_call(k_swar, out_shape=jax.ShapeDtypeStruct((32, 128), jnp.int32),
                         interpret=True)(jnp.asarray(q))
    assert_close(P.plain_probe_nibble(T(q), "swar", "planes"), out, 0)
    lo, hi = P.swar_planes(T(q))
    assert torch.equal(lo.int() + hi.int(), T(np.asarray(out)))


@pytest.mark.parametrize("wtype", ["int8", "int16"])
def test_int16_dots_match_pallas(wtype):
    k_i16i8 = nested_fn("probe_q5", "k_i16i8")
    rng = np.random.default_rng(0)
    a = rng.integers(-32768, 32768, (8, 256), dtype=np.int16)
    # int16 weights bounded so that no int32 sum overflows (|sum| < 2**31)
    b = (rng.integers(-128, 128, (256, 128), dtype=np.int8) if wtype == "int8"
         else rng.integers(-255, 256, (256, 128), dtype=np.int16))
    out = pl.pallas_call(k_i16i8, out_shape=jax.ShapeDtypeStruct((8, 128), jnp.int32),
                         interpret=True)(jnp.asarray(a), jnp.asarray(b))
    assert_close(P.plain_probe_dot(T(a), T(b), "s16"), out, 0)


# -- probe_mmvq.py: its nested kernels at the script's small shape ------------


@pytest.fixture(scope="module")
def mmvq():
    rng = np.random.default_rng(0)  # probe_mmvq.py:52-67
    M, Kk, N, G = 8, 512, 256, 32
    ng = Kk // G
    packed = rng.integers(0, 256, (Kk // 2, N), np.uint8)
    xq = rng.integers(-127, 127, (M, Kk), np.int8)
    xg = np.ascontiguousarray(xq.reshape(M, ng, G).transpose(1, 0, 2))
    s = rng.random((ng, N), np.float32)
    sx = rng.random((ng, M), np.float32)
    env = dict(ng=ng, G=G, N=N)
    return env, packed, xq, xg, s, sx


def test_mmvq_grouped_x_matches(mmvq):
    _, _, xq, xg, _, _ = mmvq
    assert np.array_equal(P.group_x(T(xq)).numpy(), xg)


MMVQ = {  # nested kernel -> (consumer, out shape, class)
    "k_reshape": ("gcolsum", lambda ng, M, N: (ng, N), jnp.float32, 0),
    "k_grouped_i8": ("gdot_s8", lambda ng, M, N: (ng, M, N), jnp.int32, 0),
    "k_full": ("gdot", lambda ng, M, N: (M, N), jnp.float32, 1e-6),
}


@pytest.mark.parametrize("kernel", list(MMVQ))
def test_mmvq_probe_matches_pallas(mmvq, kernel):
    env, packed, _, xg, s, sx = mmvq
    consumer, shape, dt, tol = MMVQ[kernel]
    fn = nested_fn("probe_mmvq", kernel, **env)
    qs = packed.view(np.int8)
    args = {"k_reshape": (qs,), "k_grouped_i8": (xg, qs), "k_full": (xg, qs, s, sx)}[kernel]
    out = pl.pallas_call(fn, out_shape=jax.ShapeDtypeStruct(shape(env["ng"], 8, env["N"]), dt),
                         interpret=True)(*(jnp.asarray(a) for a in args))
    kw = dict(sx=T(sx), s=T(s)) if consumer == "gdot" else {}
    x = None if consumer == "gcolsum" else T(xg)
    assert_close(P.plain_probe_nibble(T(qs), "i4", consumer, x, **kw), out, tol)


@pytest.mark.parametrize("m", [1, 8])
def test_mmvq_kernel_matches_pallas(m):
    """mmvq_kernel (probe_mmvq.py:174-183, grid :186-199) on a small Q4_K
    weight of the port, activations quantized by the script's formula
    (:152-166); at m = 1 the script pads to 8 identical rows, the port
    computes one and each padded row is held against it."""
    k, n, G, TN = 512, 256, 32, 128
    qt, sp = P.q4k_weight(k, n, 3, "cpu")
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((m, k)) * 0.5).astype(np.float32)
    ng2, mp = k // G, 8
    xr = x.reshape(m, ng2, G)
    xq2 = np.clip(np.round(xr / np.maximum(np.abs(xr).max(-1, keepdims=True), 1e-8) * 127.0),
                  -127, 127).astype(np.int8)
    sxv = (np.abs(xr).max(-1) / 127.0).astype(np.float32)
    xg_p, sx_p = P.quant_mmvq(T(x))
    assert np.array_equal(xg_p.numpy(), xq2.transpose(1, 0, 2)) and np.array_equal(sx_p.numpy(), sxv.T)
    xg2 = np.ascontiguousarray(np.broadcast_to(xq2, (mp, ng2, G)).transpose(1, 0, 2)
                               if m < mp else xq2.transpose(1, 0, 2))
    sx2 = np.ascontiguousarray(np.broadcast_to(sxv, (mp, ng2)).T if m < mp else sxv.T)
    fn = nested_fn("probe_mmvq", "mmvq_kernel", ng2=ng2, G=G, TN=TN)
    qs = qt.qs.numpy()
    out = np.asarray(pl.pallas_call(
        fn, grid=(n // TN,), interpret=True,
        in_specs=[pl.BlockSpec((ng2, mp, G), lambda i: (0, 0, 0)),
                  pl.BlockSpec((ng2, mp), lambda i: (0, 0)),
                  pl.BlockSpec((qs.shape[0], TN), lambda i: (0, i)),
                  pl.BlockSpec((ng2, TN), lambda i: (0, i))],
        out_specs=pl.BlockSpec((mp, TN), lambda i: (0, i)),
        out_shape=jax.ShapeDtypeStruct((mp, n), jnp.float32),
    )(jnp.asarray(xg2), jnp.asarray(sx2), jnp.asarray(qs), jnp.asarray(sp.numpy())))
    port = P.plain_probe_nibble(qt.qs, "i4", "gdot", xg_p, sx=sx_p, s=sp)
    for row in range(mp):
        assert_close(port[min(row, m - 1):min(row, m - 1) + 1], out[row:row + 1], 1e-6)


# -- probe_q3.py: the stage ablation kernel -----------------------------------


@pytest.fixture(scope="module")
def q3():
    """A small Q4_K weight of the port and one row quantized by the
    script's formula (probe_q3.py:66-76)."""
    k, n = 1024, 256
    qt, sp = P.q4k_weight(k, n, 4, "cpu")
    x = (np.random.default_rng(5).standard_normal((1, k)) * 0.5).astype(np.float32)
    g = 32
    ng = k // g
    gmax = np.abs(x.reshape(1, ng, g)).max(-1) + 1e-12
    sx = (gmax / 127.0).astype(np.float32)
    xq = np.clip(np.round(x.reshape(1, ng, g) / sx[:, :, None]), -127, 127).astype(np.int8)
    xg = np.ascontiguousarray(xq.transpose(1, 0, 2))
    xg_p, sx_p = P.quant_q3(T(x))
    assert np.array_equal(xg_p.numpy(), xg) and np.array_equal(sx_p.numpy(), sx.T)
    return qt, sp, xg, np.ascontiguousarray(sx.T), k, n


def q3_call(kern, qs_in, tks, tk, tn, k, n, g=32):
    """probe_q3.py:138-157's pallas_call at a small tile."""
    nk, nn = qs_in.shape[0] // tks, n // tn
    return pl.pallas_call(
        kern, grid=(nn, nk), interpret=True,
        in_specs=[pl.BlockSpec((2 * tk // g, 1, g), lambda i, j: (j, 0, 0)),
                  pl.BlockSpec((2 * tk // g, 1), lambda i, j: (j, 0)),
                  pl.BlockSpec((tks, tn), lambda i, j: (j, i)),
                  pl.BlockSpec((2 * tk // g, tn), lambda i, j: (j, i))],
        out_specs=pl.BlockSpec((1, tn), lambda i, j: (0, i)),
        out_shape=jax.ShapeDtypeStruct((1, n), jnp.float32))


@pytest.mark.parametrize("stage", ["full", "nodot", "norescale"])
def test_q3_stage_matches_pallas(q3, stage):
    qt, sp, xg, sx, k, n = q3
    tk, tn, inner = 128, 128, 4
    kern = functools.partial(nested_fn("probe_q3", "kern", inner=inner, g=32), stage=stage)
    qs = qt.qs.numpy()
    out = q3_call(kern, qs, tk, tk, tn, k, n)(jnp.asarray(xg), jnp.asarray(sx), jnp.asarray(qs),
                                              jnp.asarray(sp.numpy()))
    scaled = stage != "norescale"
    port = P.plain_probe_nibble(qt.qs, "i4", "gdot", None if stage == "nodot" else T(xg),
                                sx=T(sx) if scaled else None, s=sp if scaled else None, stage=stage)
    assert_close(port, out, 1e-6 if scaled else 0)


def test_q3_nocast_matches_pallas(q3):
    """The nocast stage: the int8 grid unpacked on the host (pltpu_unpack,
    probe_q3.py:165), twice the rows a tile. probe_q3.py's kern takes every
    tile for nibbles (tkr = 2 * tks, :87), so over an int8 tile its inner
    chunks would reach past the tile; held here with the grid's rows a tile
    (tkr = tks), the rest of the body as the script's."""
    qt, sp, xg, sx, k, n = q3
    src = ast.get_source_segment(open(os.path.join(SCRIPTS, "probe_q3.py")).read(), next(
        f for f in ast.walk(ast.parse(open(os.path.join(SCRIPTS, "probe_q3.py")).read()))
        if isinstance(f, ast.FunctionDef) and f.name == "kern"))
    src = textwrap.dedent(src)
    assert src.count("tkr = 2 * tks") == 1
    ns = dict(jax=jax, jnp=jnp, pl=pl, pltpu=pltpu, inner=4, g=32)
    exec(src.replace("tkr = 2 * tks", "tkr = tks"), ns)
    tk, tn = 128, 128
    grid8 = load_script("probe_q3").pltpu_unpack(qt.qs.numpy())
    kern = functools.partial(ns["kern"], stage="nocast")
    out = q3_call(kern, grid8, 2 * tk, tk, tn, k, n)(jnp.asarray(xg), jnp.asarray(sx),
                                                     jnp.asarray(grid8), jnp.asarray(sp.numpy()))
    port = P.plain_probe_nibble(T(grid8), "s8", "gdot", T(xg), sx=T(sx), s=sp)
    assert_close(port, out, 1e-6)
    full = P.plain_probe_nibble(qt.qs, "i4", "gdot", T(xg), sx=T(sx), s=sp)
    assert torch.equal(port, full)


# -- probe_q5.py / probe_q5b.py: the q form against the SWAR qp forms ---------


@pytest.fixture(scope="module")
def q5_weight():
    k, n = 1024, 256
    qt, sp = P.q4k_weight(k, n, 6, "cpu")
    return qt, sp, k, n


def q5_prep(m: int, k: int, seed: int):
    """probe_q5.py:138-150 (probe_q5b.py:55-67) in numpy, and the port's
    quant_q5 of the same x, which must equal it."""
    g = 32
    xf = (np.random.default_rng(seed).standard_normal((m, k)) * 0.5).astype(np.float32)
    ng = k // g
    xr = xf.reshape(m, ng, g)
    sx = (np.abs(xr).max(-1) / 127.0 + 1e-20).astype(np.float32)
    xq = np.clip(np.round(xr / sx[:, :, None]), -127, 127).astype(np.int8)
    xg = np.ascontiguousarray(xq.transpose(1, 0, 2))
    xe = np.ascontiguousarray(xg[:, :, 0::2])
    xo = np.ascontiguousarray(xg[:, :, 1::2])
    xp = np.concatenate([xe, xo], axis=-1)
    sxT = np.ascontiguousarray(sx.T)
    acts = (xg, xe, xo, xp, sxT, sxT / 16.0)
    for a, b in zip(P.quant_q5(T(xf)), acts):
        assert np.array_equal(a.numpy(), b)
    return acts


def q5_build(script: str, form: str, tk: int, tn: int, inner: int, m: int, rows: int, n: int):
    """build() of probe_q5.py:237-272 (probe_q5b.py:154-185) at a small tile,
    with the script's own kern_q / kern_qp."""
    g, hg = 32, 16
    mod = load_script(script)
    env = dict(g=g, hg=hg, swar_planes=mod.swar_planes)
    nk, nn = rows // tk, n // tn
    tkg = 2 * tk // g
    if form == "q":
        kfn = functools.partial(nested_fn(script, "kern_q", **env), inner=inner)
        specs = [pl.BlockSpec((tkg, m, g), lambda i, j: (j, 0, 0)),
                 pl.BlockSpec((tkg, m), lambda i, j: (j, 0))]
    else:
        kfn = functools.partial(nested_fn(script, "kern_qp", **env), inner=inner, form=form)
        specs = ([pl.BlockSpec((tkg, m, hg), lambda i, j: (j, 0, 0))] * (2 if form == "A" else 0)
                 + [pl.BlockSpec((tkg, m, g), lambda i, j: (j, 0, 0))] * (0 if form == "A" else 1)
                 + [pl.BlockSpec((tkg, m), lambda i, j: (j, 0))])
    specs += [pl.BlockSpec((tk, tn), lambda i, j: (j, i)),
              pl.BlockSpec((tkg, tn), lambda i, j: (j, i))]
    return pl.pallas_call(kfn, grid=(nn, nk), in_specs=specs, interpret=True,
                          out_specs=pl.BlockSpec((m, tn), lambda i, j: (0, i)),
                          out_shape=jax.ShapeDtypeStruct((m, n), jnp.float32))


@pytest.mark.parametrize("script", ["probe_q5", "probe_q5b"])
@pytest.mark.parametrize("m", [1, 4])
def test_q5_forms_match_pallas(q5_weight, script, m):
    qt, sp, k, n = q5_weight
    xg, xe, xo, xp, sx, sx16 = q5_prep(m, k, 7 + m)
    qs, spn = qt.qs.numpy(), sp.numpy()
    args = {"q": (xg, sx), "A": (xe, xo, sx16), "B": (xp, sx16), "C": (xp, sx16)}
    port_args = {"q": (T(xg), None, T(sx)), "A": (T(xe), T(xo), T(sx16)),
                 "B": (T(xp), None, T(sx16)), "C": (T(xp), None, T(sx16))}
    pallas, port = {}, {}
    for form in ("q", "A", "B", "C"):
        call = q5_build(script, form, 128, 128, 4, m, qs.shape[0], n)
        pallas[form] = np.asarray(call(*(jnp.asarray(a) for a in args[form]), jnp.asarray(qs),
                                       jnp.asarray(spn)))
        x, xb, s_x = port_args[form]
        port[form] = P.plain_probe_nibble(qt.qs, "i4" if form == "q" else "swar", "gdot", x, xb,
                                          sx=s_x, s=sp, form=form)
        assert_close(port[form], pallas[form], 1e-6)
    for form in ("A", "B", "C"):  # the qp forms equal the q form bit for bit
        assert torch.equal(port[form], port["q"])
        assert np.array_equal(pallas[form], pallas["q"])


# -- probe_dma.py: every byte of each layout's tiles ---------------------------


@pytest.mark.parametrize("layout", ["strided", "full", "tiled3d"])
def test_dma_probe_matches_pallas(layout):
    """probe_dma.py's kern (:63-92) through its pallas_call (:94-104) at a
    (64, 512) array with (32, 256) tiles (full width: 16 rows)."""
    kk, nn_ = 64, 512
    qs = np.random.default_rng(0).integers(0, 255, (kk, nn_), np.uint8)
    tk, tn = (16, nn_) if layout == "full" else (32, 256)
    if layout == "tiled3d":
        arr = np.ascontiguousarray(qs.reshape(kk, nn_ // tn, tn).transpose(1, 0, 2))
        spec = pl.BlockSpec((1, tk, tn), lambda g, _nk=kk // tk: (g // _nk, jax.lax.rem(g, _nk), 0))
        grid = (nn_ // tn * (kk // tk),)
    else:
        arr = qs
        nk = kk // tk
        spec = pl.BlockSpec((tk, tn), lambda g, _nk=nk: (jax.lax.rem(g, _nk), g // _nk))
        grid = (nk * (nn_ // tn),)
    kern = nested_fn("probe_dma", "kern", arr=arr)
    out = pl.pallas_call(
        kern, grid=grid, interpret=True,
        in_specs=[pl.BlockSpec((8, 8), lambda *g: (0, 0)), spec],
        out_specs=pl.BlockSpec((8, 128), lambda *g: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
    )(jnp.zeros((8, 8), jnp.float32), jnp.asarray(arr))
    t = P.stream_tiling(layout, arr.shape, (tk, tn))
    port = P.plain_probe_stream(T(arr), t).sum()
    assert np.all(np.asarray(out) == np.asarray(out)[0, 0])
    assert abs(float(np.asarray(out)[0, 0]) - port.item()) <= 1e-5 * abs(port.item())
    assert port.item() == float(qs.view(np.int8).astype(np.int64).sum())


def test_stream_bands_split_each_tile():
    a = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (64, 512), dtype=np.uint8))
    t = P.stream_tiling("strided", (64, 512), (32, 256))
    one, four = P.plain_probe_stream(a, t, 1), P.plain_probe_stream(a, t, 4)
    assert four.shape == (4, 4) and torch.equal(four.sum(1), one[:, 0])


# -- the port's probe scripts end to end on the CPU ---------------------------

PROBE_SCRIPTS = ("int8_dot", "bf16_dot", "int4", "mmvq", "q3", "q5", "q5b", "dma")
# the lines each script prints (one a probe, a comparison or a timed kernel)
LINES = {"int8_dot": 8, "bf16_dot": 6, "int4": 7, "mmvq": 9, "q3": 8, "q5": 15, "q5b": 12, "dma": 8}


@pytest.fixture(scope="module")
def script_runs(tmp_path_factory):
    """All eight scripts' main() in one fresh process on the CPU at small
    shapes: exit code and output of each, and whether JAX got imported."""
    code = textwrap.dedent(f"""
        import contextlib, io, json, runpy, sys
        sys.path.insert(0, {ROOT!r})
        res = {{}}
        for name in {PROBE_SCRIPTS!r}:
            out = io.StringIO()
            sys.argv = [name, "--device", "cpu", "--small"]
            with contextlib.redirect_stdout(out):
                try:
                    runpy.run_path({SCRIPTS!r} + "/torch_probe_" + name + ".py", run_name="__main__")
                    rc = 0
                except SystemExit as e:
                    rc = e.code if isinstance(e.code, int) else 1
            res[name] = dict(rc=rc, out=out.getvalue())
        res["jax"] = sorted(m for m in sys.modules
                            if m.split(".")[0] in ("jax", "jaxlib", "ctransformers_tpu"))
        print(json.dumps(res))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                       cwd=str(tmp_path_factory.mktemp("probes")), timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", PROBE_SCRIPTS)
def test_probe_script_runs_on_the_cpu(script_runs, name):
    res = script_runs[name]
    assert res["rc"] == 0, res["out"]
    lines = res["out"].strip().splitlines()
    assert lines[-1].startswith("done in") and lines[-1].endswith("on cpu")
    probes = lines[:-1]
    assert len(probes) == LINES[name], probes
    assert all("not measured" in ln or "ok" in ln.split() for ln in probes), probes
    assert not [ln for ln in probes if "FAIL" in ln]
    assert script_runs["jax"] == []


def test_probe_script_without_cuda_exits_2():
    r = subprocess.run([sys.executable, os.path.join(SCRIPTS, "torch_probe_int8_dot.py")],
                       capture_output=True, text=True, timeout=120,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode == 2 and "CUDA is not available" in r.stderr
    assert r.stdout == ""


def test_cpu_wrappers_take_the_plain_versions():
    P.reset_counts()
    qs = torch.zeros((16, 32), dtype=torch.int8)
    P.probe_nibble(qs, "i4", "colsum")
    P.probe_dot(torch.zeros((8, 16), dtype=torch.int8), torch.zeros((16, 64), dtype=torch.int8), "s8")
    assert P.PLAIN_CALLS["probe_nibble"] == 1 and P.PLAIN_CALLS["probe_dot"] == 1
    assert not any(P.LAUNCHES.values())
    with pytest.raises(ValueError, match="CUDA only"):
        P.probe_stream(torch.zeros((4, 16), dtype=torch.uint8, device="meta"),
                       P.stream_tiling("full", (4, 16), (4, None)))


def test_probe_sources_lie_outside_the_table_hash():
    assert all(src in K.SOURCES for src in ("probe_dot.cu", "probe_nibble.cu", "probe_stream.cu"))
    assert all(not s.startswith("qmm_") for s in ("probe_dot.cu", "probe_nibble.cu",
                                                   "probe_stream.cu"))
    assert {os.path.basename(p) for p in P.SOURCE_OF.values()} == {
        "probe_dot.cu", "probe_nibble.cu", "probe_stream.cu"}


def test_wrappers_refuse_operands_the_kernels_would_misread():
    qs = torch.zeros((16, 32), dtype=torch.int8)  # K 32, N 32: one group
    xg = torch.zeros((1, 2, 32), dtype=torch.int8)
    sx, s = torch.zeros((1, 2)), torch.zeros((1, 32))
    P.probe_nibble(qs, "i4", "gdot", xg, sx=sx, s=s)  # as given: served
    for kw in (dict(x=xg[:, :, :16]), dict(sx=torch.zeros((2, 1))), dict(s=torch.zeros((1, 64))),
               dict(x=xg.float()), dict(xb=xg)):
        args = dict(dict(x=xg, sx=sx, s=s), **kw)
        with pytest.raises(ValueError, match="probe_nibble"):
            P.probe_nibble(qs, "i4", "gdot", args["x"], args.get("xb"), sx=args["sx"], s=args["s"])
    with pytest.raises(ValueError, match="bf16"):
        P.probe_nibble(qs, "i4", "dot_bf16", torch.zeros((2, 32)))
    with pytest.raises(ValueError, match="int8 plane"):
        P.probe_nibble(qs.to(torch.uint8), "i4", "colsum")
    a = torch.zeros((64, 512), dtype=torch.uint8)
    P.probe_stream(a, P.stream_tiling("strided", (64, 512), (32, 256)))
    with pytest.raises(ValueError, match="probe_stream"):  # tiles past the array's end
        P.probe_stream(a, P.stream_tiling("strided", (128, 512), (32, 256)))
    with pytest.raises(ValueError, match="probe_stream"):  # more bands than rows
        P.probe_stream(a, P.stream_tiling("strided", (64, 512), (32, 256)), bands=33)
    with pytest.raises(ValueError, match="probe_dot"):
        P.probe_dot(torch.zeros((2, 8, 16)), torch.zeros((16, 64)), "f32")
