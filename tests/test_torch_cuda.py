"""The qmm kernels against their plain PyTorch versions on the card: the
five Q4_K kernels, the six int8-grid (Q6_K, Q5_K) kernels, the five GPTQ4
kernels at groups 32, 64 and 128 (Q4_1 at 32), the five bias-free Q4_0
kernels, the six kernels on the legacy grids' plain planes (Q8_0, Q5_0,
Q5_1), the five group-16 nibble kernels (Q2_K, Q3_K), the six ksplit
kernels on every nibble kind, the four reshape-broadcast int8-grid
kernels and the two int8-grid kernels that quantize x inside (qmm_qx8 and
its legacy form); the race that picks among them; the decode attention
kernel (ops/attention.py) over f32, bf16, f16 and int8 caches in both
layouts; and the fused decode loop of engine/engine.py (a captured CUDA
graph per key) against the eager loop on a tiny model.

These tests need an NVIDIA GPU (sm_90a) and nvcc; they skip elsewhere. The
file imports only the port (no JAX), so it also runs on a machine without
JAX: python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from ctransformers_tpu_torch.models.synthetic import K16_PLANE_RANGES
from ctransformers_tpu_torch.ops import attention as A
from ctransformers_tpu_torch.ops import qmatmul as qm
from ctransformers_tpu_torch.ops import qmm_kernels as K
from ctransformers_tpu_torch.ops.qmatmul import QTensor, qmatmul, select_mode

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    K.build()
    return torch.device("cuda")


@pytest.fixture
def no_autotune(monkeypatch):
    """select_mode decides, as before kernel selection raced on the card."""
    monkeypatch.setenv("CT_QMM_AUTOTUNE", "0")


def random_q4k(k: int, n: int, seed: int, device) -> QTensor:
    """A Q4_K QTensor with random planes at padded shape (k, n)."""
    g = torch.Generator().manual_seed(seed)
    qs = torch.randint(-128, 128, (k // 2, n), generator=g, dtype=torch.int8)
    sub_s = torch.randint(0, 64, (k // 32, n), generator=g, dtype=torch.int8)
    sub_m = torch.randint(0, 64, (k // 32, n), generator=g, dtype=torch.int8)
    sd = torch.rand((k // 256, n), generator=g) * 1e-3 + 1e-4
    sm = -torch.rand((k // 256, n), generator=g) * 1e-3
    return QTensor(
        qs, sub_s, sub_m, "Q4_K", 32, (k, n), packed=True, zp=0,
        sd=sd, sm=sm, sfactor=8, pack_layout="adjk",
    ).to(device)


def random_grid(kind: str, k: int, n: int, seed: int, device) -> QTensor:
    """A Q6_K (group 16, no mins) or Q5_K (group 32, mins) int8-grid
    QTensor with random planes at padded shape (k, n)."""
    g = torch.Generator().manual_seed(seed)
    group, sfactor, has_mins, _ = K.LAYOUTS[kind]
    lo, hi = (-32, 32) if kind == "Q6_K" else (0, 32)
    qs = torch.randint(lo, hi, (k, n), generator=g, dtype=torch.int8)
    sub_s = torch.randint(-64 if kind == "Q6_K" else 0, 64, (k // group, n), generator=g,
                          dtype=torch.int8)
    sd = torch.rand((k // 256, n), generator=g) * 1e-3 + 1e-4
    sub_m = sm = None
    if has_mins:
        sub_m = torch.randint(0, 64, (k // group, n), generator=g, dtype=torch.int8)
        sm = -torch.rand((k // 256, n), generator=g) * 1e-3
    return QTensor(qs, sub_s, sub_m, kind, group, (k, n), sd=sd, sm=sm,
                   sfactor=sfactor).to(device)


def random_gptq(k: int, n: int, group: int, seed: int, device, act_order=False) -> QTensor:
    """A GPTQ4 QTensor with random nibbles and f32 planes s and m = -s * z at
    padded shape (k, n), with a random row perm when `act_order`."""
    g = torch.Generator().manual_seed(seed)
    qs = torch.randint(-128, 128, (k // 2, n), generator=g, dtype=torch.int8)
    s = torch.rand((k // group, n), generator=g) * 3e-3 + 1e-3
    z = torch.randint(0, 16, (k // group, n), generator=g).float()
    perm = torch.randperm(k, generator=g).to(torch.int32) if act_order else None
    return QTensor(qs, s, -(s * z), "GPTQ4", group, (k, n), packed=True, zp=0,
                   perm=perm, sfactor=0, pack_layout="adjk").to(device)


def random_legacy(kind: str, k: int, n: int, seed: int, device) -> QTensor:
    """A QTensor of a legacy type (Q4_0, Q4_1 nibbles; Q8_0, Q5_0, Q5_1 int8
    grids) with random grids and f32 (k/32, n) planes at padded shape (k, n):
    s > 0 and, where the type has mins, m = -s * z."""
    g = torch.Generator().manual_seed(seed)
    group, _, has_mins, packed = K.LAYOUTS[kind]
    lo, hi = {"Q8_0": (-128, 128), "Q5_0": (-16, 16), "Q5_1": (0, 32)}.get(kind, (-128, 128))
    qs = torch.randint(lo, hi, (k // 2 if packed else k, n), generator=g, dtype=torch.int8)
    s = torch.rand((k // group, n), generator=g) * 3e-3 + 1e-3
    mn = -(s * torch.randint(0, 32, (k // group, n), generator=g).float()) if has_mins else None
    return QTensor(qs, s, mn, kind, group, (k, n), packed=packed, zp=K.zero_point(kind),
                   sfactor=0, pack_layout="adjk").to(device)


def random_k16(kind: str, k: int, n: int, seed: int, device) -> QTensor:
    """A Q2_K (sub-mins and sm = -dmin) or Q3_K (no mins, zero point 8)
    QTensor with random nibbles and factors at padded shape (k, n), in the
    ranges of synthetic.K16_PLANE_RANGES."""
    r = K16_PLANE_RANGES[kind]
    g = torch.Generator().manual_seed(seed)
    qs = torch.randint(-128, 128, (k // 2, n), generator=g, dtype=torch.int8)
    sub_s = torch.randint(*r["sub"], (k // 16, n), generator=g, dtype=torch.int8)
    sd = torch.rand((k // 256, n), generator=g) * (r["d"][1] - r["d"][0]) + r["d"][0]
    sub_m = sm = None
    if r["dmin"] is not None:
        sub_m = torch.randint(0, r["sub"][1], (k // 16, n), generator=g, dtype=torch.int8)
        sm = -torch.rand((k // 256, n), generator=g) * r["dmin"]
    return QTensor(qs, sub_s, sub_m, kind, 16, (k, n), packed=True, zp=K.zero_point(kind),
                   sd=sd, sm=sm, sfactor=16, pack_layout="adjk").to(device)


def random_ksplit(kind: str, k: int, n: int, seed: int, device) -> QTensor:
    """A nibble weight of `kind` (as _weight makes it) packed ksplit: random
    uint8 bytes, any of which is a valid pair of nibbles, over its planes."""
    g = torch.Generator().manual_seed(seed + 1)
    qs = torch.randint(0, 256, (k // 2, n), generator=g, dtype=torch.uint8).to(device)
    return dataclasses.replace(_weight("", kind, k, n, seed, device), qs=qs, pack_layout="ksplit")


def _weight(name: str, kind: str, k: int, n: int, seed: int, device) -> QTensor:
    if kind.startswith("ks:"):
        return random_ksplit(kind[3:], k, n, seed, device)
    if kind in ("Q2_K", "Q3_K"):
        return random_k16(kind, k, n, seed, device)
    if kind.startswith("GPTQ4"):
        return random_gptq(k, n, int(kind.split("/")[1]), seed, device)
    if kind in LEGACY:
        return random_legacy(kind, k, n, seed, device)
    if name in GRID + R8 + QX8:
        return random_grid(kind, k, n, seed, device)
    return random_q4k(k, n, seed, device)


def _rel(a, b):
    return (torch.linalg.norm(a - b) / torch.linalg.norm(b)).item()


# q/qx/q8: the integer group dots are exact, only the f32 rescale sums
# differ in order; i/si/b/sb: bf16 products summed in another order on
# tensor cores; g/f/s: exact or f32 products, f32 sums in another order
TOL = {"qmm_qx": 1e-5, "qmm_q": 1e-5, "qmm_si": 1e-3, "qmm_i": 1e-3,
       "qmm_q8": 1e-5, "qmm_b": 1e-3, "qmm_sb": 1e-3,
       "qmm_qx_gptq": 1e-5, "qmm_q_gptq": 1e-5, "qmm_i_gptq": 1e-3,
       "qmm_g": 1e-5, "qmm_g_gptq": 1e-5, "qmm_g8": 1e-5, "qmm_f": 1e-5, "qmm_s": 1e-5,
       "qmm_si_gptq": 1e-3,
       "qmm_qx_q4_0": 1e-5, "qmm_q_q4_0": 1e-5, "qmm_i_q4_0": 1e-3, "qmm_si_q4_0": 1e-3,
       "qmm_g_q4_0": 1e-5, "qmm_q8_legacy": 1e-5, "qmm_b_legacy": 1e-3,
       "qmm_sb_legacy": 1e-3, "qmm_g8_legacy": 1e-5, "qmm_f_legacy": 1e-5,
       "qmm_s_legacy": 1e-5, "qmm_qx_k16": 1e-5, "qmm_q_k16": 1e-5, "qmm_i_k16": 1e-3,
       "qmm_si_k16": 1e-3, "qmm_g_k16": 1e-5,
       "qmm_f_ks": 1e-5, "qmm_s_ks": 1e-5, "qmm_b_ks": 1e-3, "qmm_sb_ks": 1e-3,
       "qmm_r_ks": 1e-5, "qmm_rb_ks": 1e-3, "qmm_r8": 1e-5, "qmm_rb8": 1e-3,
       "qmm_r8_legacy": 1e-5, "qmm_rb8_legacy": 1e-3, "qmm_qx8": 1e-5,
       "qmm_qx8_legacy": 1e-5}
assert set(TOL) == set(K.KERNELS)
GRID = ("qmm_q8", "qmm_b", "qmm_sb", "qmm_g8", "qmm_f", "qmm_s")
GPTQ = ("qmm_qx_gptq", "qmm_q_gptq", "qmm_i_gptq", "qmm_g_gptq", "qmm_si_gptq")
Q4_0 = ("qmm_qx_q4_0", "qmm_q_q4_0", "qmm_i_q4_0", "qmm_si_q4_0", "qmm_g_q4_0")
LEGACY_GRID = tuple(name + "_legacy" for name in GRID)
LEGACY = ("Q4_0", "Q4_1", "Q8_0", "Q5_0", "Q5_1")
K16 = ("qmm_qx_k16", "qmm_q_k16", "qmm_i_k16", "qmm_si_k16", "qmm_g_k16")
KSPLIT = ("qmm_f_ks", "qmm_s_ks", "qmm_b_ks", "qmm_sb_ks", "qmm_r_ks", "qmm_rb_ks")
# every nibble layout the ksplit kernels take
KSPLIT_KINDS = ("Q4_K", "Q2_K", "Q3_K", "GPTQ4/32", "GPTQ4/64", "GPTQ4/128", "Q4_1", "Q4_0")
R8 = ("qmm_r8", "qmm_rb8")
R8_LEGACY = ("qmm_r8_legacy", "qmm_rb8_legacy")
QX8 = ("qmm_qx8", "qmm_qx8_legacy")
# each Q4_K kernel once, each grid kernel on both int8-grid layouts, each
# GPTQ kernel at its three groups and on Q4_1, each Q4_0 kernel once, each
# legacy-grid kernel on the three legacy grids (s and sb where there are
# mins to fold: Q5_1), each group-16 kernel on Q2_K and Q3_K
CASES = [(name, "Q4_K") for name in sorted(TOL)
         if name not in GRID + GPTQ + Q4_0 + LEGACY_GRID + K16 + KSPLIT + R8 + R8_LEGACY + QX8] + [
    (name, kind) for name in GRID for kind in ("Q6_K", "Q5_K")
] + [(name, f"GPTQ4/{g}") for name in GPTQ for g in K.GPTQ_GROUPS] + [
    (name, "Q4_1") for name in GPTQ
] + [(name, "Q4_0") for name in Q4_0] + [
    (name, kind) for name in LEGACY_GRID for kind in ("Q8_0", "Q5_0", "Q5_1")
    if kind == "Q5_1" or "s" not in name.split("_")[1]
] + [(name, kind) for name in K16 for kind in ("Q2_K", "Q3_K")] + [
    (name, "ks:" + kind) for name in KSPLIT for kind in KSPLIT_KINDS
] + [(name, kind) for name in R8 for kind in ("Q6_K", "Q5_K")] + [
    (name, kind) for name in R8_LEGACY for kind in ("Q8_0", "Q5_0", "Q5_1")] + [
    ("qmm_qx8", kind) for kind in ("Q6_K", "Q5_K")] + [
    ("qmm_qx8_legacy", kind) for kind in ("Q8_0", "Q5_0", "Q5_1")]


@pytest.mark.parametrize("name,kind", CASES)
@pytest.mark.parametrize("k,n", [(256, 384), (1024, 256), (2048, 1152)])
@pytest.mark.parametrize("m", [1, 3, 8, 33, 64, 130])
def test_kernel_matches_plain(dev, name, kind, k, n, m):
    qt = _weight(name, kind, k, n, seed=k + n + m, device=dev)
    x = torch.randn(m, k, generator=torch.Generator().manual_seed(m)).to(dev)
    args = K.quantize_activations(x, qt.group) if name in K.PREQUANTIZED else (x,)
    before = K.LAUNCHES[name]
    got = K.KERNELS[name](*args, qt)
    torch.cuda.synchronize()
    assert K.LAUNCHES[name] == before + 1
    ref = K.PLAIN[name](*args, qt)
    assert got.shape == ref.shape == (m, n)
    assert _rel(got, ref) <= TOL[name], name
    again = K.KERNELS[name](*args, qt)
    assert torch.equal(got, again), "kernel runs are not bitwise repeatable"


@pytest.mark.parametrize("name,kind", [(name, "Q4_0") for name in Q4_0] + [
    (name, kind) for name in LEGACY_GRID for kind in ("Q8_0", "Q5_1")
    if kind == "Q5_1" or "s" not in name.split("_")[1]])
@pytest.mark.parametrize("k,n", [(4096, 4096), (11264, 4096), (4096, 12288)])
def test_legacy_kernel_matches_plain_at_7b_shapes(dev, name, kind, k, n):
    """The bias-free Q4_0 kernels and the legacy-grid kernels at llama-2-7B
    shapes, at the batch size the main path gives each."""
    m = 128 if name.split("_")[1] in ("i", "si", "b", "sb") else 8
    qt = random_legacy(kind, k, n, seed=k + n, device=dev)
    x = torch.randn(m, k, generator=torch.Generator().manual_seed(m)).to(dev)
    args = K.quantize_activations(x, 32) if name in K.PREQUANTIZED else (x,)
    got = K.KERNELS[name](*args, qt)
    torch.cuda.synchronize()
    assert _rel(got, K.PLAIN[name](*args, qt)) <= TOL[name]
    assert torch.equal(got, K.KERNELS[name](*args, qt))


@pytest.mark.parametrize("name,kind,k,n", [
    ("qmm_qx8", "Q6_K", 4096, 4096), ("qmm_qx8", "Q6_K", 11264, 4096),
    ("qmm_qx8", "Q6_K", 4096, 32000), ("qmm_qx8", "Q5_K", 4096, 4096),
    ("qmm_qx8_legacy", "Q8_0", 4096, 4096), ("qmm_qx8_legacy", "Q8_0", 11264, 4096),
    ("qmm_qx8_legacy", "Q5_1", 4096, 4096)])
@pytest.mark.parametrize("m", [1, 8])
def test_qx8_matches_plain_and_q8_at_7b_shapes(dev, name, kind, k, n, m):
    """The int8-grid kernels that quantize x inside against plain_qx8 at
    llama-2-7B shapes (the down shape's x at m = 8 is larger than a block's
    shared memory: it is quantized chunk by chunk), and against q8 on the
    activations quantize_activations makes outside: the same integer dots
    and roundings, so equal up to the order of f32 sums."""
    qt = (random_legacy if kind in LEGACY else random_grid)(kind, k, n, k + n, dev)
    x = torch.randn(m, k, generator=torch.Generator().manual_seed(m)).to(dev)
    got = K.KERNELS[name](x, qt)
    torch.cuda.synchronize()
    assert _rel(got, K.PLAIN[name](x, qt)) <= TOL[name]
    q8 = K.KERNELS[name.replace("qx8", "q8")](*K.quantize_activations(x, qt.group), qt)
    assert _rel(got, q8) <= TOL[name]
    assert torch.equal(got, K.KERNELS[name](x, qt))


def test_qx8_symbols_refuse_a_layout_they_do_not_take(dev):
    """ct_qmm_qx8 takes group 16 without mins or 32 with them, and the
    legacy symbol a has-mins flag that agrees with the min plane."""
    q6k = random_grid("Q6_K", 256, 128, 1, dev)
    x = torch.randn(1, 256, device=dev)
    out = torch.empty(1, 128, device=dev)
    fn = K._fn("qmm_grid", "ct_qmm_qx8")
    assert fn(*K._ptrs(x, q6k.qs, q6k.scales, q6k.mins, q6k.sd, q6k.sm, out), 1, 256, 128, 32,
              K._stream(dev)) != 0
    q51 = random_legacy("Q5_1", 256, 128, 2, dev)
    fn = K._fn("qmm_grid", "ct_qmm_qx8_legacy")
    assert fn(*K._ptrs(x, q51.qs, q51.scales, None, out), 1, 256, 128, 1, K._stream(dev)) != 0


def test_legacy_symbols_refuse_a_mins_flag_that_disagrees(dev):
    """The legacy-grid symbols are told whether the weight has mins; a flag
    that disagrees with the min plane's pointer is refused at launch, not
    guessed from it."""
    q51 = random_legacy("Q5_1", 256, 128, 1, dev)
    x = torch.randn(64, 256, device=dev)
    lib = K._fn("qmm_grid", "ct_qmm_b_legacy")
    out = torch.empty(64, 128, device=dev)
    rc = lib(*K._ptrs(x, q51.qs, q51.scales, None, out), 64, 256, 128, 1, K._stream(dev))
    assert rc != 0
    rc = lib(*K._ptrs(x, q51.qs, q51.scales, q51.mins, out), 64, 256, 128, 0, K._stream(dev))
    assert rc != 0


@pytest.mark.parametrize("name", K16)
@pytest.mark.parametrize("kind", ["Q2_K", "Q3_K"])
@pytest.mark.parametrize("k,n", [(4096, 4096), (11264, 4096), (4096, 12288), (4096, 22528)])
def test_k16_kernel_matches_plain_at_7b_shapes(dev, name, kind, k, n):
    """The group-16 nibble kernels at llama-2-7B shapes (o, down, the fused
    QKV and gate/up), at the batch sizes the main path gives each; a lane's
    two groups are rescaled one after the other, bitwise repeatably."""
    for m in {"qmm_qx_k16": (1,), "qmm_q_k16": (8,), "qmm_i_k16": (128,),
              "qmm_si_k16": (128,), "qmm_g_k16": (1, 8)}[name]:
        qt = random_k16(kind, k, n, seed=k + n, device=dev)
        x = torch.randn(m, k, generator=torch.Generator().manual_seed(m)).to(dev)
        args = K.quantize_activations(x, 16) if name in K.PREQUANTIZED else (x,)
        got = K.KERNELS[name](*args, qt)
        torch.cuda.synchronize()
        assert _rel(got, K.PLAIN[name](*args, qt)) <= TOL[name], m
        assert torch.equal(got, K.KERNELS[name](*args, qt))


@pytest.mark.parametrize("lib,name", [
    ("qmm_decode", "ct_qmm_qx_k16"), ("qmm_prefill", "ct_qmm_i_k16"),
    ("qmm_prefill", "ct_qmm_si_k16"), ("qmm_float", "ct_qmm_g_k16"),
])
def test_k16_symbols_refuse_a_mins_flag_that_disagrees(dev, lib, name):
    """The group-16 symbols are told whether the weight has mins (Q2_K) or
    not (Q3_K); a flag that disagrees with the sub-min and sm pointers is
    refused at launch, not guessed from them."""
    q2 = random_k16("Q2_K", 256, 128, 1, dev)
    q3 = random_k16("Q3_K", 256, 128, 2, dev)
    x = torch.randn(64, 256, device=dev)
    out = torch.empty(64, 128, device=dev)
    fn = K._fn(lib, name)
    for qt, flag in ((q2, 0), (q3, 1)):
        rc = fn(*K._ptrs(x, qt.qs, qt.scales, qt.mins, qt.sd, qt.sm, out), 64, 256, 128, flag,
                K._stream(dev))
        assert rc != 0
    rc = fn(*K._ptrs(x, q2.qs, q2.scales, q2.mins, q2.sd, None, out), 64, 256, 128, 1,
            K._stream(dev))
    assert rc != 0
    rc = fn(*K._ptrs(x, q3.qs, q3.scales, None, q3.sd, None, out), 64, 256, 128, 0,
            K._stream(dev))
    assert rc == 0


def test_qmatmul_routes_the_k16_layouts(dev, no_autotune):
    """Under the fixed rule Q2_K and Q3_K reach the group-16 kernels: qx at
    m = 1, q at 8, si on a wide weight and i on a tall one at 64."""
    for kind in ("Q2_K", "Q3_K"):
        wide = dataclasses.replace(random_k16(kind, 512, 1280, seed=5, device=dev),
                                   shape=(500, 1200))
        tall = random_k16(kind, 1024, 512, seed=6, device=dev)
        K.reset_counts()
        for qt in (wide, tall):
            dense = qm.dequantize_qtensor(qt)
            for m in (1, 8, 64):
                x = torch.randn(m, qt.shape[0], device=dev)
                out = qmatmul(x, qt)
                assert out.shape == (m, qt.shape[1]) and _rel(out, x @ dense) < 0.035, (kind, m)
        assert {k: v for k, v in K.LAUNCHES.items() if v} == {
            "qmm_qx_k16": 2, "qmm_q_k16": 2, "qmm_si_k16": 1, "qmm_i_k16": 1}, kind
        assert sum(K.PLAIN_CALLS.values()) == 0


@pytest.mark.parametrize("name", KSPLIT)
@pytest.mark.parametrize("kind", ["Q4_K", "Q3_K", "GPTQ4/128", "Q4_0"])
@pytest.mark.parametrize("k,n", [(4096, 4096), (11264, 4096), (4096, 12288)])
def test_ksplit_kernel_matches_plain_at_7b_shapes(dev, name, kind, k, n):
    """The ksplit kernels at llama-2-7B shapes (the halves meet at 2048 and
    5632 byte rows), at the batch sizes the main path gives each."""
    for m in (1, 8, 128) if name in ("qmm_b_ks", "qmm_sb_ks", "qmm_rb_ks") else (1, 8):
        qt = random_ksplit(kind, k, n, seed=k + n, device=dev)
        x = torch.randn(m, k, generator=torch.Generator().manual_seed(m)).to(dev)
        got = K.KERNELS[name](x, qt)
        torch.cuda.synchronize()
        assert _rel(got, K.PLAIN[name](x, qt)) <= TOL[name], m
        assert torch.equal(got, K.KERNELS[name](x, qt))


@pytest.mark.parametrize("name", KSPLIT)
def test_ksplit_symbols_read_the_layout_from_their_ints(dev, name):
    """One ksplit symbol serves every nibble layout, named by its ints
    (group, has mins, zero point, superblock factor count); a combination
    no layout has, or pointers that disagree with the ints, is refused at
    launch."""
    lib = K._SPECS[name][0]
    fn = K._fn(lib, "ct_" + name)
    x = torch.randn(64, 256, device=dev)
    out = torch.empty(64, 128, device=dev)
    q4k = random_ksplit("Q4_K", 256, 128, 1, dev)
    q40 = random_ksplit("Q4_0", 256, 128, 2, dev)

    def call(qt, *ints):
        return fn(*K._ptrs(x, *K._planes(qt), out), 64, 256, 128, *ints, K._stream(dev))

    assert call(q4k, 32, 1, 0, 8) == 0 and call(q40, 32, 0, 8, 0) == 0
    for bad in ((32, 1, 8, 8), (16, 1, 0, 8), (32, 0, 0, 8), (32, 1, 0, 0), (64, 0, 8, 0),
                (32, 1, 0, 16)):
        assert call(q4k, *bad) != 0, bad
    for bad in ((32, 1, 0, 0), (32, 0, 0, 0), (64, 0, 8, 0), (32, 0, 8, 8)):
        assert call(q40, *bad) != 0, bad
    torch.cuda.synchronize()


def test_qmatmul_routes_ksplit(dev, no_autotune, tmp_path, monkeypatch):
    """Under the fixed rule a ksplit weight of each kind takes "sb" at every
    m, and under a table of rb_mode_entries "r" at m <= 32 and "rb" above;
    both within the bf16 class of x @ the dequantized weight."""
    for i, kind in enumerate(KSPLIT_KINDS):
        qt = dataclasses.replace(_weight("", "ks:" + kind, 512, 1024, seed=5, device=dev),
                                 shape=(500, 1000))
        dense = qm.dequantize_qtensor(qt)
        table = str(tmp_path / f"modes{i}.json")
        qm.save_table(table, torch.cuda.get_device_name(0), qm.rb_mode_entries([qt], (1, 8, 64)))
        for env, want in (({}, {"qmm_sb_ks": 3}),
                          ({"CT_QMM_AUTOTUNE": "precompiled", "CT_QMM_TILE_CACHE": table},
                           {"qmm_r_ks": 2, "qmm_rb_ks": 1})):
            with monkeypatch.context() as mp:
                for k, v in env.items():
                    mp.setenv(k, v)
                K.reset_counts()
                for m in (1, 8, 64):
                    x = torch.randn(m, 500, device=dev)
                    out = qmatmul(x, qt)
                    assert out.shape == (m, 1000) and _rel(out, x @ dense) < 0.035, (kind, m)
                assert {k: v for k, v in K.LAUNCHES.items() if v} == want, kind
                assert sum(K.PLAIN_CALLS.values()) == 0


@pytest.mark.parametrize("name", GPTQ)
@pytest.mark.parametrize("k,n", [(4096, 4096), (11264, 4096), (4096, 12288)])
def test_gptq_kernel_matches_plain_at_7b_shapes(dev, name, k, n):
    """The GPTQ kernels at llama-2-7B shapes, group 128, at the batch size
    the main path gives each; the in-kernel xsum of qx sums a group of 128
    in another order than the plain version (within the tolerance, not bit
    for bit), the integer group dots are exact."""
    m = {"qmm_qx_gptq": 1, "qmm_q_gptq": 8, "qmm_i_gptq": 128, "qmm_g_gptq": 8,
         "qmm_si_gptq": 128}[name]
    qt = random_gptq(k, n, 128, seed=k + n, device=dev)
    x = torch.randn(m, k, generator=torch.Generator().manual_seed(m)).to(dev)
    args = K.quantize_activations(x, 128) if name in K.PREQUANTIZED else (x,)
    got = K.KERNELS[name](*args, qt)
    torch.cuda.synchronize()
    assert _rel(got, K.PLAIN[name](*args, qt)) <= TOL[name]
    assert torch.equal(got, K.KERNELS[name](*args, qt))


def test_qmatmul_gathers_act_order_rows_on_the_card(dev, no_autotune):
    """qmatmul applies the act-order perm on the card: the product equals
    the same weight without a perm on rows gathered beforehand, bit for bit,
    and x @ the dequantized weight within the int8 / bf16 classes."""
    from ctransformers_tpu_torch.ops.qmatmul import dequantize_qtensor

    qt = random_gptq(512, 1024, 128, seed=9, device=dev, act_order=True)
    bare = dataclasses.replace(qt, perm=None)
    dense = dequantize_qtensor(qt)
    K.reset_counts()
    for m in (1, 8, 64):
        x = torch.randn(m, 512, device=dev)
        out = qmatmul(x, qt)
        assert torch.equal(out, qmatmul(x[:, qt.perm.long()], bare))
        assert _rel(out, x @ dense) < 0.035
    assert K.LAUNCHES == dict(dict.fromkeys(K.LAUNCHES, 0), qmm_qx_gptq=2, qmm_q_gptq=2,
                              qmm_i_gptq=2)


def test_qmatmul_routes_every_mode(dev, no_autotune):
    # logical (500, 1000) inside padded (512, 1024) planes
    q4k = dataclasses.replace(random_q4k(512, 1024, seed=1, device=dev), shape=(500, 1000))
    q4k_tall = random_q4k(1024, 512, seed=2, device=dev)
    q6k = dataclasses.replace(random_grid("Q6_K", 512, 1024, 3, dev), shape=(500, 1000))
    q5k = random_grid("Q5_K", 512, 1024, 4, dev)
    K.reset_counts()
    for qt in (q4k, q4k_tall, q6k, q5k):
        for m in (1, 8, 64):
            k, n = qt.shape
            out = qmatmul(torch.randn(m, k, device=dev), qt)
            assert out.shape == (m, n) and torch.isfinite(out).all()
    assert select_mode(64, q4k) == "si" and select_mode(64, q4k_tall) == "i"
    assert K.LAUNCHES == dict(dict.fromkeys(K.LAUNCHES, 0), qmm_qx=2, qmm_q=2, qmm_si=1,
                              qmm_i=1, qmm_q8=4, qmm_b=1, qmm_sb=1)
    assert sum(K.PLAIN_CALLS.values()) == 0


def test_qmatmul_routes_the_legacy_layouts(dev, no_autotune):
    """Under the fixed rule each legacy layout reaches its own kernels: Q4_0
    the bias-free nibble kernels, Q4_1 the GPTQ group-32 ones, the grids the
    kernels on plain planes (sb where there are mins)."""
    want = {"Q4_0": ("qmm_qx_q4_0", "qmm_q_q4_0", "qmm_i_q4_0"),
            "Q4_1": ("qmm_qx_gptq", "qmm_q_gptq", "qmm_i_gptq"),
            "Q8_0": ("qmm_q8_legacy", "qmm_q8_legacy", "qmm_b_legacy"),
            "Q5_0": ("qmm_q8_legacy", "qmm_q8_legacy", "qmm_b_legacy"),
            "Q5_1": ("qmm_q8_legacy", "qmm_q8_legacy", "qmm_sb_legacy")}
    for kind, names in want.items():
        qt = dataclasses.replace(random_legacy(kind, 512, 1024, seed=5, device=dev),
                                 shape=(500, 1000))
        dense = qm.dequantize_qtensor(qt)
        K.reset_counts()
        for m in (1, 8, 64):
            x = torch.randn(m, 500, device=dev)
            out = qmatmul(x, qt)
            assert out.shape == (m, 1000) and _rel(out, x @ dense) < 0.035, (kind, m)
        expect = {n: names.count(n) for n in names}
        assert {k: v for k, v in K.LAUNCHES.items() if v} == expect, kind
        assert sum(K.PLAIN_CALLS.values()) == 0


@pytest.mark.parametrize("kind,m", [("Q4_K", 1), ("Q4_K", 64), ("Q6_K", 8), ("Q5_K", 1),
                                    ("Q5_K", 64), ("GPTQ4/128", 8), ("GPTQ4/64", 64),
                                    ("Q4_0", 1), ("Q4_0", 64), ("Q8_0", 8), ("Q5_1", 64),
                                    ("Q2_K", 1), ("Q2_K", 8), ("Q3_K", 64), ("ks:Q4_K", 1),
                                    ("ks:Q4_K", 64), ("ks:GPTQ4/128", 8), ("ks:Q3_K", 1)])
def test_race_picks_a_candidate_and_the_table_serves_it(dev, kind, m, tmp_path, monkeypatch):
    """A miss races on the card: the pick is a member of the candidate list
    or the dense candidate, the best hand-written one is a member, every
    candidate has a time, the champion is written to the user's table, and
    the next call is served from it (no second race)."""
    monkeypatch.setenv("CT_QMM_TILE_CACHE", str(tmp_path / "modes.json"))
    monkeypatch.delenv("CT_QMM_AUTOTUNE", raising=False)
    monkeypatch.delenv("CT_QMATMUL", raising=False)
    name = {"Q4_K": "qmm_qx", "Q6_K": "qmm_q8", "Q5_K": "qmm_q8",
            "Q2_K": "qmm_qx_k16", "Q3_K": "qmm_qx_k16"}.get(kind, "qmm_qx_gptq")
    peers = [_weight(name, kind, 512, 1024, seed=s, device=dev) for s in (1, 2, 3)]
    qt = peers[0]
    cands = qm.mode_candidates(qt, m)
    res = qm.race(m, qt, peers)
    assert res["pick"] in cands + [qm.DENSE] and res["kernel"] in cands
    assert set(res["ms"]) == {qm.label(c) for c in cands} | {"dense"}
    assert all(0 < t < 1e3 for t in res["ms"].values())
    races = qm.N_RACES
    x = torch.randn(m, 512, device=dev)
    out = qmatmul(x, qt)
    assert qm.N_RACES == races + 1  # the miss raced
    key = qm.cache_key(m, qt)
    saved = qm._parse_cache_file(str(tmp_path / "modes.json"), torch.cuda.get_device_name(0))
    assert saved[key]["pick"] == qm.table(qt.qs.device)[key]["pick"]
    assert torch.equal(out, qmatmul(x, qt)) and qm.N_RACES == races + 1
    assert _rel(out, x @ qm.dequantize_qtensor(qt)) < 0.035
    # without the dense candidate the key takes its best hand-written kernel
    monkeypatch.setenv("CT_QMATMUL", "kernels")
    K.reset_counts()
    qmatmul(x, qt)
    assert sum(K.LAUNCHES.values()) >= 1 and K.DENSE_CALLS["dense"] == 0


def test_a_candidate_that_cannot_launch_fails_the_race(dev, monkeypatch):
    qt = random_q4k(512, 1024, seed=1, device=dev)

    def broken(x, w):
        raise RuntimeError("qmm_g: kernel launch failed")

    monkeypatch.setattr(K, "qmm_g", broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        qm.race(8, qt)


def test_wrapper_rejects_bad_operands(dev):
    qt = random_q4k(256, 128, seed=2, device=dev)
    with pytest.raises(ValueError):
        K.qmm_qx(torch.randn(1, 256, device=dev, dtype=torch.float64), qt)
    with pytest.raises(ValueError):
        K.qmm_si(torch.randn(4, 256), qt)  # CPU activations, CUDA weight
    q6k = random_grid("Q6_K", 256, 128, 3, dev)
    with pytest.raises(ValueError):
        K.qmm_b(torch.randn(64, 256), q6k)  # CPU activations, CUDA weight
    with pytest.raises(NotImplementedError):
        K.qmm_sb(torch.randn(64, 256, device=dev), dataclasses.replace(q6k, group=32))
    gq = random_gptq(256, 128, 128, 4, dev)
    with pytest.raises(ValueError):
        K.qmm_qx_gptq(torch.randn(1, 256), gq)  # CPU activations, CUDA weight
    with pytest.raises(NotImplementedError):
        K.qmm_i(torch.randn(64, 256, device=dev), gq)  # the Q4_K wrapper


def random_cache(dtype, hm: bool, shape, seed: int, device):
    """A random stacked KV cache (k, v, ks, vs) of `shape` (L, B, S, Hkv,
    dh), head-major (L, B, Hkv, S, dh) with `hm`; int8 with scale planes."""
    g = torch.Generator().manual_seed(seed)
    n_layer, b, s, hkv, dh = shape
    shape = (n_layer, b, hkv, s, dh) if hm else shape
    if dtype == torch.int8:
        k, v = (torch.randint(-127, 128, shape, generator=g, dtype=torch.int8) for _ in "kv")
        ks, vs = (torch.rand(shape[:-1], generator=g) * 0.02 + 1e-3 for _ in "kv")
        return tuple(a.to(device) for a in (k, v, ks, vs))
    k, v = (torch.randn(shape, generator=g).to(dtype).to(device) for _ in "kv")
    return k, v, None, None


# cdt f32: f32 sums in another order; bf16, f16 and int8: p rounded to cdt
# as the plain version rounds it (a rounding flips only where expf and the
# f32 sums land within an ulp of a rounding boundary)
ATTN_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-4, torch.float16: 1e-4, torch.int8: 1e-4}


@pytest.mark.parametrize("dtype", list(ATTN_TOL))
@pytest.mark.parametrize("hm", [False, True])
@pytest.mark.parametrize("h,hkv,dh", [(4, 4, 128), (8, 4, 128), (32, 8, 128), (8, 2, 64),
                                     (24, 8, 256), (16, 2, 64)])
@pytest.mark.parametrize("window", [None, 256])
@pytest.mark.parametrize("alibi", [False, True])
def test_decode_attn_matches_plain(dev, dtype, hm, h, hkv, dh, window, alibi):
    s, b = 768, 3
    k, v, ks, vs = random_cache(dtype, hm, (2, b, s, hkv, dh), seed=h + dh, device=dev)
    g = torch.Generator().manual_seed(dh)
    q = torch.randn((b, h, dh), generator=g).to(dev)
    top = (window or s) - 1
    n_past = torch.tensor([0, top // 2 + 7, top], dtype=torch.int32, device=dev)
    slopes = (torch.rand(h, generator=g) * 0.1).to(dev) if alibi else None
    kw = dict(window=window, k_scale=ks, v_scale=vs, alibi_slopes=slopes, head_major=hm)
    launches, plain = A.LAUNCHES["decode_attn"], A.PLAIN_CALLS["decode_attn"]
    got = A.decode_attention(q, k, v, 1, n_past, **kw)
    torch.cuda.synchronize()
    assert A.LAUNCHES["decode_attn"] == launches + 1
    assert A.PLAIN_CALLS["decode_attn"] == plain  # never the plain version on the card
    ref = A.plain_decode_attention(q, k, v, 1, n_past, **kw)
    assert torch.isfinite(got).all()
    assert _rel(got, ref) < ATTN_TOL[dtype], _rel(got, ref)


def test_decode_attn_refuses_what_it_does_not_take(dev):
    k, v, _, _ = random_cache(torch.float32, False, (1, 1, 256, 2, 64), 0, dev)
    ki, vi, ks, vs = random_cache(torch.int8, False, (1, 1, 256, 2, 64), 1, dev)
    q = torch.randn(1, 4, 64, device=dev)
    n_past = torch.tensor([10], dtype=torch.int32, device=dev)
    run = A.decode_attention
    bad = {
        "f64 q": lambda: run(q.double(), k, v, 0, n_past),
        "f64 cache": lambda: run(q, k.double(), v.double(), 0, n_past),
        "strided cache": lambda: run(q, k.transpose(2, 3), v.transpose(2, 3), 0, n_past,
                                     head_major=True),
        "strided q": lambda: run(torch.randn(1, 4, 128, device=dev)[..., ::2], k, v, 0, n_past),
        "3 heads over 2": lambda: run(q[:, :3].contiguous(), k, v, 0, n_past),
        "9 heads a kv head": lambda: run(torch.randn(1, 18, 64, device=dev), k, v, 0, n_past),
        "width 48": lambda: run(q[..., :48].contiguous(), k[..., :48].contiguous(),
                                v[..., :48].contiguous(), 0, n_past),
        "width 16": lambda: run(q[..., :16].contiguous(), k[..., :16].contiguous(),
                                v[..., :16].contiguous(), 0, n_past),
        "int64 n_past": lambda: run(q, k, v, 0, n_past.long()),
        "n_past on the CPU": lambda: run(q, k, v, 0, n_past.cpu()),
        "int8 without scales": lambda: run(q, ki, vi, 0, n_past),
        "f32 with scales": lambda: run(q, k, v, 0, n_past, k_scale=ks, v_scale=vs),
        "strided scales": lambda: run(q, ki, vi, 0, n_past, k_scale=ks.transpose(2, 3),
                                      v_scale=vs.transpose(2, 3)),
        "layer 1 of 1": lambda: run(q, k, v, 1, n_past),
    }
    launches = A.LAUNCHES["decode_attn"]
    for what, call in bad.items():
        with pytest.raises(ValueError):
            call()
            pytest.fail(what)
    assert A.LAUNCHES["decode_attn"] == launches


def test_decode_attn_raises_on_a_launch_error(dev, monkeypatch):
    """A launch the kernel refuses (here: one chunk's scores above the
    card's shared memory, past the wrapper's own check) raises and counts
    nothing."""
    monkeypatch.setattr(A, "MAX_CHUNK_SCORE_BYTES", 1 << 40)
    k, v, _, _ = random_cache(torch.float32, False, (1, 1, 8000, 1, 64), 0, dev)
    q = torch.randn(1, 8, 64, device=dev)
    n_past = torch.tensor([7999], dtype=torch.int32, device=dev)
    assert A.decode_chunk(8000) == 8000  # 8 heads x 8000 scores = 256 KB
    launches = A.LAUNCHES["decode_attn"]
    with pytest.raises(RuntimeError, match="launch failed"):
        A.decode_attention(q, k, v, 0, n_past)
    assert A.LAUNCHES["decode_attn"] == launches


# -- the fused decode loop -------------------------------------------------------


TINY = dict(n_vocab=512, n_ctx=128, n_embd=256, n_ff=512, n_layer=2)


@pytest.fixture(scope="module")
def tiny_q4km(dev, tmp_path_factory):
    """A tiny Q4_K_M llama (Q6_K v, down and output) written from a seed."""
    from ctransformers_tpu_torch.models.synthetic import write_llama_gguf

    path = str(tmp_path_factory.mktemp("fused") / "tiny_q4km.gguf")
    write_llama_gguf(path, mix="Q4_K_M", seed=1, **TINY)
    return path


def _eager_greedy(llm, prompt: str, n: int, every: int):
    """The eval/argmax loop from an empty context: n tokens and the logits
    after every `every` tokens."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        llm.reset()
    llm.eval(llm.tokenize(prompt))
    toks, logits = [], {}
    for i in range(n):
        toks.append(int(np.argmax(llm.logits)))
        llm.eval([toks[-1]])
        if (i + 1) % every == 0:
            logits[i + 1] = llm.logits.copy()
    return toks, logits


def _fused_greedy(llm, prompt: str, n: int, chunk: int):
    """generate_fast greedy in segments of `chunk`: its tokens and the logits
    after each segment."""
    eng = llm._engine
    seen = {}
    decode = eng.decode

    def recording(*args, **kw):
        out = decode(*args, **kw)
        seen[eng.n_past] = eng.logits.copy()
        return out

    eng.decode = recording
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            llm.reset()
        ids = llm.tokenize(prompt)
        llm.generate_fast(prompt, max_new_tokens=n, temperature=0.0, repetition_penalty=1.0,
                          chunk=chunk)
    finally:
        del eng.decode
    return llm._context[len(ids):], {k - len(ids): v for k, v in seen.items()}


@pytest.mark.parametrize("kv_dtype,layout", [("f32", "sm"), ("bf16", "sm"), ("int8", "hm")])
def test_graph_decode_equals_the_eager_loop(dev, tiny_q4km, kv_dtype, layout, monkeypatch):
    """Greedy generate_fast replays one captured step per token: its tokens
    equal the eager loop's and the logits at each segment's end are bitwise
    the eager ones; a second call replays the same graph (no capture), and
    the replays launched what the capture recorded, once per token."""
    import ctransformers_tpu_torch as T

    monkeypatch.setenv("CT_QMM_AUTOTUNE", "0")
    monkeypatch.setenv("CT_KV_LAYOUT", layout)
    llm = T.AutoModelForCausalLM.from_pretrained(tiny_q4km, kv_dtype=kv_dtype)
    want, want_logits = _eager_greedy(llm, "the big cat", 24, 8)
    eng = llm._engine
    got, got_logits = _fused_greedy(llm, "the big cat", 24, 8)
    assert eng.n_compile == 1 and eng.timings()["t_compile_ms"] > 0
    assert got == want[:len(got)] and (len(got) == 24 or llm.is_eos_token(want[len(got)]))
    assert got_logits and all(np.array_equal(got_logits[c], want_logits[c]) for c in got_logits)
    again, _ = _fused_greedy(llm, "the big cat", 24, 8)
    assert again == got and eng.n_compile == 1
    stats = eng.graph_launches()
    (graph,) = eng._graphs.values()
    assert graph.replays == 2 * max(got_logits)  # every decoded token, a dropped tail too
    assert stats["recorded"]["decode_attn"] == TINY["n_layer"]
    assert stats["replayed"]["decode_attn"] == TINY["n_layer"] * graph.replays


def test_a_changed_key_setting_captures_again(dev, tiny_q4km, tmp_path, monkeypatch):
    """A setting the step reads at capture (pick_mode's environment) is in
    the graph key: changing it captures a new graph, which computes the
    same tokens; the sampler settings are in the key too."""
    import ctransformers_tpu_torch as T

    monkeypatch.setenv("CT_QMM_AUTOTUNE", "0")
    llm = T.AutoModelForCausalLM.from_pretrained(tiny_q4km)
    eng = llm._engine
    first = llm.generate_fast("hello", max_new_tokens=8, temperature=0.0, chunk=8)
    assert eng.n_compile == 1
    monkeypatch.setenv("CT_QMM_AUTOTUNE", "precompiled")
    monkeypatch.setenv("CT_QMM_TILE_CACHE", str(tmp_path / "empty.json"))
    assert llm.generate_fast("hello", max_new_tokens=8, temperature=0.0, chunk=8) == first
    assert eng.n_compile == 2
    a = llm.generate_fast("hello", max_new_tokens=8, seed=3, top_k=20, chunk=8)
    assert eng.n_compile == 3
    assert llm.generate_fast("hello", max_new_tokens=8, seed=3, top_k=20, chunk=8) == a
    assert eng.n_compile == 3


def test_a_capture_raises_on_an_unsettled_key(dev, tmp_path, monkeypatch):
    """A key the tables do not hold would race; inside a capture pick_mode
    raises instead of baking the fixed rule's kernel into the graph."""
    monkeypatch.setenv("CT_QMM_AUTOTUNE", "1")
    monkeypatch.setenv("CT_QMM_TILE_CACHE", str(tmp_path / "empty.json"))
    monkeypatch.delenv("CT_QMATMUL", raising=False)
    qt = random_q4k(256, 384, seed=9, device=dev)
    x = torch.randn(1, 256, device=dev)
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="not settled"):
        with torch.cuda.graph(graph):
            qmatmul(x, qt)
    assert 1 not in qt.picks
    qmatmul(x, qt)  # outside a capture the key races and settles
    assert 1 in qt.picks


# -- the probe kernels (ops/probes.py, csrc/probe_*.cu) ------------------------

from ctransformers_tpu_torch.ops import probes as PR  # noqa: E402


def _probe_close(got, ref, tol):
    if tol == 0:
        assert got.dtype == ref.dtype and torch.equal(got, ref), PR.max_err(got, ref)
    else:
        assert PR.max_err(got, ref)[1] <= tol, PR.max_err(got, ref)


def _seeded(shape, lo, hi, dtype, seed, dev):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(lo, hi, shape, generator=g, dtype=dtype).to(dev)


def _randn(shape, seed, dev):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed)).to(dev)


@pytest.mark.parametrize("m,k,n", [(8, 512, 256), (16, 1024, 1024), (3, 64, 128)])
def test_probe_dot_matches_plain(dev, m, k, n):
    xi = _seeded((m, k), -128, 128, torch.int8, 1, dev)
    wi = _seeded((k, n), -128, 128, torch.int8, 2, dev)
    xf, wf = _randn((m, k), 3, dev), _randn((k, n), 4, dev)
    # the FFMA dots on random-normal f32 x: f32 sums of k products in another
    # order than the library's, ~sqrt(k) roundings of the sum's size (k 1024
    # read 1.07e-6 of the largest output): 1e-5; on the probes' own operands
    # (integer-valued x, test_probe_script_checks_pass_at_its_shapes) 1e-6
    cases = [((xi, wi, "s8"), {}, 0), ((xi, wi, "s8"), dict(out_dtype=torch.float32), 0),
             ((xf, wi, "f32"), {}, 1e-5), ((xf, wf, "f32"), {}, 1e-5),
             ((xf.bfloat16(), wf.bfloat16(), "bf16"), {}, 1e-5), ((xf, wf, "bf16"), {}, 1e-5),
             ((xf, wi, "bf16"), dict(floor=True), 1e-5)]
    for args, kw, tol in cases:
        _probe_close(PR.probe_dot(*args, **kw), PR.plain_probe_dot(*args, **kw), tol)
    g = 32
    xg, wg = xf.reshape(m, k // g, g).transpose(0, 1).contiguous(), wf.reshape(k // g, g, n)
    _probe_close(PR.probe_dot(xg, wg, "f32"), PR.plain_probe_dot(xg, wg, "f32"), 1e-5)
    a = _seeded((m, k), -32768, 32768, torch.int16, 5, dev)
    for b in (_seeded((k, n), -128, 128, torch.int8, 6, dev),
              _seeded((k, n), -255 if k <= 256 else -63, 64 if k > 256 else 256, torch.int16, 7, dev)):
        _probe_close(PR.probe_dot(a, b, "s16"), PR.plain_probe_dot(a, b, "s16"), 0)
    parts, s = _randn((k // g, m, n), 8, dev), _randn((k // g, n), 9, dev)
    _probe_close(PR.probe_rescale(parts, s), PR.plain_probe_rescale(parts, s), 1e-6)


@pytest.mark.parametrize("variant", ["B", "D", "E", "C"])
def test_probe_dot_bf16_steps_match_plain(dev, variant):
    tk = 1024
    x, w = _randn((8, 2 * tk), 10, dev), _randn((tk, 1024), 11, dev)
    kw = {"B": dict(steps=2, k_step=tk // 2, x_step=tk // 2, w_step=tk // 2),
          "D": dict(steps=2, k_step=tk, x_step=tk, w_step=tk),
          "E": dict(steps=2, k_step=tk, x_step=tk, twice=True),
          "C": dict(k_step=tk, floor=True)}[variant]
    if variant == "D":
        w = torch.cat([w, w])
    _probe_close(PR.probe_dot(x, w, "bf16", **kw), PR.plain_probe_dot(x, w, "bf16", **kw), 1e-5)


NIBBLE_CASES = [("i4", "planes", None), ("swar", "planes", None), ("i4", "colsum", None),
                ("i4", "gcolsum", None), ("i4", "dot_bf16", "bf16"), ("floor", "dot_bf16", "bf16"),
                ("i4", "dot_s8", "nat"), ("i4", "gdot_s8", "grp")]


@pytest.mark.parametrize("unpack,consumer,act", NIBBLE_CASES)
@pytest.mark.parametrize("m,k,n", [(8, 512, 256), (1, 4096, 1024), (5, 1024, 128)])
def test_probe_nibble_matches_plain(dev, unpack, consumer, act, m, k, n):
    qs = _seeded((k // 2, n), -128, 128, torch.int8, 12, dev)
    x = None
    if act == "bf16":
        x = _randn((m, k), 13, dev).bfloat16()
    elif act:
        x = _seeded((m, k), -127, 128, torch.int8, 14, dev)
        x = PR.group_x(x) if act == "grp" else x
    tol = 1e-5 if consumer == "dot_bf16" else 0
    _probe_close(PR.probe_nibble(qs, unpack, consumer, x),
                 PR.plain_probe_nibble(qs, unpack, consumer, x), tol)


@pytest.mark.parametrize("m", [1, 8, 128])
@pytest.mark.parametrize("stage", ["full", "nodot", "norescale", "nocast"])
def test_probe_nibble_stages_match_plain(dev, m, stage):
    k, n = 4096, 2048
    qt, sp = PR.q4k_weight(k, n, 0, "cuda")
    xg, sx = PR.quant_q3(_randn((m, k), 15, dev))
    w, unpack = (PR.unpack_s8_grid(qt.qs), "s8") if stage == "nocast" else (qt.qs, "i4")
    kst = "full" if stage == "nocast" else stage
    kw = dict(sx=None if stage == "norescale" else sx, s=None if stage == "norescale" else sp,
              stage=kst)
    x = None if stage == "nodot" else xg
    _probe_close(PR.probe_nibble(w, unpack, "gdot", x, **kw),
                 PR.plain_probe_nibble(w, unpack, "gdot", x, **kw), 0 if stage == "norescale" else 1e-6)


@pytest.mark.parametrize("m", [1, 8, 128])
def test_probe_qp_forms_equal_the_q_form_bitwise(dev, m):
    k, n = 4096, 11264
    qt, sp = PR.q4k_weight(k, n, 0, "cuda")
    xg, xe, xo, xp, sx, sx16 = PR.quant_q5(_randn((m, k), 16, dev) * 0.5)
    q = PR.probe_nibble(qt.qs, "i4", "gdot", xg, sx=sx, s=sp)
    _probe_close(q, PR.plain_probe_nibble(qt.qs, "i4", "gdot", xg, sx=sx, s=sp), 1e-6)
    for form, x, xb in (("A", xe, xo), ("B", xp, None), ("C", xp, None)):
        got = PR.probe_nibble(qt.qs, "swar", "gdot", x, xb, sx=sx16, s=sp, form=form)
        _probe_close(got, q, 0)


@pytest.mark.parametrize("m", [1, 8])
def test_probe_full_stage_is_qmm_q_q4_0(dev, m):
    """The i4 / full instantiation computes what ct_qmm_q_q4_0 does on the
    same operands (the Q4_K nibbles with the f32 scale plane, no bias)."""
    k, n = 4096, 11264
    qt, sp = PR.q4k_weight(k, n, 0, "cuda")
    xg, sx = PR.quant_q3(_randn((m, k), 17, dev))
    full = PR.probe_nibble(qt.qs, "i4", "gdot", xg, sx=sx, s=sp)
    q40 = QTensor(qt.qs, sp, None, "Q4_0", 32, qt.shape, packed=True, zp=8, sfactor=0,
                  pack_layout="adjk")
    xq = xg.transpose(0, 1).reshape(m, k).contiguous()
    ref = K.qmm_q_q4_0(xq, sx.T.contiguous(), sx.T.contiguous(), q40)
    _probe_close(full, ref, 1e-6)


@pytest.mark.parametrize("layout,shape,tile", [
    ("strided", (4096, 22528), (2048, 1024)), ("strided", (4096, 22528), (512, 1024)),
    ("full", (4096, 22528), (256, None)), ("tiled3d", (22, 4096, 1024), (2048, 1024)),
    ("strided", (64, 512), (32, 256))])
@pytest.mark.parametrize("bands", [1, 6])
def test_probe_stream_matches_plain(dev, layout, shape, tile, bands):
    a = _seeded(shape, 0, 256, torch.uint8, 18, dev)
    t = PR.stream_tiling(layout, shape, tile)
    got = PR.probe_stream(a, t, bands)
    ref = PR.plain_probe_stream(a, t, bands)
    assert got.dtype == torch.int32 and torch.equal(got.double(), ref)


def test_probe_wrappers_raise_on_refused_arguments(dev):
    qs = torch.zeros((16, 40), dtype=torch.int8, device=dev)  # N not a multiple of 32
    with pytest.raises(RuntimeError, match="probe_nibble"):
        PR.probe_nibble(qs, "i4", "colsum")
    with pytest.raises(RuntimeError, match="probe_dot"):  # N not a multiple of 64
        PR.probe_dot(torch.zeros((8, 16), dtype=torch.int8, device=dev),
                     torch.zeros((16, 32), dtype=torch.int8, device=dev), "s8")
    with pytest.raises(ValueError, match="CUDA only"):
        PR.probe_dot(torch.zeros((8, 16), dtype=torch.int8, device=dev),
                     torch.zeros((16, 64), dtype=torch.int8), "s8")


@pytest.mark.parametrize("script", ["int8_dot", "bf16_dot", "int4", "mmvq", "q3", "q5", "q5b", "dma"])
def test_probe_script_checks_pass_at_its_shapes(dev, script):
    """Each scripts/torch_probe_*.py holds its kernels against their plain
    versions at the JAX script's own shapes (no timing)."""
    import importlib.util
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(root, "scripts", f"torch_probe_{script}.py")
    spec = importlib.util.spec_from_file_location(f"torch_probe_{script}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    lines = []
    before = dict(PR.LAUNCHES)
    mod.run(PR.Runner("cuda", check=True, time=False, out=lines.append))
    assert lines and not [ln for ln in lines if "FAIL" in ln]
    assert sum(PR.LAUNCHES.values()) > sum(before.values())
