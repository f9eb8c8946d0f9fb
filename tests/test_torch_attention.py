"""Attention of the port against the JAX package's on the CPU:
plain_decode_attention (the decode kernel's plain version) against the
Pallas decode_attention in interpret mode, and the prompt-chunk scores
(_full_scores, _chunked_scores) against the JAX functions, for f32, bf16,
IEEE f16 and int8 caches in both layouts. Inputs are made with numpy from
a seed and handed to both packages."""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ctransformers_tpu.ops.qmatmul  # noqa: F401  (the Pallas module's relative import)
from ctransformers_tpu.models import forward as jf
from ctransformers_tpu.models.spec import ArchSpec as JSpec
from ctransformers_tpu_torch.models import forward as tf
from ctransformers_tpu_torch.models.spec import ArchSpec as TSpec
from ctransformers_tpu_torch.ops import attention as A

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16, "ieee_f16": jnp.float16, "int8": jnp.int8}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16, "ieee_f16": torch.float16,
       "int8": torch.int8}


@pytest.fixture(scope="module")
def pallas():
    """scripts/_attention_kernel.py loaded as a module of the JAX package's
    ops/, so that its `from .qmatmul import _dot_prec` resolves (a plain
    import of the script fails on that relative import)."""
    spec = importlib.util.spec_from_file_location(
        "ctransformers_tpu.ops._attention_kernel",
        os.path.join(ROOT, "scripts", "_attention_kernel.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def random_cache(name: str, shape, seed: int):
    """numpy (k, v, ks, vs) of a sequence-major cache `shape` (L, B, S, Hkv,
    dh): int8 values with f32 scales, or f32 values rounded to the dtype."""
    rng = np.random.default_rng(seed)
    if name == "int8":
        k, v = (rng.integers(-127, 128, shape).astype(np.int8) for _ in "kv")
        ks, vs = (rng.uniform(1e-3, 0.02, shape[:-1]).astype(np.float32) for _ in "kv")
        return k, v, ks, vs
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in "kv")
    return k, v, None, None


def _hm(a):
    """A sequence-major (L, B, S, Hkv[, dh]) numpy plane made head-major."""
    return None if a is None else np.ascontiguousarray(np.swapaxes(a, 2, 3))


def _torch(a, name=None):
    if a is None:
        return None
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(TDT[name]) if name and a.dtype == np.float32 else t


# (cache dtype, head-major, H, Hkv, ALiBi, window) at L 2, B 2, S 256, dh 16,
# n_past (5, 200) (window 128: (5, 120)), chunk 64: every dtype in both
# layouts, GQA at rep 4, ALiBi, a window below the cache
DECODE_CASES = [
    ("f32", False, 4, 2, False, None, 16), ("f32", True, 4, 2, False, None, 16),
    ("bf16", False, 4, 2, False, None, 16), ("bf16", True, 4, 4, False, 128, 16),
    ("ieee_f16", True, 4, 2, False, None, 16), ("int8", False, 4, 2, False, None, 16),
    ("int8", True, 8, 2, False, None, 16), ("bf16", False, 8, 2, False, None, 16),
    ("f32", True, 4, 2, True, None, 16), ("int8", False, 4, 1, True, 128, 16),
    # llama head shapes past the kernel's first template: widths 48, 80 and
    # 100 (n_embd / n_head of 3B-class files), and 16 query heads over one
    # kv head (two blocks of 8 on the card)
    ("f32", False, 4, 2, False, None, 48), ("bf16", True, 4, 2, False, None, 80),
    ("int8", False, 4, 2, False, None, 100), ("bf16", False, 16, 1, False, None, 16),
    # widths above 256, whose scores the port sums per column slice of 256
    # (the kernel's slices) in slice order
    ("f32", True, 4, 1, True, None, 320), ("bf16", False, 4, 1, False, 128, 512),
    ("int8", True, 8, 2, False, None, 264),
]
# ids as before the head width joined the cases; other widths append it
DECODE_IDS = ["-".join(map(str, c[:6])) + ("" if c[6] == 16 else f"-dh{c[6]}")
              for c in DECODE_CASES]
# both round q and p to cdt at the same places and sum in f32 in another
# order, so a rounding flips only where the sums land within an ulp of a
# bf16 / f16 boundary: 1.8e-8..4.1e-7 measured here, every dtype
DECODE_TOL = 1e-5


@pytest.mark.parametrize("name,hm,h,hkv,alibi,window,dh", DECODE_CASES, ids=DECODE_IDS)
def test_plain_decode_attention_matches_pallas(pallas, name, hm, h, hkv, alibi, window, dh):
    n_layer, b, s, chunk = 2, 2, 256, 64
    k, v, ks, vs = random_cache(name, (n_layer, b, s, hkv, dh), seed=h * 10 + hkv)
    rng = np.random.default_rng(1)
    q = rng.standard_normal((b, h, dh)).astype(np.float32)
    top = (window or s) - 8
    n_past = np.array([5, top], np.int32)
    slopes = rng.uniform(0.01, 0.2, h).astype(np.float32) if alibi else None
    # the Pallas function reads a head-major cache only
    jk, jv = (jnp.asarray(_hm(a)).astype(JDT[name]) for a in (k, v))
    want = pallas.decode_attention(
        jnp.asarray(q), jk, jv, 1, jnp.asarray(n_past), window=window,
        k_scale=None if ks is None else jnp.asarray(_hm(ks)),
        v_scale=None if vs is None else jnp.asarray(_hm(vs)),
        alibi_slopes=None if slopes is None else jnp.asarray(slopes), chunk=chunk,
        interpret=True)
    lay = _hm if hm else (lambda a: a)
    A.reset_counts()
    got = A.decode_attention(
        torch.from_numpy(q), _torch(lay(k), name), _torch(lay(v), name), 1,
        torch.from_numpy(n_past), window=window, k_scale=_torch(lay(ks)),
        v_scale=_torch(lay(vs)), alibi_slopes=_torch(slopes), chunk=chunk, head_major=hm)
    assert A.PLAIN_CALLS["decode_attn"] == 1 and A.LAUNCHES["decode_attn"] == 0
    assert got.dtype == torch.float32 and got.shape == (b, h, dh)
    assert _rel(got, np.asarray(want)) < DECODE_TOL


def test_kernel_smem_bytes_bounds_the_card_widths():
    """The wrapper's one limit on the card: a block's shared memory (q rows
    at the padded width, a span of chunks' scores, an int8 cache's V
    scales, the PV sums). Every width up to 1024 fits at any chunk the
    default takes and any number of heads a kv head; a q row of 8 heads of
    8192 does not."""
    for dh in (16, 64, 100, 128, 256, 257, 320, 512, 1000, 1024):
        for rep in (1, 4, 8, 16):
            for quant in (False, True):
                for win in (256, 2048, 4096):
                    need = A.kernel_smem_bytes(rep, dh, win, A.decode_chunk(win), quant,
                                               scalar=dh % 4 != 0)
                    assert need <= A.MAX_SMEM_BYTES, (dh, rep, quant, win)
    # padded widths: 64, 128, 256, then slices of 256
    base = A.kernel_smem_bytes(8, 64, 512, 512, False, False)
    assert A.kernel_smem_bytes(8, 300, 512, 512, False, False) - base == 4 * 8 * (512 - 64)
    assert A.kernel_smem_bytes(8, 8192, 512, 512, False, False) > A.MAX_SMEM_BYTES


# the kernel's split of the window over a cluster (decode_plan): batch, kv
# heads, query heads a kv head, windows and SM counts of the card tests,
# chip_smoke.py's cases and the tiny served models
PLAN_SHAPES = [(b, hkv, rep) for b in (1, 2, 3, 4, 8) for hkv in (1, 2, 4, 8, 32)
               for rep in (1, 2, 4, 8, 16)]
PLAN_WINDOWS = (8, 64, 100, 128, 256, 300, 1000, 2048, 4096, 8000)


def test_decode_plan_is_a_power_of_two_of_the_shape_alone():
    """P and the group are powers of two up to 8, from B, Hkv, the query
    heads a kv head, the window and the SM count alone: the function takes
    no n_past."""
    import inspect

    assert list(inspect.signature(A.decode_plan).parameters) == ["batch", "hkv", "rep", "win",
                                                                  "sms"]
    for b, hkv, rep in PLAN_SHAPES:
        for win in PLAN_WINDOWS:
            for sms in (132, 114, 16):
                parts, rows, group = A.decode_plan(b, hkv, rep, win, sms)
                assert parts in (1, 2, 4, 8) and group in (1, 2, 4, 8) and group < 2 * rep
                assert (parts, rows, group) == A.decode_plan(b, hkv, rep, win, sms)
    # llama-2-7B at one slot: 32 clusters of 8, two blocks an SM of the
    # H100's 132; its GQA form (8 kv heads) a query head a group; four slots
    assert A.decode_plan(1, 32, 1, 2048, 132) == (8, 256, 1)
    assert A.decode_plan(1, 8, 4, 2048, 132) == (8, 256, 1)
    assert A.decode_plan(4, 32, 1, 2048, 132) == (2, 1024, 1)


def test_decode_plan_parts_tile_the_window():
    """Part i takes rows [i * rows, (i + 1) * rows) of the window: together
    every row once, no part empty."""
    for b, hkv, rep in PLAN_SHAPES:
        for win in PLAN_WINDOWS:
            parts, rows, _ = A.decode_plan(b, hkv, rep, win, 132)
            spans = [(i * rows, min(win, (i + 1) * rows)) for i in range(parts)]
            assert spans[0][0] == 0 and spans[-1][1] == win
            assert all(lo < hi for lo, hi in spans)
            assert all(spans[i][1] == spans[i + 1][0] for i in range(parts - 1))


def test_decode_plan_fills_the_card_where_the_window_allows():
    """The grid fits two blocks an SM, and doubles its split until it
    would not, P reaches 8 or a part would fall below MIN_PART rows; the
    group is halved while the grid gives an SM at most one block."""
    for b, hkv, rep in PLAN_SHAPES:
        for win in PLAN_WINDOWS:
            for sms in (132, 114):
                parts, rows, group = A.decode_plan(b, hkv, rep, win, sms)
                units = b * hkv * -(-rep // group)
                assert parts == 1 or units * parts <= 2 * sms
                assert (parts == A.MAX_PARTS or win < 2 * parts * A.MIN_PART
                        or units * 2 * parts > 2 * sms)
                assert parts == 1 or rows >= A.MIN_PART
                assert group == 1 or units * parts > sms


def test_kernel_smem_bytes_fits_every_plan():
    """Every shape of test_kernel_smem_bytes_bounds_the_card_widths fits a
    block under the split and group the plan takes for it, and a split never
    needs more shared memory than the whole window in one block."""
    for dh in (16, 64, 100, 128, 256, 257, 320, 512, 1000, 1024):
        for rep in (1, 4, 8, 16):
            for quant in (False, True):
                for win in (256, 2048, 4096):
                    for b, hkv in ((1, 1), (1, 32), (4, 8)):
                        parts, _, group = A.decode_plan(b, hkv, rep, win, 132)
                        args = (dh, win, A.decode_chunk(win), quant, dh % 4 != 0)
                        need = A.kernel_smem_bytes(group, *args, parts)
                        assert need <= min(A.MAX_SMEM_BYTES, A.kernel_smem_bytes(rep, *args))


def test_decode_chunk_divides_the_window_as_the_pallas_function():
    assert [A.decode_chunk(w) for w in (128, 256, 768, 1024, 2048, 300, 1000)] == [
        128, 256, 256, 512, 512, 300, 1000]
    assert A.decode_chunk(256, 64) == 64


def test_plain_decode_attention_needs_no_chunk_past_n_past():
    """The kernel stops after the chunk that holds n_past: the chunks after
    it are fully masked and change nothing, bit for bit."""
    k, v, _, _ = random_cache("bf16", (1, 1, 512, 2, 16), seed=3)
    q = torch.from_numpy(np.random.default_rng(2).standard_normal((1, 4, 16)).astype(np.float32))
    n_past = torch.tensor([100], dtype=torch.int32)
    kt, vt = _torch(k, "bf16"), _torch(v, "bf16")
    full = A.plain_decode_attention(q, kt, vt, 0, n_past, chunk=64)
    cut = A.plain_decode_attention(q, kt, vt, 0, n_past, chunk=64, window=128)
    assert torch.equal(full, cut)


def _specs(h=4, hkv=2, dh=16):
    kw = dict(name="llama", n_vocab=64, n_ctx=256, n_embd=h * dh, n_head=h, n_head_kv=hkv,
              n_layer=1, n_ff=64, rope_mode="interleaved", n_rot=dh, norm="rmsnorm",
              act="silu_gate")
    return JSpec(**kw), TSpec(**kw)


@pytest.mark.parametrize("name", list(JDT))
@pytest.mark.parametrize("hm", [False, True])
@pytest.mark.parametrize("chunked", [False, True])
def test_prompt_scores_match_jax(name, hm, chunked, monkeypatch):
    """_full_scores / _chunked_scores of a prompt chunk (T 24 at n_past 40
    over a 128-position window) with the compute-dtype rules of the JAX
    package: cdt bf16 for int8; q rounded to cdt; scores times k_scale after
    the dot; probabilities times v_scale, then rounded to cdt. The port
    computes in f32 over exactly upcast operands, as JAX keeps the f32 result
    of a bf16 product: only the f32 sums' order differs (1e-5)."""
    monkeypatch.setenv("CT_KV_LAYOUT", "hm" if hm else "sm")
    monkeypatch.setenv("CT_ATTN_CHUNK", "32")
    js, ts = _specs(h=8, hkv=2)
    b, t, s, n_past = 2, 24, 128, 40
    k, v, ks, vs = random_cache(name, (1, b, s, 2, 16), seed=5)
    k, v, ks, vs = (None if a is None else (_hm(a) if hm else a)[0] for a in (k, v, ks, vs))
    q = np.random.default_rng(6).standard_normal((b, t, 8, 16)).astype(np.float32)
    jfn = jf._chunked_scores if chunked else jf._full_scores
    tfn = tf._chunked_scores if chunked else tf._full_scores
    want = jfn(js, jnp.asarray(q), jnp.asarray(k).astype(JDT[name]),
               jnp.asarray(v).astype(JDT[name]), jnp.int32(n_past),
               None if ks is None else jnp.asarray(ks), None if vs is None else jnp.asarray(vs))
    got = tfn(ts, torch.from_numpy(q), _torch(k, name), _torch(v, name), n_past,
              _torch(ks), _torch(vs), hm=hm)
    assert _rel(got, np.asarray(want)) < 1e-5
