"""The probe kernels of scripts/probe_*.py as hand-written Hopper kernels,
their plain PyTorch versions, the probe scripts' host helpers, a launch
counter of their own and the timing helper of scripts/torch_probe_*.py.

The JAX package's probe scripts asked the TPU what an operand pair, a
nibble unpack, an integer dot, a rescale or a DMA pattern costs on a
llama-7B tile. Their kernels are ported as four symbols in three sources:

  probe_dot     (csrc/probe_dot.cu) the dots of probe_int8_dot.py,
                probe_bf16_dot.py and the int16 dots of probe_q5.py: s8 x s8
                and bf16 x bf16 on tensor cores, f32 x s8 and batched f32 on
                CUDA-core FFMA, s16 x s8 through dp2a and s16 x s16 through IMAD
  probe_rescale (csrc/probe_dot.cu) the per-group rescale epilogue of
                probe_int8_dot.py:133
  probe_nibble  (csrc/probe_nibble.cu) unpack {i4, swar, s8, floor} x
                consumer {planes, colsum, gcolsum, dot_bf16, dot_s8, gdot_s8,
                gdot} x stage {full, nodot, norescale}: probe_int4.py,
                probe_mmvq.py, probe_q3.py, probe_q5.py and probe_q5b.py
  probe_stream  (csrc/probe_stream.cu) every byte of a tiled uint8 array
                summed, one block a tile (or a band of one): probe_dma.py

The sources are built with the qmm kernels (ops/qmm_kernels.py:build) but
lie outside the hash that the kernel tables are tied to (their names do not
start with "qmm_"). The counters here are their own (LAUNCHES): the probes
run in no model's main path, so chip_smoke.py drives them in their own
phase, through the scripts.

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version (the rule of ops/qmm_kernels.py). There is no fallback from one to
the other.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import qmm_kernels as K

_CSRC = "ctransformers_tpu_torch/csrc/"
SOURCE_OF = {"probe_dot": _CSRC + "probe_dot.cu", "probe_rescale": _CSRC + "probe_dot.cu",
             "probe_nibble": _CSRC + "probe_nibble.cu", "probe_stream": _CSRC + "probe_stream.cu"}
# the pl.pallas_call each symbol replaces first (PERF.md rows 14a-14h list all)
REPLACES = {"probe_dot": "scripts/probe_int8_dot.py:29", "probe_rescale": "scripts/probe_int8_dot.py:29",
            "probe_nibble": "scripts/probe_int4.py:97", "probe_stream": "scripts/probe_dma.py:94"}
# kernel launches (incremented only where a kernel is launched, or replayed
# by time_graph) and calls of the plain versions through the wrappers
LAUNCHES: Dict[str, int] = dict.fromkeys(SOURCE_OF, 0)
PLAIN_CALLS: Dict[str, int] = dict.fromkeys(SOURCE_OF, 0)

# published H100 SXM peaks (dense): HBM rate, int8 and bf16 tensor-core
# rates, f32 outside the tensor cores (also taken for the CUDA-core integer
# dots, which have no peak of their own in the data sheet)
PEAK_BYTES_S = 3.35e12
PEAK_INT8_S = 1979e12
PEAK_BF16_S = 989e12
PEAK_F32_S = 67e12
GROUP = 32  # rows a quant group in every grouped probe
L2_BYTES = 50e6
GRAPH_CALLS = 50  # calls of a probe in one timed CUDA graph

# dtype codes of csrc/probe_dot.cu
_DT = {torch.int8: 0, torch.int16: 1, torch.bfloat16: 2, torch.float32: 3, torch.int32: 4}
DOT_OPS = {"s8": 0, "bf16": 1, "f32": 2, "s16": 3}
UNPACKS = {"i4": 0, "swar": 1, "s8": 2, "floor": 3}
CONSUMERS = {"planes": 0, "colsum": 1, "gcolsum": 2, "dot_bf16": 3, "dot_s8": 4, "gdot_s8": 5,
             "gdot": 6}
STAGES = {"full": 0, "nodot": 1, "norescale": 2}
FORMS = {"q": 0, "A": 1, "B": 2, "C": 3}


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


def _launch(name: str, lib: str, *args) -> None:
    rc = K._fn(lib, "ct_" + name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")
    LAUNCHES[name] += 1


def _ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return K._ptrs(t)[0]


def _cuda(name: str, *ts: Optional[torch.Tensor]) -> bool:
    """True for CUDA tensors (the kernel), False for CPU ones (the plain
    version); raises on a mix or another device, and on CUDA tensors that
    are not contiguous."""
    devs = {t.device.type for t in ts if t is not None}
    if devs == {"cpu"}:
        return False
    if devs != {"cuda"}:
        raise ValueError(f"{name}: tensors on {sorted(devs)}; the kernel runs on CUDA only")
    if not all(t.is_contiguous() for t in ts if t is not None):
        raise ValueError(f"{name}: operands must be contiguous")
    return True


def _bf16_round(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


# -- the probe scripts' host helpers ------------------------------------------


def pack_adjacent_k(w4: np.ndarray) -> np.ndarray:
    """(K, N) int values in [-8, 7] -> (K/2, N) int8 bytes, row k holding
    rows 2k (low nibble) and 2k + 1 (high), two's complement: the adjk
    layout (probe_int4.py:34). qmm_kernels.unpack_w4 is its inverse (the
    script's unpack_ref)."""
    lo = (w4[0::2] & 0xF).astype(np.uint8)
    hi = (w4[1::2] & 0xF).astype(np.uint8)
    return ((hi << 4) | lo).view(np.int8)


def unpack_s8_grid(qs: torch.Tensor) -> torch.Tensor:
    """adjk bytes (K/2, N) -> the int8 grid (K, N) of their signed nibbles:
    the host unpack of probe_q3.py:165 ("nocast" stage)."""
    return K.unpack_w4(qs).to(torch.int8)


def swar_planes(qs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """adjk bytes -> (lo, hi) int8 planes of the same shape, each byte 16 x
    its signed nibble (lo: the even rows, hi: the odd ones), probe_q5.py:48:
    lo = (v & 0x0F0F0F0F) << 4, hi = v & 0xF0F0F0F0, masks that act per byte."""
    u = qs.view(torch.uint8).to(torch.int32)
    return (((u & 0x0F) << 4) & 0xFF).to(torch.uint8).view(torch.int8), \
        (u & 0xF0).to(torch.uint8).view(torch.int8)


def group_x(xq: torch.Tensor, group: int = GROUP) -> torch.Tensor:
    """int8 (m, K) -> (K / group, m, group), the pre-grouped form of the
    probes' activations."""
    m, k = xq.shape
    return xq.reshape(m, k // group, group).transpose(0, 1).contiguous()


def quant_q3(x: torch.Tensor, group: int = GROUP):
    """probe_q3.py:70-76: sx = (absmax + 1e-12) / 127 per (row, group),
    xq = clip(round(x / sx), -127, 127). Returns (xg (ng, m, g) int8, sx
    (ng, m) f32)."""
    m, k = x.shape
    xr = x.reshape(m, k // group, group)
    sx = (xr.abs().amax(-1) + 1e-12) / 127.0
    xq = torch.clamp(torch.round(xr / sx[:, :, None]), -127, 127).to(torch.int8)
    return xq.transpose(0, 1).contiguous(), sx.T.contiguous()


def quant_q5(x: torch.Tensor, group: int = GROUP):
    """probe_q5.py:138-150: sx = absmax / 127 + 1e-20, xq = clip(round(x /
    sx), -127, 127). Returns (xg (ng, m, g), xe, xo (ng, m, g/2): its even and
    odd columns, xp (ng, m, g): [evens | odds], sx (ng, m), sx / 16)."""
    m, k = x.shape
    xr = x.reshape(m, k // group, group)
    sx = xr.abs().amax(-1) / 127.0 + 1e-20
    xq = torch.clamp(torch.round(xr / sx[:, :, None]), -127, 127).to(torch.int8)
    xg = xq.transpose(0, 1).contiguous()
    xe, xo = xg[:, :, 0::2].contiguous(), xg[:, :, 1::2].contiguous()
    sxt = sx.T.contiguous()
    return xg, xe, xo, torch.cat([xe, xo], -1), sxt, sxt / 16.0


def quant_mmvq(x: torch.Tensor, group: int = GROUP):
    """probe_mmvq.py:152-155: xq = clip(round(x / max(absmax, 1e-8) * 127),
    -127, 127), sx = absmax / 127. Returns (xg (ng, m, g), sx (ng, m))."""
    m, k = x.shape
    xr = x.reshape(m, k // group, group)
    amax = xr.abs().amax(-1)
    xq = torch.clamp(torch.round(xr / torch.clamp_min(amax, 1e-8)[:, :, None] * 127.0), -127, 127)
    return xq.to(torch.int8).transpose(0, 1).contiguous(), (amax / 127.0).T.contiguous()


@functools.lru_cache(maxsize=2)
def q4k_weight(k: int, n: int, seed: int = 0, device: str = "cuda"):
    """A Q4_K QTensor (K, N) from random valid Q4_K blocks through the port's
    repack, and its f32 scale plane scale_planes(qt)[0] (K/32, N): the
    weight of probe_mmvq.py, probe_q3.py and probe_q5.py (random blocks
    instead of quantized Gaussians: the kernels' work does not depend on the
    values). Cached: the scripts run in one process share it."""
    from ..formats.quants import GGMLType
    from ..models.synthetic import random_q4k_blocks
    from .qmatmul import repack, scale_planes

    blocks = random_q4k_blocks(np.random.default_rng(seed), k * n)
    qt = repack(blocks, GGMLType.Q4_K, n, k).to(device)
    return qt, scale_planes(qt)[0].contiguous()


def clone_qtensor(qt):
    """A copy of a QTensor with planes of its own (another weight of the same
    key, for the L2 rotation of the production kernels' timing)."""
    planes = ("qs", "scales", "mins", "sd", "sm")
    return dataclasses.replace(qt, **{f: getattr(qt, f).clone() for f in planes
                                      if getattr(qt, f) is not None})


def plane_bytes(qt) -> int:
    return sum(a.numel() * a.element_size() for a in (qt.qs, qt.scales, qt.mins, qt.sd, qt.sm)
               if a is not None)


class Tiling(NamedTuple):
    """Tiles of a byte array by strides: tile (ty, tx) starts at ty *
    ty_stride + tx * tx_stride and holds `rows` rows of `cols` bytes,
    row_stride apart."""

    nty: int
    ntx: int
    rows: int
    cols: int
    row_stride: int
    ty_stride: int
    tx_stride: int


def stream_tiling(layout: str, shape: Tuple[int, ...], tile: Tuple[int, int]) -> Tiling:
    """The tiles of probe_dma.py's layouts: "strided" column tiles (tk, tn) of
    a row-major (K, N) array, "full" row tiles (tk, N) of it, and "tiled3d"
    (tk, tn) tiles of the same bytes pre-tiled to (N / tn, K, tn)."""
    tk, tn = tile
    if layout == "strided":
        k, n = shape
        return Tiling(k // tk, n // tn, tk, tn, n, tk * n, tn)
    if layout == "full":
        k, n = shape
        return Tiling(k // tk, 1, tk, n, n, tk * n, 0)
    if layout == "tiled3d":
        nn, k, tn3 = shape
        return Tiling(nn, k // tk, tk, tn3, tn3, k * tn3, tk * tn3)
    raise ValueError(f"unknown stream layout {layout!r}")


def pretile(a: torch.Tensor, tn: int) -> torch.Tensor:
    """(K, N) -> (N / tn, K, tn) contiguous: probe_dma.py's tiled3d storage."""
    k, n = a.shape
    return a.reshape(k, n // tn, tn).transpose(0, 1).contiguous()


# -- plain versions -----------------------------------------------------------


def plain_probe_dot(x, w, op: str, *, out_dtype=None, steps: int = 1, k_step: Optional[int] = None,
                    x_step: int = 0, w_step: int = 0, floor: bool = False,
                    twice: bool = False) -> torch.Tensor:
    """What probe_dot computes (see its wrapper). Integer dots go through f32
    products and sums, exact under 2**24 (s8 at K <= 1024), or float64 for
    s16 (exact under 2**53); bf16 operands are rounded and multiplied in
    f32 (a bf16 matmul on a CPU returns bf16)."""
    if op == "s8":
        r = x.float() @ w.float()
        return r if out_dtype == torch.float32 else r.to(torch.int32)
    if op == "s16":
        return (x.double() @ w.double()).to(torch.int32)
    if op == "f32":
        return torch.matmul(x, w.float())
    if op != "bf16":
        raise ValueError(f"unknown dot op {op!r}")
    k = k_step or w.shape[0]
    out = None
    for s in range(steps):
        xs = x[:, s * x_step:s * x_step + k].float()
        ws = w[s * w_step:s * w_step + k].float()
        if floor:
            f = torch.floor(ws * (1.0 / 16.0))
            ws = (ws - f * 16.0) + f
        if twice and s > 0:
            ws = ws * 2.0
        part = _bf16_round(xs) @ _bf16_round(ws)
        out = part if out is None else out + part
    return out


def plain_probe_rescale(parts: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return (parts * s[:, None, :]).sum(0)


def nibble_grid(qs: torch.Tensor, unpack: str) -> torch.Tensor:
    """The (K, N) grid a probe_nibble consumer sees, in logical row order:
    int32 for i4 (the signed nibbles), swar (16 x them) and s8 (the grid
    itself), f32 rows [l - 8 ; f - 8] for floor."""
    if unpack == "i4":
        return K.unpack_w4(qs)
    if unpack == "swar":
        lo, hi = swar_planes(qs)
        return torch.stack([lo, hi], 1).reshape(2 * qs.shape[0], qs.shape[1]).to(torch.int32)
    if unpack == "s8":
        return qs.to(torch.int32)
    if unpack == "floor":
        b = qs.float()
        f = torch.floor(b * (1.0 / 16.0))
        return torch.cat([b - f * 16.0 - 8.0, f - 8.0])
    raise ValueError(f"unknown unpack {unpack!r}")


def logical_x(x: torch.Tensor, xb: Optional[torch.Tensor], form: str) -> torch.Tensor:
    """int8 activations in a probe's form -> (ng, m, 32) in logical order:
    form q takes (m, K) or (ng, m, 32); A its evens and odds (ng, m, 16)
    each; B and C (ng, m, 32) permuted [evens | odds]."""
    if form == "q":
        return group_x(x) if x.dim() == 2 else x
    if form == "A":
        ev, od = x, xb
    else:
        h = x.shape[-1] // 2
        ev, od = x[..., :h], x[..., h:]
    return torch.stack([ev, od], -1).reshape(*ev.shape[:-1], 2 * ev.shape[-1])


def plain_probe_nibble(qs, unpack: str, consumer: str, x=None, xb=None, sx=None, s=None,
                       stage: str = "full", form: str = "q") -> torch.Tensor:
    """What probe_nibble computes (see its wrapper), integer parts in f32
    (exact: |part| <= 32 * 127 * 128 < 2**24, sums of parts too)."""
    w = nibble_grid(qs, unpack)
    k, n = w.shape
    ng = k // GROUP
    if consumer == "planes":
        return w[0::2] + w[1::2]
    if consumer == "colsum":
        return w.sum(0, keepdim=True).float()
    if consumer == "gcolsum":
        return w.reshape(ng, GROUP, n).sum(1).float()
    if consumer == "dot_bf16":
        return _bf16_round(x.float()) @ w.float()
    if consumer == "dot_s8":
        return x.float() @ w.float()
    xg = logical_x(x, xb, form) if x is not None else None
    wg = w.float().reshape(ng, GROUP, n)
    if consumer == "gdot_s8":
        return torch.bmm(xg.float(), wg).to(torch.int32)
    if consumer != "gdot":
        raise ValueError(f"unknown consumer {consumer!r}")
    if stage == "nodot":
        parts = wg.sum(1)[:, None, :].expand(ng, sx.shape[1], n)
    else:
        parts = torch.bmm(xg.float(), wg)
    if stage == "norescale":
        return parts.sum(0)
    return (parts * sx[:, :, None] * s[:, None, :]).sum(0)


def plain_probe_stream(a: torch.Tensor, tiling: Tiling, bands: int = 1) -> torch.Tensor:
    """float64 sums of every (tile, band) of `a`'s bytes read as int8,
    (nty * ntx, bands)."""
    v = a.view(torch.int8).reshape(-1)
    t = tiling
    out = torch.empty((t.nty * t.ntx, bands), dtype=torch.float64, device=a.device)
    for b in range(bands):
        r0, r1 = t.rows * b // bands, t.rows * (b + 1) // bands
        view = torch.as_strided(v, (t.nty, t.ntx, r1 - r0, t.cols),
                                (t.ty_stride, t.tx_stride, t.row_stride, 1), r0 * t.row_stride)
        out[:, b] = view.double().sum((-2, -1)).reshape(-1)
    return out


# -- wrappers -----------------------------------------------------------------


def probe_dot(x: torch.Tensor, w: torch.Tensor, op: str, *, out_dtype=None, steps: int = 1,
              k_step: Optional[int] = None, x_step: int = 0, w_step: int = 0, floor: bool = False,
              twice: bool = False) -> torch.Tensor:
    """A dot of one operand pair (csrc/probe_dot.cu):

      "s8"   int8 x (M, K) @ int8 w (K, N) -> int32 (or f32 with out_dtype)
      "bf16" bf16 or f32 x (M, Kx) against bf16, f32 or int8 w (Kw, N), both
             rounded to bf16, f32 out: the sum over `steps` of x[:, s x_step :
             + k_step] @ rhs(w[s w_step : + k_step]), rhs the floor chain
             l + f (floor) and 2 w on steps after the first (twice)
      "f32"  f32 x (B, M, K) or (M, K) @ f32 or int8 w (B, K, N) or (K, N),
             f32 products and sums
      "s16"  int16 x (M, K) @ int8 or int16 w (K, N) -> int32"""
    k = k_step or w.shape[-2]
    if x.dim() != w.dim() or x.dim() not in (2, 3) or x.shape[:-2] != w.shape[:-2]:
        raise ValueError(f"probe_dot: x {tuple(x.shape)} and w {tuple(w.shape)} are not "
                         "two matrices or two batches of as many")
    if not _cuda("probe_dot", x, w):
        PLAIN_CALLS["probe_dot"] += 1
        return plain_probe_dot(x, w, op, out_dtype=out_dtype, steps=steps, k_step=k_step,
                               x_step=x_step, w_step=w_step, floor=floor, twice=twice)
    batch = x.shape[0] if x.dim() == 3 else 1
    m, n = x.shape[-2], w.shape[-1]
    odt = torch.float32 if op in ("bf16", "f32") or out_dtype == torch.float32 else torch.int32
    out = torch.empty((batch, m, n) if x.dim() == 3 else (m, n), dtype=odt, device=x.device)
    _launch("probe_dot", "probe_dot", _ptr(x), _ptr(w), _ptr(out), DOT_OPS[op], _DT[x.dtype],
            _DT[w.dtype], _DT[odt], batch, m, n, x.shape[-1], w.shape[-2], k, steps, x_step,
            w_step, int(floor) | 2 * int(twice), K._stream(x.device))
    return out


def probe_rescale(parts: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """sum_g parts[g] * s[g] over (ng, M, N) f32 parts and an (ng, N) plane,
    g in order (csrc/probe_dot.cu)."""
    if not _cuda("probe_rescale", parts, s):
        PLAIN_CALLS["probe_rescale"] += 1
        return plain_probe_rescale(parts, s)
    ng, m, n = parts.shape
    out = torch.empty((m, n), dtype=torch.float32, device=parts.device)
    _launch("probe_rescale", "probe_dot", _ptr(parts), _ptr(s), _ptr(out), ng, m, n,
            K._stream(parts.device))
    return out


def probe_nibble(qs: torch.Tensor, unpack: str, consumer: str, x: Optional[torch.Tensor] = None,
                 xb: Optional[torch.Tensor] = None, sx: Optional[torch.Tensor] = None,
                 s: Optional[torch.Tensor] = None, stage: str = "full",
                 form: str = "q") -> torch.Tensor:
    """A 4-bit unpack and its consumer on the decode kernels' block structure
    (csrc/probe_nibble.cu, whose header lists the combinations). qs: int8
    adjk nibbles (K/2, N), or the int8 grid (K, N) for unpack "s8". x: bf16
    (m, K) for dot_bf16; int8 (m, K) or (ng, m, 32) for form q, the evens
    (ng, m, 16) with xb the odds for form A, (ng, m, 32) [evens | odds] for
    B and C. sx (ng, m) and s (ng, N) f32 for gdot."""
    m, sg, st = _check_nibble(qs, unpack, consumer, x, xb, sx, s, stage, form)
    if not _cuda("probe_nibble", qs, x, xb, sx, s):
        PLAIN_CALLS["probe_nibble"] += 1
        return plain_probe_nibble(qs, unpack, consumer, x, xb, sx, s, stage, form)
    k = qs.shape[0] * (1 if unpack == "s8" else 2)
    n = qs.shape[1]
    ng = k // GROUP
    shape = {"planes": (k // 2, n), "colsum": (1, n), "gcolsum": (ng, n),
             "gdot_s8": (ng, m, n)}.get(consumer, (m, n))
    odt = torch.int32 if consumer in ("planes", "gdot_s8") else torch.float32
    out = torch.empty(shape, dtype=odt, device=qs.device)
    _launch("probe_nibble", "probe_nibble", _ptr(qs), _ptr(x), _ptr(xb), _ptr(sx), _ptr(s),
            _ptr(out), UNPACKS[unpack], CONSUMERS[consumer], STAGES[stage], FORMS[form], m, k, n,
            sg, st, K._stream(qs.device))
    return out


def _check_nibble(qs, unpack, consumer, x, xb, sx, s, stage, form) -> Tuple[int, int, int]:
    """Refuses operands the kernel would misread; returns (m, sg, st): the
    activation rows and the group and row strides of int8 activations."""
    def bad(what):
        return ValueError(f"probe_nibble ({unpack}, {consumer}, {stage}, {form}): {what}")

    if qs.dtype != torch.int8 or qs.dim() != 2:
        raise bad(f"qs {qs.dtype} {tuple(qs.shape)}, expected a 2-D int8 plane")
    k = qs.shape[0] * (1 if unpack == "s8" else 2)
    n, ng = qs.shape[1], k // GROUP
    if k % GROUP:
        raise bad(f"K {k} is not a multiple of {GROUP}")
    int_x = consumer in ("dot_s8", "gdot_s8") or (consumer == "gdot" and stage != "nodot")
    m, sg, st = 1, 0, 0
    if consumer == "dot_bf16":
        if x is None or x.dtype != torch.bfloat16 or x.dim() != 2 or x.shape[1] != k:
            raise bad(f"x must be bf16 (m, {k})")
        m = x.shape[0]
    elif int_x:
        width = GROUP // 2 if form == "A" else GROUP
        if x is None or x.dtype != torch.int8:
            raise bad("x must be int8")
        if x.dim() == 2 and form == "q" and x.shape[1] == k:
            m, sg, st = x.shape[0], GROUP, k
        elif x.dim() == 3 and x.shape[0] == ng and x.shape[2] == width:
            m, sg, st = x.shape[1], x.shape[1] * width, width
        else:
            raise bad(f"x {tuple(x.shape)}: expected ({ng}, m, {width})"
                      + (f" or (m, {k})" if form == "q" else ""))
        if (form == "A") != (xb is not None) or (xb is not None and xb.shape != x.shape):
            raise bad("form A takes the odd rows as xb, of x's shape; the others none")
    elif sx is not None:
        m = sx.shape[1]
    if consumer == "gdot" and stage != "norescale":
        if sx is None or s is None or sx.dtype != torch.float32 or s.dtype != torch.float32:
            raise bad("gdot takes f32 sx and s")
        if tuple(sx.shape) != (ng, m) or tuple(s.shape) != (ng, n):
            raise bad(f"sx {tuple(sx.shape)}, s {tuple(s.shape)}: expected ({ng}, {m}), ({ng}, {n})")
    return m, sg, st


def probe_stream(a: torch.Tensor, tiling: Tiling, bands: int = 1) -> torch.Tensor:
    """The int32 sum of each (tile, band) of `a`'s bytes read as int8,
    (nty * ntx, bands) (csrc/probe_stream.cu); the plain version sums in
    float64."""
    t = tiling
    end = ((t.nty - 1) * t.ty_stride + (t.ntx - 1) * t.tx_stride + (t.rows - 1) * t.row_stride
           + t.cols)
    if a.dtype != torch.uint8 or end > a.numel() or not 1 <= bands <= t.rows:
        raise ValueError(f"probe_stream: {a.dtype} array of {a.numel()} bytes, tiles reach "
                         f"byte {end}, {bands} bands of {t.rows} rows")
    if not _cuda("probe_stream", a):
        PLAIN_CALLS["probe_stream"] += 1
        return plain_probe_stream(a, tiling, bands)
    out = torch.empty((t.nty * t.ntx, bands), dtype=torch.int32, device=a.device)
    LL = ctypes.c_longlong
    _launch("probe_stream", "probe_stream", _ptr(a), _ptr(out), t.nty, t.ntx, t.rows, t.cols,
            LL(t.row_stride), LL(t.ty_stride), LL(t.tx_stride), bands, K._stream(a.device))
    return out


# -- timing and reporting -----------------------------------------------------


def time_graph(fn: Callable[[int], object], reps: int = GRAPH_CALLS) -> float:
    """Mean ms of fn(i), i = 0 .. reps - 1, captured in one CUDA graph and
    replayed (after a warm-up replay) between two CUDA events: the device's
    time alone. The wrappers count a launch when the graph records it; the
    counts are set to what the replays ran."""
    fn(0)
    torch.cuda.synchronize()
    before = dict(LAUNCHES)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(reps):
            fn(i)
    recorded = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
    g.replay()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    g.replay()
    e1.record()
    torch.cuda.synchronize()
    for k in LAUNCHES:
        LAUNCHES[k] = before[k] + 2 * recorded[k]
    return e0.elapsed_time(e1) / reps


def time_once(fn: Callable[[], object]) -> float:
    """The least ms of three single calls between CUDA events (a plain
    version: many kernels, no graph)."""
    best = float("inf")
    for _ in range(3):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        best = min(best, e0.elapsed_time(e1))
    return best


def bound_ms(nbytes: int, ops: int = 0, peak: float = PEAK_F32_S) -> Tuple[float, str]:
    """The least ms the card could take: max(bytes / 3.35 TB/s, operations /
    peak), and which of the two bounds it."""
    tb, to = nbytes / PEAK_BYTES_S, ops / peak
    return max(tb, to) * 1e3, "operations" if to > tb else "bytes"


def max_err(got: torch.Tensor, ref: torch.Tensor) -> Tuple[float, float]:
    """(max |got - ref|, that over max |ref|) in float64."""
    d = (got.double() - ref.double()).abs().max().item()
    return d, d / max(ref.double().abs().max().item(), 1e-30)


class Runner:
    """One probe script's lines: for each probe, the kernel (its wrapper) held
    against its plain version (check) and timed (time), on `device`.

    A probe is (label, symbol, kernel(i) -> output on input copy i,
    plain() -> the reference on copy 0, tol: 0 for bitwise, else the
    largest error over the largest reference value). Timing: the kernel
    from a replayed CUDA graph over the copies, the plain version from
    single calls, the library call (where one torch call computes the same
    function) like the kernel; the bound over `nbytes` (each input read
    once, each output written once) and `ops` at `peak`; GB/s over `gbs`
    bytes where the JAX script printed GB/s; on the CPU no time is
    measured. An error outside its class raises SystemExit."""

    def __init__(self, device: str = "cuda", check: bool = True, time: bool = True,
                 out=print):
        self.dev = torch.device(device)
        self.check, self.time, self.out = check, time, out
        self.rows: List[dict] = []

    @property
    def cuda(self) -> bool:
        return self.dev.type == "cuda"

    def copies(self, make: Callable[[], object], nbytes: int) -> list:
        """Distinct inputs made by `make`, `nbytes` each: where the kernels
        are timed, enough that a graph cycling over them reads three of the
        card's 50 MB L2 (at most one a call of the graph), so every call of
        a large probe reads its input from device memory; else one."""
        if not (self.cuda and self.time):
            return [make()]
        return [make() for _ in range(min(GRAPH_CALLS, max(1, math.ceil(3 * L2_BYTES / nbytes))))]

    def probe(self, label: str, symbol: str, kernel: Callable[[int], torch.Tensor],
              plain: Callable[[], torch.Tensor], tol: float, *, nbytes: int = 0, ops: int = 0,
              peak: float = PEAK_F32_S, library: Optional[Callable[[int], object]] = None,
              gbs: int = 0) -> dict:
        row = dict(label=label, symbol=symbol, tol=tol, bytes=nbytes, ops=ops, peak=peak)
        parts = [f"{label}:"]
        if self.check:
            got = kernel(0)
            if self.cuda:
                torch.cuda.synchronize()
            ref = plain()
            err, rel = max_err(got, ref)
            ok = bool(torch.equal(got, ref)) if tol == 0 else bool(torch.isfinite(got).all()) and rel <= tol
            row.update(max_abs_err=err, rel_err=rel)
            parts.append(f"max_abs_err={err:.3e} rel_err={rel:.3e} "
                         f"({'bitwise' if tol == 0 else f'tol {tol:g}'}) {'ok' if ok else 'FAIL'}")
            if not ok:
                self.out(" ".join(parts))
                raise SystemExit(f"{label}: the kernel disagrees with its plain version "
                                 f"(max abs {err:.3e}, rel {rel:.3e}, tol {tol:g})")
        if self.time:
            b_ms, by = bound_ms(nbytes, ops, peak)
            row.update(bound_ms=b_ms, bound_by=by)
            if self.cuda:
                n0 = sum(LAUNCHES.values())
                ms = time_graph(kernel)
                row["launches"] = sum(LAUNCHES.values()) - n0
                row.update(ms=ms, plain_ms=time_once(plain),
                           library_ms=time_graph(library) if library else None)
                parts.append(f"us={ms * 1e3:.2f} bound_us={b_ms * 1e3:.2f} ({by}) "
                             f"plain_us={row['plain_ms'] * 1e3:.1f}")
                if library:
                    parts.append(f"library_us={row['library_ms'] * 1e3:.2f}")
                if gbs:
                    parts.append(f"GB/s={gbs / ms / 1e6:.0f}")
            else:
                parts.append(f"us=not measured (device {self.dev.type})")
        self.out(" ".join(parts))
        self.rows.append(row)
        return row

    def compare(self, label: str, got: torch.Tensor, ref: torch.Tensor, tol: float) -> float:
        """Two outputs held against each other (a kernel against another
        kernel, or one padded row against another); raises outside tol."""
        err, rel = max_err(got, ref)
        ok = bool(torch.equal(got, ref)) if tol == 0 else rel <= tol
        self.out(f"{label}: max_abs_err={err:.3e} rel_err={rel:.3e} "
                 f"({'bitwise' if tol == 0 else f'tol {tol:g}'}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"{label}: outside its class (rel {rel:.3e}, tol {tol:g})")
        return rel

    def timed(self, label: str, fn: Callable[[int], object], nbytes: int = 0) -> Optional[float]:
        """A kernel timed alone (a production kernel, or a dense control)."""
        if not (self.time and self.cuda):
            self.out(f"{label}: us=not measured (device {self.dev.type})")
            return None
        ms = time_graph(fn)
        self.out(f"{label}: us={ms * 1e3:.2f}" + (f" GB/s={nbytes / ms / 1e6:.0f}" if nbytes else ""))
        self.rows.append(dict(label=label, symbol=None, ms=ms))
        return ms


def script_main(run: Callable[[Runner, bool], None], argv=None) -> int:
    """The command line of scripts/torch_probe_*.py: --device (default cuda;
    exits 2 where CUDA is not available), --small (the CPU tests' sizes).
    Every probe is held against its plain version and timed."""
    import argparse
    import sys

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--small", action="store_true", help="small shapes (a CPU run of the plain versions)")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("CUDA is not available", file=sys.stderr)
            return 2
        K.build()
    t0 = time.perf_counter()
    runner = Runner(args.device)
    run(runner, args.small)
    print(f"done in {time.perf_counter() - t0:.1f} s on "
          f"{torch.cuda.get_device_name(0) if args.device == 'cuda' else 'cpu'}")
    return 0
