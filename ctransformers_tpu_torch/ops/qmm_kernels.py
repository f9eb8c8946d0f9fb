"""The hand-written Hopper kernels of the quantized matmul, their plain
PyTorch versions, launch counters and the nvcc/ctypes loader.

Every wrapper takes activations already zero-padded to the weight's
storage rows, x (m, Kp) float32 (or their int8 quantization), and a
QTensor (ops/qmatmul.py), and returns the padded product (m, Np) float32.

Q4_K, nibble-packed in the adjk layout (csrc/qmm_decode.cu,
csrc/qmm_prefill.cu):

  qmm_qx  x quantized to int8 per (token, group) inside the kernel
          (replaces ctransformers_tpu/ops/qmatmul.py:_qmm_qx_kernel)
  qmm_q   the same function on activations quantized outside
          (replaces _qmm_q_kernel, modes "q" and "q4", packed4=True)
  qmm_si  bf16(x) @ bf16(w4 * s) + xsum @ B   (replaces _qmm_i4_s_kernel)
  qmm_i   bf16(x) @ bf16(w4 * s + B)         (replaces _qmm_i4_kernel)
  qmm_g   sum_g s[g] * dot_g(bf16(x), w4) + xsum @ B   (replaces
          _qmm_g_kernel; csrc/qmm_float.cu)
          (qmm_qx and qmm_g at m <= 32: K split over a thread-block cluster,
          the nibble stream kept in flight by a cp.async ring, x quantized or
          rounded once a block, csrc/qmm_splitk.cuh; grid_split_plan gives
          the cluster's size)

with w4 = q + zp - 8 the stored nibble, s = sd * sub_s, m = sm * sub_m and
B = (8 - zp) * s + m per group of 32 rows (zp = 0: B = 8 * s + m).

GPTQ4 and Q4_1, the same nibble layout with plain f32 (Kp/G, Np) planes s
and m (sfactor 0, no superblock factors) and a group G of 32, 64 or 128
rows (Q4_1: 32, the layout of GPTQ4 at group 32, so it runs the group-32
instantiations); the reference kernels' sfactor == 0 branches
(csrc/qmm_decode.cu, csrc/qmm_prefill.cu):

  qmm_qx_gptq  the function of qmm_qx  (replaces _qmm_qx_kernel)
  qmm_q_gptq   the function of qmm_q   (replaces _qmm_q_kernel)
  qmm_i_gptq   the function of qmm_i   (replaces _qmm_i4_kernel; the
               Hopper GEMM core's adjk nibble tile)
  qmm_si_gptq  the function of qmm_si  (replaces _qmm_i4_s_kernel; the
               same tile with the fold of B)
  qmm_g_gptq   the function of qmm_g   (replaces _qmm_g_kernel)

Q4_0, the same nibbles at zero point 8 (w4 = q in [-8, 7]) with a plain
f32 (Kp/32, Np) plane s and no mins, so B = 0: the reference kernels'
branches without a bias term (qx_bias and g_bias False, b is None):

  qmm_qx_q4_0, qmm_q_q4_0, qmm_i_q4_0, qmm_si_q4_0, qmm_g_q4_0
      the functions above without the bias (si then computes what i does;
      qmm_i_q4_0 and qmm_si_q4_0 on the Hopper GEMM core's adjk nibble
      tile, the plain s plane without mins)

Q2_K and Q3_K, the same nibbles at group 16 with factored scales (16
groups a superblock): int8 sub-scales over f32 sd, and for Q2_K int8
sub-mins over f32 sm = -dmin. Q2_K (zero point 0, q in [0, 3] stored as
q - 8) has the bias B = 8 * s + m; Q3_K (zero point 8, q in [-4, 3] stored
as it is, no mins) has none (the reference's qx_bias / g_bias False, b is
None). The symbols are told whether the weight has mins and refuse a flag
that disagrees with the sub-min and sm pointers:

  qmm_qx_k16, qmm_q_k16, qmm_i_k16, qmm_si_k16, qmm_g_k16
      the functions of qmm_qx, qmm_q, qmm_i, qmm_si and qmm_g at group 16
      (qmm_si_k16 and qmm_i_k16 on the Hopper GEMM core's adjk nibble
      tile, four groups of 16 a stage)

An act-order weight (QTensor.perm) reaches the wrappers with x already
gathered (ops/qmatmul.py:qmatmul).

int8 grids with factored scales: Q6_K (group 16, no mins) and Q5_K (group
32, with mins) (csrc/qmm_grid.cu; qmm_g8, qmm_f and qmm_s in
csrc/qmm_float.cu):

  qmm_q8  xsum @ M + sum_g int32 dot_g(xq, q) * sx * s, on activations
          quantized outside per group of the weight's group
          (replaces _qmm_q_kernel, mode "q", packed4=False; at m <= 32 K
          split over a thread-block cluster, dp4a on transposed grid bytes,
          csrc/qmm_splitk.cuh; grid_split_plan gives the cluster's size)
  qmm_qx8 the same function on raw f32 x, quantized inside the kernel
          (replaces _qmm_qx_kernel, mode "qx", packed4=False)
  qmm_b   bf16(x) @ bf16(q * s + m)          (replaces _qmm_kernel, mode "b";
          the Hopper GEMM core of csrc/qmm_wgmma.cuh)
  qmm_sb  xsum @ M + bf16(x) @ bf16(q * s)   (replaces _qmm_s_kernel, mode "sb";
          the Hopper GEMM core)
  qmm_g8  xsum @ M + sum_g s[g] * dot_g(bf16(x), q)    (replaces _qmm_g_kernel)
  qmm_f   x @ (q * s + m), all f32           (replaces _qmm_kernel, mode "")
          (qmm_g8 and qmm_f at m <= 32: K split over a thread-block cluster,
          the weight stream kept in flight by a cp.async ring,
          csrc/qmm_splitk.cuh; grid_split_plan gives the cluster's size)
  qmm_s   xsum @ M + x @ (q * s), all f32    (replaces _qmm_s_kernel, mode "s")
  qmm_rb8 the function of qmm_b                (replaces _qmm_rb_kernel, mode "rb";
          qmm_b's Hopper GEMM core above m = 32, at m <= 32 the K split's
          bf16 form, csrc/qmm_splitk.cuh: each weight's q * s (+ m) rounded
          once to bf16, f32 sums of the exact products at m = 1, bf16
          mma.sync at m > 1; grid_split_plan gives the cluster's size)

with M the (Kp/g, Np) plane m = sm * sub_m (absent for Q6_K).

int8 grids with plain f32 (Kp/32, Np) planes s and m (sfactor 0): the
legacy types Q8_0 and Q5_0 (no mins) and Q5_1 (with mins), the reference
kernels' sfactor == 0 branches:

  qmm_q8_legacy, qmm_qx8_legacy, qmm_b_legacy, qmm_sb_legacy, qmm_g8_legacy,
  qmm_f_legacy, qmm_s_legacy, qmm_rb8_legacy
                               the functions of the eight grid kernels above
                               (qmm_b_legacy and qmm_sb_legacy on the Hopper
                               GEMM core, qmm_q8_legacy and qmm_rb8_legacy
                               on the K splits of qmm_q8 and qmm_rb8 at
                               m <= 32, the plain planes in each stage;
                               qmm_rb8_legacy on qmm_b_legacy's core above)

The same six nibble layouts (Q4_K, Q2_K, Q3_K, GPTQ4, Q4_1, Q4_0) packed
"ksplit" (ops/qmatmul.py: byte r holds row r in the low nibble, lo = q + zp,
and row r + Kp/2 in the high nibble, sign-biased, so that the byte b read
as int8 gives f = floor(b / 16) = hi - 8 and l = b - 16 f = lo), one symbol
per mode for every layout, told the group, whether there are mins, the
zero point and the superblock factor count:

  qmm_f_ks   x_lo @ (l * s + B_lo) + x_hi @ (f * s + B_hi), all f32
             (replaces _qmm_pack4_kernel, mode ""; csrc/qmm_ksplit.cu)
  qmm_s_ks   xs_lo @ B_lo + xs_hi @ B_hi + x_lo @ (l * s) + x_hi @ (f * s),
             all f32 (replaces _qmm_pack4_s_kernel, mode "s")
             (qmm_f_ks and qmm_s_ks at m <= 32: K split over a thread-block
             cluster, both nibbles of a byte per load and neither through an
             I2F, csrc/qmm_splitk.cuh; grid_split_plan gives the cluster's
             size)
  qmm_b_ks   the function of qmm_f_ks on bf16 operands, f32 sums
             (replaces _qmm_pack4_kernel, mode "b"; csrc/qmm_ksplit.cu: the
             K split of qmm_f_ks with each weight and x rounded once to
             bf16 at m <= 32, mma.sync at m > 1; the Hopper GEMM core's
             ksplit nibble tile without the sum fold above)
  qmm_sb_ks  the function of qmm_s_ks with the two dots on bf16 operands
             (replaces _qmm_pack4_s_kernel, mode "sb"; csrc/qmm_float.cu:
             the first design of qmm_float.cuh at m <= 32, the Hopper GEMM
             core's ksplit nibble tile above)
  qmm_r_ks   the function of qmm_f_ks, dequantized per (group, column)
             pair (replaces _qmm_pack4_rb_kernel, mode "r"; csrc/qmm_rb.cu)
  qmm_rb_ks  the function of qmm_b_ks and its instantiations (replaces
             _qmm_pack4_rb_kernel, mode "rb"; csrc/qmm_ksplit.cu)

with x_lo, x_hi the two halves of x's columns, xs their f32 sums over each
group, B_lo = -zp * s + m and B_hi = (8 - zp) * s + m (zp = 8, no mins:
B_lo = -8 s, no B_hi; zp = 0: B_lo = m, B_hi = 8 s + m), each product and
sum rounded once in f32 as the reference's.

The reshape-broadcast form of the int8-grid dequantize-and-dot (csrc/qmm_rb.cu):

  qmm_r8  the function of qmm_f (replaces _qmm_rb_kernel, mode "r"), with
          its "_legacy" form on the unfactored grids

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version, which computes the same function with torch ops (and is what
chip_smoke.py holds each kernel against on the card). There is no
fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Optional, Tuple

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(CSRC), "_build")
# every kernel source of the port; attn_decode.cu is ops/attention.py's, the
# probe_*.cu sources ops/probes.py's
SOURCES = ("qmm_decode.cu", "qmm_prefill.cu", "qmm_grid.cu", "qmm_float.cu", "qmm_ksplit.cu",
           "qmm_rb.cu", "attn_decode.cu", "probe_dot.cu", "probe_nibble.cu", "probe_stream.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_INFO: Dict[str, object] = {}


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN_CALLS, DENSE_CALLS):
        for k in d:
            d[k] = 0


# -- build -------------------------------------------------------------------


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the qmm kernels need the CUDA toolkit")


def _source_hash(prefix: str = "qmm_") -> str:
    """Hash of the nvcc flags and the sources under csrc/ whose names start
    with `prefix`: by default the qmm kernels' sources, which the kernel
    tables are tied to (ops/qmatmul.py); with "" every source, which names
    the build directory."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        if name.startswith(prefix) and name.endswith((".cu", ".cuh")):
            h.update(name.encode())
            with open(os.path.join(CSRC, name), "rb") as f:
                h.update(f.read())
    return h.hexdigest()[:16]


def build() -> Dict[str, object]:
    """Compile every source under csrc/ (one nvcc per file, all started
    together) into <package>/_build/<source hash>/, unless already built,
    and load the libraries. Returns BUILD_INFO: seconds (each source's in
    source_seconds: the longest sets the build's) and ptxas output."""
    if len(_LIBS) == len(SOURCES):
        return BUILD_INFO
    out_dir = os.path.join(BUILD_ROOT, _source_hash(""))
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for src in SOURCES:
        so = os.path.join(out_dir, f"lib{src[:-3]}.so")
        if os.path.exists(so):
            continue
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, src)]
        log = open(f"{tmp}.log", "w+")
        procs[src] = (so, tmp, log, subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT, text=True
        ))
    seconds = {}
    while len(seconds) < len(procs):
        for src, (_, _, _, p) in procs.items():
            if src not in seconds and p.poll() is not None:
                seconds[src] = round(time.perf_counter() - t0, 1)
        time.sleep(0.05)
    logs = {}
    for src, (so, tmp, log, p) in procs.items():
        log.seek(0)
        logs[src] = log.read()
        log.close()
        os.remove(log.name)
    for src, (so, tmp, _, p) in procs.items():
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{logs[src]}")
        os.replace(tmp, so)
    BUILD_INFO.update(
        dir=out_dir, seconds=time.perf_counter() - t0, compiled=sorted(procs),
        source_seconds=seconds, log=logs,
    )
    for src in SOURCES:
        lib = ctypes.CDLL(os.path.join(out_dir, f"lib{src[:-3]}.so"))
        _bind(lib)
        _LIBS[src[:-3]] = lib
    return BUILD_INFO


def _bind(lib: ctypes.CDLL) -> None:
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # pointers, then m, kp, np, the symbol's own ints (group, has mins; the
    # ksplit symbols: group, has mins, zero point, superblock factor count)
    # and the stream; the decode attention of ops/attention.py: pointers, dtype,
    # batch, heads, kv heads, head width, window, chunk, layer, the score
    # scale, the cache's and the scale planes' strides, the stream; the probes
    # of ops/probes.py: pointers, their ints (and strides), the stream
    sigs = {
        "ct_decode_attn": [P] * 8 + [I] * 8 + [ctypes.c_float] + [LL] * 8 + [P],
        "ct_probe_dot": [P] * 3 + [I] * 14 + [P],
        "ct_probe_rescale": [P] * 3 + [I] * 3 + [P],
        "ct_probe_nibble": [P] * 6 + [I] * 9 + [P],
        "ct_probe_stream": [P] * 2 + [I] * 4 + [LL] * 3 + [I, P],
        "ct_qmm_qx": [P] * 7 + [I, I, I, P],
        "ct_qmm_q": [P] * 9 + [I, I, I, P],
        "ct_qmm_si": [P] * 7 + [I, I, I, P],
        "ct_qmm_i": [P] * 7 + [I, I, I, P],
        "ct_qmm_q8": [P] * 9 + [I, I, I, I, P],
        "ct_qmm_qx8": [P] * 7 + [I, I, I, I, P],
        "ct_qmm_b": [P] * 7 + [I, I, I, I, P],
        "ct_qmm_sb": [P] * 7 + [I, I, I, I, P],
        "ct_qmm_qx_gptq": [P] * 5 + [I, I, I, I, P],
        "ct_qmm_q_gptq": [P] * 7 + [I, I, I, I, P],
        "ct_qmm_i_gptq": [P] * 5 + [I, I, I, I, P],
        "ct_qmm_g": [P] * 7 + [I, I, I, P],
        "ct_qmm_g_gptq": [P] * 5 + [I, I, I, I, P],
        "ct_qmm_g8": [P] * 7 + [I, I, I, I, P],
        "ct_qmm_f": [P] * 7 + [I, I, I, I, P],
        "ct_qmm_s": [P] * 7 + [I, I, I, I, P],
        "ct_qmm_grid_split_plan": [I] * 5,
        "ct_qmm_grid_split_capacity": [I] * 4,
        "ct_qmm_qx_split_plan": [I] * 3,
        "ct_qmm_qx_split_capacity": [I] * 2,
        "ct_qmm_g_split_plan": [I] * 3,
        "ct_qmm_g_split_capacity": [I] * 2,
        "ct_qmm_q8_split_plan": [I] * 6,
        "ct_qmm_q8_split_capacity": [I] * 5,
        "ct_qmm_rb8_split_plan": [I] * 6,
        "ct_qmm_rb8_split_capacity": [I] * 5,
        "ct_qmm_ks_split_plan": [I] * 7,
        "ct_qmm_ks_split_capacity": [I] * 6,
        "ct_qmm_si_gptq": [P] * 5 + [I, I, I, I, P],
        "ct_qmm_qx_q4_0": [P] * 5 + [I, I, I, P],
        "ct_qmm_q_q4_0": [P] * 7 + [I, I, I, P],
        "ct_qmm_i_q4_0": [P] * 5 + [I, I, I, P],
        "ct_qmm_si_q4_0": [P] * 5 + [I, I, I, P],
        "ct_qmm_g_q4_0": [P] * 5 + [I, I, I, P],
        "ct_qmm_q8_legacy": [P] * 7 + [I, I, I, I, P],
        "ct_qmm_qx8_legacy": [P] * 5 + [I, I, I, I, P],
        "ct_qmm_b_legacy": [P] * 5 + [I, I, I, I, P],
        "ct_qmm_sb_legacy": [P] * 5 + [I, I, I, I, P],
        "ct_qmm_g8_legacy": [P] * 5 + [I, I, I, I, P],
        "ct_qmm_f_legacy": [P] * 5 + [I, I, I, I, P],
        "ct_qmm_s_legacy": [P] * 5 + [I, I, I, I, P],
        "ct_qmm_qx_k16": [P] * 7 + [I, I, I, I, P],
        "ct_qmm_q_k16": [P] * 9 + [I, I, I, I, P],
        "ct_qmm_i_k16": [P] * 7 + [I, I, I, I, P],
        "ct_qmm_si_k16": [P] * 7 + [I, I, I, I, P],
        "ct_qmm_g_k16": [P] * 7 + [I, I, I, I, P],
        "ct_qmm_r8": [P] * 7 + [I, I, I, I, P],
        "ct_qmm_rb8": [P] * 7 + [I, I, I, I, P],
        "ct_qmm_r8_legacy": [P] * 5 + [I, I, I, I, P],
        "ct_qmm_rb8_legacy": [P] * 5 + [I, I, I, I, P],
        **{f"ct_qmm_{mode}_ks": [P] * 7 + [I] * 7 + [P]
           for mode in ("f", "s", "b", "sb", "r", "rb")},
    }
    for name, args in sigs.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = args
            fn.restype = I


def _fn(lib: str, name: str):
    build()
    return getattr(_LIBS[lib], name)


# -- argument checks -----------------------------------------------------------


# the layouts the kernels take: kind -> (group, groups per superblock,
# has mins, nibble-packed). Q4_K is nibble-packed in the adjk layout, Q2_K
# (with mins) and Q3_K (without) too at group 16; Q6_K and Q5_K are int8
# grids; GPTQ4 is nibble-packed with unfactored f32 planes
# (0 groups per superblock: no sd, no sm) and its group is the checkpoint's,
# one of GPTQ_GROUPS (the table names the common one). The legacy GGML
# types are unfactored at group 32: Q4_1 is GPTQ4's layout at that group,
# Q4_0 nibbles without mins, Q8_0, Q5_0 and Q5_1 int8 grids.
LAYOUTS = {
    "Q4_K": (32, 8, True, True),
    "Q2_K": (16, 16, True, True),
    "Q3_K": (16, 16, False, True),
    "Q6_K": (16, 16, False, False),
    "Q5_K": (32, 8, True, False),
    "GPTQ4": (128, 0, True, True),
    "Q4_0": (32, 0, False, True),
    "Q4_1": (32, 0, True, True),
    "Q8_0": (32, 0, False, False),
    "Q5_0": (32, 0, False, False),
    "Q5_1": (32, 0, True, False),
}
GPTQ_GROUPS = (32, 64, 128)


def zero_point(kind: str) -> int:
    """The nibble zero point of a layout: 8 where nibbles have no mins
    (Q4_0's and Q3_K's signed grids, no bias), else 0 (B = 8 * s + m)."""
    _, _, has_mins, packed = LAYOUTS[kind]
    return 8 if packed and not has_mins else 0


def _check_layout(qt, kinds: Tuple[str, ...], what: str, layout: str = "adjk") -> None:
    lay = LAYOUTS.get(qt.kind)
    groups = GPTQ_GROUPS if qt.kind == "GPTQ4" else lay and lay[:1]
    if qt.kind not in kinds or not (
        qt.packed == lay[3] and qt.pack_layout == layout and qt.zp == zero_point(qt.kind)
        and qt.group in groups and qt.sfactor == lay[1]
        and (qt.perm is None or qt.kind == "GPTQ4")
        and (qt.sd is not None) == (lay[1] > 0)
        and (qt.mins is not None) == lay[2]
        and (qt.sm is not None) == (lay[2] and lay[1] > 0)
    ):
        raise NotImplementedError(
            f"qmm kernels take {what}, got {qt.kind} (group {qt.group}, packed "
            f"{qt.packed}, zero point {qt.zp}, layout {qt.pack_layout}, sfactor "
            f"{qt.sfactor}); served are {', '.join(LAYOUTS)} weights (GPTQ4 at "
            "groups 32, 64, 128), other types are not yet ported, see ROADMAP"
        )


def check_qtensor(qt) -> Tuple[int, int]:
    """The Q4_K kernels take exactly the Q4_K adjk layout; returns (Kp, Np)."""
    _check_layout(qt, ("Q4_K",), "Q4_K adjk QTensors")
    rows, np_ = qt.qs.shape
    return _check_planes(qt, 2 * rows, np_)


def check_k16_qtensor(qt) -> Tuple[int, int]:
    """The group-16 nibble kernels take Q2_K and Q3_K: adjk nibbles with
    int8 (Kp/16, Np) sub-scales (and Q2_K's sub-mins) over f32 (Kp/256, Np)
    superblock factors; returns (Kp, Np)."""
    _check_layout(qt, ("Q2_K", "Q3_K"), "Q2_K or Q3_K adjk QTensors")
    rows, np_ = qt.qs.shape
    return _check_planes(qt, 2 * rows, np_)


def check_gptq_qtensor(qt) -> Tuple[int, int]:
    """The GPTQ kernels take adjk nibbles with f32 (Kp/G, Np) scale and min
    planes, G in GPTQ_GROUPS, with or without an act-order perm (x arrives
    gathered), and Q4_1, that layout at group 32; returns (Kp, Np)."""
    _check_layout(qt, ("GPTQ4", "Q4_1"), "GPTQ4 or Q4_1 adjk QTensors")
    rows, np_ = qt.qs.shape
    return _check_planes(qt, 2 * rows, np_)


def check_q40_qtensor(qt) -> Tuple[int, int]:
    """The bias-free nibble kernels take Q4_0: adjk nibbles at zero point 8
    with one f32 (Kp/32, Np) scale plane; returns (Kp, Np)."""
    _check_layout(qt, ("Q4_0",), "Q4_0 adjk QTensors")
    rows, np_ = qt.qs.shape
    return _check_planes(qt, 2 * rows, np_)


NIBBLE_KINDS = tuple(k for k, lay in LAYOUTS.items() if lay[3])


def check_ksplit_qtensor(qt) -> Tuple[int, int]:
    """The ksplit kernels take the six nibble layouts of LAYOUTS (Q4_K,
    Q2_K, Q3_K, GPTQ4, Q4_0, Q4_1) packed ksplit: uint8 (Kp/2, Np) bytes
    with each kind's planes, group, zero point and mins; returns (Kp, Np)."""
    _check_layout(qt, NIBBLE_KINDS, "ksplit nibble QTensors", "ksplit")
    rows, np_ = qt.qs.shape
    return _check_planes(qt, 2 * rows, np_)


def check_grid_qtensor(qt) -> Tuple[int, int]:
    """The factored grid kernels take exactly the Q6_K and Q5_K int8 grids;
    returns (Kp, Np)."""
    _check_layout(qt, ("Q6_K", "Q5_K"), "Q6_K or Q5_K int8 grids")
    kp, np_ = qt.qs.shape
    return _check_planes(qt, kp, np_)


def check_legacy_grid_qtensor(qt) -> Tuple[int, int]:
    """The unfactored grid kernels take the Q8_0, Q5_0 and Q5_1 int8 grids
    with f32 (Kp/32, Np) planes s (and m for Q5_1); returns (Kp, Np)."""
    _check_layout(qt, ("Q8_0", "Q5_0", "Q5_1"), "Q8_0, Q5_0 or Q5_1 int8 grids")
    kp, np_ = qt.qs.shape
    return _check_planes(qt, kp, np_)


def _check_planes(qt, kp: int, np_: int) -> Tuple[int, int]:
    g = qt.group
    # factored k-quants: int8 sub-scales and f32 superblock factors;
    # unfactored (GPTQ4, the legacy types): the f32 planes themselves
    plane = torch.int8 if qt.sfactor else torch.float32
    want = {
        "qs": (torch.uint8 if qt.pack_layout == "ksplit" else torch.int8, tuple(qt.qs.shape)),
        "scales": (plane, (kp // g, np_)),
        "mins": (plane, (kp // g, np_)),
        "sd": (torch.float32, (kp // 256, np_)),
        "sm": (torch.float32, (kp // 256, np_)),
    }
    dev = qt.qs.device
    for name, (dt, shape) in want.items():
        a = getattr(qt, name)
        if a is None:  # absent mins or factors, checked by the caller
            continue
        if a.dtype != dt or tuple(a.shape) != shape or a.device != dev:
            raise ValueError(
                f"QTensor.{name}: {a.dtype} {tuple(a.shape)} on {a.device}, "
                f"expected {dt} {shape} on {dev}"
            )
        if not a.is_contiguous():
            raise ValueError(f"QTensor.{name} must be contiguous")
    if kp % 256 or np_ % 128:
        raise ValueError(f"padded weight shape ({kp}, {np_}) is not (256k, 128j)")
    return kp, np_


def _check_act(t: torch.Tensor, dtype, shape, dev, name: str) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != dev:
        raise ValueError(
            f"{name}: {t.dtype} {tuple(t.shape)} on {t.device}, "
            f"expected {dtype} {tuple(shape)} on {dev}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptrs(*ts):
    out = []
    for t in ts:
        if t is None:  # an absent plane (Q6_K's, Q4_0's mins) is a null pointer
            out.append(ctypes.c_void_p(None))
            continue
        p = t.data_ptr()
        if p % 16:
            raise ValueError("kernel operands must be 16-byte aligned")
        out.append(ctypes.c_void_p(p))
    return out


def _stream(dev: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _planes(qt):
    # unfactored: no superblock planes to pass, except to the ksplit symbols,
    # which take all five for every layout (absent ones null)
    if qt.sfactor == 0 and qt.pack_layout != "ksplit":
        return (qt.qs, qt.scales, qt.mins)
    return (qt.qs, qt.scales, qt.mins, qt.sd, qt.sm)


def _launch(name: str, lib: str, dev, acts, qt, m: int, kp: int, np_: int, *ints: int):
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors on {dev}; the kernel runs on CUDA only")
    out = torch.empty((m, np_), dtype=torch.float32, device=dev)
    fn = _fn(lib, "ct_" + name)
    rc = fn(*_ptrs(*acts, *_planes(qt), out), m, kp, np_, *ints, _stream(dev))
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")
    LAUNCHES[name] += 1
    return out


# -- plain versions ------------------------------------------------------------


def group_planes(qt) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(Kp/G, Np) f32 planes s and B = (8 - zp) * s + m of a nibble-packed
    weight: s = sd * sub_s and m = sm * sub_m where factored (Q4_K, Q2_K,
    Q3_K), the stored f32 planes themselves where not (GPTQ4, Q4_1, Q4_0).
    B is None where the reference kernels have no bias term (zp 8 and no
    mins: Q4_0, Q3_K), rounded as theirs: (8 - zp) * s, then + m."""
    if qt.sfactor == 0:
        s, m = qt.scales, qt.mins
    else:
        s = qt.scales.float() * qt.sd.repeat_interleave(qt.sfactor, 0)
        m = None if qt.mins is None else qt.mins.float() * qt.sm.repeat_interleave(qt.sfactor, 0)
    b = None if qt.zp == 8 else float(8 - qt.zp) * s
    if m is not None:
        b = m if b is None else b + m
    return s, b


def unpack_w4(qs: torch.Tensor) -> torch.Tensor:
    """adjk bytes (Kp/2, Np) -> stored nibbles w4 = q - 8, (Kp, Np) int32."""
    u = qs.to(torch.int32)
    lo = ((u & 0xF) ^ 8) - 8
    hi = (((u >> 4) & 0xF) ^ 8) - 8
    return torch.stack([lo, hi], dim=1).reshape(2 * qs.shape[0], qs.shape[1])


def quantize_activations(x: torch.Tensor, group: int):
    """Per-(token, group) symmetric int8, with the weight's group (32; 16
    for Q6_K, Q2_K and Q3_K; 32, 64 or 128 for GPTQ4): (xq (m, Kp) int8,
    sx (m, Kp/group) f32, xsum (m, Kp/group) f32), the formula of the
    reference's "q" mode: sx = absmax/127, xq = clip(round(x / max(sx,
    1e-20)), +-127); torch.round rounds half to even, as jnp.round does."""
    m, kp = x.shape
    xr = x.reshape(m, kp // group, group)
    amax = xr.abs().amax(-1)
    # a tensor divisor: on the card torch divides by a Python scalar as a
    # product with its reciprocal, which can miss the IEEE quotient that the
    # kernels (and the JAX package) take by an ulp and so quantize an element
    # one step off (a qx_gptq call read 6.2e-4 from its kernel so)
    sx = amax / torch.full_like(amax, 127.0)
    xq = torch.clamp(torch.round(xr / torch.clamp_min(sx, 1e-20)[..., None]), -127, 127)
    return xq.to(torch.int8).reshape(m, kp), sx, xr.sum(-1)


def plain_q(xq: torch.Tensor, sx: torch.Tensor, xs: torch.Tensor, qt) -> torch.Tensor:
    """Group dots in f32, exact for integer operands (|sum| <= 128*127*8 <
    2**24 at the largest group), rescaled by sx * s, plus the bias
    xsum @ B where there is one."""
    m, kp = xq.shape
    g = qt.group
    ng = kp // g
    s, b = group_planes(qt)
    w = unpack_w4(qt.qs).float().reshape(ng, g, -1)
    parts = torch.bmm(xq.float().reshape(m, ng, g).transpose(0, 1), w)
    d = (parts * sx.T[:, :, None] * s[:, None, :]).sum(0)
    return d if b is None else xs @ b + d


def plain_qx(x: torch.Tensor, qt) -> torch.Tensor:
    return plain_q(*quantize_activations(x, qt.group), qt)


def _bf16_round(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def plain_si(x: torch.Tensor, qt) -> torch.Tensor:
    """bf16 operands, exact products and f32 sums (a bf16 matmul on a CPU
    returns bf16, so the operands are rounded and multiplied in f32)."""
    m, kp = x.shape
    s, b = group_planes(qt)
    g = qt.group
    w = _bf16_round(unpack_w4(qt.qs).float() * s.repeat_interleave(g, 0))
    if b is None:
        return _bf16_round(x) @ w
    xs = x.reshape(m, kp // g, g).sum(-1)
    return xs @ b + _bf16_round(x) @ w


def plain_g(x: torch.Tensor, qt) -> torch.Tensor:
    """Grouped dot: x rounded to bf16 against the raw grid (stored nibbles
    w4, or the int8 grid), exact products summed in f32 inside a group, the
    f32 scale applied to each group's partial sum, plus the bias through
    the group sums of the unrounded x (B = (8 - zp) * s + m for nibbles, m
    for grids, none for Q4_0, Q3_K, Q6_K, Q8_0 and Q5_0)."""
    m, kp = x.shape
    g = qt.group
    ng = kp // g
    if qt.packed:
        s, b = group_planes(qt)
        w = unpack_w4(qt.qs)
    else:
        s, b = grid_planes(qt)
        w = qt.qs
    parts = torch.bmm(_bf16_round(x).reshape(m, ng, g).transpose(0, 1),
                      w.float().reshape(ng, g, -1))
    d = (parts * s[:, None, :]).sum(0)
    return d if b is None else x.reshape(m, ng, g).sum(-1) @ b + d


def plain_i(x: torch.Tensor, qt) -> torch.Tensor:
    s, b = group_planes(qt)
    w = unpack_w4(qt.qs).float() * s.repeat_interleave(qt.group, 0)
    if b is not None:
        w = w + b.repeat_interleave(qt.group, 0)
    return _bf16_round(x) @ _bf16_round(w)


def grid_planes(qt) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(Kp/g, Np) f32 planes of an int8 grid: s = sd * sub_s and
    m = sm * sub_m (None without mins), the f32 products of _apply_factors,
    or the stored f32 planes themselves where not factored (sfactor 0: Q8_0,
    Q5_0, Q5_1)."""
    if qt.sfactor == 0:
        return qt.scales, qt.mins
    s = qt.scales.float() * qt.sd.repeat_interleave(qt.sfactor, 0)
    if qt.mins is None:
        return s, None
    return s, qt.mins.float() * qt.sm.repeat_interleave(qt.sfactor, 0)


def plain_q8(xq: torch.Tensor, sx: torch.Tensor, xs: torch.Tensor, qt) -> torch.Tensor:
    """Group dots in f32, exact for integer operands (|sum| <= 32*127*128 <
    2**24), rescaled by sx * s, plus the bias xsum @ M where there are mins."""
    m, kp = xq.shape
    g = qt.group
    s, mn = grid_planes(qt)
    w = qt.qs.float().reshape(kp // g, g, -1)
    parts = torch.bmm(xq.float().reshape(m, kp // g, g).transpose(0, 1), w)
    d = (parts * sx.T[:, :, None] * s[:, None, :]).sum(0)
    return d if mn is None else xs @ mn + d


def plain_qx8(x: torch.Tensor, qt) -> torch.Tensor:
    """Mode "qx" on an int8 grid: plain_q8 on x quantized per group of the
    weight's group, the quantization the kernel does in place."""
    return plain_q8(*quantize_activations(x, qt.group), qt)


def x_operands(x: torch.Tensor, group: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """What the bf16 GEMMs make of the activations: x rounded to nearest
    even bf16 (held in f32, exactly) and the f32 sums of x over each group
    of `group` columns, (m, Kp/group). The GEMM core of csrc/qmm_wgmma.cuh
    makes both inside the kernel, once per block, from the f32 x."""
    m, kp = x.shape
    return _bf16_round(x), x.reshape(m, kp // group, group).sum(-1)


def plain_b(x: torch.Tensor, qt) -> torch.Tensor:
    s, mn = grid_planes(qt)
    w = qt.qs.float() * s.repeat_interleave(qt.group, 0)
    if mn is not None:
        w = w + mn.repeat_interleave(qt.group, 0)
    return _bf16_round(x) @ _bf16_round(w)


def plain_sb(x: torch.Tensor, qt) -> torch.Tensor:
    s, mn = grid_planes(qt)
    xb, xs = x_operands(x, qt.group)
    out = xb @ _bf16_round(qt.qs.float() * s.repeat_interleave(qt.group, 0))
    if mn is None:
        return out
    return xs @ mn + out


def plain_f(x: torch.Tensor, qt) -> torch.Tensor:
    """Mode "": the dequantized weight q * s + m and the product, all f32."""
    s, mn = grid_planes(qt)
    w = qt.qs.float() * s.repeat_interleave(qt.group, 0)
    if mn is not None:
        w = w + mn.repeat_interleave(qt.group, 0)
    return x @ w


def plain_s(x: torch.Tensor, qt) -> torch.Tensor:
    """Mode "s": x @ (q * s) in f32, the mins folded through the group sums."""
    m, kp = x.shape
    s, mn = grid_planes(qt)
    out = x @ (qt.qs.float() * s.repeat_interleave(qt.group, 0))
    if mn is None:
        return out
    return x.reshape(m, kp // qt.group, qt.group).sum(-1) @ mn + out


def ksplit_planes(qt) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(Kp, Np) f32 grid values v = [l; f] of a ksplit weight (rows in
    logical order: the low nibbles, then the high ones) and its (Kp/G, Np)
    f32 planes s and B, B_lo = -zp * s + m and B_hi = (8 - zp) * s + m
    rounded as the reference's (the product, then + m; 0 where it has no
    term: the high half without mins)."""
    s, m = grid_planes(qt)  # s = sd * sub_s, m = sm * sub_m where factored
    half = s.shape[0] // 2
    s_lo, s_hi = s[:half], s[half:]
    b_lo = -float(qt.zp) * s_lo if qt.zp else None
    b_hi = float(8 - qt.zp) * s_hi if qt.zp != 8 else None
    if m is not None:
        b_lo = m[:half] if b_lo is None else b_lo + m[:half]
        b_hi = m[half:] if b_hi is None else b_hi + m[half:]
    bias = torch.cat([torch.zeros_like(s_lo) if b_lo is None else b_lo,
                      torch.zeros_like(s_hi) if b_hi is None else b_hi])
    b = qt.qs.view(torch.int8).to(torch.int32)  # 16 (hi - 8) + lo
    f = b >> 4  # floor(b / 16) = hi - 8
    return torch.cat([b - 16 * f, f]).float(), s, bias


def plain_f_ks(x: torch.Tensor, qt) -> torch.Tensor:
    """Modes "" and "r" on ksplit: w = v * s + B per element, all f32."""
    v, s, b = ksplit_planes(qt)
    g = qt.group
    return x @ (v * s.repeat_interleave(g, 0) + b.repeat_interleave(g, 0))


def plain_s_ks(x: torch.Tensor, qt) -> torch.Tensor:
    """Mode "s" on ksplit: xs @ B + x @ (v * s), all f32."""
    m, kp = x.shape
    v, s, b = ksplit_planes(qt)
    g = qt.group
    return x.reshape(m, kp // g, g).sum(-1) @ b + x @ (v * s.repeat_interleave(g, 0))


def plain_b_ks(x: torch.Tensor, qt) -> torch.Tensor:
    """Modes "b" and "rb" on ksplit: bf16(x) @ bf16(v * s + B)."""
    v, s, b = ksplit_planes(qt)
    g = qt.group
    return _bf16_round(x) @ _bf16_round(v * s.repeat_interleave(g, 0) + b.repeat_interleave(g, 0))


def plain_sb_ks(x: torch.Tensor, qt) -> torch.Tensor:
    """Mode "sb" on ksplit: xs @ B in f32 + bf16(x) @ bf16(v * s)."""
    m, kp = x.shape
    v, s, b = ksplit_planes(qt)
    g = qt.group
    out = _bf16_round(x) @ _bf16_round(v * s.repeat_interleave(g, 0))
    return x.reshape(m, kp // g, g).sum(-1) @ b + out


# -- wrappers ------------------------------------------------------------------


def _wrapper(name: str, lib: str, check, plain, ints):
    """The wrapper of kernel `name` in library `lib`: run(x, qt), or
    run(xq, sx, xsum, qt) for a kernel on activations quantized outside
    (PREQUANTIZED). It checks the weight with `check` and the activations
    against it, takes `plain` for CPU tensors, and launches the kernel for
    CUDA tensors, with the ints `ints(qt)` that the symbol takes after the
    shape (its group, or whether the weight has mins)."""

    def run(*args) -> torch.Tensor:
        *acts, qt = args
        kp, np_ = check(qt)
        m = acts[0].shape[0]
        dev = qt.qs.device
        if name in PREQUANTIZED:
            ng = kp // qt.group
            _check_act(acts[0], torch.int8, (m, kp), dev, "xq")
            _check_act(acts[1], torch.float32, (m, ng), dev, "sx")
            _check_act(acts[2], torch.float32, (m, ng), dev, "xsum")
        else:
            _check_act(acts[0], torch.float32, (m, kp), dev, "x")
        if dev.type == "cpu":
            PLAIN_CALLS[name] += 1
            return plain(*acts, qt)
        return _launch(name, lib, dev, acts, qt, m, kp, np_, *ints(qt))

    run.__name__ = run.__qualname__ = name
    return run


# kernels whose wrappers take (xq, sx, xsum) from quantize_activations
PREQUANTIZED = ("qmm_q", "qmm_q8", "qmm_q_gptq", "qmm_q_q4_0", "qmm_q8_legacy", "qmm_q_k16")


def _no_ints(qt) -> tuple:
    return ()


def _group(qt) -> tuple:  # the symbol dispatches on the group
    return (qt.group,)


def _has_mins(qt) -> tuple:  # the symbol is told whether the weight has mins
    return (int(qt.mins is not None),)


def _ksplit_ints(qt) -> tuple:  # the ksplit symbols read the layout from these
    return (qt.group, int(qt.mins is not None), qt.zp, qt.sfactor)


_QMATMUL_PY = "ctransformers_tpu/ops/qmatmul.py"
# kernel -> (library and source under csrc/, layout check, plain version, the
# ints the symbol takes, line of the Pallas kernel it replaces). One plain
# version serves a function whatever the group, the scale source and the bias.
_SPECS = {
    "qmm_qx": ("qmm_decode", check_qtensor, plain_qx, _no_ints, 1370),
    "qmm_q": ("qmm_decode", check_qtensor, plain_q, _no_ints, 1288),
    "qmm_si": ("qmm_prefill", check_qtensor, plain_si, _no_ints, 1148),
    "qmm_i": ("qmm_prefill", check_qtensor, plain_i, _no_ints, 1090),
    "qmm_q8": ("qmm_grid", check_grid_qtensor, plain_q8, _group, 1288),
    "qmm_qx8": ("qmm_grid", check_grid_qtensor, plain_qx8, _group, 1370),
    "qmm_b": ("qmm_grid", check_grid_qtensor, plain_b, _group, 734),
    "qmm_sb": ("qmm_grid", check_grid_qtensor, plain_sb, _group, 1040),
    "qmm_qx_gptq": ("qmm_decode", check_gptq_qtensor, plain_qx, _group, 1370),
    "qmm_q_gptq": ("qmm_decode", check_gptq_qtensor, plain_q, _group, 1288),
    "qmm_i_gptq": ("qmm_prefill", check_gptq_qtensor, plain_i, _group, 1090),
    "qmm_g": ("qmm_float", check_qtensor, plain_g, _no_ints, 1206),
    "qmm_g_gptq": ("qmm_float", check_gptq_qtensor, plain_g, _group, 1206),
    "qmm_g8": ("qmm_float", check_grid_qtensor, plain_g, _group, 1206),
    "qmm_f": ("qmm_float", check_grid_qtensor, plain_f, _group, 734),
    "qmm_s": ("qmm_float", check_grid_qtensor, plain_s, _group, 1040),
    "qmm_si_gptq": ("qmm_prefill", check_gptq_qtensor, plain_si, _group, 1148),
    "qmm_qx_q4_0": ("qmm_decode", check_q40_qtensor, plain_qx, _no_ints, 1370),
    "qmm_q_q4_0": ("qmm_decode", check_q40_qtensor, plain_q, _no_ints, 1288),
    "qmm_i_q4_0": ("qmm_prefill", check_q40_qtensor, plain_i, _no_ints, 1090),
    "qmm_si_q4_0": ("qmm_prefill", check_q40_qtensor, plain_si, _no_ints, 1148),
    "qmm_g_q4_0": ("qmm_float", check_q40_qtensor, plain_g, _no_ints, 1206),
    "qmm_q8_legacy": ("qmm_grid", check_legacy_grid_qtensor, plain_q8, _has_mins, 1288),
    "qmm_qx8_legacy": ("qmm_grid", check_legacy_grid_qtensor, plain_qx8, _has_mins, 1370),
    "qmm_b_legacy": ("qmm_grid", check_legacy_grid_qtensor, plain_b, _has_mins, 734),
    "qmm_sb_legacy": ("qmm_grid", check_legacy_grid_qtensor, plain_sb, _has_mins, 1040),
    "qmm_g8_legacy": ("qmm_float", check_legacy_grid_qtensor, plain_g, _has_mins, 1206),
    "qmm_f_legacy": ("qmm_float", check_legacy_grid_qtensor, plain_f, _has_mins, 734),
    "qmm_s_legacy": ("qmm_float", check_legacy_grid_qtensor, plain_s, _has_mins, 1040),
    "qmm_qx_k16": ("qmm_decode", check_k16_qtensor, plain_qx, _has_mins, 1370),
    "qmm_q_k16": ("qmm_decode", check_k16_qtensor, plain_q, _has_mins, 1288),
    "qmm_i_k16": ("qmm_prefill", check_k16_qtensor, plain_i, _has_mins, 1090),
    "qmm_si_k16": ("qmm_prefill", check_k16_qtensor, plain_si, _has_mins, 1148),
    "qmm_g_k16": ("qmm_float", check_k16_qtensor, plain_g, _has_mins, 1206),
    "qmm_f_ks": ("qmm_ksplit", check_ksplit_qtensor, plain_f_ks, _ksplit_ints, 783),
    "qmm_s_ks": ("qmm_ksplit", check_ksplit_qtensor, plain_s_ks, _ksplit_ints, 957),
    "qmm_b_ks": ("qmm_ksplit", check_ksplit_qtensor, plain_b_ks, _ksplit_ints, 783),
    "qmm_sb_ks": ("qmm_float", check_ksplit_qtensor, plain_sb_ks, _ksplit_ints, 957),
    "qmm_r_ks": ("qmm_rb", check_ksplit_qtensor, plain_f_ks, _ksplit_ints, 872),
    "qmm_rb_ks": ("qmm_ksplit", check_ksplit_qtensor, plain_b_ks, _ksplit_ints, 872),
    "qmm_r8": ("qmm_rb", check_grid_qtensor, plain_f, _group, 1459),
    "qmm_rb8": ("qmm_grid", check_grid_qtensor, plain_b, _group, 1459),
    "qmm_r8_legacy": ("qmm_rb", check_legacy_grid_qtensor, plain_f, _has_mins, 1459),
    "qmm_rb8_legacy": ("qmm_grid", check_legacy_grid_qtensor, plain_b, _has_mins, 1459),
}
KERNELS = {n: _wrapper(n, lib, chk, pl, ints) for n, (lib, chk, pl, ints, _) in _SPECS.items()}
PLAIN = {n: spec[2] for n, spec in _SPECS.items()}
SOURCE_OF = {n: f"ctransformers_tpu_torch/csrc/{spec[0]}.cu" for n, spec in _SPECS.items()}
# the K split of csrc/qmm_splitk.cuh at m <= 32: qmm_g8, qmm_f and qmm_g
# (symbols in qmm_float.cu), qmm_qx (qmm_decode.cu), qmm_q8, qmm_q8_legacy,
# qmm_rb8 and qmm_rb8_legacy (qmm_grid.cu), qmm_f_ks, qmm_s_ks, qmm_b_ks
# and qmm_rb_ks (qmm_ksplit.cu); their files' own designs serve m > 32
# (qmm_rb8's, qmm_b_ks's and qmm_rb_ks's the Hopper GEMM core)
SPLIT_KERNELS = ("qmm_g8", "qmm_f", "qmm_qx", "qmm_g", "qmm_q8", "qmm_q8_legacy", "qmm_f_ks",
                 "qmm_s_ks", "qmm_rb8", "qmm_rb8_legacy", "qmm_b_ks", "qmm_rb_ks")
SOURCE_OF.update(dict.fromkeys(SPLIT_KERNELS, "ctransformers_tpu_torch/csrc/qmm_splitk.cuh"))
# the symbols that run the Hopper GEMM core: those of qmm_grid.cu and every
# adjk nibble GEMM of qmm_prefill.cu (the core's adjk nibble tile) at every
# m, the ksplit GEMMs at m > 32 (qmm_sb_ks of qmm_float.cu, its source;
# qmm_b_ks and qmm_rb_ks, named by their split's source)
WGMMA_KERNELS = ("qmm_b", "qmm_sb", "qmm_b_legacy", "qmm_sb_legacy", "qmm_si", "qmm_i",
                 "qmm_si_gptq", "qmm_i_gptq", "qmm_si_k16", "qmm_i_k16", "qmm_si_q4_0",
                 "qmm_i_q4_0", "qmm_sb_ks", "qmm_b_ks", "qmm_rb_ks")
SOURCE_OF.update({n: "ctransformers_tpu_torch/csrc/qmm_wgmma.cuh" for n in WGMMA_KERNELS
                  if n != "qmm_sb_ks" and n not in SPLIT_KERNELS})
REPLACES = {n: f"{_QMATMUL_PY}:{spec[4]}" for n, spec in _SPECS.items()}
# the wrappers as module functions: qmm_qx(x, qt), qmm_q(xq, sx, xsum, qt), ...
# (ops/qmatmul.py looks them up here by name at call time)
globals().update(KERNELS)

# kernel launches (incremented only where a kernel is launched) and calls
# of the plain versions through the wrappers (CPU tensors)
LAUNCHES: Dict[str, int] = dict.fromkeys(_SPECS, 0)
PLAIN_CALLS: Dict[str, int] = dict.fromkeys(_SPECS, 0)
# calls of the dense candidate (ops/qmatmul.py: dequantize, then a bf16
# torch.matmul), a counted choice of the race beside the kernels
DENSE_CALLS: Dict[str, int] = {"dense": 0}


# the launch configuration of each kernel family, the second field of a
# candidate (ops/qmatmul.py:mode_candidates): output tile and K chunk of a
# block. One per kernel so far; a tuned variant of a kernel joins as another
# configuration of the same mode.
DECODE_CONFIG = "n32k1024"  # 32 columns and all of K per block, 1024-row chunks
KSPLIT_FLOAT_CONFIG = "n32k512"  # the same, 512 byte rows (both halves) a chunk
# 128 columns a block, stages of 16 rows a warp in a cp.async ring of 2, K
# split over a cluster of up to 8 blocks (csrc/qmm_splitk.cuh; grid_split_plan)
SPLIT_CONFIG = "n128k16r2c8"
# the same on nibbles: a group of 32 rows a warp, a superblock a stage
NIBBLE_SPLIT_CONFIG = "n128k32r2c8"
# the same on ksplit bytes: 16 byte rows a warp, both nibbles (halves) of each
KSPLIT_SPLIT_CONFIG = "n128k16h2r2c8"
R_CONFIG = "m8n32k128"  # 8 x 32 output tile, 128-row K steps dequantized to f32
# 128 x 128 output tile over two wgmma warpgroups, K split over a cluster of
# 3 (csrc/qmm_wgmma.cuh)
WGMMA_CONFIG = "wg128n128c3"
CONFIG_OF = dict.fromkeys(_SPECS, DECODE_CONFIG)
CONFIG_OF.update(dict.fromkeys(WGMMA_KERNELS, WGMMA_CONFIG))
# qmm_sb_ks: the float design at m <= 32, the core above
CONFIG_OF.update(qmm_sb_ks=f"{KSPLIT_FLOAT_CONFIG}|{WGMMA_CONFIG}")
# qmm_g8, qmm_f, qmm_q8 and qmm_q8_legacy: the K split at m <= 32 (the race
# offers them there), the decode design above
CONFIG_OF.update(dict.fromkeys(("qmm_g8", "qmm_f", "qmm_q8", "qmm_q8_legacy"),
                               f"{SPLIT_CONFIG}|{DECODE_CONFIG}"))
# qmm_qx, qmm_g: the nibble K split at m <= 32, the decode design above
CONFIG_OF.update(dict.fromkeys(("qmm_qx", "qmm_g"), f"{NIBBLE_SPLIT_CONFIG}|{DECODE_CONFIG}"))
# qmm_f_ks, qmm_s_ks: the ksplit K split at m <= 32, the float design above
CONFIG_OF.update(dict.fromkeys(("qmm_f_ks", "qmm_s_ks"),
                               f"{KSPLIT_SPLIT_CONFIG}|{KSPLIT_FLOAT_CONFIG}"))
CONFIG_OF.update(qmm_r_ks=R_CONFIG, qmm_r8=R_CONFIG, qmm_r8_legacy=R_CONFIG)
# qmm_rb8, qmm_rb8_legacy: the K split's bf16 form at m <= 32, the core above
CONFIG_OF.update(dict.fromkeys(("qmm_rb8", "qmm_rb8_legacy"), f"{SPLIT_CONFIG}|{WGMMA_CONFIG}"))
# qmm_b_ks, qmm_rb_ks: the ksplit K split's bf16 form at m <= 32, the core above
CONFIG_OF.update(dict.fromkeys(("qmm_b_ks", "qmm_rb_ks"), f"{KSPLIT_SPLIT_CONFIG}|{WGMMA_CONFIG}"))
# the modes of an int8 grid by the JAX package's names ("q8" is the port's
# name for its "q" with packed4=False; "qx" is in no candidate list, as in
# the JAX package: a table sends keys there, ops/qmatmul.py:qx_mode_entries)
_GRID_KERNELS = {"": "qmm_f", "s": "qmm_s", "b": "qmm_b", "sb": "qmm_sb", "g": "qmm_g8",
                 "q": "qmm_q8", "q8": "qmm_q8", "qx": "qmm_qx8", "r": "qmm_r8",
                 "rb": "qmm_rb8"}
# the modes a ksplit weight takes ("" is the f32 dequantize-and-dot "f")
_KSPLIT_KERNELS = {"": "qmm_f_ks", "s": "qmm_s_ks", "b": "qmm_b_ks", "sb": "qmm_sb_ks",
                   "r": "qmm_r_ks", "rb": "qmm_rb_ks"}
# the ksplit split's mode of each kernel it serves (ct_qmm_ks_split_plan)
_KS_SPLIT_MODE = {"qmm_f_ks": 0, "qmm_s_ks": 1, "qmm_b_ks": 2, "qmm_rb_ks": 2}


def grid_split_plan(name: str, qt, m: int) -> int:
    """The blocks P of a cluster that a K-split kernel (`name`, one of
    SPLIT_KERNELS) splits K over for weight `qt` (on the card; qmm_g8,
    qmm_f, qmm_q8 and qmm_rb8: Q6_K or Q5_K, qmm_q8_legacy and qmm_rb8_legacy:
    Q8_0, Q5_0 or Q5_1,
    qmm_qx and qmm_g: Q4_K, qmm_f_ks, qmm_s_ks, qmm_b_ks and qmm_rb_ks: the
    ksplit nibbles of every kind) at batch size m <= 32: the first of 8, 6, 4, 3 and 2, up to
    the weight's stages, whose clusters all fit on the card at once, else 1
    (csrc/qmm_splitk.cuh:plan)."""
    if name not in SPLIT_KERNELS:
        raise ValueError(f"{name}: the K split serves {', '.join(SPLIT_KERNELS)}")
    lib, check = _SPECS[name][:2]
    kp, np_ = check(qt)
    if qt.qs.device.type != "cuda":
        raise ValueError(f"{name}: the plan asks the card; the weight is on {qt.qs.device}")
    if name in ("qmm_g8", "qmm_f"):
        p = _fn(lib, "ct_qmm_grid_split_plan")(int(name == "qmm_g8"), qt.group, m, kp, np_)
    elif name in ("qmm_q8", "qmm_q8_legacy", "qmm_rb8", "qmm_rb8_legacy"):
        p = _fn(lib, f"ct_{name.removesuffix('_legacy')}_split_plan")(
            int(qt.sfactor == 0), int(qt.mins is not None), qt.group, m, kp, np_)
    elif name in _KS_SPLIT_MODE:
        p = _fn(lib, "ct_qmm_ks_split_plan")(_KS_SPLIT_MODE[name], qt.group,
                                             int(qt.mins is not None), qt.sfactor, m, kp, np_)
    else:
        p = _fn(lib, f"ct_{name}_split_plan")(m, kp, np_)
    if p <= 0:
        raise RuntimeError(f"{name}: no split plan at m={m}, shape ({kp}, {np_}): CUDA error {-p}")
    return p


def kernel_name(mode: str, qt) -> str:
    """The wrapper serving `mode` (ops/qmatmul.py:mode_candidates) on `qt`:
    the int8-grid kernels for an unpacked weight (their "_legacy" forms
    where the planes are unfactored), and for nibble-packed planes the Q4_K
    kernels where factored at group 32 and the "_k16" kernels at group 16
    (Q2_K, Q3_K), else the GPTQ kernels where there are mins (GPTQ4, Q4_1)
    and the bias-free Q4_0 kernels where there are none; a ksplit weight's
    "_ks" kernels, one per mode for every kind."""
    if not qt.packed:
        return _GRID_KERNELS[mode] + ("_legacy" if qt.sfactor == 0 else "")
    if qt.pack_layout == "ksplit":
        if mode not in _KSPLIT_KERNELS:
            raise ValueError(f"mode {mode!r} needs the adjk layout; ksplit weights take "
                             f"{sorted(_KSPLIT_KERNELS)}")
        return _KSPLIT_KERNELS[mode]
    if qt.sfactor:
        return f"qmm_{mode}" + ("_k16" if qt.group == 16 else "")
    return f"qmm_{mode}" + ("_gptq" if qt.mins is not None else "_q4_0")
