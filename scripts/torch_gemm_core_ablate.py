"""Split the time of the Hopper GEMM core (csrc/qmm_wgmma.cuh) on one card:
build the core as it is and copies with one part taken out, and time each
on the same card in one process.

    python3 scripts/torch_gemm_core_ablate.py
        [--kind Q6_K|ks:Q4_K|sb:Q5_K|aj:GPTQ4/128|aj:Q2_K|aj:Q4_K|ai:Q4_0|ai:Q2_K|ai:Q3_K]
        [--m 128 ...]
        [--variants base no_mrows ...] [--reps 20]

--kind Q6_K (the default) times the int8-grid tile behind ct_qmm_b on a
Q6_K grid; ks:Q4_K the ksplit nibble tile behind ct_qmm_sb_ks (m > 32) on
Q4_K nibbles packed ksplit, with the sum fold of both halves' biases;
sb:Q5_K the int8-grid tile behind ct_qmm_sb on a Q5_K grid, with the fold
of the factored M = sm * sub_m; aj:GPTQ4/128 the adjk nibble tile behind
ct_qmm_si_gptq on GPTQ4 planes at group 128, with the fold of B = 8 s + m
carried over a group's two stages; aj:Q2_K the same tile behind
ct_qmm_si_k16 on Q2_K nibbles (group 16, factored scales), whose fold takes
four groups a stage; aj:Q4_K the same tile behind ct_qmm_si on Q4_K
nibbles (group 32, factored scales), whose fold takes two; ai:Q4_0 the
adjk tile without a fold behind ct_qmm_i_q4_0 (and ct_qmm_si_q4_0) on Q4_0
nibbles (group 32, the plain s plane, no mins: W = w4 * s); ai:Q2_K and
ai:Q3_K the adjk tile without a fold behind ct_qmm_i_k16 on Q2_K nibbles
(group 16, factored scales, the bias added to each weight) and on Q3_K
nibbles (no bias; ct_qmm_si_k16 runs the same instantiation). Every variant
is the symbol's source (qmm_grid.cu, qmm_float.cu or qmm_prefill.cu)
built by nvcc (the package's flags, all started together) from a copy of
csrc/ under build/gemm_core_ablate/ with one edit to qmm_wgmma.cuh:

  base         the source as it is
  split4       K split over a cluster of 4 blocks (the source: 3)
  split2       over a cluster of 2
  no_copies    the producer issues no copy (the stage's barrier completes
               with one arrival): the consumers' work alone
  no_xfrag     the x fragments are constants, not loaded and rounded
  no_dequant   the dequantized weight tile is not stored
  no_wgmma     no tensor-core product (a stand-in keeps the fragments live)
  no_fence     no proxy fence and barrier between the tile and the products
  no_mrows     (the fold's kinds) no rows of M or B written or read: the
               fold adds constants
  m_in_fold    (sb:Q5_K) M is not written into shared memory: the fold
               rebuilds each M value from the stage's sub_m bytes and sm
               row (one more f32 product per value), the other way to feed
               the factored fold

--variants builds only those named (all of the kind's by default); each
build prints ptxas' registers and spill stores for the timed
instantiation and whether ptxas serialised its wgmma (warning C7513). Only
base and m_in_fold compute the function (the error against the
plain version is printed; the others print theirs too, meaningless by
design). For each variant: the clusters the card runs at once
(cudaOccupancyMaxActiveClusters) and, per shape (v: 4096 x 4096, down:
11264 x 4096) and m, the kernel ms from a replayed CUDA graph cycling over
weight copies past the L2, as chip_smoke.py phase 3 times it. Last line: a
JSON object {variant: {"shape m": ms}}.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from ctransformers_tpu_torch.models.synthetic import K16_PLANE_RANGES  # noqa: E402
from ctransformers_tpu_torch.ops import qmm_kernels as K  # noqa: E402
from ctransformers_tpu_torch.ops.qmatmul import QTensor  # noqa: E402

CORE = "qmm_wgmma.cuh"
OUT = os.path.join(ROOT, "build", "gemm_core_ablate")
WGMMA = "    for (int kk = 0; kk < 4; ++kk) wgmma_m64n128k16(acc[0], acc[1], af[kk], b_desc(bt + kk * 2048));"
# the fold's reads of its rows of M or B, and each tile's writes of them
MROW_READ = """            const float2 mm =
                *reinterpret_cast<const float2*>(mrow + gi * kBN + nh * 64 + 8 * j + 2 * q);"""
AJ_WRITE = """          *reinterpret_cast<float4*>(mrow + gl * kBN + 4 * lane) = make_float4(b[0], b[1], b[2], b[3]);"""
GRID_WRITE = """          *reinterpret_cast<float4*>(mrow + gl * kBN + 4 * lane) =
              make_float4(m1[0], m1[1], m1[2], m1[3]);"""
KS_WRITE = """          *reinterpret_cast<float4*>(mrow + (h * KSS::kNGB + j) * kBN + 4 * lane) =
              make_float4(b[h][0], b[h][1], b[h][2], b[h][3]);"""
VARIANTS = {
    "base": [],
    "split4": [("constexpr int kSplit = 3;", "constexpr int kSplit = 4;")],
    "split2": [("constexpr int kSplit = 3;", "constexpr int kSplit = 2;")],
    "no_copies": [
        ("""          tma_2d(xs, &tx, k0, row0, bar);
          tma_2d(xs + kXHalf, &tx, k0 + kXBox, row0, bar);
          tma_2d(smem_addr(sh.wtile(st)), &tw, n0, k0, bar);
          S::copy(p, k0, n0, smem_addr(sh.scales(st)), bar);""", ""),
        ("mbar_expect_tx(bar, kXBytes + kWBytes + S::kBytes);", "mbar_arrive(bar);"),
        ("""          tma_2d(xs, &tx, r0, row0, bar);
          tma_2d(xs + kXHalf, &tx, half + r0, row0, bar);
          tma_2d(smem_addr(sh.wtile(st)), &tw, n0, r0, bar);
          KSS::copy(p, r0, half, n0, smem_addr(sh.wtile(st)) + kKsWBytes, bar);""", ""),
        ("mbar_expect_tx(bar, kXBytes + kKsWBytes + KSS::kBytes);", "mbar_arrive(bar);"),
        ("""          tma_2d(xs, &tx, k0, row0, bar);
          tma_2d(xs + kXHalf, &tx, k0 + kXBox, row0, bar);
          tma_2d(smem_addr(sh.wtile(st)), &tw, n0, k0 / 2, bar);
          S::copy(p, k0, n0, smem_addr(sh.scales(st)), bar);""", ""),
        ("mbar_expect_tx(bar, kXBytes + kKsWBytes + S::kBytes);", "mbar_arrive(bar);")],
    "no_xfrag": [("""        const float4 v = *reinterpret_cast<const float4*>(box + row * 128 + ((c ^ (row & 7)) << 4));""",
                  """        const float4 v = make_float4(kk, hr, c, row);""")],
    "no_dequant": [("""  *reinterpret_cast<uint2*>(bt + kr * 128 + ((c ^ (kr & 7)) << 4)) =
      make_uint2(bf16x2(v[0], v[1]), bf16x2(v[2], v[3]));""", "")],
    "no_wgmma": [(WGMMA, """    for (int kk = 0; kk < 4; ++kk)
      acc[0][kk] += __uint_as_float(af[kk][0] ^ af[kk][1] ^ af[kk][2] ^ af[kk][3] ^ bt);""")],
    "no_fence": [("""  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  consumers_sync();""", "")],
    "no_mrows": [
        (MROW_READ, "            const float2 mm = make_float2(1.f, 2.f);"),
        (AJ_WRITE, ";"), (GRID_WRITE, ";"), (KS_WRITE, ";")],
    "m_in_fold": [(GRID_WRITE, ";"), (MROW_READ, """            const int col = nh * 64 + 8 * j + 2 * q;
            const uint8_t* sm2 = sh.scales(st) + 1280 + 4 * col;
            const int8_t* subm = reinterpret_cast<const int8_t*>(sh.scales(st) + 1024 + gi * kBN + col);
            const float2 mm = make_float2(
                __fmul_rn(*reinterpret_cast<const float*>(sm2), static_cast<float>(subm[0])),
                __fmul_rn(*reinterpret_cast<const float*>(sm2 + 4), static_cast<float>(subm[1])));""")],
}
# the variants each kind builds (no_mrows where there is a fold, m_in_fold
# where M is factored)
FOLD_KINDS = ("ks:Q4_K", "sb:Q5_K", "aj:GPTQ4/128", "aj:Q2_K", "aj:Q4_K")
# appended to each copy of the source: the clusters of the timed
# instantiation (INSTANCE) that the card runs at once
OCCUPANCY = """
extern "C" int ablate_max_active_clusters() {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(32, 1, ctw::kSplit);
  cfg.blockDim = dim3(ctw::kThreads);
  cfg.dynamicSmemBytes = ctw::kSmemOf<SMEM>;
  auto kern = ctw::grid_gemm_kernel<INSTANCE>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ctw::kSmemOf<SMEM>);
  int n = -1;
  const cudaError_t e = cudaOccupancyMaxActiveClusters(&n, (void*)kern, &cfg);
  return e == cudaSuccess ? n : -1000 - (int)e;
}
"""
SHAPES = {"v": (4096, 4096), "down": (11264, 4096)}
# kind -> (source, symbol, the core's template arguments: G, HAS_MINS,
# PLAIN_S, FOLD, KS, AJ)
KINDS = {"Q6_K": ("qmm_grid.cu", "ct_qmm_b", "16, false, false, false, false, false"),
         "ks:Q4_K": ("qmm_float.cu", "ct_qmm_sb_ks", "32, true, false, true, true, false"),
         "sb:Q5_K": ("qmm_grid.cu", "ct_qmm_sb", "32, true, false, true, false, false"),
         "aj:GPTQ4/128": ("qmm_prefill.cu", "ct_qmm_si_gptq", "128, true, true, true, false, true"),
         "aj:Q2_K": ("qmm_prefill.cu", "ct_qmm_si_k16", "16, true, false, true, false, true"),
         "aj:Q4_K": ("qmm_prefill.cu", "ct_qmm_si", "32, true, false, true, false, true"),
         "ai:Q4_0": ("qmm_prefill.cu", "ct_qmm_i_q4_0", "32, false, true, false, false, true"),
         "ai:Q2_K": ("qmm_prefill.cu", "ct_qmm_i_k16", "16, true, false, false, false, true"),
         "ai:Q3_K": ("qmm_prefill.cu", "ct_qmm_i_k16", "16, false, false, false, false, true")}


def variants_of(kind: str) -> list:
    return [v for v in VARIANTS if (v != "no_mrows" or kind in FOLD_KINDS)
            and (v != "m_in_fold" or kind == "sb:Q5_K")]


def ptxas_of(log: str, args: str) -> str:
    """Registers, spill stores and the wgmma serialisation warning (C7513)
    of the core's instantiation `args` (KINDS' template arguments) in an
    `nvcc -Xptxas -v` log."""
    g, *flags = [a.strip() for a in args.split(",")]
    mangled = (f"grid_gemm_kernelILi{g}E" + "".join("Lb1E" if f == "true" else "Lb0E" for f in flags)
               + "E")
    regs = spill = "?"
    for blk in re.split(r"ptxas info\s*: Compiling entry function ", log)[1:]:
        if mangled in blk.split("'")[1]:
            r = re.search(r"Used (\d+) registers", blk)
            sp = re.search(r"(\d+) bytes spill stores", blk)
            regs, spill = (r.group(1) if r else "?"), (sp.group(1) if sp else "?")
    c7513 = any(mangled in ln for ln in log.splitlines() if "C7513" in ln)
    return f"{regs} registers, {spill} bytes spill stores, C7513 {'yes' if c7513 else 'no'}"


def build(names, kind: str):
    """nvcc on a patched copy per variant of `kind`'s source, all started
    together; returns {name: loaded library} and prints each build's
    ptxas line for the timed instantiation."""
    procs = {}
    for name in names:
        d = os.path.join(OUT, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(K.CSRC, d)
        path = os.path.join(d, CORE)
        src = open(path).read()
        for old, new in VARIANTS[name]:
            if old not in src:
                raise SystemExit(f"{name}: the edit's anchor is not in {CORE}: {old[:60]!r}")
            src = src.replace(old, new)
        open(path, "w").write(src)
        source = KINDS[kind][0]
        args = KINDS[kind][2]
        with open(os.path.join(d, source), "a") as f:
            f.write(OCCUPANCY.replace("INSTANCE", args).replace(
                "SMEM", ", ".join(args.split(", ")[2:])))
        so = os.path.join(d, f"lib{source[:-3]}.so")
        procs[name] = (so, subprocess.Popen(
            [K._nvcc(), *K.NVCC_FLAGS, "-o", so, os.path.join(d, source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{out[-4000:]}")
        print(f"{name}: ptxas {ptxas_of(out, KINDS[kind][2])}", flush=True)
        lib = ctypes.CDLL(so)
        K._bind(lib)
        lib.ablate_max_active_clusters.restype = ctypes.c_int
        libs[name] = lib
    return libs


def weight(kind: str, k: int, n: int, seed: int) -> QTensor:
    """A random Q6_K or Q5_K grid, GPTQ4 group-128 adjk nibbles over f32
    planes, Q4_0 adjk nibbles over an f32 s plane, Q2_K or Q3_K adjk
    nibbles over group-16 factors (the ranges of models/synthetic.py's
    random blocks), or Q4_K nibbles over group-32 factors, adjk or packed
    ksplit (any byte is a pair of nibbles), at padded shape (k, n)."""
    g = torch.Generator().manual_seed(seed)
    sd = torch.rand((k // 256, n), generator=g) * 1e-3 + 1e-4
    if kind == "Q6_K":
        qs = torch.randint(-32, 32, (k, n), generator=g, dtype=torch.int8)
        sub_s = torch.randint(-64, 64, (k // 16, n), generator=g, dtype=torch.int8)
        return QTensor(qs, sub_s, None, "Q6_K", 16, (k, n), sd=sd, sm=None, sfactor=16).to("cuda")
    if kind == "sb:Q5_K":
        qs = torch.randint(0, 32, (k, n), generator=g, dtype=torch.int8)
        sub_s = torch.randint(0, 64, (k // 32, n), generator=g, dtype=torch.int8)
        sub_m = torch.randint(0, 64, (k // 32, n), generator=g, dtype=torch.int8)
        sm = -torch.rand((k // 256, n), generator=g) * 1e-3
        return QTensor(qs, sub_s, sub_m, "Q5_K", 32, (k, n), sd=sd, sm=sm, sfactor=8).to("cuda")
    if kind == "aj:GPTQ4/128":
        qs = torch.randint(-128, 128, (k // 2, n), generator=g, dtype=torch.int8)
        s = torch.rand((k // 128, n), generator=g) * 3e-3 + 1e-3
        z = torch.randint(0, 16, (k // 128, n), generator=g).float()
        return QTensor(qs, s, -(s * z), "GPTQ4", 128, (k, n), packed=True, zp=0, sfactor=0,
                       pack_layout="adjk").to("cuda")
    if kind == "ai:Q4_0":
        qs = torch.randint(-128, 128, (k // 2, n), generator=g, dtype=torch.int8)
        s = torch.rand((k // 32, n), generator=g) * 3e-3 + 1e-3
        return QTensor(qs, s, None, "Q4_0", 32, (k, n), packed=True, zp=8, sfactor=0,
                       pack_layout="adjk").to("cuda")
    if kind in ("aj:Q2_K", "ai:Q2_K", "ai:Q3_K"):
        q2 = kind.endswith("Q2_K")
        r = K16_PLANE_RANGES["Q2_K" if q2 else "Q3_K"]
        qs = torch.randint(-128, 128, (k // 2, n), generator=g, dtype=torch.int8)
        sub_s = torch.randint(*r["sub"], (k // 16, n), generator=g, dtype=torch.int8)
        sub_m = (torch.randint(*r["sub"], (k // 16, n), generator=g, dtype=torch.int8)
                 if q2 else None)
        sd = torch.rand((k // 256, n), generator=g) * (r["d"][1] - r["d"][0]) + r["d"][0]
        if not q2:
            return QTensor(qs, sub_s, None, "Q3_K", 16, (k, n), packed=True, zp=8, sd=sd,
                           sm=None, sfactor=16, pack_layout="adjk").to("cuda")
        sm = -torch.rand((k // 256, n), generator=g) * r["dmin"]
        return QTensor(qs, sub_s, sub_m, "Q2_K", 16, (k, n), packed=True, zp=0, sd=sd, sm=sm,
                       sfactor=16, pack_layout="adjk").to("cuda")
    adjk = kind == "aj:Q4_K"
    qs = (torch.randint(-128, 128, (k // 2, n), generator=g, dtype=torch.int8) if adjk
          else torch.randint(0, 256, (k // 2, n), generator=g, dtype=torch.uint8))
    sub_s = torch.randint(0, 64, (k // 32, n), generator=g, dtype=torch.int8)
    sub_m = torch.randint(0, 64, (k // 32, n), generator=g, dtype=torch.int8)
    sm = -torch.rand((k // 256, n), generator=g) * 1e-3
    return QTensor(qs, sub_s, sub_m, "Q4_K", 32, (k, n), packed=True, zp=0, sd=sd, sm=sm,
                   sfactor=8, pack_layout="adjk" if adjk else "ksplit").to("cuda")


def graph_ms(fn, reps: int) -> float:
    fn(0)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(reps):
            fn(i)
    g.replay()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    g.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kind", choices=sorted(KINDS), default="Q6_K")
    ap.add_argument("--m", type=int, nargs="+", default=[128])
    ap.add_argument("--variants", nargs="+", help="build only these (default: all of the kind's)")
    ap.add_argument("--reps", type=int, default=20)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_gemm_core_ablate: CUDA is not available", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    if min(opts.m) <= 32:
        raise SystemExit("the core serves m > 32")
    names = variants_of(opts.kind)
    if opts.variants:
        unknown = set(opts.variants) - set(names)
        if unknown:
            raise SystemExit(f"no such variant of {opts.kind}: {sorted(unknown)}")
        names = [v for v in names if v in opts.variants]
    libs = build(names, opts.kind)
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, lib in libs.items():
        print(f"{name}: max active clusters {lib.ablate_max_active_clusters()}", flush=True)
    dev = torch.device("cuda")
    result = {name: {} for name in libs}
    symbol = KINDS[opts.kind][1]
    plain, ints = {"Q6_K": (K.plain_b, lambda qt: (16,)), "ks:Q4_K": (K.plain_sb_ks, K._ksplit_ints),
                   "sb:Q5_K": (K.plain_sb, lambda qt: (32,)),
                   "aj:GPTQ4/128": (K.plain_si, lambda qt: (128,)),
                   "aj:Q2_K": (K.plain_si, K._has_mins),
                   "aj:Q4_K": (K.plain_si, K._no_ints), "ai:Q4_0": (K.plain_i, K._no_ints),
                   "ai:Q2_K": (K.plain_i, K._has_mins),
                   "ai:Q3_K": (K.plain_i, K._has_mins)}[opts.kind]
    for shape, (k, n) in SHAPES.items():
        qts = [weight(opts.kind, k, n, 0)]
        per_copy = sum(a.numel() * a.element_size() for a in K._planes(qts[0]) if a is not None)
        qts += [weight(opts.kind, k, n, i) for i in range(1, math.ceil(150e6 / per_copy))]
        for m in opts.m:
            x = torch.randn(m, k, generator=torch.Generator().manual_seed(m)).to(dev)
            out = torch.empty(m, n, device=dev)
            ref = plain(x, qts[0])
            for name, lib in libs.items():
                def call(i, fn=getattr(lib, symbol)):
                    qt = qts[i % len(qts)]
                    rc = fn(*K._ptrs(x, *K._planes(qt), out), m, k, n, *ints(qt), K._stream(dev))
                    if rc:
                        raise SystemExit(f"{name}: launch failed with CUDA error {rc}")
                ms = graph_ms(call, opts.reps)
                call(0)
                torch.cuda.synchronize()
                err = ((out - ref).norm() / ref.norm()).item()
                result[name][f"{shape} {m}"] = ms
                print(f"{name:10s} {opts.kind} {shape:4s} m={m:4d}: {ms:.4f} ms (rel err "
                      f"{err:.2e})", flush=True)
    print(torch.cuda.get_device_name(0))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
