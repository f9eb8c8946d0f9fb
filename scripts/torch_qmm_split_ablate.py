"""Time the K-split decode GEMVs of csrc/qmm_splitk.cuh, ct_qmm_g8, ct_qmm_f,
ct_qmm_q8 and ct_qmm_rb8 on the factored int8 grids, ct_qmm_q8_legacy and
ct_qmm_rb8_legacy on the legacy ones, ct_qmm_qx and ct_qmm_g on Q4_K nibbles
and ct_qmm_f_ks, ct_qmm_s_ks, ct_qmm_b_ks and ct_qmm_rb_ks on the ksplit
nibbles of every kind, against variants of their design on one card, in one
process.

    python3 scripts/torch_qmm_split_ablate.py [--m 1 8] [--reps 50]
        [--cases REGEX] [--symbols REGEX] [--no-check] VARIANT [VARIANT ...]

Each VARIANT is the libraries of the timed symbols (qmm_float.cu,
qmm_decode.cu, qmm_grid.cu, qmm_ksplit.cu; a checkout without qmm_ksplit.cu
has the ksplit symbols in qmm_float.cu, one without the rb8 symbols in
qmm_grid.cu has them in qmm_rb.cu, one without ct_qmm_b_ks and ct_qmm_rb_ks
in qmm_ksplit.cu has them in qmm_prefill.cu and qmm_rb.cu) built by nvcc (the package's flags, all
started together) from a copy of csrc/ under build/split_ablate/ with edits
to qmm_splitk.cuh:

  base         the sources as they are
  stages3      a ring of 3 stages (the design: 2, one in flight while a
               stage computes)
  stages4      a ring of 4 stages
  mt4          4 rows of x a block at m > 1, three blocks an SM (the
               design: 8 rows, two)
  p4, p2, p1   clusters of at most 4, 2 or 1 blocks (the design: 8; p1 is
               no K split: one block a column tile takes all of K)
  no_compute   no products: the stage's copies, barriers, scales and
               reductions alone
  no_weights   no weight copies issued (the stage's x, scales and
               factors only): the compute, barriers and reductions alone
  imad_dot     qx: a shift pair and a multiply-add a nibble (the first
               design's form; the design: dp4a on transposed bytes)
  i2f          g on Q4_K nibbles at m = 1, and the ksplit kernels: an I2F
               a nibble (the first design's form; the design: the nibble in
               the mantissa of 2^23)
  byte_mad     q8 on the grids: a byte extract and a multiply-add a weight
               and row of x (the first design's form; the design: dp4a on
               transposed grid bytes)
  lo_mul       the ksplit kernels: l * s of the low nibble as the
               subtraction of 2^23, then the multiply (the design: one exact
               fma of 2^23 + l, kKsLoFma)
  m1occ        the ksplit kernels at m = 1: four blocks an SM asked of the
               compiler, two byte rows a step, a window of 1024 (the design:
               three, four, 2048)
  m8occ        the ksplit kernels at m > 1: three blocks an SM, two byte
               rows a step, the steps not unrolled (the design: two, four,
               unrolled)
  no_mma       g on nibbles at m > 1: f32 products as at m = 1 (the
               design: bf16 mma.sync on tensor cores)
  rb_f32       rb8 on the grids and b_ks / rb_ks on ksplit at m > 1: f32
               products of the bf16 operands as at m = 1 (the design: bf16
               mma.sync on tensor cores; on ksplit one k16 tile a half)
  root:PATH    the sources of another checkout (PATH/ctransformers_tpu_torch/
               csrc), e.g. a `git archive` of the parent unpacked under build/

For each (Q6_K v, down, output; Q5_K fused QKV, o, gate/up, down; Q8_0
fused QKV, o, gate/up, down, output; Q5_1 o; Q4_K o, fused QKV, gate/up,
down, output; packed ksplit ("ks:"): Q4_K at those five, GPTQ4 group 128
at fused QKV, o, gate/up and down, groups 32 and 64 at o, Q4_0, Q2_K and
Q3_K at o and down; at their padded llama-2-7B shapes; the rb8 symbols only
on the cases of PERF.md's rows 8b and 8d, chip_smoke.py's, and without
--m at m = 128 too, where they run the Hopper GEMM core, as the ksplit b_ks
and rb_ks do on their rows 9b and 10b) x m x symbol
(those of --symbols): the kernel ms from a replayed CUDA graph cycling over weight copies
past the 50 MB L2 (as chip_smoke.py phase 3 times it; q8 on activations
quantized outside, as its wrapper takes them), the bytes bound, the
error against the plain version (a variant that computes the function fails
the run above chip_smoke.py's tolerance, 1e-5 or for rb8 1e-3, unless
--no-check; no_weights and no_compute print
theirs, meaningless by design) and the split's P of the variant's plan. The
build log's ptxas lines of the split's kernels (registers, spills) are
printed per variant first. Last line: a JSON object
{variant: {"symbol kind shape m": ms}}.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as C  # noqa: E402
from ctransformers_tpu_torch.ops import qmatmul as qm  # noqa: E402
from ctransformers_tpu_torch.ops import qmm_kernels as K  # noqa: E402

OUT = os.path.join(HERE, "build", "split_ablate")
# the keys of PERF.md's rows 5b, 7c and 2b, of row 2e, of rows 1a and 7a,
# and of rows 9a and 11a (chip_smoke.py phase 3's timed cases)
CASES = [("Q6_K", "v"), ("Q6_K", "down"), ("Q6_K", "lm_head"), ("Q5_K", "qkv"), ("Q5_K", "o"),
         ("Q5_K", "gate_up"), ("Q5_K", "down"), ("Q8_0", "qkv"), ("Q8_0", "o"),
         ("Q8_0", "gate_up"), ("Q8_0", "down"), ("Q8_0", "lm_head"), ("Q5_1", "o"),
         ("Q4_K", "o"), ("Q4_K", "qkv"), ("Q4_K", "gate_up"), ("Q4_K", "down"),
         ("Q4_K", "lm_head")] + [
    ("ks:Q4_K", s) for s in ("o", "qkv", "gate_up", "down", "lm_head")] + [
    ("ks:GPTQ4/128", s) for s in ("qkv", "o", "gate_up", "down")] + [
    ("ks:GPTQ4/32", "o"), ("ks:GPTQ4/64", "o")] + [
    (f"ks:{kind}", s) for kind in ("Q4_0", "Q2_K", "Q3_K") for s in ("o", "down")]
# the split's symbols of a weight kind, and the library each is built into
SYMBOLS = {"Q6_K": ("qmm_g8", "qmm_f", "qmm_q8", "qmm_rb8"),
           "Q5_K": ("qmm_g8", "qmm_f", "qmm_q8", "qmm_rb8"),
           "Q8_0": ("qmm_q8_legacy", "qmm_rb8_legacy"),
           "Q5_1": ("qmm_q8_legacy", "qmm_rb8_legacy"),
           "Q4_K": ("qmm_qx", "qmm_g"), "ks": ("qmm_f_ks", "qmm_s_ks", "qmm_b_ks", "qmm_rb_ks")}
LIB_OF = {"qmm_g8": "qmm_float", "qmm_f": "qmm_float", "qmm_g": "qmm_float",
          "qmm_qx": "qmm_decode", "qmm_q8": "qmm_grid", "qmm_q8_legacy": "qmm_grid",
          "qmm_f_ks": "qmm_ksplit", "qmm_s_ks": "qmm_ksplit", "qmm_rb8": "qmm_grid",
          "qmm_rb8_legacy": "qmm_grid", "qmm_b_ks": "qmm_ksplit", "qmm_rb_ks": "qmm_ksplit"}
RB8 = ("qmm_rb8", "qmm_rb8_legacy")
# the symbols that take the Hopper GEMM core above m = 32 (timed at 128 too)
CORE_TOO = RB8 + ("qmm_b_ks", "qmm_rb_ks")
# the split's mode of each ksplit symbol (ct_qmm_ks_split_plan)
KS_MODE = {"qmm_f_ks": 0, "qmm_s_ks": 1, "qmm_b_ks": 2, "qmm_rb_ks": 2}
# the cases (and batch sizes) chip_smoke.py times those symbols at: rows
# 8b, 8d, 9b and 10b
CORE_RUNS = {(kind, shape, name): sorted(m for nm, m in runs if nm == name)
             for kind, shape, runs in C.KERNEL_CASES for name in CORE_TOO
             if any(nm == name for nm, _ in runs)}
# the ksplit layouts (group, has mins, superblock factor count) whose
# cluster capacities are printed
KS_LAYOUTS = ((32, 1, 8), (16, 1, 16), (16, 0, 16), (32, 1, 0), (64, 1, 0), (128, 1, 0), (32, 0, 0))
# variant -> edits to qmm_splitk.cuh
VARIANTS = {
    "base": (),
    "stages3": (("constexpr int kStages = 2;", "constexpr int kStages = 3;"),),
    "stages4": (("constexpr int kStages = 2;", "constexpr int kStages = 4;"),),
    "mt4": (("constexpr int kMT = 8;", "constexpr int kMT = 4;"),),
    "p4": (("constexpr int kMaxP = 8;", "constexpr int kMaxP = 4;"),),
    "p2": (("constexpr int kMaxP = 8;", "constexpr int kMaxP = 2;"),),
    "p1": (("constexpr int kMaxP = 8;", "constexpr int kMaxP = 1;"),),
    "no_compute": (("    for (int rr = 0; rr < kLR; rr += 4) {",
                    "    for (int rr = 0; rr < 0; rr += 4) {"),
                   ("    for (int rr = 0; rr < kLR; rr += kQ) {",
                    "    for (int rr = 0; rr < 0; rr += kQ) {"),
                   ("for (int q = 0; q < 4; ++q) {\n        uint32_t wv[4];",
                    "for (int q = 0; q < 0; ++q) {\n        uint32_t wv[4];"),
                   ("      for (int j = 0; j < ctq::kGroup / 2; j += 2) {",
                    "      for (int j = 0; j < 0; j += 2) {"),
                   ("for (int h = 0; h < 2; ++h) {\n        // words h",
                    "for (int h = 0; h < 0; ++h) {\n        // words h"),
                   ("      for (int k = 0; k < 2; ++k) {", "      for (int k = 0; k < 0; ++k) {"),
                   ("for (int h = 0; h < 2; ++h) {\n        const bool hi = h == 1;",
                    "for (int h = 0; h < 0; ++h) {\n        const bool hi = h == 1;")),
    "no_weights": (("    for (int u = 0; u < 4; ++u) cp16(b + St::kW + 16 * (tid + u * kThreads), "
                    "wp + u * wstep);", "    (void)wp;"),
                   ("    for (int u = 0; u < 4; ++u) cp16(b + St::kW + 16 * (tid + u * kThreads) + "
                    "wswz, wp + u * wstep);", "    (void)wp;")),
    "imad_dot": (("constexpr bool kNibbleDp4a = true;", "constexpr bool kNibbleDp4a = false;"),),
    "i2f": (("constexpr bool kNibbleMagic = true;", "constexpr bool kNibbleMagic = false;"),),
    "no_mma": (("constexpr bool kNibbleMma = true;", "constexpr bool kNibbleMma = false;"),),
    "rb_f32": (("constexpr bool kGridMma = true;", "constexpr bool kGridMma = false;"),),
    "byte_mad": (("constexpr bool kGridDp4a = true;", "constexpr bool kGridDp4a = false;"),),
    "lo_mul": (("constexpr bool kKsLoFma = true;", "constexpr bool kKsLoFma = false;"),),
    "m1occ": (("constexpr int kKsMinBlocks = MT == 1 ? 3 : 2;",
               "constexpr int kKsMinBlocks = MT == 1 ? 4 : 2;"),
              ("constexpr int kKsStep = MT == 1 ? 4 : 4;", "constexpr int kKsStep = MT == 1 ? 2 : 4;"),
              ("constexpr int kKsUnroll = MT == 1 ? 4 : 4;",
               "constexpr int kKsUnroll = MT == 1 ? 8 : 4;"),
              ("constexpr int kKsWinRows = MT == 1 ? 2048 : 512;",
               "constexpr int kKsWinRows = MT == 1 ? 1024 : 512;")),
    "m8occ": (("constexpr int kKsMinBlocks = MT == 1 ? 3 : 2;",
               "constexpr int kKsMinBlocks = MT == 1 ? 3 : 3;"),
              ("constexpr int kKsStep = MT == 1 ? 4 : 4;", "constexpr int kKsStep = MT == 1 ? 4 : 2;"),
              ("constexpr int kKsUnroll = MT == 1 ? 4 : 4;",
               "constexpr int kKsUnroll = MT == 1 ? 4 : 1;")),
}
CHECKED = tuple(v for v in VARIANTS if not v.startswith("no_"))


def build(names, libraries):
    """nvcc on `libraries` (of qmm_float.cu, qmm_decode.cu, qmm_grid.cu) of
    a copy of csrc/ per variant, all started together; returns {name:
    ({library name: library}, ptxas lines of the split's kernels)}."""
    procs = {}
    for name in names:
        d = os.path.join(OUT, re.sub(r"[^A-Za-z0-9_]", "_", name))
        shutil.rmtree(d, ignore_errors=True)
        if name.startswith("root:"):
            shutil.copytree(os.path.join(name[5:], "ctransformers_tpu_torch", "csrc"), d)
        else:
            shutil.copytree(K.CSRC, d)
            edits = VARIANTS[name]
            path = os.path.join(d, "qmm_splitk.cuh")
            src = open(path).read()
            for old, new in edits:
                if old not in src:
                    raise SystemExit(f"{name}: the edit's anchor is not in qmm_splitk.cuh: "
                                     f"{old[:60]!r}")
                src = src.replace(old, new)
            open(path, "w").write(src)
        for lib in libraries:
            if not os.path.exists(os.path.join(d, f"{lib}.cu")):
                continue  # an older checkout: its symbols are in another library
            so = os.path.join(d, f"lib{lib}.so")
            # -fno-gnu-unique: each variant's function-local statics (the
            # split's cluster capacities) stay its own, not the first
            # loaded variant's
            procs[(name, lib)] = (so, subprocess.Popen(
                [K._nvcc(), *K.NVCC_FLAGS, "-Xcompiler", "-fno-gnu-unique", "-o", so,
                 os.path.join(d, f"{lib}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {name: ({}, []) for name in names}
    for (name, lib), (so, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"nvcc failed on {name} {lib}:\n{out[-4000:]}")
        dll = ctypes.CDLL(so)
        K._bind(dll)
        libs[name][0][lib] = dll
        lines = out.splitlines()
        libs[name][1].extend(
            " ".join([lines[i].split("entry function")[-1].split(" for ")[0].strip()] + [
                ln.split(":", 1)[-1].strip() for ln in lines[i + 1:i + 4]
                if "spill" in ln or "Used" in ln])
            for i in range(len(lines)) if "Compiling entry" in lines[i]
            and any(k in lines[i] for k in ("splitk_kernel", "nibble_kernel", "ctsk9q8_kernel",
                                            "ksplit_kernel")))
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="+")
    ap.add_argument("--m", type=int, nargs="+",
                    help="batch sizes (default 1 and 8, and 128 for rb8)")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--cases", default="", help="regex over 'kind shape'")
    ap.add_argument("--symbols", default="", help="regex over the symbols (qmm_g8, qmm_q8, ...)")
    ap.add_argument("--no-check", action="store_true")
    opts = ap.parse_args()
    for v in opts.variants:
        if v not in VARIANTS and not v.startswith("root:"):
            raise SystemExit(f"no such variant: {v}")
    if not torch.cuda.is_available():
        print("torch_qmm_split_ablate: CUDA is not available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    names = list(dict.fromkeys(opts.variants))
    cases = [(kind, shape, syms) for kind, shape in CASES
             if re.search(opts.cases, f"{kind} {shape}")
             for syms in [[sym for sym in SYMBOLS[kind.split(":")[0]]
                           if re.search(opts.symbols, sym)
                           and (sym not in RB8 or (kind, shape, sym) in CORE_RUNS)]] if syms]
    libraries = {LIB_OF[sym] for _, _, syms in cases for sym in syms}
    if "qmm_ksplit" in libraries:  # where an older checkout keeps the ksplit symbols
        libraries.add("qmm_float")
    if any(sym in RB8 + ("qmm_rb_ks",) for _, _, syms in cases for sym in syms):
        libraries.add("qmm_rb")  # and the rb8 and rb_ks ones
    if any(sym == "qmm_b_ks" for _, _, syms in cases for sym in syms):
        libraries.add("qmm_prefill")  # and the b_ks one
    libs = build(names, sorted(libraries))
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, (dlls, ptxas) in libs.items():
        for line in ptxas:
            print(f"[ptxas] {name}: {line}", flush=True)
        # clusters of p blocks the card holds at once, per instantiation
        cap = getattr(dlls.get("qmm_float"), "ct_qmm_grid_split_capacity", None)
        if cap:
            for g8, group, m in itertools.product((1, 0), (16, 32), (1, 8)):
                print(f"[occupancy] {name}: {'g8' if g8 else 'f'} group {group} m={m}: " + " ".join(
                    f"P={p}:{cap(g8, group, m, p)}" for p in (8, 6, 4, 3, 2, 1)), flush=True)
        cap = getattr(dlls.get("qmm_grid"), "ct_qmm_q8_split_capacity", None)
        if cap:
            for plain, mins, group, m in itertools.product((0, 1), (0, 1), (16, 32), (1, 8)):
                if cap(plain, mins, group, m, 1) > 0:  # a layout q8 takes
                    print(f"[occupancy] {name}: q8 {'legacy' if plain else 'grid'} group {group} "
                          f"mins {mins} m={m}: " + " ".join(
                              f"P={p}:{cap(plain, mins, group, m, p)}" for p in (8, 6, 4, 3, 2, 1)),
                          flush=True)
        cap = getattr(dlls.get("qmm_grid"), "ct_qmm_rb8_split_capacity", None)
        for (plain, mins, group), m in itertools.product(((0, 0, 16), (0, 1, 32), (1, 0, 32),
                                                          (1, 1, 32)), (1, 8)):
            if cap:
                print(f"[occupancy] {name}: rb8 {'legacy' if plain else 'grid'} group {group} "
                      f"mins {mins} m={m}: " + " ".join(
                          f"P={p}:{cap(plain, mins, group, m, p)}" for p in (8, 6, 4, 3, 2, 1)),
                      flush=True)
        for sym in ("qmm_qx", "qmm_g"):
            cap = getattr(dlls.get(LIB_OF[sym]), f"ct_{sym}_split_capacity", None)
            for m in (1, 8) if cap else ():
                print(f"[occupancy] {name}: {sym} m={m}: " + " ".join(
                    f"P={p}:{cap(m, p)}" for p in (8, 6, 4, 3, 2, 1)), flush=True)
        cap = getattr(dlls.get("qmm_ksplit"), "ct_qmm_ks_split_capacity", None)
        for mode, (group, mins, sf), m in itertools.product((0, 1, 2), KS_LAYOUTS, (1, 8)):
            if cap and any(s.endswith("_ks") for _, _, syms in cases for s in syms):
                print(f"[occupancy] {name}: {'fsb'[mode]}_ks group {group} mins {mins} "
                      f"sfactor {sf} m={m}: " + " ".join(
                          f"P={p}:{cap(mode, group, mins, sf, m, p)}" for p in (8, 6, 4, 3, 2, 1)),
                      flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {name: {} for name in opts.variants}
    for kind, shape, syms in cases:
        k, n = C.SHAPES[shape]
        kp, npad = qm.padded_shape(k, n)
        qts = [C.random_planes(K, kind, kp, npad, k, n, gen)]
        wbytes = C.plane_bytes(qts[0])
        qts += [C.random_planes(K, kind, kp, npad, k, n, gen)
                for _ in range(max(0, math.ceil(150e6 / wbytes) - 1))]
        sizes = opts.m or sorted({1, 8}.union(*(CORE_RUNS.get((kind, shape, sym), [])
                                                for sym in syms if sym in CORE_TOO)))
        for m in sizes:
            x = torch.zeros((m, kp), device=dev)
            x[:, :k] = torch.randn((m, k), generator=gen, device=dev)
            out = torch.empty(m, npad, device=dev)
            for sym in syms:
                if m > 8 and not opts.m and sym not in CORE_TOO:
                    continue
                acts = K.quantize_activations(x, qts[0].group) if sym in K.PREQUANTIZED else (x,)
                nbytes = wbytes + sum(a.numel() * a.element_size() for a in acts) + 4 * m * npad
                bound = nbytes / C.PEAK_BYTES_S * 1e3
                ref = K.PLAIN[sym](*acts, qts[0])
                ints = K._SPECS[sym][3](qts[0])  # the symbol's own ints (the grids: group)
                for j, name in enumerate(opts.variants):
                    dlls = libs[name][0]
                    lib = next(d for d in [dlls.get(LIB_OF[sym])] + list(dlls.values())
                               if d is not None and hasattr(d, "ct_" + sym))
                    fn = getattr(lib, "ct_" + sym)

                    def call(i, fn=fn):
                        qt = qts[i % len(qts)]
                        rc = fn(*K._ptrs(*acts, *K._planes(qt), out), m, kp, npad, *ints,
                                K._stream(dev))
                        if rc:
                            raise SystemExit(f"{name} {sym}: launch failed with CUDA error {rc}")

                    ms = C.cuda_time_ms(call, opts.reps, graph=True)
                    call(0)
                    torch.cuda.synchronize()
                    err = ((out - ref).norm() / ref.norm()).item()
                    if kind.startswith("ks:"):
                        plan = getattr(lib, "ct_qmm_ks_split_plan", None)
                        plan = plan if m <= 32 else None  # b_ks and rb_ks above: the core
                        qt = qts[0]
                        p = plan(KS_MODE[sym], qt.group, int(qt.mins is not None),
                                 qt.sfactor, m, kp, npad) if plan else "-"
                    elif kind == "Q4_K":
                        plan = getattr(lib, f"ct_{sym}_split_plan", None)
                        p = plan(m, kp, npad) if plan else "-"
                    elif sym in ("qmm_q8", "qmm_q8_legacy") + RB8:
                        plan = getattr(lib, f"ct_{sym.removesuffix('_legacy')}_split_plan", None)
                        plan = plan if m <= 32 else None  # rb8 above: the GEMM core
                        qt = qts[0]
                        p = plan(int(qt.sfactor == 0), int(qt.mins is not None), qt.group, m, kp,
                                 npad) if plan else "-"
                    else:
                        plan = getattr(lib, "ct_qmm_grid_split_plan", None)
                        p = plan(int(sym == "qmm_g8"), qts[0].group, m, kp, npad) if plan else "-"
                    label = f"{j}:{name}" if opts.variants.count(name) > 1 else name
                    result[name][f"{sym} {kind} {shape} m={m}"] = ms
                    print(f"{label:24s} {sym:13s} {kind} {shape:7s} m={m:2d} P={p}: {ms:.4f} ms "
                          f"(bound {bound:.4f}, x{ms / bound:.2f}; rel err {err:.2e})",
                          flush=True)
                    if not opts.no_check and (name in CHECKED or name.startswith("root:")) \
                            and not err <= C.TOL[sym]:
                        raise SystemExit(f"{name} {sym} {kind} {shape} m={m}: rel err {err:.2e}")
        del qts
        torch.cuda.empty_cache()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
