"""Time variants of the decode attention kernel (csrc/attn_decode.cu) on one
card in one process, so that revisions and launch constants are compared on
the same card under the same power limit.

    python3 scripts/torch_attn_variants.py [--cases REGEX] [--no-check] [--occupancy]
        VARIANT [VARIANT ...]

A VARIANT is one of
  base              the source as it is;
  THREADS:ROWS4:ROWS2
                    the source with THREADS threads a block and a lane keeping
                    ROWS4 rows in flight for a 4-byte cache element (f32),
                    ROWS2 for the others (bf16, f16, int8);
  rev:REVISION      the source as it stood at a git revision (`git show`; the
                    C signature of ct_decode_attn is the same at every
                    revision since the kernel was ported). Where git has no
                    repository (a copy of the tree without .git), the source
                    saved by an earlier run in build/attn_variants/ is used:
                    run the script once inside the repository first (it saves
                    every revision's source, then stops where there is no card);
  file:PATH         the source at PATH (a repaired parent kept outside git).
Every variant is built by nvcc (the package's flags, all started together)
into build/attn_variants/, then each in the order given (name one twice to
see the spread) runs chip_smoke.py's decode attention cases (those whose
label matches --cases): the kernel against its plain version and its time
from a replayed CUDA graph. A revision that refuses a case (widths above
256 before they were taken) raises there: select its cases with --cases.
Prints ptxas' registers and spills per kernel instantiation of width 128,
one line per (variant, case) and, last, a JSON object {variant: {case: ms}}.
--no-check times variants that are wrong on purpose (ablations: a pass
left out) without failing on their results. --occupancy prints, for each
variant, how many clusters of P = 1, 2, 4 and 8 blocks the card holds at
once (cudaOccupancyMaxActiveClusters) for the one-head width-128 kernel
of an f32, a bf16 and an int8 cache at a window of 2048.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SOURCE = "ctransformers_tpu_torch/csrc/attn_decode.cu"
THREADS = "constexpr int kThreads = 256;"
ROWS = "constexpr int kRowsInFlight = sizeof(T) == 4 ? 4 : 8;"
# the first template argument of a kernel instantiation (Itanium mangling)
DTYPE_OF = {"f": "f32", "13__nv_bfloat16": "bf16", "6__half": "f16", "a": "int8"}


def variant_source(src: str, name: str, saved: str) -> str:
    """The source of variant `name`; `saved` is where a rev: variant's
    source is kept for a tree without git."""
    if name == "base":
        return src
    if name.startswith("file:"):
        with open(os.path.join(ROOT, name[5:])) as f:
            return f.read()
    if name.startswith("rev:"):
        p = subprocess.run(["git", "-C", ROOT, "show", f"{name[4:]}:{SOURCE}"],
                           capture_output=True, text=True)
        if p.returncode == 0:
            return p.stdout
        if os.path.exists(saved):
            with open(saved) as f:
                return f.read()
        raise SystemExit(f"{name}: no git here and no saved source at {saved}: "
                         "run the script once inside the repository")
    threads, rows4, rows2 = (int(x) for x in name.split(":"))
    if THREADS not in src or ROWS not in src:
        raise SystemExit("the kernel's constants moved: update this script")
    src = src.replace(THREADS, f"constexpr int kThreads = {threads};")
    return src.replace(ROWS, f"constexpr int kRowsInFlight = sizeof(T) == 4 ? {rows4} : {rows2};")


# a second library for --occupancy: the variant's source and a function that
# asks the runtime how many clusters of `parts` blocks fit the card at once
OCCUPANCY = """#include "%s"
template <typename T>
int occupancy(int parts, int smem, int* clusters) {
  auto kern = decode_attn_kernel<T, 128, 1, false>;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = parts;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(parts * 32, 1, 1);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(clusters, (void*)kern, &cfg);
}
extern "C" int ct_occupancy(int dtype, int parts, int smem, int* clusters) {
  if (dtype == 0) return occupancy<float>(parts, smem, clusters);
  if (dtype == 1) return occupancy<__nv_bfloat16>(parts, smem, clusters);
  return occupancy<int8_t>(parts, smem, clusters);
}
"""


def print_occupancy(A, name: str, lib) -> None:
    for code, dtype in ((0, "f32"), (1, "bf16"), (3, "int8")):
        row = []
        for parts in (1, 2, 4, 8):
            smem = A.kernel_smem_bytes(1, 128, 2048, 512, code == 3, False, parts)
            n = ctypes.c_int()
            rc = lib.ct_occupancy(code, parts, smem, ctypes.byref(n))
            row.append(f"P={parts}: {n.value}" if rc == 0 else f"P={parts}: error {rc}")
        print(f"[occupancy] {name} {dtype}: clusters the card holds at once, " + ", ".join(row),
              flush=True)


def ptxas_rows(log: str) -> list:
    """(dtype, instantiation, registers, spill store bytes) of each kernel
    instantiation of width 128 in an `nvcc -Xptxas -v` log."""
    rows = []
    blocks = re.split(r"ptxas info\s*: Compiling entry function ", log)[1:]
    for blk in blocks:
        name = re.match(r"'(\w+)'", blk)
        regs = re.search(r"Used (\d+) registers", blk)
        spill = re.search(r"(\d+) bytes spill stores", blk)
        if not name or not regs or "Li128E" not in name.group(1):
            continue
        first = re.search(r"decode_attn_kernelI(f|13__nv_bfloat16|6__half|a)", name.group(1))
        dtype = DTYPE_OF[first.group(1)] if first else "?"
        rows.append((dtype, name.group(1), int(regs.group(1)), int(spill.group(1)) if spill else 0))
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cases", default="", help="a regex the case labels must match")
    ap.add_argument("--no-check", action="store_true",
                    help="time without holding the results against the plain version")
    ap.add_argument("--occupancy", action="store_true",
                    help="print the clusters of each size that the card holds at once")
    ap.add_argument("variants", nargs="+")
    args = ap.parse_args()
    import torch

    import chip_smoke as C
    from ctransformers_tpu_torch.ops import attention as A
    from ctransformers_tpu_torch.ops import qmm_kernels as K

    out_dir = os.path.join(ROOT, "build", "attn_variants")
    os.makedirs(out_dir, exist_ok=True)
    src = open(os.path.join(K.CSRC, "attn_decode.cu")).read()
    sources = {}
    for name in dict.fromkeys(args.variants):
        stem = re.sub(r"[^\w-]", "_", name)
        cu = os.path.join(out_dir, f"{stem}.cu")
        sources[name] = (stem, cu, variant_source(src, name, cu))
        with open(cu, "w") as f:
            f.write(sources[name][2])
    if not torch.cuda.is_available():
        print(f"torch_attn_variants: CUDA is not available (sources saved in {out_dir})",
              file=sys.stderr)
        return 2
    procs, occ = {}, {}
    for name, (stem, cu, _) in sources.items():
        so = os.path.join(out_dir, f"lib{stem}.so")
        procs[name] = (so, subprocess.Popen([K._nvcc(), *K.NVCC_FLAGS, "-o", so, cu],
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                            text=True))
        if args.occupancy:
            occ_cu = os.path.join(out_dir, f"occupancy_{stem}.cu")
            with open(occ_cu, "w") as f:
                f.write(OCCUPANCY % cu)
            occ[name] = (os.path.join(out_dir, f"liboccupancy_{stem}.so"), subprocess.Popen(
                [K._nvcc(), *K.NVCC_FLAGS, "-o", os.path.join(out_dir, f"liboccupancy_{stem}.so"),
                 occ_cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{log}")
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
        spills = sum(int(x) for x in re.findall(r"(\d+) bytes spill stores", log))
        print(f"[build] {name}: registers {min(regs)}-{max(regs)}, spill stores {spills} bytes",
              flush=True)
        for dtype, inst, r, s in ptxas_rows(log):
            print(f"[build] {name}: {dtype} {inst}: {r} registers, {s} bytes spill stores",
                  flush=True)
        lib = ctypes.CDLL(so)
        K._bind(lib)
        libs[name] = lib
    for name, (so, p) in occ.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"nvcc failed on the occupancy library of {name}:\n{log}")
        print_occupancy(A, name, ctypes.CDLL(so))
    smi = C.phase_card(K)
    cases = [c for c in C.ATTN_CASES if re.search(args.cases, C.attn_label(*c))]
    table = {}
    for name in args.variants:
        lib = libs[name]
        K._fn = lambda _lib, sym, lib=lib: getattr(lib, sym)  # noqa: E731
        rows = C.phase_attention(A, cases, check=not args.no_check)
        label = name if name not in table else f"{name} #{sum(k.startswith(name) for k in table) + 1}"
        table[label] = {r["case"]: r["ms"] for r in rows}
        for r in rows:
            print(f"[variant {label}] {r['case']}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f}, "
                  f"rel err {r['rel_err']:.2e})", flush=True)
    print(smi)
    print(json.dumps(table))
    return 0


if __name__ == "__main__":
    sys.exit(main())
