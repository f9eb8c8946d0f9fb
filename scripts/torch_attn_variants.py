"""Time variants of the decode attention kernel (csrc/attn_decode.cu) on one
card in one process, so that its launch constants are chosen on the same
card under the same power limit.

    python3 scripts/torch_attn_variants.py VARIANT [VARIANT ...]

A VARIANT is "base" (the source as it is) or THREADS:ROWS4:ROWS2, the
source with THREADS threads a block and a lane keeping ROWS4 rows in flight
for a 4-byte cache element (f32), ROWS2 for the others (bf16, f16, int8).
Every variant is built by nvcc (the package's flags, all started together)
into build/attn_variants/, then each in the order given (name one twice to
see the spread) runs chip_smoke.py's decode attention cases: the kernel
against its plain version and its time from a replayed CUDA graph. Prints
ptxas' registers and spills per variant, one line per (variant, case) and,
last, a JSON object {variant: {case: ms}}.
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

THREADS = "constexpr int kThreads = 512;"
ROWS = "constexpr int kRowsInFlight = sizeof(T) == 4 ? 8 : 16;"


def variant_source(src: str, name: str) -> str:
    if name == "base":
        return src
    threads, rows4, rows2 = (int(x) for x in name.split(":"))
    if THREADS not in src or ROWS not in src:
        raise SystemExit("the kernel's constants moved: update this script")
    src = src.replace(THREADS, f"constexpr int kThreads = {threads};")
    return src.replace(ROWS, f"constexpr int kRowsInFlight = sizeof(T) == 4 ? {rows4} : {rows2};")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="+")
    args = ap.parse_args()
    import torch

    import chip_smoke as C
    from ctransformers_tpu_torch.ops import attention as A
    from ctransformers_tpu_torch.ops import qmm_kernels as K

    if not torch.cuda.is_available():
        print("torch_attn_variants: CUDA is not available", file=sys.stderr)
        return 2
    out_dir = os.path.join(ROOT, "build", "attn_variants")
    os.makedirs(out_dir, exist_ok=True)
    src = open(os.path.join(K.CSRC, "attn_decode.cu")).read()
    procs = {}
    for name in dict.fromkeys(args.variants):
        stem = name.replace(":", "_")
        cu, so = os.path.join(out_dir, f"{stem}.cu"), os.path.join(out_dir, f"lib{stem}.so")
        with open(cu, "w") as f:
            f.write(variant_source(src, name))
        procs[name] = (so, subprocess.Popen([K._nvcc(), *K.NVCC_FLAGS, "-o", so, cu],
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                            text=True))
    libs = {}
    for name, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{log}")
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
        spills = sum(int(x) for x in re.findall(r"(\d+) bytes spill stores", log))
        print(f"[build] {name}: registers {min(regs)}-{max(regs)}, spill stores {spills} bytes",
              flush=True)
        lib = ctypes.CDLL(so)
        K._bind(lib)
        libs[name] = lib
    smi = C.phase_card(K)
    table = {}
    for name in args.variants:
        lib = libs[name]
        K._fn = lambda _lib, sym, lib=lib: getattr(lib, sym)  # noqa: E731
        rows = C.phase_attention(A)
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
