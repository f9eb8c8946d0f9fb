"""Compare the machine code (SASS) of the qmm kernel sources of two checkouts
of the port, on a machine with the CUDA toolkit.

    python3 scripts/torch_sass_diff.py OLD_ROOT [NEW_ROOT]
        [--sources qmm_prefill.cu qmm_grid.cu ...] [--opcodes REGEX]

OLD_ROOT and NEW_ROOT (default ".") are checkouts of this repository, for
example a `git archive` of the parent commit unpacked under build/. Each
source under ctransformers_tpu_torch/csrc/ (by default every qmm_*.cu) is
compiled by nvcc to a cubin with the package's architecture and
optimisation flags (one nvcc per source and checkout, all started
together), `cuobjdump -sass` splits it into its kernels, and each kernel's
instructions are compared with the addresses and encodings taken out.
Prints, per source, each kernel of the new build (demangled) as "same" (the
old build has a kernel of that name with the same instructions), "same as
<old kernels>" (no such name, but those old kernels have the same
instructions: a dropped template argument), "changed" or "new", then the
old kernels that no new kernel matches as "gone". With --opcodes, each
kernel of either build whose demangled name matches REGEX also gets a line
of its instruction count by opcode (the mnemonic before its first dot;
predicates dropped), most frequent first. Last line: a JSON object
{source: {"same": n, "renamed": n, "changed": [...], "new": [...],
"gone": [...]}}.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join("ctransformers_tpu_torch", "csrc")
OUT = os.path.join(ROOT, "build", "sass_diff")
# ops/qmm_kernels.py:NVCC_FLAGS without the shared-library and ptxas-log flags
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-cubin")
FUNC = re.compile(r"^\s*Function : (\S+)")
INSN = re.compile(r"^\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;?\s*/\* 0x[0-9a-f]+ \*/\s*$")
LABEL = re.compile(r"\.L_x_\d+")


def tool(name: str) -> str:
    for cand in (shutil.which(name), f"/usr/local/cuda/bin/{name}"):
        if cand and os.path.exists(cand):
            return cand
    raise SystemExit(f"{name} not found: this script needs the CUDA toolkit")


def kernels(cubin: str) -> dict:
    """{mangled name: tuple of instructions} of a cubin."""
    text = subprocess.run([tool("cuobjdump"), "-sass", cubin], check=True, capture_output=True,
                          text=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        f = FUNC.match(line)
        if f:
            name = f.group(1)
            out[name] = []
            continue
        i = INSN.match(line)
        if name is not None and i:
            out[name].append(i.group(1).replace(name, "SELF"))
    return {k: tuple(local_labels(v)) for k, v in out.items()}


def local_labels(insns: list) -> list:
    """Branch labels (.L_x_<n>, numbered across the cubin) renumbered in the
    order a kernel first names them, so that a kernel's code compares equal
    whatever comes before it in the file."""
    seen = {}
    return [LABEL.sub(lambda l: f".L{seen.setdefault(l.group(0), len(seen))}", i) for i in insns]


def opcode_counts(body) -> str:
    """"OP n, ..." of a kernel's instructions, most frequent first."""
    counts = {}
    for insn in body:
        words = insn.split()
        op = words[1] if words and words[0].startswith("@") and len(words) > 1 else words[0]
        op = op.split(".")[0]
        counts[op] = counts.get(op, 0) + 1
    return ", ".join(f"{op} {n}" for op, n in sorted(counts.items(), key=lambda kv: -kv[1]))


def demangle(names) -> dict:
    names = list(names)
    filt = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    if not os.path.exists(filt):
        filt = shutil.which("c++filt")
    if not filt or not names:
        return {n: n for n in names}
    res = subprocess.run([filt], input="\n".join(names), capture_output=True, text=True)
    lines = res.stdout.splitlines()
    return dict(zip(names, lines)) if len(lines) == len(names) else {n: n for n in names}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old")
    ap.add_argument("new", nargs="?", default=".")
    ap.add_argument("--sources", nargs="+")
    ap.add_argument("--opcodes", help="regex over demangled kernel names")
    opts = ap.parse_args()
    roots = {"old": os.path.abspath(opts.old), "new": os.path.abspath(opts.new)}
    sources = opts.sources or sorted(
        f for f in os.listdir(os.path.join(roots["new"], CSRC))
        if f.startswith("qmm_") and f.endswith(".cu"))
    shutil.rmtree(OUT, ignore_errors=True)
    procs = {}
    for side, root in roots.items():
        os.makedirs(os.path.join(OUT, side))
        for src in sources:
            cubin = os.path.join(OUT, side, src[:-3] + ".cubin")
            procs[side, src] = (cubin, subprocess.Popen(
                [tool("nvcc"), *FLAGS, "-o", cubin, os.path.join(root, CSRC, src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for (side, src), (_, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"nvcc failed on the {side} {src}:\n{log[-4000:]}")
    summary = {}
    for src in sources:
        old, new = (kernels(procs[side, src][0]) for side in ("old", "new"))
        # compared by demangled name: a kernel in an anonymous namespace is
        # mangled with a name unique to its build
        names = demangle(set(old) | set(new))
        old = {names[k]: v for k, v in old.items()}
        new = {names[k]: v for k, v in new.items()}
        by_body = {}
        for name, body in old.items():
            by_body.setdefault(body, []).append(name)
        row = {"same": 0, "renamed": 0, "changed": [], "new": [], "gone": []}
        matched = set()
        print(f"== {src}: {len(old)} kernels before, {len(new)} after")
        for name, body in sorted(new.items()):
            twins = by_body.get(body, [])
            matched.update(twins)
            if old.get(name) == body:
                row["same"] += 1
                what = "same"
            elif twins:
                row["renamed"] += 1
                what = "same as " + "; ".join(twins)
            elif name in old:
                row["changed"].append(name)
                what = f"changed ({len(old[name])} -> {len(body)} instructions)"
            else:
                row["new"].append(name)
                what = f"new ({len(body)} instructions)"
            print(f"  {name}: {what}")
        for name in sorted(set(old) - set(new) - matched):
            row["gone"].append(name)
            print(f"  {name}: gone")
        for side, table in (("old", old), ("new", new)):
            for name, body in sorted(table.items()):
                if opts.opcodes and re.search(opts.opcodes, name):
                    print(f"  [opcodes {side}] {name}: {len(body)}: {opcode_counts(body)}")
        summary[src] = row
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
