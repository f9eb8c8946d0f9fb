"""Time the port's qmm kernels from several checkouts on one card, in one
process sequence, so that two versions of a kernel are compared on the same
card under the same power limit.

    python3 scripts/torch_qmm_ab.py [--kinds Q4_K,Q6_K] ROOT [ROOT ...]

Each ROOT is a checkout of this repository (a `git archive` of a commit
unpacked into a directory, or "." for the working tree). For each, in the
order given (name a root twice to see the spread: parent change change
parent), a fresh Python process builds that checkout's kernels and runs
phase 3 of its chip_smoke.py (every kernel against its plain version at the
llama-2-7B shapes, timed from a replayed CUDA graph, and the race of every
key's candidates at m = 1, 8 and 128) on the weight kinds named by --kinds.
Prints one line per (root, kernel, kind, shape, m), one per raced key with
its winner ("race <key>": the winner's ms), and, last, a JSON object
{root label: {case: ms}}. A checkout from before the race phase reports
its kernels only. The table shipped under ctransformers_tpu_torch/data/ is
written by `python3 chip_smoke.py --write-table PATH`, not by this script.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CHILD = """
import json, sys
sys.path.insert(0, {root!r})
import torch
import chip_smoke as C
from ctransformers_tpu_torch.ops import qmm_kernels as K
kinds = {kinds!r}
C.KERNEL_CASES = [c for c in C.KERNEL_CASES if c[0].split("/")[0] in kinds]
smi = C.phase_card(K)
results = C.phase_kernels(K, C.phase_bandwidth())
raced = {{}}
if isinstance(results, tuple):  # (kernel rows, raced table entries)
    results, raced = results
out = {{f"{{name}} {{r['kind']}} {{r['shape']}} m={{r['m']}}": r["ms"]
       for name, rows in results.items() for r in rows}}
for key, v in raced.items():
    out["race " + ",".join(map(str, key)) + " -> " + (v["pick"][0] or "f")] = min(v["ms"].values())
print("AB_RESULT " + json.dumps({{"card": smi, "ms": out}}))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kinds", default="Q4_K")
    ap.add_argument("roots", nargs="+")
    args = ap.parse_args()
    kinds = tuple(args.kinds.split(","))
    table = {}
    for i, root in enumerate(args.roots):
        root = os.path.abspath(root)
        r = subprocess.run([sys.executable, "-c", CHILD.format(root=root, kinds=kinds)],
                           capture_output=True, text=True, cwd=root)
        if r.returncode != 0:
            print(r.stdout[-2000:], r.stderr[-4000:], file=sys.stderr)
            return r.returncode
        line = next(l for l in r.stdout.splitlines() if l.startswith("AB_RESULT "))
        res = json.loads(line[len("AB_RESULT "):])
        label = f"{i}:{os.path.relpath(root)}"
        table[label] = res["ms"]
        print(f"[{label}] card {res['card']}")
        for case, ms in res["ms"].items():
            print(f"[{label}] {case}: {ms:.4f} ms")
    print(json.dumps(table))
    return 0


if __name__ == "__main__":
    sys.exit(main())
