"""The probes of scripts/probe_bf16_dot.py on the card: the bf16 dot of an
(8, 1024) activation block and a (1024, 1024) weight tile in six variants
(A whole; B two K halves added; C the floor-chain rhs l + f; D two K steps
of a stacked weight; E two dots summed, the second on 2 w; F M = 16),
through ctransformers_tpu_torch.ops.probes (csrc/probe_dot.cu, tensor
cores), each held against its plain version and timed beside torch.matmul
in bf16 on the same rounded operands.

    python3 scripts/torch_probe_bf16_dot.py [--device cpu] [--small]

The weights cycle over enough copies (3 x the 50 MB L2) that every call
reads them from device memory.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from ctransformers_tpu_torch.ops import probes as P

M, TK, TN = 8, 1024, 1024


def run(r: P.Runner, small: bool = False) -> None:
    rng = np.random.default_rng(0)
    tk, tn = (TK // 4, TN // 4) if small else (TK, TN)
    xf = torch.from_numpy(rng.standard_normal((M, 2 * tk)).astype(np.float32)).to(r.dev)
    wf = torch.from_numpy(rng.standard_normal((tk, tn)).astype(np.float32)).to(r.dev)
    x16 = torch.from_numpy(rng.standard_normal((16, tk)).astype(np.float32)).to(r.dev)
    ws = r.copies(lambda: wf.clone(), wf.numel() * 4)
    wds = [torch.cat([w, w]) for w in ws]  # D: the weight stacked twice
    bf = lambda a: a.to(torch.bfloat16)  # noqa: E731
    f = torch.floor(wf * (1.0 / 16.0))
    rhs_c = bf((wf - f * 16.0) + f)
    lib = {"A": (bf(xf[:, :tk]), [bf(w) for w in ws]), "B": (bf(xf[:, :tk]), [bf(w) for w in ws]),
           "C": (bf(xf[:, :tk]), [rhs_c.clone() for _ in ws]),
           "D": (bf(xf), [bf(w) for w in wds]),
           "E": (bf(xf), [torch.cat([bf(w), bf(2.0 * w)]) for w in ws]),
           "F": (bf(x16), [bf(w) for w in ws])}
    n = len(ws)
    cases = [
        ("A whole-ref bf16 dot (8,1024)x(1024,1024)", "A", xf, ws, dict(k_step=tk)),
        ("B sliced lhs/rhs + accumulate", "B", xf, ws,
         dict(steps=2, k_step=tk // 2, x_step=tk // 2, w_step=tk // 2)),
        ("C computed rhs cast bf16", "C", xf, ws, dict(k_step=tk, floor=True)),
        ("D grid + cross-step accumulate", "D", xf, wds, dict(steps=2, k_step=tk, x_step=tk, w_step=tk)),
        ("E two bf16 dots summed", "E", xf, ws, dict(steps=2, k_step=tk, x_step=tk, twice=True)),
        ("F M=16 bf16 dot", "F", x16, ws, dict(k_step=tk)),
    ]
    for label, key, x, w, kw in cases:
        rows = x.shape[0]
        steps = kw.get("steps", 1)
        kx = kw["k_step"] * steps
        xl, wl = lib[key]
        r.probe(label, "probe_dot",
                lambda i, x=x, w=w, kw=kw: P.probe_dot(x, w[i % n], "bf16", **kw),
                lambda x=x, w=w, kw=kw: P.plain_probe_dot(x, w[0], "bf16", **kw), 1e-5,
                nbytes=4 * (rows * kx + w[0].shape[0] * tn + rows * tn), ops=2 * rows * kx * tn,
                peak=P.PEAK_BF16_S,
                library=lambda i, xl=xl, wl=wl: torch.matmul(xl, wl[i % n]))


if __name__ == "__main__":
    sys.exit(P.script_main(run))
