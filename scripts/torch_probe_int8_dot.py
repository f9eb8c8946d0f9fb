"""The probes of scripts/probe_int8_dot.py on the card: each operand pair
of a small quantized-matmul tile (M 8, K 512, N 256, groups of 32) through
ctransformers_tpu_torch.ops.probes (csrc/probe_dot.cu), held against its
plain version and timed.

    python3 scripts/torch_probe_int8_dot.py [--device cpu] [--small]

On the TPU each probe asked whether the pair lowers; on the card every pair
has a unit, so each line gives the kernel's error against its plain version
and its time (a replayed CUDA graph), beside the bound, the plain version's
time and, where one torch call computes the same function, that call's.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from ctransformers_tpu_torch.ops import probes as P

# the script's shapes: M tokens, K rows, N columns, G rows a group
M, K, N, G = 8, 512, 256, 32


def run(r: P.Runner, small: bool = False) -> None:
    rng = np.random.default_rng(0)
    ng = K // G

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(r.dev)

    xi8 = t(rng.integers(-8, 8, (M, K), np.int8))
    wi8 = t(rng.integers(-8, 8, (K, N), np.int8))
    s = t(rng.random((ng, N), np.float32))
    xf = xi8.float()
    dot_bytes = M * K + K * N + 4 * M * N
    ops = 2 * M * K * N
    r.probe("int8 x int8 -> int32 dot", "probe_dot", lambda i: P.probe_dot(xi8, wi8, "s8"),
            lambda: P.plain_probe_dot(xi8, wi8, "s8"), 0, nbytes=dot_bytes, ops=ops,
            peak=P.PEAK_INT8_S)
    r.probe("int8 x int8 -> f32 dot", "probe_dot",
            lambda i: P.probe_dot(xi8, wi8, "s8", out_dtype=torch.float32),
            lambda: P.plain_probe_dot(xi8, wi8, "s8", out_dtype=torch.float32), 0,
            nbytes=dot_bytes, ops=ops, peak=P.PEAK_INT8_S)
    r.probe("f32 x int8 mixed dot", "probe_dot", lambda i: P.probe_dot(xf, wi8, "f32"),
            lambda: P.plain_probe_dot(xf, wi8, "f32"), 1e-6, nbytes=dot_bytes + 3 * M * K, ops=ops)
    # batched per-group dot: x (ng, M, G) @ w (ng, G, N) -> (ng, M, N)
    xg = xf.reshape(M, ng, G).transpose(0, 1).contiguous()
    wg = wi8.float().reshape(ng, G, N)
    wgi = wi8.reshape(ng, G, N)
    out_g = 4 * ng * M * N
    r.probe("batched per-group f32 dot (ng,M,G)x(ng,G,N)", "probe_dot",
            lambda i: P.probe_dot(xg, wg, "f32"), lambda: P.plain_probe_dot(xg, wg, "f32"), 1e-6,
            nbytes=4 * (M * K + K * N) + out_g, ops=ops, library=lambda i: torch.bmm(xg, wg))
    r.probe("batched per-group dot, i8 w cast in-kernel", "probe_dot",
            lambda i: P.probe_dot(xg, wgi, "f32"), lambda: P.plain_probe_dot(xg, wgi, "f32"), 1e-6,
            nbytes=4 * M * K + K * N + out_g, ops=ops)
    # bf16 operands: given as bf16, and f32 rounded to bf16 at the dot
    xb, wb = xf.to(torch.bfloat16), wi8.to(torch.bfloat16)
    r.probe("bf16 x bf16 -> f32 dot", "probe_dot", lambda i: P.probe_dot(xb, wb, "bf16"),
            lambda: P.plain_probe_dot(xb, wb, "bf16"), 1e-5, nbytes=2 * (M * K + K * N) + 4 * M * N,
            ops=ops, peak=P.PEAK_BF16_S, library=lambda i: torch.matmul(xb, wb))
    wf = wi8.float()
    r.probe("f32-cast-to-bf16 dot", "probe_dot", lambda i: P.probe_dot(xf, wf, "bf16"),
            lambda: P.plain_probe_dot(xf, wf, "bf16"), 1e-5, nbytes=4 * (M * K + K * N + M * N),
            ops=ops, peak=P.PEAK_BF16_S)
    # epilogue: partials (ng, M, N) * s (ng, N) -> sum over g -> (M, N)
    parts = t(rng.random((ng, M, N), np.float32))
    r.probe("per-group rescale epilogue sum", "probe_rescale",
            lambda i: P.probe_rescale(parts, s), lambda: P.plain_probe_rescale(parts, s), 1e-6,
            nbytes=4 * (ng * M * N + ng * N + M * N), ops=2 * ng * M * N,
            library=lambda i: torch.einsum("gmn,gn->mn", parts, s))


if __name__ == "__main__":
    sys.exit(P.script_main(run))
