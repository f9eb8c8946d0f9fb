"""The probes of scripts/probe_int4.py on the card: adjk nibbles (byte row k
holds rows 2k and 2k + 1) unpacked by sign extension (i4) against the f32
floor chain (rows [l - 8 ; f - 8]), each feeding a column sum, a bf16 dot or
an int8 dot, through ctransformers_tpu_torch.ops.probes
(csrc/probe_nibble.cu), held against the plain versions; then the i4 and
floor bf16 dots timed on a llama-7B tile, (2048, 11264) packed bytes (K
4096) at m 8, in GB/s over the packed bytes, beside torch.matmul in bf16 on
the unpacked grid.

    python3 scripts/torch_probe_int4.py [--device cpu] [--small]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from ctransformers_tpu_torch.ops import probes as P
from ctransformers_tpu_torch.ops import qmm_kernels as K

# byte rows x columns of the lowering probes (K = 512) and of the timed tile
KB, NB = 256, 1024
KB_BIG, N_BIG = 2048, 11264
M = 8


def run(r: P.Runner, small: bool = False) -> None:
    rng = np.random.default_rng(0)
    w4 = rng.integers(-8, 8, (2 * KB, NB), dtype=np.int32)
    qs = torch.from_numpy(P.pack_adjacent_k(w4)).to(r.dev)
    if not np.array_equal(K.unpack_w4(qs.cpu()).numpy(), w4):
        raise SystemExit("pack_adjacent_k and unpack_w4 disagree")
    xf = rng.standard_normal((M, 2 * KB)).astype(np.float32)
    x = torch.from_numpy(xf).to(r.dev).to(torch.bfloat16)
    xi8 = torch.from_numpy(np.clip(np.round(xf * 10), -127, 127).astype(np.int8)).to(r.dev)

    qbytes = qs.numel()
    for label in ("i4->f32 cast ", "i4->bf16 cast"):  # nibbles are exact in bf16
        r.probe(label, "probe_nibble", lambda i: P.probe_nibble(qs, "i4", "colsum"),
                lambda: P.plain_probe_nibble(qs, "i4", "colsum"), 0, nbytes=qbytes + 4 * NB)
    dot = dict(nbytes=qbytes + 2 * x.numel() + 4 * M * NB, ops=2 * M * 2 * KB * NB)  # bf16 x
    r.probe("i4->bf16 + dot", "probe_nibble", lambda i: P.probe_nibble(qs, "i4", "dot_bf16", x),
            lambda: P.plain_probe_nibble(qs, "i4", "dot_bf16", x), 1e-5, peak=P.PEAK_BF16_S, **dot)
    r.probe("i4->i8 int dot", "probe_nibble", lambda i: P.probe_nibble(qs, "i4", "dot_s8", xi8),
            lambda: P.plain_probe_nibble(qs, "i4", "dot_s8", xi8), 0, peak=P.PEAK_INT8_S,
            **dict(dot, nbytes=qbytes + xi8.numel() + 4 * M * NB))
    r.probe("floor control ", "probe_nibble", lambda i: P.probe_nibble(qs, "floor", "dot_bf16", x),
            lambda: P.plain_probe_nibble(qs, "floor", "dot_bf16", x), 1e-5, peak=P.PEAK_BF16_S,
            **dot)

    # the timed tile: K = 2 * kb rows, m 8, bf16 activations
    kb, n = (KB, 1408) if small else (KB_BIG, N_BIG)
    big = torch.from_numpy(rng.integers(-128, 128, (kb, n), dtype=np.int8)).to(r.dev)
    xb = torch.from_numpy(rng.standard_normal((M, 2 * kb)).astype(np.float32)).to(r.dev)
    xb = xb.to(torch.bfloat16)
    bigs = r.copies(lambda: big.clone(), big.numel())
    nb = len(bigs)
    for unpack in ("i4", "floor"):
        dense = P.nibble_grid(big, unpack).to(torch.bfloat16)
        denses = r.copies(lambda: dense.clone(), dense.numel() * 2)
        r.probe(f"{unpack:5s} big tile ({kb},{n}) bytes, m {M}", "probe_nibble",
                lambda i, u=unpack: P.probe_nibble(bigs[i % nb], u, "dot_bf16", xb),
                lambda u=unpack: P.plain_probe_nibble(big, u, "dot_bf16", xb), 1e-5,
                nbytes=big.numel() + 2 * xb.numel() + 4 * M * n, ops=2 * M * 2 * kb * n,
                peak=P.PEAK_BF16_S, gbs=big.numel(),
                library=lambda i, d=denses: torch.matmul(xb, d[i % len(d)]))
        del dense, denses


if __name__ == "__main__":
    sys.exit(P.script_main(run))
