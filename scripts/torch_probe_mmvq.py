"""The probes of scripts/probe_mmvq.py on the card: the MMVQ formulation of
the decode matmul (activations quantized to int8 per group of 32, integer
dots per group against the raw nibbles, the scales applied to the partial
sums) through ctransformers_tpu_torch.ops.probes (csrc/probe_nibble.cu):
per-group column sums, per-group int8 dots and the rescaled tile at M 8,
K 512, N 256; then the full kernel on a llama-7B Q4_K (4096, 11264) weight
at m 1 and 8 beside the port's production kernels ct_qmm_si and ct_qmm_i
at the same key, in GB/s over the packed bytes.

    python3 scripts/torch_probe_mmvq.py [--device cpu] [--small]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from ctransformers_tpu_torch.ops import probes as P
from ctransformers_tpu_torch.ops import qmm_kernels as K

M, KS, NS = 8, 512, 256
K7, N7 = 4096, 11264


def run(r: P.Runner, small: bool = False) -> None:
    rng = np.random.default_rng(0)
    G = P.GROUP
    ng = KS // G

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(r.dev)

    packed = t(rng.integers(0, 256, (KS // 2, NS), np.uint8).view(np.int8))
    xg = P.group_x(t(rng.integers(-127, 127, (M, KS), np.int8)))
    s = t(rng.random((ng, NS), np.float32))
    sx = t(rng.random((ng, M), np.float32))
    qb = packed.numel()
    r.probe("in-kernel bitcast+reshape (K,N)->(ng,G,N)", "probe_nibble",
            lambda i: P.probe_nibble(packed, "i4", "gcolsum"),
            lambda: P.plain_probe_nibble(packed, "i4", "gcolsum"), 0, nbytes=qb + 4 * ng * NS)
    r.probe("grouped int8 x int8 -> int32 dot (w reshaped in-kernel)", "probe_nibble",
            lambda i: P.probe_nibble(packed, "i4", "gdot_s8", xg),
            lambda: P.plain_probe_nibble(packed, "i4", "gdot_s8", xg), 0,
            nbytes=qb + xg.numel() + 4 * ng * M * NS, ops=2 * M * KS * NS, peak=P.PEAK_INT8_S)
    r.probe("full mmvq tile: grouped i8 dot + rescale epilogue", "probe_nibble",
            lambda i: P.probe_nibble(packed, "i4", "gdot", xg, sx=sx, s=s),
            lambda: P.plain_probe_nibble(packed, "i4", "gdot", xg, sx=sx, s=s), 1e-6,
            nbytes=qb + xg.numel() + 4 * (sx.numel() + s.numel() + M * NS),
            ops=2 * M * KS * NS, peak=P.PEAK_INT8_S)

    # the llama-7B down-projection tile, Q4_K
    k, n = (512, 1024) if small else (K7, N7)
    qt, sp = P.q4k_weight(k, n, 0, str(r.dev))
    wbytes = qt.qs.numel() + sp.numel() * 4
    mm = r.copies(lambda: (qt.qs.clone(), sp.clone()), wbytes)
    qts = r.copies(lambda: P.clone_qtensor(qt), P.plane_bytes(qt))
    for m in (1, 8):
        x = torch.from_numpy((rng.standard_normal((m, k)) * 0.5).astype(np.float32)).to(r.dev)
        for mode in ("si", "i"):
            fn = K.KERNELS[f"qmm_{mode}"]
            r.timed(f"m={m} ct_qmm_{mode} (production)", lambda i, fn=fn: fn(x, qts[i % len(qts)]),
                    nbytes=qt.qs.numel())
        xq, sxq = P.quant_mmvq(x)
        r.probe(f"m={m} mmvq (full, i4)", "probe_nibble",
                lambda i: P.probe_nibble(mm[i % len(mm)][0], "i4", "gdot", xq, sx=sxq,
                                         s=mm[i % len(mm)][1]),
                lambda: P.plain_probe_nibble(qt.qs, "i4", "gdot", xq, sx=sxq, s=sp), 1e-6,
                nbytes=wbytes + xq.numel() + 4 * (sxq.numel() + m * n), ops=2 * m * k * n,
                peak=P.PEAK_INT8_S, gbs=qt.qs.numel(), library=P.library_matmul(r, qt, sp, m))


if __name__ == "__main__":
    sys.exit(P.script_main(run))
