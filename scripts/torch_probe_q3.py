"""The probes of scripts/probe_q3.py on the card: where the time of the
activation-quantized Q4_K decode matmul goes. A llama-7B Q4_K (4096, 11264)
weight at m 1, activations quantized per group of 32 outside, the grouped
dot of ctransformers_tpu_torch.ops.probes (csrc/probe_nibble.cu, the decode
kernels' block structure) in four stages: full (i4 unpack, int8 dots,
rescale), nocast (the int8 grid unpacked on the host: no unpack, twice the
bytes), nodot (each group's column sum instead of the dot) and norescale
(the dots summed without scales); beside the production ct_qmm_q on the
same weight and ct_qmm_q_q4_0 on the same operands (the full stage's
function: no bias, the f32 scale plane), in GB/s over the grid bytes.

    python3 scripts/torch_probe_q3.py [--device cpu] [--small]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from ctransformers_tpu_torch.ops import probes as P
from ctransformers_tpu_torch.ops import qmm_kernels as K
from ctransformers_tpu_torch.ops.qmatmul import QTensor

K7, N7 = 4096, 11264
STAGES = ("full", "nocast", "nodot", "norescale")


def q40_view(qt, sp) -> QTensor:
    """The same nibbles with the f32 scale plane and no mins: the operands
    of ct_qmm_q_q4_0, whose function is the full stage's."""
    return QTensor(qt.qs, sp, None, "Q4_0", 32, qt.shape, packed=True, zp=8, sfactor=0,
                   pack_layout="adjk")


def run(r: P.Runner, small: bool = False) -> None:
    rng = np.random.default_rng(0)
    k, n = (512, 1024) if small else (K7, N7)
    qt, sp = P.q4k_weight(k, n, 0, str(r.dev))
    x8 = torch.from_numpy((rng.standard_normal((8, k)) * 0.5).astype(np.float32)).to(r.dev)
    x1 = x8[:1].contiguous()
    xg, sx = P.quant_q3(x1)  # (ng, 1, 32), (ng, 1)

    qts = r.copies(lambda: P.clone_qtensor(qt), P.plane_bytes(qt))
    qargs = K.quantize_activations(x1, 32)
    r.timed("prod ct_qmm_q m=1", lambda i: K.qmm_q(*qargs, qts[i % len(qts)]),
            nbytes=P.plane_bytes(qt))

    grid8 = P.unpack_s8_grid(qt.qs)
    outs = {}
    for stage in STAGES:
        outs[stage] = stage_probe(r, stage, grid8 if stage == "nocast" else qt.qs, sp, xg, sx, n)
    if r.check:
        r.compare("nocast against full (the same parts)", outs["nocast"], outs["full"], 0)
    # the full stage's function, as the production decode kernel computes it
    xq, sxn = xg.transpose(0, 1).reshape(1, k).contiguous(), sx.T.contiguous()
    q40s = r.copies(lambda: q40_view(P.clone_qtensor(qt), sp.clone()), qt.qs.numel() + 4 * sp.numel())
    if r.check:
        r.compare("full against ct_qmm_q_q4_0 (the same operands)",
                  outs["full"], K.qmm_q_q4_0(xq, sxn, sxn, q40_view(qt, sp)), 1e-6)
    r.timed("ct_qmm_q_q4_0 m=1 (the full stage's function)",
            lambda i: K.qmm_q_q4_0(xq, sxn, sxn, q40s[i % len(q40s)]), nbytes=qt.qs.numel())


def stage_probe(r: P.Runner, stage: str, w, sp, xg, sx, n: int):
    """One stage of the grouped dot held and timed; returns its output (on
    the checked run)."""
    unpack = "s8" if stage == "nocast" else "i4"
    scaled = stage != "norescale"
    x = None if stage == "nodot" else xg
    kstage = "full" if stage == "nocast" else stage
    ws = r.copies(lambda: (w.clone(), sp.clone()), w.numel() + 4 * sp.numel())

    def kernel(i):
        wi, si = ws[i % len(ws)]
        return P.probe_nibble(wi, unpack, "gdot", x, sx=sx if scaled else None,
                              s=si if scaled else None, stage=kstage)

    def plain():
        return P.plain_probe_nibble(w, unpack, "gdot", x, sx=sx if scaled else None,
                                    s=sp if scaled else None, stage=kstage)

    k = w.shape[0] * (1 if unpack == "s8" else 2)
    nbytes = w.numel() + 4 * n + (0 if x is None else x.numel())
    nbytes += 4 * (sp.numel() + sx.numel()) if scaled else 0
    r.probe(f"{stage:10s}", "probe_nibble", kernel, plain, 1e-6 if scaled else 0, nbytes=nbytes,
            ops=2 * k * n, peak=P.PEAK_INT8_S, gbs=w.numel())
    return kernel(0) if r.check else None

if __name__ == "__main__":
    sys.exit(P.script_main(run))
