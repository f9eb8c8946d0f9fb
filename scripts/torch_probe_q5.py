"""The probes of scripts/probe_q5.py on the card: the SWAR nibble unpack
(lo = (v & 0x0F0F0F0F) << 4, hi = v & 0xF0F0F0F0 on a word of four bytes:
each byte 16 x its signed nibble, no sign step) against the sign-extending
i4 unpack, in the grouped int8 dot of a llama-7B Q4_K (4096, 11264) weight
through ctransformers_tpu_torch.ops.probes (csrc/probe_nibble.cu):

  q    i4 unpack, activations (ng, m, 32), scales sx
  qpA  swar planes, the even and the odd activations as two inputs
  qpB  swar planes, one input permuted [evens | odds]
  qpC  B with one dot chain for both planes

The qp forms take sx / 16 and must equal q bit for bit (integer dots are
exact, the f32 rescale runs in one order). Also: the dense bf16 "health"
control (torch.matmul, a plain large product), the SWAR planes on their
own, the s16 x s8 and s16 x s16 dots (csrc/probe_dot.cu: dp2a and IMAD;
the TPU lowered neither), and the production ct_qmm_q at m 1 and ct_qmm_si
at m 128 on the same weight.

    python3 scripts/torch_probe_q5.py [--device cpu] [--small]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from ctransformers_tpu_torch.ops import probes as P
from ctransformers_tpu_torch.ops import qmm_kernels as K

K7, N7 = 4096, 11264
FORMS = ("q", "A", "B", "C")


def health(r: P.Runner, rng, k: int, n: int) -> None:
    wd = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)).to(r.dev)
    wd = wd.to(torch.bfloat16)
    xd = torch.zeros((8, k), dtype=torch.bfloat16, device=r.dev)
    wds = r.copies(lambda: wd.clone(), wd.numel() * 2)
    r.timed("health: dense bf16 (torch.matmul)", lambda i: torch.matmul(xd, wds[i % len(wds)]),
            nbytes=wd.numel() * 2)


def form_args(form: str, acts) -> tuple:
    """(x, xb, sx) of a form from quant_q5's activations."""
    xg, xe, xo, xp, sx, sx16 = acts
    if form == "q":
        return xg, None, sx
    if form == "A":
        return xe, xo, sx16
    return xp, None, sx16


def grouped(r: P.Runner, form: str, acts, qt, sp, ms, check_q=None):
    """One form of the grouped dot held against its plain version (and, qp
    forms, against the q form bit for bit) and timed over the weight copies."""
    x, xb, sx = form_args(form, acts)
    unpack = "i4" if form == "q" else "swar"
    m, n, k = sx.shape[1], qt.qs.shape[1], 2 * qt.qs.shape[0]
    xbytes = x.numel() + (xb.numel() if xb is not None else 0)  # int8 activations

    def kernel(i):
        qs, s = ms[i % len(ms)]
        return P.probe_nibble(qs, unpack, "gdot", x, xb, sx=sx, s=s, form=form)

    r.probe(f"m={m} {'q' if form == 'q' else 'qp' + form}", "probe_nibble", kernel,
            lambda: P.plain_probe_nibble(qt.qs, unpack, "gdot", x, xb, sx=sx, s=sp, form=form),
            1e-6, nbytes=qt.qs.numel() + 4 * (sp.numel() + sx.numel() + m * n) + xbytes,
            ops=2 * m * k * n, peak=P.PEAK_INT8_S, gbs=qt.qs.numel() + 4 * sp.numel())
    if check_q is not None and r.check:
        r.compare(f"parity {form}: qp{form} against q", kernel(0), check_q, 0)


def run_timing(r: P.Runner, small: bool, rng) -> None:
    """The Q4_K part: parity at m 1 and the q / qp forms timed at m 1 and
    128, beside the production kernels (probe_q5b.py runs this part alone)."""
    k, n = (512, 1024) if small else (K7, N7)
    health(r, rng, k, n)
    qt, sp = P.q4k_weight(k, n, 0, str(r.dev))
    ms = r.copies(lambda: (qt.qs.clone(), sp.clone()), qt.qs.numel() + 4 * sp.numel())
    qts = r.copies(lambda: P.clone_qtensor(qt), P.plane_bytes(qt))
    x1 = torch.from_numpy((rng.standard_normal((1, k)) * 0.5).astype(np.float32)).to(r.dev)
    acts = P.quant_q5(x1)
    q1 = P.probe_nibble(qt.qs, "i4", "gdot", acts[0], sx=acts[4], s=sp) if r.check else None
    for form in FORMS:
        grouped(r, form, acts, qt, sp, ms, check_q=None if form == "q" else q1)
    qargs = K.quantize_activations(x1, 32)
    r.timed("m=1 prod ct_qmm_q", lambda i: K.qmm_q(*qargs, qts[i % len(qts)]),
            nbytes=P.plane_bytes(qt))
    x128 = torch.from_numpy((rng.standard_normal((128, k)) * 0.5).astype(np.float32)).to(r.dev)
    acts128 = P.quant_q5(x128)
    for form in ("C", "A"):
        grouped(r, form, acts128, qt, sp, ms)
    r.timed("m=128 prod ct_qmm_si", lambda i: K.qmm_si(x128, qts[i % len(qts)]),
            nbytes=P.plane_bytes(qt))


def run(r: P.Runner, small: bool = False) -> None:
    rng = np.random.default_rng(0)
    # the SWAR planes of a (32, 128) byte tile (k_swar), bit for bit
    q = torch.from_numpy(rng.integers(-128, 128, (32, 128), dtype=np.int8)).to(r.dev)
    r.probe("swar-masks planes (32,128)", "probe_nibble",
            lambda i: P.probe_nibble(q, "swar", "planes"),
            lambda: P.plain_probe_nibble(q, "swar", "planes"), 0, nbytes=q.numel() * 5)
    # int16 operands: dp2a (s16 x s8) and IMAD (s16 x s16), exact int32
    a = torch.from_numpy(rng.integers(-32768, 32768, (8, 256), dtype=np.int16)).to(r.dev)
    for name, b in (("int16xint8 dot", rng.integers(-128, 128, (256, 128), dtype=np.int8)),
                    ("int16xint16 dot", rng.integers(-255, 256, (256, 128), dtype=np.int16))):
        bt = torch.from_numpy(b).to(r.dev)
        r.probe(name, "probe_dot", lambda i, bt=bt: P.probe_dot(a, bt, "s16"),
                lambda bt=bt: P.plain_probe_dot(a, bt, "s16"), 0,
                nbytes=2 * a.numel() + bt.numel() * bt.element_size() + 4 * 8 * 128,
                ops=2 * 8 * 256 * 128)
    run_timing(r, small, rng)


if __name__ == "__main__":
    sys.exit(P.script_main(run))
