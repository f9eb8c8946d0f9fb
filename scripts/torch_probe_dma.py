"""The probe of scripts/probe_dma.py on the card: the read rate of each
tile pattern of a (4096, 22528) uint8 array (the llama-7B gate/up weight's
bytes), every byte summed so that no load can be elided, through
ctransformers_tpu_torch.ops.probes (csrc/probe_stream.cu): strided column
tiles (2048, 1024) and (512, 1024) of the row-major array, full-width row
tiles (256, 22528), and (2048, 1024) tiles of the same bytes pre-tiled to
(22, 4096, 1024). Each layout runs with one block a tile (the Pallas grid's
step) and with each tile's rows split into bands so that at least two
blocks an SM are in flight; GB/s over the array's bytes, beside torch's own
sum over the same tiles.

    python3 scripts/torch_probe_dma.py [--device cpu] [--small]
"""

import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from ctransformers_tpu_torch.ops import probes as P

SHAPE = (4096, 22528)
# (layout, tile) as probe_dma.py runs them
CASES = (("strided", (2048, 1024)), ("strided", (512, 1024)), ("full", (256, None)),
         ("tiled3d", (2048, 1024)))
SMS = 132  # an H100's streaming multiprocessors


def run(r: P.Runner, small: bool = False) -> None:
    div = 16 if small else 1
    k, n = SHAPE[0] // div, SHAPE[1] // div
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.integers(0, 256, (k, n), dtype=np.uint8)).to(r.dev)
    for layout, (tk, tn) in CASES:
        tk //= div
        tn = n if tn is None else tn // div
        arr = P.pretile(a, tn) if layout == "tiled3d" else a
        t = P.stream_tiling(layout, tuple(arr.shape), (tk, tn))
        arrs = r.copies(lambda arr=arr: arr.clone(), arr.numel())
        tiles = t.nty * t.ntx
        view = lambda v, t=t: torch.as_strided(  # noqa: E731
            v.view(torch.int8).reshape(-1), (t.nty, t.ntx, t.rows, t.cols),
            (t.ty_stride, t.tx_stride, t.row_stride, 1))
        for bands in sorted({1, min(t.rows, math.ceil(2 * SMS / tiles))}):
            r.probe(f"{layout} ({tk},{tn}) {tiles} tiles x {bands} bands", "probe_stream",
                    lambda i, t=t, b=bands, arrs=arrs: P.probe_stream(arrs[i % len(arrs)], t, b),
                    lambda t=t, b=bands, arr=arr: P.plain_probe_stream(arr, t, b), 1e-5,
                    nbytes=arr.numel() + 4 * tiles * bands, gbs=arr.numel(),
                    library=None if bands > 1 else
                    (lambda i, arrs=arrs, view=view: view(arrs[i % len(arrs)]).sum(
                        (-2, -1), dtype=torch.int64)))
        del arrs


if __name__ == "__main__":
    sys.exit(P.script_main(run))
