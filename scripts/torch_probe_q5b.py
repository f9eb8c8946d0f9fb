"""The probes of scripts/probe_q5b.py on the card: the timing part of
torch_probe_q5.py alone (the dense bf16 control, then the q and SWAR qp
forms of the grouped int8 dot on a llama-7B Q4_K weight at m 1 and 128,
beside the production kernels). probe_q5b.py was probe_q5.py's timing
rerun; its kernels are probe_q5.py's.

    python3 scripts/torch_probe_q5b.py [--device cpu] [--small]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import torch_probe_q5
from ctransformers_tpu_torch.ops import probes as P


def run(r: P.Runner, small: bool = False) -> None:
    torch_probe_q5.run_timing(r, small, np.random.default_rng(0))


if __name__ == "__main__":
    sys.exit(P.script_main(run))
