"""One tiny llama of chip_smoke.py served on the card and on the CPU under
the fixed rule, step by step: where a greedy token flips between the two,
whether a kernel call disagreed with its plain version or rounding moved
the logits across a near-tie.

    python3 scripts/torch_tiny_flip.py [--mix gptq:128] [--seed 1] [--ksplit]

The model is chip_smoke.py's tiny llama (TINY) of the mix ("Q4_K_M", any key
of models/synthetic.py:MIXES, or gptq:<group> for a GPTQ directory) at the
seed, its nibbles packed ksplit with --ksplit. Both devices run the
prompt (chunks 64 + 8) and TINY_STEPS greedy steps each on its own tokens
(chip_smoke.py:greedy_margins) under CT_QMM_AUTOTUNE=0, every kernel call
of the card held against its plain version on the same operands. Prints
the greedy tokens of both, the CPU's top-2 margins, the relative error of
the logits at each step, and the worst relative error of each kernel's
calls. Needs one NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mix", default="gptq:128")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--ksplit", action="store_true")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_tiny_flip: CUDA is not available", file=sys.stderr)
        return 2
    os.environ["CT_QMM_AUTOTUNE"] = "0"
    os.environ["CT_PACK4_LAYOUT"] = "ksplit" if opts.ksplit else "adjk"
    import chip_smoke as C
    from ctransformers_tpu_torch import AutoModelForCausalLM
    from ctransformers_tpu_torch.ops import qmm_kernels as K

    mix = opts.mix
    if mix.startswith("gptq:"):
        mix = ("gptq", int(mix.split(":")[1]), False)
    tmp = tempfile.mkdtemp()
    try:
        path = C.model_path(tmp, "tiny", mix)
        C.write_model(path, mix, opts.seed, **C.TINY)
        gpu = AutoModelForCausalLM.from_pretrained(path)
        cpu = AutoModelForCausalLM.from_pretrained(path, device="cpu")
        worst = {}
        originals = dict(K.KERNELS)

        def checked(name):
            def run(*args):
                out = originals[name](*args)
                ref = K.PLAIN[name](*args)
                err = (torch.linalg.norm(out - ref) / torch.linalg.norm(ref)).item()
                worst[name] = max(worst.get(name, 0.0), err)
                return out
            return run

        for name in originals:
            setattr(K, name, checked(name))
        try:
            got = C.greedy_margins(gpu)
        finally:
            for name, fn in originals.items():
                setattr(K, name, fn)
        want = C.greedy_margins(cpu)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    errs = [float(np.linalg.norm(a - b) / np.linalg.norm(b)) for a, b in zip(got[1], want[1])]
    print(f"{opts.mix} seed {opts.seed} {'ksplit' if opts.ksplit else 'adjk'}, fixed rule")
    print(f"greedy card {got[0]}")
    print(f"greedy cpu  {want[0]}")
    print(f"cpu top-2 margins {[round(x, 4) for x in want[2]]}")
    print(f"logits rel err by step {[float(f'{e:.3e}') for e in errs]}")
    print(f"worst kernel call vs its plain version {worst}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
