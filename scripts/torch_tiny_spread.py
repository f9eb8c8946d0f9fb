"""Spread of the tiny Q2_K llama's logits across seeds, beside planted faults
in its bias, so that a logit class can be judged: what rounding alone moves
the logits by, and what a wrong bias reads.

    python3 scripts/torch_tiny_spread.py [--seeds 1-12] [--device cpu|cuda]

Per seed, the tiny Q2_K llama of chip_smoke.py (TINY, the Q2_K mix, random
weights from the seed), its prompt (chunks 64 + 8) and TINY_STEPS greedy steps,
every model fed the same tokens (those of the port on the CPU under the
fixed rule). Columns, each the worst step's relative error of the logits
against the port on the CPU under the fixed rule (int8 activations for qx
and q, bf16 for i and si):
  margin      the least top-2 margin of that run (relative to the top logit)
  exact       the exact path: every QTensor dequantized to f32, x @ W in f64
  mins0       a planted fault: Q2_K's mins dropped from its bias (sm = 0)
  submshift   a planted fault: each Q2_K sub-min read from the next group
  card        (--device cuda) the port on the card under the fixed rule
and `same_exact` / `same_card` whether the exact path / the card take the
same greedy tokens. Prints one line per seed and, last, a JSON list of them. The faults
change the weights' planes on the CPU model; nothing else is touched.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
MIX = "Q2_K"


def seeds_arg(text: str) -> list:
    lo, _, hi = text.partition("-")
    return list(range(int(lo), int(hi or lo) + 1))


@contextlib.contextmanager
def exact_matmul():
    """forward.mm as the exact path inside the block."""
    from ctransformers_tpu_torch.models import forward
    from ctransformers_tpu_torch.ops import qmatmul as qm

    mm = forward.mm

    def exact(x, w):
        if not isinstance(w, qm.QTensor):
            return mm(x, w)
        k, n = w.shape
        out = x.reshape(-1, k).double() @ qm.dequantize_qtensor(w).double()
        return out.float().reshape(*x.shape[:-1], n)

    forward.mm = exact
    try:
        yield
    finally:
        forward.mm = mm


def plant(llm, fault: str) -> None:
    """Plant `fault` in every Q2_K QTensor of the model."""
    from ctransformers_tpu_torch.ops import qmatmul as qm

    hit = [w for w in qm.qtensors(llm._engine.params) if w.kind == "Q2_K"]
    for w in hit:
        if fault == "mins0":
            w.sm = torch.zeros_like(w.sm)
        else:  # submshift: group g reads group g + 1's sub-min
            w.mins = torch.roll(w.mins, -1, 0)
        w.picks.clear()


def run(llm, toks: list, steps: list) -> list:
    """Logits after the prompt and after each of `steps` fed tokens."""
    import chip_smoke as C

    C.empty_context(llm)
    llm.eval(toks)
    out = [np.asarray(llm.logits, np.float64)]
    for t in steps:
        llm.eval([t])
        out.append(np.asarray(llm.logits, np.float64))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", default="1-12", type=seeds_arg)
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch_tiny_spread: CUDA is not available", file=sys.stderr)
        return 2
    os.environ["CT_QMM_AUTOTUNE"] = "0"  # the fixed rule on both devices
    import chip_smoke as C
    from ctransformers_tpu_torch import AutoModelForCausalLM

    if args.device == "cuda":
        from ctransformers_tpu_torch.ops import qmm_kernels as K

        C.phase_card(K)  # the card's name and power limit, and the kernel build
    tmp = os.path.join(HERE, "build", "tiny_spread")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    rel = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(b))  # noqa: E731
    rows = []
    try:
        for seed in args.seeds:
            path = C.model_path(tmp, f"tiny_{MIX}_{seed}", MIX)
            C.write_model(path, MIX, seed, **C.TINY)
            load = lambda dev: AutoModelForCausalLM.from_pretrained(path, device=dev)  # noqa: E731
            base = load("cpu")
            base.eval(C.tiny_prompt())
            steps, margin = [], 1.0
            for _ in range(C.TINY_STEPS):
                a = np.asarray(base.logits, np.float64)
                top2 = np.sort(a)[-2:]
                margin = min(margin, float((top2[1] - top2[0]) / abs(top2[1])))
                steps.append(int(np.argmax(a)))
                base.eval([steps[-1]])
            steps = steps[:-1]
            ref = run(base, C.tiny_prompt(), steps)
            greedy = [int(np.argmax(a)) for a in ref]
            row = dict(seed=seed, margin=margin)
            with exact_matmul():
                got = run(base, C.tiny_prompt(), steps)
            row["exact"] = max(rel(a, b) for a, b in zip(got, ref))
            row["same_exact"] = [int(np.argmax(a)) for a in got] == greedy
            for fault in ("mins0", "submshift"):
                faulty = load("cpu")
                plant(faulty, fault)
                row[fault] = max(rel(a, b) for a, b in zip(run(faulty, C.tiny_prompt(), steps), ref))
                del faulty
            if args.device == "cuda":
                got = run(load("cuda"), C.tiny_prompt(), steps)
                row["card"] = max(rel(a, b) for a, b in zip(got, ref))
                row["same_card"] = [int(np.argmax(a)) for a in got] == greedy
            rows.append(row)
            C.remove_model(path)
            print(f"[spread] {MIX} seed {seed}: " + " ".join(
                f"{k}={v:.4e}" if isinstance(v, float) else f"{k}={v}"
                for k, v in row.items() if k != "seed"), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
