"""Serve the same full-width llama checkpoints from several checkouts of the
port on one card, one fresh process per run, so that two versions of the
engine's host path (not only of a kernel) are compared under the same card,
power limit and host.

    python3 scripts/torch_serve_ab.py [--layers 32] [--steps 64] [--fused] [--rb]
        [--models Q4_K_M,GPTQ4-g128,...] RUN [RUN ...]

Each RUN is ROOT or ROOT:NAME=VALUE[,NAME=VALUE...]: a checkout of this
repository (a `git archive` of a commit unpacked into a directory, or "."
for the working tree) and environment variables for that run, for example

    build/parent . .:CT_QMM_AUTOTUNE=0 .:CT_QMM_AUTOTUNE=0 . build/parent

(parent, the table's choices, the fixed rule twice, the table, parent). The
checkpoints (--models, of MODELS: by default a Q4_K_M GGUF file and a GPTQ
4-bit directory of group 128; Q2_K, Q3_K_M, Q4_0 and Q8_0 GGUF files
too: a Q8_0 file's every weight is an int8 grid with plain f32 scales; and
"Q4_K_M-ksplit", the Q4_K_M file loaded with its nibbles packed ksplit,
CT_PACK4_LAYOUT=ksplit, so that its Q4_K matmuls run the ksplit kernels) at
llama-2-7B width with random weights from seed 7, are written once by this
checkout's writer under build/serve_ab/ and removed at the end. Each run
loads a checkpoint through AutoModelForCausalLM.from_pretrained, evaluates
the 137-token prompt once untimed (a checkout with kernel selection picks
its kernels there; each run has a user table of its own, which starts
empty), then from an empty context times the prompt plus the first sample
(TTFT), the device's busy time over one 128-token prompt chunk from an
empty context under torch.profiler, `--steps` decode steps (eval + sample
on the host clock: mean, median and least; the first 16 sampled tokens),
the device's busy time over four more steps, and, where the checkout has
kernel selection, the host's cost of one settled `pick_mode` call (the
mean over 20 passes over the engine's weights at m = 1) and the modes the
128-token chunk ran (weights by weight type and mode). With --rb, each run
serves under a user's table that names the reshape-broadcast modes (r at
m <= 32, rb above) for every ksplit and int8-grid key, as chip_smoke.py's
"rb" paths do: a first load tells the keys, the checkout's own
rb_mode_entries writes its table (one a run, tied to that checkout's
kernel sources), and the model is loaded again under it with
CT_QMM_AUTOTUNE=precompiled. With --fused, also the fused decode as
chip_smoke.py's serve_fast takes it (the checkout's own chip_smoke.py
helpers): a greedy generate_fast of 64 tokens in segments of 32 that
captures, a second one whose engine timings give the fused ms per token,
and the device's busy ms per token over one replayed segment. Prints one
line per run and model and, last, a JSON list of them.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = {"Q4_K_M": "Q4_K_M", "GPTQ4-g128": ("gptq", 128, False), "Q2_K": "Q2_K",
          "Q3_K_M": "Q3_K_M", "Q4_0": "Q4_0", "Q8_0": "Q8_0", "Q4_K_M-ksplit": "Q4_K_M"}
# the nibble layout each label loads with (CT_PACK4_LAYOUT); adjk elsewhere
LAYOUT_OF = {"Q4_K_M-ksplit": "ksplit"}

CHILD = """
import json, os, statistics, sys, time, warnings
sys.path.insert(0, {root!r})
import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile
from ctransformers_tpu_torch import AutoModelForCausalLM

def step(llm, tok):
    llm.eval([tok])
    return llm.sample(seed=5, top_k=40, temperature=0.8)

def device_us(prof):
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)

out = []
base_table = os.environ.get("CT_QMM_TILE_CACHE", "")
ids = [1] + [int(t) for t in np.random.default_rng(11).integers(3, 32000, 136)]
for label, path, layout in {models!r}:
    os.environ["CT_PACK4_LAYOUT"] = layout
    if {rb}:
        from ctransformers_tpu_torch.ops import qmatmul as qm
        os.environ["CT_QMM_AUTOTUNE"] = "precompiled"
        table = base_table + f".rb_{{label}}.json"
        llm = AutoModelForCausalLM.from_pretrained(path)
        qm.save_table(table, torch.cuda.get_device_name(0),
                      qm.rb_mode_entries(qm.qtensors(llm._engine.params), (1, 8, 128)))
        del llm
        torch.cuda.empty_cache()
        os.environ["CT_QMM_TILE_CACHE"] = table
    t0 = time.perf_counter()
    llm = AutoModelForCausalLM.from_pretrained(path)
    load_s = time.perf_counter() - t0
    llm.eval(ids)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        llm.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        llm.eval(ids)
        tok = llm.sample(seed=5, top_k=40, temperature=0.8)
        ttft_ms = (time.perf_counter() - t0) * 1e3
        llm.reset()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            llm.eval(ids[:128])
            torch.cuda.synchronize()
        chunk_busy_us = device_us(prof)
        tok = llm.sample(seed=5, top_k=40, temperature=0.8)
        times, toks = [], [int(tok)]
        for _ in range({steps}):
            t0 = time.perf_counter()
            tok = step(llm, tok)
            times.append((time.perf_counter() - t0) * 1e3)
            toks.append(int(tok))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(4):
                tok = step(llm, tok)
        busy_us = device_us(prof)
    fused = {{}}
    if {fused}:
        import chip_smoke as C
        eng = llm._engine
        prompt = C.prompt_of_len(llm, C.FAST_PROMPT)
        C.fused_greedy(llm, prompt, C.FAST_TOKENS, C.FAST_CHUNK)  # captures
        t = eng.timings()
        C.fused_greedy(llm, prompt, C.FAST_TOKENS, C.FAST_CHUNK)  # replays only
        t2 = eng.timings()
        C.empty_context(llm)
        pids = llm.tokenize(prompt)
        llm.eval(pids)
        cfg = llm.config
        torch.cuda.synchronize()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                eng.decode(C.FAST_CHUNK, top_k=cfg.top_k, top_p=cfg.top_p, temperature=0.0,
                           repetition_penalty=1.0, last_tokens=pids, last_n=cfg.last_n_tokens)
                torch.cuda.synchronize()
        fused = dict(fused_ms=(t2["t_eval_ms"] - t["t_eval_ms"]) / (t2["n_eval"] - t["n_eval"]),
                     fused_busy_ms=device_us(prof) / 1e3 / C.FAST_CHUNK)
    pick_us = modes = None
    from ctransformers_tpu_torch.ops import qmatmul as qm
    if hasattr(qm, "pick_mode"):
        qts = qm.qtensors(llm._engine.params)
        modes = {{}}
        for w in qts:
            m128 = w.picks.get(128)
            if m128 is not None:
                key = w.kind + ":" + (m128[1][0] or "f")
                modes[key] = modes.get(key, 0) + 1
        t0 = time.perf_counter()
        for _ in range(20):
            for w in qts:
                qm.pick_mode(1, w)
        pick_us = (time.perf_counter() - t0) * 1e6 / (20 * len(qts))
    out.append(dict(model=label, load_s=load_s, ttft_ms=ttft_ms,
                    chunk_busy_ms=chunk_busy_us / 1e3,
                    decode_ms_mean=statistics.fmean(times),
                    decode_ms_median=statistics.median(times),
                    decode_ms_min=min(times),
                    device_busy_ms=busy_us / 4e3, pick_mode_us=pick_us, modes_m128=modes,
                    tokens=toks[:16], **fused))
    del llm
    torch.cuda.empty_cache()
print("AB_RESULT " + json.dumps(out))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--fused", action="store_true", help="also time generate_fast")
    ap.add_argument("--rb", action="store_true",
                    help="serve under a table naming r and rb (rb_mode_entries)")
    ap.add_argument("--models", default="Q4_K_M,GPTQ4-g128",
                    help=f"comma-separated, of {','.join(MODELS)}")
    ap.add_argument("runs", nargs="+")
    args = ap.parse_args()
    labels = args.models.split(",")
    if not set(labels) <= set(MODELS):
        ap.error(f"--models: unknown {sorted(set(labels) - set(MODELS))}")

    sys.path.insert(0, HERE)
    import chip_smoke as C
    from ctransformers_tpu_torch.models.synthetic import LLAMA2_7B

    tmp = os.path.join(HERE, "build", "serve_ab")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"card {smi}", flush=True)
    models, written = [], {}
    for label in labels:
        mix = MODELS[label]
        if repr(mix) not in written:  # one file a mix, whatever layout loads it
            path = C.model_path(tmp, f"llama7b_{args.layers}l_{label}", mix)
            C.write_model(path, mix, seed=7, big=True,
                          **dict(LLAMA2_7B, n_layer=args.layers, n_ctx=2048))
            written[repr(mix)] = path
        models.append((label, written[repr(mix)], LAYOUT_OF.get(label, "adjk")))
    rows = []
    try:
        for i, run in enumerate(args.runs):
            root, _, settings = run.partition(":")
            env = dict(os.environ, CT_QMM_TILE_CACHE=os.path.join(tmp, f"table_{i}.json"))
            env.update(kv.split("=", 1) for kv in settings.split(",") if kv)
            r = subprocess.run(
                [sys.executable, "-c",
                 CHILD.format(root=os.path.abspath(root), models=models, steps=args.steps,
                              fused=args.fused, rb=args.rb)],
                capture_output=True, text=True, cwd=os.path.abspath(root), env=env)
            if r.returncode != 0:
                print(r.stdout[-2000:], r.stderr[-4000:], file=sys.stderr)
                return r.returncode
            line = next(l for l in r.stdout.splitlines() if l.startswith("AB_RESULT "))
            for row in json.loads(line[len("AB_RESULT "):]):
                row = dict(run=f"{i}:{run}", **row)
                rows.append(row)
                print(" ".join(f"{k}={v:.3f}" if isinstance(v, float) else f"{k}={v}"
                               for k, v in row.items()), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
