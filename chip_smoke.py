"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py [--write-table PATH]

Phases (any failure exits non-zero; nothing falls back to the CPU):
  1. card      nvidia-smi name and power limit, versions, kernel build time
  2. bandwidth dense device-to-device copy of 2 GiB, timed with CUDA events
  3. kernels   each of the qmm kernels against its plain PyTorch version at
               the llama-2-7B matmul shapes (Q4_K, the Q6_K / Q5_K int8
               grids of Q4_K_M / Q5_K_M files, GPTQ4 planes at group 128,
               with groups 32 and 64 at one shape, Q4_0 nibbles, the Q8_0
               grid and the Q5_1 grid at the o shape, the group-16 Q2_K and
               Q3_K nibbles; Q4_1's and Q5_1's other keys held only; the
               ksplit nibbles of Q4_K, GPTQ4, Q4_0, Q2_K and Q3_K with the
               six ksplit kernels, the reshape-broadcast r8 / rb8 kernels
               and the qx8 kernels, which quantize x inside, on the Q6_K,
               Q5_K, Q8_0 and Q5_1 grids), with times beside the card's
               bound and a bf16 torch.matmul yardstick;
               every other candidate of those keys at m = 1, 8 and 128 is
               held against its plain version too, so that whatever a
               table sends to a main path was held at that shape and m
               (phase 5 fails on a launch that was not);
     attention the decode attention kernel (csrc/attn_decode.cu) against its
               plain version at llama-2-7B heads (32 of width 128, n_ctx
               2048): f32, bf16, IEEE f16 and int8 caches at n_past 200 and
               2000, head-major at 2000, GQA (32 heads over 8), ALiBi, and
               4 slots at n_past (5, 300, 1000, 2000); times beside the
               bound and scaled_dot_product_attention as the yardstick
     probes    the probe kernels (ops/probes.py: csrc/probe_{dot,nibble,
               stream}.cu, the ports of scripts/probe_*.py): every probe of
               scripts/torch_probe_*.py (torch_probe_q5b.py is
               torch_probe_q5.py's timing part: run once) held against its plain
               version at the JAX scripts' shapes (llama-7B tiles), then the
               scripts' timed runs, the probe path of this phase, with the
               probe counts set to 0 before and read after: each row's ms,
               bound, plain and library ms and launches
     race      per layout and 7B shape at m = 1, 8 and 128 the race of
               ops/qmatmul.py: every candidate's ms (the dense candidate
               included), the winner and the best hand-written kernel;
               --write-table saves these champions as a table file (how
               the table shipped under ctransformers_tpu_torch/data/ is made)
  4. tiny      tiny all-Q4_K, Q4_K_M, Q5_K_M, Q4_0, Q8_0, Q5_1, Q2_K,
               Q3_K_M and Q3_K_S llama files and tiny GPTQ directories
               (groups 32 and 128, with and without act-order), and eight
               of them packed ksplit (CT_PACK4_LAYOUT=ksplit), served on the
               card (kernels picked by the race) and on the CPU under the
               card's picks, then twelve of them again on both under a
               user's table file that names the modes g, "", s, si and sb
               ("", s, b and sb on ksplit nibbles), and four under one that
               names r and rb, and two (Q4_K_M, Q8_0) under one that names
               qx, where greedy generate_fast (captured CUDA graphs) must
               equal the eager loop's tokens and bitwise logits; every
               kernel call held against its plain version; a tiny Q4_K_M
               llama with bf16 and int8 KV
               caches and head-major caches (CT_KV_LAYOUT=hm) on both, every
               decode attention call held against its plain version
  5. main      llama-2-7B-width checkpoints (random weights from a seed)
               through AutoModelForCausalLM.from_pretrained -> llm(...):
               text prompts, a 137-token prompt (chunks 128 + 8 + 1) and
               decode, each with its launch counts (dense calls included)
               asserted against the table's choices: the Q4_K_M file, a
               GPTQ 4-bit directory (group 128) and the Q4_K_M file packed
               ksplit at full depth and Q2_K, Q3_K_M, Q4_0 and Q8_0 files
               at 8 layers, loaded cold (an
               empty table: the load races) and again warm, served under
               the fixed rule and under the raced table in turns; a Q5_K_M
               file at 4 layers, an all-Q4_K file at 8, an act-order GPTQ
               directory and Q4_1, Q5_0, Q5_1, Q3_K_S and Q3_K_L files at 4,
               and a GPTQ directory and Q4_0, Q2_K and Q3_K_M files packed
               ksplit at 4, without the dense candidate (the best
               hand-written kernel of every key); Q4_K_M, Q5_K_M, Q4_0,
               Q5_1, Q2_K and Q3_K_M files, a GPTQ directory and the Q4_K_M
               file packed ksplit at 2 layers under a user's table that
               names the float-activation and sum-fold modes for every key;
               the ksplit Q4_K_M and the Q8_0 file at 2 layers under one
               that names r and rb; the Q4_K_M file at 2 layers and the
               Q8_0 file at 8 under one that names qx, also through
               generate_fast; the 32-layer Q4_K_M file through
               generate_fast (the fused decode: a CUDA graph a key, replayed
               a token; tokens and segment-end logits against the eager
               loop, fused and eager ms per token, busy ms, capture ms,
               launches of the replays), again with bf16 and int8 KV
               caches (through generate_fast too), and a long-context
               decode (a 1920-token prompt, then 32 steps at window 2048)
               with f32, bf16 and int8 caches
Prints a JSON line of per-kernel results, then, as the last line,
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import functools
import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

# published H100 SXM peaks (dense): HBM rate, bf16 and int8 tensor-core
# rates, f32 outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_BF16_S = 989e12
PEAK_INT8_S = 1979e12
PEAK_F32_S = 67e12
# llama-2-7B matmul shapes (K, N) as the engine runs them (QKV and gate/up
# fused where their types agree)
SHAPES = {
    "qkv": (4096, 12288),
    "o": (4096, 4096),
    "v": (4096, 4096),
    "gate_up": (4096, 22016),
    "up": (4096, 11008),  # unfused gate / up of an act-order GPTQ directory
    "down": (11008, 4096),
    "lm_head": (4096, 32000),
}
# the batch sizes m each kernel is held and timed at with its plain version
# and the library call (the decode step, the 8-token and the 128-token
# chunk of the main path's prompt; "g" is a candidate at m <= 32). These
# rows make the sums of the "kernels" line and stay as they are from run to
# run; every other candidate of a case's key at RACE_M is held as well
# (phase_kernels), its error and kernel ms logged
RUNS_Q4K = [("qmm_qx", 1), ("qmm_q", 8), ("qmm_si", 128), ("qmm_i", 128), ("qmm_g", 1), ("qmm_g", 8)]
RUNS_GPTQ = [("qmm_qx_gptq", 1), ("qmm_q_gptq", 8), ("qmm_i_gptq", 128), ("qmm_g_gptq", 1),
             ("qmm_g_gptq", 8), ("qmm_si_gptq", 128)]
RUNS_Q6K = [("qmm_q8", 1), ("qmm_q8", 8), ("qmm_g8", 1), ("qmm_g8", 8), ("qmm_f", 1), ("qmm_f", 8)]
RUNS_Q5K = RUNS_Q6K + [("qmm_s", 1), ("qmm_s", 8), ("qmm_sb", 128)]
RUNS_Q40 = [("qmm_qx_q4_0", 1), ("qmm_q_q4_0", 8), ("qmm_i_q4_0", 128), ("qmm_si_q4_0", 128),
            ("qmm_g_q4_0", 1), ("qmm_g_q4_0", 8)]
RUNS_Q80 = [(f"{name}_legacy", m) for name, m in RUNS_Q6K]
RUNS_K16 = [(f"{name}_k16", m) for name, m in RUNS_Q4K]
RUNS_Q51 = RUNS_Q80 + [("qmm_s_legacy", 1), ("qmm_s_legacy", 8), ("qmm_b_legacy", 128),
                       ("qmm_sb_legacy", 128)]
# the ksplit kernels: the f32 modes at the decode step and the 8-token chunk,
# the bf16-operand GEMMs at those and the 128-token chunk; the
# reshape-broadcast forms of the int8 grids at the same m
RUNS_KS = [(f"qmm_{mode}_ks", m) for mode in ("f", "s", "r") for m in (1, 8)] + [
    (f"qmm_{mode}_ks", m) for mode in ("b", "sb", "rb") for m in (1, 8, 128)]
RUNS_R8 = [("qmm_r8", 1), ("qmm_r8", 8), ("qmm_rb8", 1), ("qmm_rb8", 8), ("qmm_rb8", 128)]
RUNS_R8_LEGACY = [(f"{name}_legacy", m) for name, m in RUNS_R8]
# the int8-grid kernels that quantize x inside (mode "qx", served by a table)
RUNS_QX8 = [("qmm_qx8", 1), ("qmm_qx8", 8)]
RUNS_QX8_LEGACY = [("qmm_qx8_legacy", 1), ("qmm_qx8_legacy", 8)]
# (weight type, shape, [(kernel, m), ...]) held against the plain versions:
# Q4_K at five shapes; the Q6_K tensors of a Q4_K_M file (attn_v and ffn_down of
# the more-bits layers, output) and the Q5_K tensors of a Q5_K_M file, each in
# decode, 8-token and 128-token chunks; GPTQ4 planes ("GPTQ4/<group>") at
# group 128 at the four shapes of the GPTQ path, and at groups 32 and 64 at
# one shape, so that every instantiation meets a 7B shape; the legacy types'
# keys: Q4_0 at the four shapes of its path (its output is Q6_K), Q8_0 at
# five (its output stays Q8_0; Q5_0 has Q8_0's keys), Q5_1 timed at o, and
# every candidate of Q5_1's and Q4_1's other keys held (Q4_1 has GPTQ4/32's
# keys and kernels); the group-16 nibbles Q2_K (with mins) and Q3_K
# (without) at the four shapes of the Q2_K, Q3_K_S/M/L paths (q, k and o
# have the o shape; QKV fuses in Q3_K_S only); the same nibbles packed ksplit
# ("ks:<kind>"): Q4_K at its five shapes, GPTQ4 at group 128's four and
# groups 32 and 64 at o, Q4_0, Q2_K and Q3_K at o and down, and every
# candidate held at the other keys of the ksplit paths (Q4_0's fused QKV
# and gate/up, Q2_K's and Q3_K's gate/up); the reshape-broadcast kernels
# of the int8 grids on Q6_K v, down and lm_head, Q5_K o, Q8_0 o and down
# and Q5_1 o, and the kernels that quantize x inside on the same keys
KERNEL_CASES = [
    ("Q4_K", s, RUNS_Q4K) for s in ("qkv", "o", "gate_up", "down", "lm_head")
] + [
    ("Q6_K", "v", RUNS_Q6K + [("qmm_b", 128)] + RUNS_R8 + RUNS_QX8),
    ("Q6_K", "down", RUNS_Q6K + [("qmm_b", 128)] + RUNS_R8 + RUNS_QX8),
    ("Q6_K", "lm_head", RUNS_Q6K + RUNS_R8 + RUNS_QX8),
] + [
    ("Q5_K", s, RUNS_Q5K + (RUNS_R8 + RUNS_QX8 if s == "o" else []))
    for s in ("qkv", "o", "gate_up", "down")
] + [
    (f"GPTQ4/{g}", s, RUNS_GPTQ)
    for g, s in ((128, "qkv"), (128, "o"), (128, "gate_up"), (128, "down"), (32, "o"), (64, "o"))
] + [
    ("GPTQ4/128", "up", []),  # a key of the act-order path: every candidate held
] + [
    ("Q4_0", s, RUNS_Q40) for s in ("qkv", "o", "gate_up", "down")
] + [
    ("Q8_0", s, RUNS_Q80 + [("qmm_b_legacy", 128)]
     + (RUNS_R8_LEGACY + RUNS_QX8_LEGACY if s in ("o", "down") else []))
    for s in ("qkv", "o", "gate_up", "down")
] + [
    ("Q8_0", "lm_head", RUNS_Q80), ("Q5_1", "o", RUNS_Q51 + RUNS_R8_LEGACY + RUNS_QX8_LEGACY),
] + [
    (kind, s, []) for kind in ("Q5_1", "Q4_1") for s in ("qkv", "gate_up", "down")
] + [
    (kind, s, RUNS_K16) for kind in ("Q2_K", "Q3_K") for s in ("o", "qkv", "gate_up", "down")
] + [
    ("ks:Q4_K", s, RUNS_KS) for s in ("qkv", "o", "gate_up", "down", "lm_head")
] + [
    (f"ks:GPTQ4/{g}", s, RUNS_KS)
    for g, s in ((128, "qkv"), (128, "o"), (128, "gate_up"), (128, "down"), (32, "o"), (64, "o"))
] + [
    (f"ks:{kind}", s, RUNS_KS) for kind in ("Q4_0", "Q2_K", "Q3_K") for s in ("o", "down")
] + [
    ("ks:Q4_0", "qkv", []), ("ks:Q4_0", "gate_up", []), ("ks:Q2_K", "gate_up", []),
    ("ks:Q3_K", "gate_up", []),
]
# (kernel, table key) held against its plain version in phase 3
HELD = set()
# the batch sizes raced per case (the sizes the main path's prompt and decode run)
RACE_M = (1, 8, 128)
# int8 dots for the activation-quantized kernels, bf16 operands for the GEMMs
# and the grouped dot "g", f32 for "" and "s"
PEAK_OF = {"qmm_qx": PEAK_INT8_S, "qmm_q": PEAK_INT8_S, "qmm_q8": PEAK_INT8_S,
           "qmm_si": PEAK_BF16_S, "qmm_i": PEAK_BF16_S, "qmm_b": PEAK_BF16_S,
           "qmm_sb": PEAK_BF16_S, "qmm_qx_gptq": PEAK_INT8_S, "qmm_q_gptq": PEAK_INT8_S,
           "qmm_i_gptq": PEAK_BF16_S, "qmm_g": PEAK_BF16_S, "qmm_g_gptq": PEAK_BF16_S,
           "qmm_g8": PEAK_BF16_S, "qmm_f": PEAK_F32_S, "qmm_s": PEAK_F32_S,
           "qmm_si_gptq": PEAK_BF16_S, "qmm_qx_q4_0": PEAK_INT8_S, "qmm_q_q4_0": PEAK_INT8_S,
           "qmm_i_q4_0": PEAK_BF16_S, "qmm_si_q4_0": PEAK_BF16_S, "qmm_g_q4_0": PEAK_BF16_S,
           "qmm_q8_legacy": PEAK_INT8_S, "qmm_b_legacy": PEAK_BF16_S,
           "qmm_sb_legacy": PEAK_BF16_S, "qmm_g8_legacy": PEAK_BF16_S,
           "qmm_f_legacy": PEAK_F32_S, "qmm_s_legacy": PEAK_F32_S,
           "qmm_qx_k16": PEAK_INT8_S, "qmm_q_k16": PEAK_INT8_S, "qmm_i_k16": PEAK_BF16_S,
           "qmm_si_k16": PEAK_BF16_S, "qmm_g_k16": PEAK_BF16_S,
           **{f"qmm_{mode}_ks": PEAK_F32_S for mode in ("f", "s", "r")},
           **{f"qmm_{mode}_ks": PEAK_BF16_S for mode in ("b", "sb", "rb")},
           "qmm_r8": PEAK_F32_S, "qmm_rb8": PEAK_BF16_S, "qmm_r8_legacy": PEAK_F32_S,
           "qmm_rb8_legacy": PEAK_BF16_S, "qmm_qx8": PEAK_INT8_S, "qmm_qx8_legacy": PEAK_INT8_S}
# q/qx/q8: the integer group dots are exact, only f32 rescale sums differ in
# order; i/si/b/sb: bf16 products summed in another order on tensor cores;
# g: exact products, f and s: f32 products, f32 sums in another order
TOL = {"qmm_qx": 1e-5, "qmm_q": 1e-5, "qmm_q8": 1e-5,
       "qmm_si": 1e-3, "qmm_i": 1e-3, "qmm_b": 1e-3, "qmm_sb": 1e-3,
       "qmm_qx_gptq": 1e-5, "qmm_q_gptq": 1e-5, "qmm_i_gptq": 1e-3,
       "qmm_g": 1e-5, "qmm_g_gptq": 1e-5, "qmm_g8": 1e-5, "qmm_f": 1e-5, "qmm_s": 1e-5,
       "qmm_si_gptq": 1e-3, "qmm_qx_q4_0": 1e-5, "qmm_q_q4_0": 1e-5, "qmm_i_q4_0": 1e-3,
       "qmm_si_q4_0": 1e-3, "qmm_g_q4_0": 1e-5, "qmm_q8_legacy": 1e-5, "qmm_b_legacy": 1e-3,
       "qmm_sb_legacy": 1e-3, "qmm_g8_legacy": 1e-5, "qmm_f_legacy": 1e-5,
       "qmm_s_legacy": 1e-5, "qmm_qx_k16": 1e-5, "qmm_q_k16": 1e-5, "qmm_i_k16": 1e-3,
       "qmm_si_k16": 1e-3, "qmm_g_k16": 1e-5,
       **{f"qmm_{mode}_ks": 1e-5 for mode in ("f", "s", "r")},
       **{f"qmm_{mode}_ks": 1e-3 for mode in ("b", "sb", "rb")},
       "qmm_r8": 1e-5, "qmm_rb8": 1e-3, "qmm_r8_legacy": 1e-5, "qmm_rb8_legacy": 1e-3,
       "qmm_qx8": 1e-5, "qmm_qx8_legacy": 1e-5}
# main paths: (label, mix, layers, how). mix is a llama.cpp mix (K_M or a
# legacy ftype, models/synthetic.py:MIXES), None for an all-Q4_K file, or
# ("gptq", group, act_order) for a GPTQ 4-bit directory.
# how: "race" loads with an empty table (cold, the load races), loads again
# (warm) and serves under the fixed rule and under the raced table in turns;
# "kernels" serves without the dense candidate (CT_QMATMUL=kernels), so the
# best hand-written kernel of every key runs; "new" serves under a user's
# table that names the float-activation modes (g, "", s) and the sum-fold
# GEMMs (si, sb) for every key (ops/qmatmul.py:float_mode_entries). The
# all-Q4_K and Q5_K_M paths are cut in depth so that the whole run stays
# within a few minutes; the act-order path is the second GPTQ path; the
# Q4_1, Q5_0 and Q5_1 paths are the legacy types that no full-depth path
# serves; Q4_0 and Q8_0 are cut from 32 to 8 layers to make room for the
# full-depth group-16 path (Q2_K runs Q2_K and Q3_K nibbles), and Q3_K_M
# (Q3_K beside Q4_K) from 32 to 8 to make room for the full-depth ksplit
# Q4_K_M path; Q3_K_S (fused Q3_K QKV) and Q3_K_L (Q5_K beside Q3_K) are
# the other mixes of the card. Labels with "-ksplit" pack their nibbles
# ksplit (CT_PACK4_LAYOUT): the GPTQ, Q4_0, Q2_K and Q3_K_M ksplit paths
# run every nibble kind's ksplit kernels; "rb" serves under a user's table
# that names the reshape-broadcast modes r and rb for every ksplit and
# int8-grid key (ops/qmatmul.py:rb_mode_entries), which no race picks;
# "qx" under one that names qx (the activations quantized inside the
# kernel) for every int8-grid key at m <= 32 (ops/qmatmul.py:qx_mode_entries),
# and serves generate_fast too (serve_fast), so that qmm_qx8 and its legacy
# form run inside captured decode graphs. Q2_K is cut from 32 to 8 layers
# to make room for the fused decode (serve_fast) of the 32-layer Q4_K_M file
# and the two qx paths.
MAIN_PATHS = [
    ("Q4_K_M", "Q4_K_M", 32, "race"),
    ("Q5_K_M", "Q5_K_M", 4, "kernels"),
    ("Q4_K", None, 8, "kernels"),
    ("GPTQ4-g128", ("gptq", 128, False), 32, "race"),
    ("GPTQ4-g128-actorder", ("gptq", 128, True), 4, "kernels"),
    ("Q4_K_M-new", "Q4_K_M", 2, "new"),
    ("Q5_K_M-new", "Q5_K_M", 2, "new"),
    ("GPTQ4-g128-new", ("gptq", 128, False), 2, "new"),
    ("Q4_0", "Q4_0", 8, "race"),
    ("Q8_0", "Q8_0", 8, "race"),
    ("Q4_1", "Q4_1", 4, "kernels"),
    ("Q5_0", "Q5_0", 4, "kernels"),
    ("Q5_1", "Q5_1", 4, "kernels"),
    ("Q4_0-new", "Q4_0", 2, "new"),
    ("Q5_1-new", "Q5_1", 2, "new"),
    ("Q2_K", "Q2_K", 8, "race"),
    ("Q3_K_M", "Q3_K_M", 8, "race"),
    ("Q3_K_S", "Q3_K_S", 4, "kernels"),
    ("Q3_K_L", "Q3_K_L", 4, "kernels"),
    ("Q2_K-new", "Q2_K", 2, "new"),
    ("Q3_K_M-new", "Q3_K_M", 2, "new"),
    ("Q4_K_M-ksplit", "Q4_K_M", 32, "race"),
    ("GPTQ4-g128-ksplit", ("gptq", 128, False), 4, "kernels"),
    ("Q4_0-ksplit", "Q4_0", 4, "kernels"),
    ("Q2_K-ksplit", "Q2_K", 4, "kernels"),
    ("Q3_K_M-ksplit", "Q3_K_M", 4, "kernels"),
    ("Q4_K_M-ksplit-new", "Q4_K_M", 2, "new"),
    ("Q4_K_M-ksplit-rb", "Q4_K_M", 2, "rb"),
    ("Q8_0-rb", "Q8_0", 2, "rb"),
    ("Q4_K_M-qx", "Q4_K_M", 2, "qx"),
    ("Q8_0-qx", "Q8_0", 8, "qx"),
]
PROMPT_LEN = 137  # chunks 128 + 8 + 1
# tiny llamas of phase 4 (2 layers, so layer 1 is a more-bits layer): label,
# K_M mix (None: all-Q4_K), prompt and greedy steps
TINY = dict(n_vocab=512, n_ctx=128, n_embd=256, n_ff=512, n_layer=2)
TINY_MODELS = (
    ("Q4_K", None), ("Q4_K_M", "Q4_K_M"), ("Q5_K_M", "Q5_K_M"),
    ("GPTQ4-g32", ("gptq", 32, False)), ("GPTQ4-g128", ("gptq", 128, False)),
    ("GPTQ4-g32-actorder", ("gptq", 32, True)), ("GPTQ4-g128-actorder", ("gptq", 128, True)),
    ("Q4_0", "Q4_0"), ("Q8_0", "Q8_0"), ("Q5_1", "Q5_1"),
    ("Q2_K", "Q2_K"), ("Q3_K_M", "Q3_K_M"), ("Q3_K_S", "Q3_K_S"),
)
# the same checkpoints with their nibbles packed ksplit (CT_PACK4_LAYOUT)
TINY_KSPLIT_MODELS = (
    ("Q4_K-ksplit", None), ("Q4_K_M-ksplit", "Q4_K_M"), ("Q4_0-ksplit", "Q4_0"),
    ("Q2_K-ksplit", "Q2_K"), ("Q3_K_M-ksplit", "Q3_K_M"),
    ("GPTQ4-g32-ksplit", ("gptq", 32, False)), ("GPTQ4-g128-ksplit", ("gptq", 128, False)),
    ("GPTQ4-g128-actorder-ksplit", ("gptq", 128, True)),
)
# the tiny models served again under the table that names the new modes
TINY_NEW_MODES = ("Q4_K_M", "Q5_K_M", "GPTQ4-g32", "GPTQ4-g128", "Q4_0", "Q8_0", "Q5_1",
                  "Q2_K", "Q3_K_M", "Q4_K_M-ksplit", "GPTQ4-g32-ksplit", "Q2_K-ksplit")
# and under the table that names the reshape-broadcast modes r and rb
TINY_RB_MODES = ("Q4_K_M-ksplit", "Q4_0-ksplit", "GPTQ4-g128-ksplit", "Q8_0")
# and under the table that names qx on the int8 grids, where greedy
# generate_fast (captured decode graphs) must also equal the eager loop
TINY_QX_MODES = ("Q4_K_M", "Q8_0")
TINY_STEPS = 8
# card-vs-CPU logits: the wiring class (a wrong bias fold or split reads
# 10-100%), 10% for Q5_1, whose int8 grid is stored uncentred (q in [0, 31],
# the mins folded apart) so that int8 activation rounding amplifies more, as
# tests/test_torch_legacy.py holds it against the JAX package; 20% for Q2_K,
# whose 2-bit grid is stored as nibbles q - 8 in [-8, -5] (the bias folded
# apart): the JAX package's own q/qx kernels sit 7.4-16.2% from its exact
# path on the tiny Q2_K model (tests/test_torch_kquant_low.py, its 20%
# class), and card against CPU under the fixed rule read 10.87% (equal
# greedy tokens; raced table 2.27%); across seeds 1-8 an H100 against CPU
# reads 2.6-8.6%, while a Q2_K bias with its mins dropped or its sub-mins
# one group off reads 140-161% (scripts/torch_tiny_spread.py). The ksplit
# models (Q2_K-ksplit included) keep the 5% class: their nibbles take the
# f32 and bf16-operand modes, no int8 activation rounding
TINY_LOGIT_CLASS = {"Q5_1": 0.10, "Q2_K": 0.20}
# a seed serves when every greedy step on the CPU keeps its top-2 logits
# this far apart (relative to the top one): card-vs-CPU logits differ by a
# few percent (rounding amplification), which may rightly flip a near-tie;
# Q2_K's differ by up to twice as much as the others', so its steps keep
# twice the margin, and so do the ksplit GPTQ4 g128 llama's: under the
# fixed rule (sb, the bias of a 128-row group folded through f32 group
# sums) its seed 1 read 0.36-0.95% card vs CPU for six steps, then 4.34%
# at a step with a 2.58% margin, where the token flipped, while every
# kernel call agreed with its plain version to 1.12e-6
# (scripts/torch_tiny_flip.py --ksplit)
TINY_MIN_MARGIN = 0.025
TINY_MIN_MARGIN_OF = {"Q2_K": 0.05, "GPTQ4-g128-ksplit": 0.05}
# decode attention at llama-2-7B heads (32 of width 128, n_ctx 2048): (cache
# dtype, head-major, kv heads, n_past of each slot, window, ALiBi). Every
# dtype at n_past 200 and 2000 sequence-major and at 2000 head-major; GQA
# with Mistral-7B's and Llama-3-8B's 8 kv heads; random ALiBi slopes; four
# slots. "ieee_f16" is the kernel's f16 (kv_dtype "f16" names bf16, as in
# the JAX package)
ATTN_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "ieee_f16": torch.float16,
               "int8": torch.int8}
ATTN_CASES = (
    [(d, False, 32, (200,), 256, False) for d in ATTN_DTYPES]
    + [(d, False, 32, (2000,), 2048, False) for d in ATTN_DTYPES]
    + [(d, True, 32, (2000,), 2048, False) for d in ATTN_DTYPES]
    + [("bf16", False, 8, (2000,), 2048, False), ("f32", False, 32, (2000,), 2048, True),
       ("bf16", False, 32, (5, 300, 1000, 2000), 2048, False)]
)
ATTN_HEADS, ATTN_DH, ATTN_CTX = 32, 128, 2048
# f32: the same sums in another order; bf16, f16, int8: q and p rounded at
# the same places as the plain version, which a rounding flip changes only
# where the f32 sums land within an ulp of a boundary
ATTN_TOL = {"f32": 1e-5, "bf16": 1e-4, "ieee_f16": 1e-4, "int8": 1e-4}
# tiny Q4_K_M llama served with these (kv_dtype, CT_KV_LAYOUT) on both devices
TINY_KV = (("bf16", "sm"), ("int8", "sm"), ("f32", "hm"), ("bf16", "hm"), ("int8", "hm"))
# the long-context decode of the 32-layer Q4_K_M file: the prompt as 15
# chunks of 128 tokens (the chunk size phase 3 holds the kernels at), then
# decode steps at window 2048
LONG_PROMPT, LONG_CHUNK, LONG_STEPS = 1920, 128, 32
# the fused decode (LLM.generate_fast): greedy tokens in segments of
# FAST_CHUNK after a FAST_PROMPT-token text prompt (chunks 8 + 1, sizes
# phase 3 holds every kernel at); the tiny models' run
FAST_TOKENS, FAST_CHUNK, FAST_PROMPT = 64, 32, 9
TINY_FAST_TOKENS, TINY_FAST_CHUNK = 24, 8


def log(*a):
    print(*a, flush=True)


def layout_env(label: str) -> dict:
    """The packing a path or tiny model of this label runs under: ksplit
    nibbles where the label says so (CT_PACK4_LAYOUT, read at load),
    else the default (adjk)."""
    return dict(CT_PACK4_LAYOUT="ksplit" if "-ksplit" in label else None)


def is_gptq(mix) -> bool:
    return isinstance(mix, tuple) and mix[0] == "gptq"


def model_path(tmpdir: str, stem: str, mix) -> str:
    """Where write_model puts a checkpoint: a GGUF file, or a directory whose
    name routes it to the GPTQ backend."""
    return os.path.join(tmpdir, f"{stem}-gptq" if is_gptq(mix) else f"{stem}.gguf")


def write_model(path: str, mix, seed: int, big: bool = False, **cfg) -> None:
    """A synthetic llama checkpoint of `mix` (see MAIN_PATHS) at `path`;
    `big` draws the GGUF quant blocks directly instead of quantizing."""
    from ctransformers_tpu_torch.formats.quants import GGMLType
    from ctransformers_tpu_torch.models.synthetic import write_llama_gguf, write_llama_gptq

    if is_gptq(mix):
        write_llama_gptq(path, seed=seed, group=mix[1], act_order=mix[2], **cfg)
    elif big:
        write_llama_gguf(path, wtype=GGMLType.Q4_K, embed_type=GGMLType.F16,
                         synthesize_blocks=True, seed=seed, mix=mix, **cfg)
    else:
        write_llama_gguf(path, seed=seed, mix=mix, **cfg)


def remove_model(path: str) -> None:
    if os.path.isdir(path):
        shutil.rmtree(path)
    elif os.path.exists(path):
        os.remove(path)


def model_size(path: str) -> int:
    if os.path.isdir(path):
        return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
    return os.path.getsize(path)


def cuda_time_ms(fn, reps: int, graph: bool = False) -> float:
    """Mean ms per call of `fn(i)` over `reps` back-to-back calls. With
    graph=True the calls are captured in one CUDA graph and replayed, so
    the time is the device's alone, free of the host's launch cost."""
    fn(0)
    torch.cuda.synchronize()
    run = lambda: [fn(i) for i in range(reps)]  # noqa: E731
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            run()
        run = g.replay
        run()
        torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    run()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def phase_card(K):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(f"[card] {smi}")
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    info = K.build()
    log(f"[card] kernel build {time.perf_counter() - t0:.3f} s "
        f"(compiled {info['compiled']} into {os.path.relpath(info['dir'], HERE)})")
    return smi


def phase_bandwidth() -> float:
    n = 2 << 30
    a = torch.empty(n, dtype=torch.uint8, device="cuda")
    b = torch.empty_like(a)
    ms = cuda_time_ms(lambda i: b.copy_(a), 20)
    gbs = 2 * n / (ms * 1e-3) / 1e9  # read + write
    log(f"[bandwidth] device copy of {n >> 30} GiB: {ms:.4f} ms, {gbs:.1f} GB/s "
        f"(read + write), {100 * gbs * 1e9 / PEAK_BYTES_S:.1f}% of 3.35 TB/s")
    del a, b
    torch.cuda.empty_cache()
    return gbs * 1e9


def random_planes(K, kind: str, kp: int, npad: int, k: int, n: int, gen: torch.Generator):
    """`kind` planes at padded shape (kp, npad) ("ks:<kind>": the nibbles
    of <kind> packed ksplit, random bytes): Q4_K adjk nibbles, Q2_K
    and Q3_K adjk nibbles at group 16 (Q2_K's sub-scales and sub-mins in
    [0, 16), Q3_K's sub-scales in [-32, 32), no mins), the Q6_K / Q5_K int8
    grid, or unfactored planes: adjk nibbles of GPTQ4
    ("GPTQ4/<group>"), Q4_1 or Q4_0, or the Q8_0, Q5_0 or Q5_1 int8 grid,
    with f32 planes s and (where the type has mins) m = -s * zero-point;
    padding rows and columns are zero, as make_qtensor leaves them."""
    from ctransformers_tpu_torch.models.synthetic import K16_PLANE_RANGES
    from ctransformers_tpu_torch.ops.qmatmul import QTensor

    def rnd(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device="cuda", dtype=torch.int8)

    def rand(lo, hi, shape):
        return torch.rand(shape, generator=gen, device="cuda") * (hi - lo) + lo

    if kind.startswith("ks:"):  # any byte is a valid pair of ksplit nibbles
        qt = random_planes(K, kind[3:], kp, npad, k, n, gen)
        qs = torch.randint(0, 256, (kp // 2, npad), generator=gen, device="cuda",
                           dtype=torch.uint8)
        return dataclasses.replace(qt, qs=qs, pack_layout="ksplit")
    layout = kind.split("/")[0]
    group, sf, has_mins, packed = K.LAYOUTS[layout]
    if sf == 0:
        group = int(kind.split("/")[1]) if "/" in kind else group
        rows = kp // 2 if packed else kp
        lo, hi = {"Q8_0": (-128, 128), "Q5_0": (-16, 16), "Q5_1": (0, 32)}.get(layout, (-128, 128))
        qs = rnd(lo, hi, (rows, npad))
        sc = rand(1e-3, 4e-3, (kp // group, npad))
        mn = -(sc * rnd(0, 32 if layout == "Q5_1" else 16, (kp // group, npad)).float()) \
            if has_mins else None
        for a, r in ((qs, k * rows // kp), (sc, k // group), (mn, k // group)):
            if a is not None:
                a[r:] = 0
                a[:, n:] = 0
        return QTensor(qs, sc, mn, layout, group, (kp, npad), packed=packed,
                       zp=K.zero_point(layout), sfactor=0, pack_layout="adjk")
    if packed:
        rows = kp // 2
        # sub-scale range, d range and dmin bound of the layout (Q4_K's, or
        # those of models/synthetic.py's random group-16 blocks)
        r = K16_PLANE_RANGES.get(kind, dict(sub=(0, 64), d=(1e-4, 1e-3), dmin=1e-3))
        qs, sub_s = rnd(-128, 128, (rows, npad)), rnd(*r["sub"], (kp // group, npad))
        sub_m = rnd(0, r["sub"][1], (kp // group, npad)) if has_mins else None
        sd = rand(*r["d"], (kp // 256, npad))
        sm = -rand(0.0, r["dmin"], (kp // 256, npad)) if has_mins else None
    else:
        rows = kp
        q6 = kind == "Q6_K"
        qs = rnd(-32 if q6 else 0, 32, (kp, npad))
        sub_s = rnd(-64 if q6 else 0, 64, (kp // group, npad))
        sd = rand(2e-5, 2e-4, (kp // 256, npad)) if q6 else rand(5e-5, 5e-4, (kp // 256, npad))
        sub_m = rnd(0, 64, (kp // group, npad)) if has_mins else None
        sm = -rand(0.0, 1e-3, (kp // 256, npad)) if has_mins else None
    for a, r in ((qs, k * rows // kp), (sub_s, k // group), (sub_m, k // group),
                 (sd, k // 256), (sm, k // 256)):
        if a is not None:
            a[r:] = 0
            a[:, n:] = 0
    return QTensor(qs, sub_s, sub_m, kind, group, (kp, npad), packed=packed,
                   zp=K.zero_point(kind), sd=sd, sm=sm, sfactor=sf, pack_layout="adjk")


def plane_bytes(qt) -> int:
    return sum(a.numel() * a.element_size() for a in (qt.qs, qt.scales, qt.mins, qt.sd, qt.sm)
               if a is not None)


@contextlib.contextmanager
def env(**kv):
    """Set (or, with None, unset) environment variables for a block."""
    old = {k: os.environ.get(k) for k in kv}
    try:
        for k, v in kv.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def no_shipped_table(qm):
    """Tables read inside the block find no table shipped for any card."""
    shipped, qm._SHIPPED_TABLES = qm._SHIPPED_TABLES, {}
    try:
        yield
    finally:
        qm._SHIPPED_TABLES = shipped


def phase_kernels(K, copy_bw: float):
    """Phase 3 and the race: returns the per-kernel rows and the raced
    table entries {key: {"pick", "kernel", "ms"}}."""
    from ctransformers_tpu_torch.ops import qmatmul as qm

    gen = torch.Generator(device="cuda").manual_seed(0)
    results = collections.defaultdict(list)
    raced = {}
    for kind, sname, runs in KERNEL_CASES:
        k, n = SHAPES[sname]
        kp, npad = qm.padded_shape(k, n)
        base = random_planes(K, kind, kp, npad, k, n, gen)
        wbytes = plane_bytes(base)
        # distinct weight copies cycled between launches: > 3x the 50 MB L2,
        # so every launch streams its weight from device memory as decode does
        copies = [base] + [
            random_planes(K, kind, kp, npad, k, n, gen)
            for _ in range(max(0, math.ceil(150e6 / wbytes) - 1))
        ]
        w_bf16 = qm.dequantize_qtensor(base).to(torch.bfloat16)
        lib_copies = [w_bf16] + [w_bf16.clone() for _ in range(max(0, math.ceil(150e6 / (w_bf16.numel() * 2)) - 1))]
        others = [(K.kernel_name(mode, base), m) for m in RACE_M
                  for mode, _ in qm.mode_candidates(base, m)]
        if not base.packed or base.pack_layout == "ksplit":
            # where a table of rb_mode_entries sends these keys
            others += [(K.kernel_name("r" if m <= 32 else "rb", base), m) for m in RACE_M]
        if not base.packed:  # and where one of qx_mode_entries sends the grids
            others += [(K.kernel_name("qx", base), m) for m in RACE_M if m <= 32]
        others = [r for r in others if r not in runs]
        for j, (name, m) in enumerate(runs + others):
            timed = j < len(runs)
            x = torch.zeros((m, kp), device="cuda")
            x[:, :k] = torch.randn((m, k), generator=gen, device="cuda")
            args = K.quantize_activations(x, base.group) if name in K.PREQUANTIZED else (x,)
            kern, plain = K.KERNELS[name], K.PLAIN[name]
            got = kern(*args, base)
            torch.cuda.synchronize()
            ref = plain(*args, base)
            err = (torch.linalg.norm(got - ref) / torch.linalg.norm(ref)).item()
            max_abs = (got - ref).abs().max().item()
            ok = bool(torch.isfinite(got).all()) and err <= TOL[name]
            ms = cuda_time_ms(lambda i: kern(*args, copies[i % len(copies)]), 50, graph=True)
            plain_ms = lib_ms = float("nan")
            if timed:
                # the least of three single calls: one call now and then reads
                # several times the others (allocator and clock effects)
                plain_ms = min(cuda_time_ms(lambda i: plain(*args, base), 1) for _ in range(3))
                xb = x.to(torch.bfloat16)
                lib_ms = cuda_time_ms(
                    lambda i: torch.matmul(xb, lib_copies[i % len(lib_copies)]), 50, graph=True
                )
            act = sum(a.numel() * a.element_size() for a in args)
            nbytes = wbytes + act + m * npad * 4
            ops = 2 * m * kp * npad
            bound_ms = max(nbytes / PEAK_BYTES_S, ops / PEAK_OF[name]) * 1e3
            bound_copy_ms = nbytes / copy_bw * 1e3
            r = dict(kind=kind, shape=sname, k=k, n=n, m=m, rel_err=err, max_abs_err=max_abs,
                     ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                     bound_copy_ms=bound_copy_ms, bytes=nbytes, ops=ops, timed=timed)
            results[name].append(r)
            q8 = ""
            if timed and name in ("qmm_qx8", "qmm_qx8_legacy"):
                # the q8 kernel with the quantization it needs outside, as qmatmul runs it
                fn, g = K.KERNELS[name.replace("qx8", "q8")], base.group
                q8_ms = cuda_time_ms(lambda i: fn(*K.quantize_activations(x, g),
                                                  copies[i % len(copies)]), 50, graph=True)
                q8 = f" q8_with_quantization_ms={q8_ms:.4f}"
            log(f"[kernels] {name:11s} {kind:9s} {sname:8s} K={k:5d} N={n:5d} m={m:3d} "
                f"rel_err={err:.3e} kernel_ms={ms:.4f} plain_ms={plain_ms:.3f} "
                f"library_ms={lib_ms:.4f} bound_ms={bound_ms:.4f} "
                f"bound_copy_ms={bound_copy_ms:.4f} GB/s={nbytes / ms / 1e6:.0f}{q8} "
                f"{'ok' if ok else 'FAIL'}{'' if timed else ' (held only)'}")
            if not ok:
                raise SystemExit(f"{name} on {kind} at {sname} m={m}: rel err {err:.3e} > {TOL[name]}")
            HELD.add((name, qm.cache_key(m, base)))
        for m in RACE_M:
            res = qm.race(m, base, copies)
            raced[qm.cache_key(m, base)] = res
            times = " ".join(f"{c}={t:.4f}" for c, t in res["ms"].items())
            log(f"[race] {kind:9s} {sname:8s} m={m:3d} over {len(copies)} weights: {times} ms "
                f"-> winner {qm.label(res['pick'])}, best hand-written {qm.label(res['kernel'])}")
        del copies, base, lib_copies, w_bf16
        torch.cuda.empty_cache()
    return results, raced


def phase_attention(A) -> list:
    """Phase 3's decode attention cases (ATTN_CASES): the kernel against its
    plain version on the same cache, its ms replayed in a CUDA graph that
    cycles over the layers of a cache larger than three L2s, the plain
    version's ms, scaled_dot_product_attention's (a boolean mask; a float
    one with ALiBi; none for int8, whose scales no single call takes) and
    the bound of this run's live rows."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for name, hm, hkv, n_past, window, alibi in ATTN_CASES:
        dt = ATTN_DTYPES[name]
        quant = dt == torch.int8
        b, h, dh = len(n_past), ATTN_HEADS, ATTN_DH
        live = sum(n + 1 for n in n_past)  # the K/V rows the slots attend over
        elem = torch.empty(0, dtype=dt).element_size()
        kv_bytes = 2 * live * hkv * (dh * elem + (4 if quant else 0))
        n_layer = min(64, max(2, math.ceil(150e6 / kv_bytes)))
        shape = (n_layer, b, hkv, ATTN_CTX, dh) if hm else (n_layer, b, ATTN_CTX, hkv, dh)
        if quant:
            k, v = (torch.randint(-127, 128, shape, generator=gen, device="cuda",
                                  dtype=torch.int8) for _ in "kv")
            ks, vs = (torch.rand(shape[:-1], generator=gen, device="cuda") * 0.02 + 1e-3
                      for _ in "kv")
        else:
            k, v = (torch.randn(shape, generator=gen, device="cuda").to(dt) for _ in "kv")
            ks = vs = None
        q = torch.randn((b, h, dh), generator=gen, device="cuda")
        npt = torch.tensor(n_past, dtype=torch.int32, device="cuda")
        slopes = torch.rand(h, generator=gen, device="cuda") * 0.1 if alibi else None
        kw = dict(window=window, k_scale=ks, v_scale=vs, alibi_slopes=slopes, head_major=hm)
        got = A.decode_attention(q, k, v, 0, npt, **kw)
        torch.cuda.synchronize()
        ref = A.plain_decode_attention(q, k, v, 0, npt, **kw)
        err = (torch.linalg.norm(got - ref) / torch.linalg.norm(ref)).item()
        max_abs = (got - ref).abs().max().item()
        ok = bool(torch.isfinite(got).all()) and err <= ATTN_TOL[name]
        ms = cuda_time_ms(lambda i: A.decode_attention(q, k, v, i % n_layer, npt, **kw), 50,
                          graph=True)
        plain_ms = min(cuda_time_ms(lambda i: A.plain_decode_attention(q, k, v, 0, npt, **kw), 1)
                       for _ in range(3))
        lib_ms = float("nan")
        if not quant:
            kpos = torch.arange(window, device="cuda")
            mask = (kpos[None, :] <= npt[:, None])[:, None, None, :]
            if alibi:
                mask = torch.where(mask, slopes[None, :, None, None] * kpos.float(),
                                   float("-inf")).to(dt)
            qd = q.to(dt)[:, :, None, :]

            def library(il):
                kl, vl = (a[il] if hm else a[il].transpose(1, 2) for a in (k, v))
                return torch.nn.functional.scaled_dot_product_attention(
                    qd, kl[:, :, :window], vl[:, :, :window], attn_mask=mask,
                    enable_gqa=hkv != h)

            lib_ms = cuda_time_ms(lambda i: library(i % n_layer), 50, graph=True)
        nbytes = kv_bytes + 2 * b * h * dh * 4 + b * 4 + (h * 4 if alibi else 0)
        ops = 4 * live * h * dh
        peak = PEAK_F32_S if dt == torch.float32 else PEAK_BF16_S
        bound_ms = max(nbytes / PEAK_BYTES_S, ops / peak) * 1e3
        what = (f"{name} {'hm' if hm else 'sm'} H={h} Hkv={hkv} n_past={list(n_past)} "
                f"window={window}{' alibi' if alibi else ''}")
        log(f"[attention] decode_attn {what}: rel_err={err:.3e} max_abs_err={max_abs:.3e} "
            f"kernel_ms={ms:.4f} plain_ms={plain_ms:.3f} library_ms={lib_ms:.4f} "
            f"bound_ms={bound_ms:.4f} GB/s={nbytes / ms / 1e6:.0f} over {n_layer} layers "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"decode_attn {what}: rel err {err:.3e} > {ATTN_TOL[name]}")
        rows.append(dict(case=what, rel_err=err, max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=bound_ms, bytes=nbytes, ops=ops, peak=peak))
        del k, v, ks, vs
        torch.cuda.empty_cache()
    return rows


# the probe scripts (scripts/torch_probe_<name>.py) and the PERF.md row of
# each: torch_probe_q5.py's SWAR planes and int16 dots are row 14c, its
# grouped dots row 14g (torch_probe_q5b.py is its timing part alone, the
# same probes: left out here so that no probe is counted twice)
PROBE_ROWS = {"int8_dot": "14a", "bf16_dot": "14b", "int4": "14d", "mmvq": "14e", "q3": "14f",
              "q5": "14g", "dma": "14h"}


def probe_row(script: str, label: str) -> str:
    return "14c" if script == "q5" and label.startswith(("swar", "int16")) else PROBE_ROWS[script]


def phase_probes(PR) -> tuple:
    """The probes phase: each script's probes held against their plain
    versions at the JAX scripts' shapes (those launches do not count), then
    the scripts' timed runs with the probe counts set to 0 just before and
    read just after: the probe path. Fails on a kernel that disagrees or
    was never launched. Returns (held rows, timed rows, launches by symbol)."""
    import importlib.util

    mods = {}
    for name in PROBE_ROWS:
        path = os.path.join(HERE, "scripts", f"torch_probe_{name}.py")
        spec = importlib.util.spec_from_file_location(f"torch_probe_{name}", path)
        mods[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mods[name])
    held, timed = [], []
    for name, mod in mods.items():
        r = PR.Runner("cuda", check=True, time=False,
                      out=lambda line, name=name: log(f"[probes] held {name}: {line}"))
        mod.run(r)
        held += [dict(row, script=name) for row in r.rows]
    PR.reset_counts()
    for name, mod in mods.items():
        r = PR.Runner("cuda", check=False, time=True,
                      out=lambda line, name=name: log(f"[probes] timed {name}: {line}"))
        mod.run(r)
        timed += [dict(row, script=name) for row in r.rows]
    launches = dict(PR.LAUNCHES)
    log(f"[probes] launches over the scripts' timed runs {launches}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise SystemExit(f"probes: kernels never launched on the probe path: {missing}")
    for row_id in sorted(set(PROBE_ROWS.values()) | {"14c"}):
        rows = [r for r in timed if r["symbol"] and probe_row(r["script"], r["label"]) == row_id]
        lib = [r for r in rows if r["library_ms"] is not None]
        log(f"[probes] row {row_id}: kernel_ms={sum(r['ms'] for r in rows):.4f} "
            f"bound_ms={sum(r['bound_ms'] for r in rows):.4f} "
            f"plain_ms={sum(r['plain_ms'] for r in rows):.3f} "
            f"library_ms={sum(r['library_ms'] for r in lib):.4f} against kernel_ms="
            f"{sum(r['ms'] for r in lib):.4f} over {len(lib)} of {len(rows)} probes "
            f"launches={sum(r['launches'] for r in rows)}")
    return held, timed, launches


def phase_tiny_kv(A, tmpdir: str) -> None:
    """A tiny Q4_K_M llama with the caches of TINY_KV on the card and on the
    CPU, both under the fixed rule (the same matmul functions): equal greedy
    tokens, logits within the wiring class (5%), and every decode attention
    call of the card held against its plain version on the same operands."""
    from ctransformers_tpu_torch import AutoModelForCausalLM
    from ctransformers_tpu_torch.models import forward as F

    path = model_path(tmpdir, "tiny_kv_Q4_K_M", "Q4_K_M")
    seed = pick_tiny_seed(path, "Q4_K_M", "Q4_K_M")
    kernel = F.decode_attention
    worst, calls = 0.0, 0

    def checked(*args, **kw):
        nonlocal worst, calls
        out = kernel(*args, **kw)
        ref = A.plain_decode_attention(*args, **kw)
        worst = max(worst, (torch.linalg.norm(out - ref) / torch.linalg.norm(ref)).item())
        calls += 1
        return out

    for kv_dtype, layout in TINY_KV:
        with env(CT_KV_LAYOUT=layout, CT_QMM_AUTOTUNE="0"):
            gpu = AutoModelForCausalLM.from_pretrained(path, kv_dtype=kv_dtype)
            cpu = AutoModelForCausalLM.from_pretrained(path, kv_dtype=kv_dtype, device="cpu")
            if gpu._engine.kv.k.device.type != "cuda" or cpu._engine.kv.k.dtype != gpu._engine.kv.k.dtype:
                raise SystemExit(f"tiny kv {kv_dtype} {layout}: caches {gpu._engine.kv.k.dtype} "
                                 f"on {gpu._engine.kv.k.device}, {cpu._engine.kv.k.dtype}")
            F.decode_attention = checked
            try:
                got = greedy_margins(gpu)
            finally:
                F.decode_attention = kernel
            want = greedy_margins(cpu)
        rel = max(float(np.linalg.norm(a - b) / np.linalg.norm(b)) for a, b in zip(got[1], want[1]))
        log(f"[tiny] Q4_K_M seed {seed} kv_dtype {kv_dtype} CT_KV_LAYOUT={layout}: card vs CPU "
            f"logits rel err (worst of {TINY_STEPS} steps) {rel:.3e}; greedy card {got[0]} "
            f"cpu {want[0]}")
        if rel > 0.05 or got[0] != want[0] or not all(np.isfinite(a).all() for a in got[1]):
            raise SystemExit(f"tiny kv {kv_dtype} {layout}: card and CPU disagree")
    log(f"[tiny] decode_attn calls held against the plain version: {calls}, worst rel err "
        f"{worst:.3e}")
    remove_model(path)
    if not calls or worst > max(ATTN_TOL.values()):
        raise SystemExit("tiny kv: decode_attn disagrees with its plain version (or never ran)")


def empty_context(llm) -> None:
    with warnings.catch_warnings():  # LLM.reset() is marked deprecated
        warnings.simplefilter("ignore")
        llm.reset()


def tiny_prompt() -> list:
    return [1] + [int(t) for t in np.random.default_rng(3).integers(3, TINY["n_vocab"], 71)]


def greedy_margins(llm) -> tuple:
    """Greedy tokens of TINY_STEPS steps after the tiny prompt (chunks
    64 + 8), each step's logits, and each step's top-2 margin relative to
    the top logit."""
    llm.eval(tiny_prompt())
    toks, logits, margins = [], [], []
    for _ in range(TINY_STEPS):
        a = np.asarray(llm.logits, dtype=np.float64)
        top2 = np.sort(a)[-2:]
        logits.append(a)
        margins.append(float((top2[1] - top2[0]) / abs(top2[1])))
        toks.append(int(np.argmax(a)))
        llm.eval([toks[-1]])
    return toks, logits, margins


def pick_tiny_seed(path: str, label: str, mix, max_seed: int = 32) -> int:
    """The first seed from 1 whose tiny model keeps every greedy step's
    top-2 margin on the CPU above the label's minimum (TINY_MIN_MARGIN_OF,
    else TINY_MIN_MARGIN); writes it to `path`."""
    from ctransformers_tpu_torch import AutoModelForCausalLM

    for seed in range(1, max_seed + 1):
        remove_model(path)
        write_model(path, mix, seed, **TINY)
        _, _, margins = greedy_margins(AutoModelForCausalLM.from_pretrained(path, device="cpu"))
        log(f"[tiny] {label} seed {seed}: CPU top-2 margins "
            f"{[round(x, 4) for x in margins]}")
        if min(margins) > TINY_MIN_MARGIN_OF.get(label, TINY_MIN_MARGIN):
            return seed
    raise SystemExit(f"tiny {label}: no seed up to {max_seed} without a greedy near-tie")


def eager_greedy(llm, ids, n: int, every: int) -> tuple:
    """The eager eval/argmax loop from an empty context over `ids`: n greedy
    tokens, the logits after every `every` tokens (and after the last), and
    the loop's ms per token on the host clock."""
    empty_context(llm)
    llm.eval(ids)
    toks, logits = [], {}
    t0 = time.perf_counter()
    for i in range(n):
        toks.append(int(np.argmax(llm.logits)))
        llm.eval([toks[-1]])
        if (i + 1) % every == 0 or i + 1 == n:
            logits[i + 1] = np.array(llm.logits, copy=True)
    return toks, logits, (time.perf_counter() - t0) / n * 1e3


def fused_greedy(llm, prompt: str, n: int, chunk: int) -> tuple:
    """llm.generate_fast greedy (repetition_penalty 1.0) from an empty
    context in segments of `chunk`: its tokens, and the logits at the end of
    each segment by the tokens decoded so far (a tail dropped at EOS
    included)."""
    eng = llm._engine
    seen = {}
    decode = eng.decode

    def recording(*args, **kw):
        out = decode(*args, **kw)
        seen[eng.n_past] = np.array(eng.logits, copy=True)
        return out

    eng.decode = recording
    try:
        empty_context(llm)
        n_prompt = len(llm.tokenize(prompt))
        llm.generate_fast(prompt, max_new_tokens=n, temperature=0.0, repetition_penalty=1.0,
                          chunk=chunk)
    finally:
        del eng.decode
    return llm._context[n_prompt:], {k - n_prompt: v for k, v in seen.items()}


def fused_equals_eager(llm, n: int, fused: tuple, eager: tuple, tag: str) -> list:
    """Hold a fused run (fused_greedy's tokens and segment-end logits)
    against the eager loop's (eager_greedy's): equal tokens (the fused run
    stops at EOS) and bitwise equal, finite logits at every segment end.
    Returns the segment ends."""
    (got, got_logits), (want, want_logits) = fused, eager[:2]
    ends = sorted(got_logits)
    same = [c in want_logits and np.array_equal(got_logits[c], want_logits[c]) for c in ends]
    ok = (got == want[:len(got)] and (len(got) == n or llm.is_eos_token(want[len(got)]))
          and ends and all(same) and all(np.isfinite(v).all() for v in got_logits.values()))
    log(f"{tag} generate_fast greedy {len(got)} tokens: "
        f"{'equal to' if got == want[:len(got)] else 'DIFFERENT from'} the eager loop's; "
        f"logits at segment ends {ends} bitwise equal: {same}")
    if not ok:
        raise SystemExit(f"{tag} fused decode differs from the eager loop: {got} / {want}")
    return ends


def check_fused(llm, prompt: str, n: int, chunk: int, tag: str) -> None:
    """Greedy generate_fast against the eager loop on the same prompt."""
    eager = eager_greedy(llm, llm.tokenize(prompt), n, chunk)
    fused = fused_greedy(llm, prompt, n, chunk)
    fused_equals_eager(llm, n, fused, eager, f"{tag} {chunk}-token segments")


def prompt_of_len(llm, n: int) -> str:
    """A text prompt that tokenizes to n tokens (BOS included)."""
    words = ("the", "big", "cat", "is", "on", "a", "mat", "and", "tells", "me", "story", "once")
    text = ""
    for _ in range(4):
        for w in words:
            cand = f"{text} {w}".strip()
            size = len(llm.tokenize(cand))
            if size == n:
                return cand
            if size < n:
                text = cand
    raise SystemExit(f"no prompt of {n} tokens from {words}")


def phase_tiny(K, tmpdir: str):
    """Tiny llamas (TINY_MODELS) on the card and on the CPU (prompt chunks
    64 + 8, then greedy decode). On the card the race picks each key's
    kernel; the CPU model is served under a table of the card's picks, so
    both compute the same functions. Both are then served under the fixed
    rule (CT_QMM_AUTOTUNE=0). The models of TINY_NEW_MODES are then
    served again on both under a user's table file that names the modes g,
    "", s and GPTQ4 si (CT_QMM_TILE_CACHE with CT_QMM_AUTOTUNE=precompiled).
    Every kernel call of the card runs is held against its plain version on
    the same operands (the kernels' tolerances), each of the kernels must
    run, the greedy tokens must be equal, and the logits must agree
    within the wiring class (5%; TINY_LOGIT_CLASS): they cannot agree much
    closer, because
    bf16 and int8 rounding of the activations turn the ~1e-7 differences of
    the two devices' other ops into whole rounding steps here and there.
    Each model's seed is the first without a greedy near-tie on the CPU
    (pick_tiny_seed)."""
    from ctransformers_tpu_torch import AutoModelForCausalLM
    from ctransformers_tpu_torch.ops import qmatmul as qm

    worst_call = dict.fromkeys(K.KERNELS, 0.0)
    calls = dict.fromkeys(K.KERNELS, 0)
    originals = dict(K.KERNELS)
    card = torch.cuda.get_device_name(0)
    sizes = (64, 8, 1)

    def checked(name):
        def run(*args):
            out = originals[name](*args)
            ref = K.PLAIN[name](*args)
            err = (torch.linalg.norm(out - ref) / torch.linalg.norm(ref)).item()
            worst_call[name] = max(worst_call[name], err)
            calls[name] += 1
            return out
        return run

    def compare(label, what, gpu, gpu_env, cpu, cpu_env):
        """Serve both models from an empty context, each under its own table
        file (the table in force follows CT_QMM_TILE_CACHE at call time)."""
        if gpu.device.type != "cuda" or cpu.device.type != "cpu":
            raise SystemExit(f"tiny: models on {gpu.device} and {cpu.device}")
        for name in originals:
            setattr(K, name, checked(name))
        try:
            with env(**gpu_env):
                races = qm.N_RACES
                empty_context(gpu)
                got = greedy_margins(gpu)
                if qm.N_RACES != races:
                    raise SystemExit(f"tiny {label} {what}: a race inside a forward")
        finally:
            for name, fn in originals.items():
                setattr(K, name, fn)
        with env(**cpu_env):
            empty_context(cpu)
            want = greedy_margins(cpu)
        if not all(np.isfinite(a).all() for a in got[1]):
            raise SystemExit(f"tiny {label}: non-finite logits on the card")
        errs = [float(np.linalg.norm(a - b) / np.linalg.norm(b)) for a, b in zip(got[1], want[1])]
        worst = max(errs)
        log(f"[tiny] {label} {what}: card vs CPU logits rel err (worst of "
            f"{TINY_STEPS} steps) {worst:.3e}, by step {[float(f'{e:.3e}') for e in errs]}; "
            f"greedy card {got[0]} cpu {want[0]}")
        if worst > TINY_LOGIT_CLASS.get(label, 0.05) or got[0] != want[0]:
            log(f"[tiny] {label} {what}: CPU top-2 margins {[round(x, 4) for x in want[2]]}; "
                f"worst kernel call so far { {k: v for k, v in worst_call.items() if calls[k]} }")
            raise SystemExit(f"tiny {label} {what}: card and CPU disagree")

    def picks(eng) -> dict:
        """The table's choice for every key of the engine at `sizes`."""
        table = qm.table(eng.device)
        return {qm.cache_key(m, w): table[qm.cache_key(m, w)]
                for w in qm.qtensors(eng.params) for m in sizes
                if qm.cache_key(m, w) in table}

    tables = {"new": (TINY_NEW_MODES, qm.float_mode_entries, "table naming g, '', s, si, sb"),
              "rb": (TINY_RB_MODES, qm.rb_mode_entries, "table naming r, rb"),
              "qx": (TINY_QX_MODES, qm.qx_mode_entries, "table naming qx")}

    def one(label, mix):
        path = model_path(tmpdir, f"tiny_{label}", mix)
        # a file per model and purpose: a table file is read once per card,
        # not again when its contents change
        cpu_table = os.path.join(tmpdir, f"tiny_{label}_raced_cpu.json")
        seed = pick_tiny_seed(path, label, mix)
        gpu = AutoModelForCausalLM.from_pretrained(path)
        gpu.eval(tiny_prompt())  # races the chunk sizes 64 and 8 (m = 1 raced at load)
        chosen = picks(gpu._engine)
        names = collections.Counter(qm.label(v["pick"]) for v in chosen.values())
        log(f"[tiny] {label} seed {seed}: the race picked {dict(names)} over {len(chosen)} keys")
        qm.save_table(cpu_table, "cpu", chosen)
        cpu_env = dict(CT_QMM_TILE_CACHE=cpu_table, CT_QMM_AUTOTUNE="precompiled")
        cpu = AutoModelForCausalLM.from_pretrained(path, device="cpu")
        compare(label, "raced table", gpu, {}, cpu, cpu_env)
        # the fixed rule on both (the q, q8 and GPTQ q kernels, which the
        # race may leave without a tiny key, and the grids' b)
        rule = dict(CT_QMM_AUTOTUNE="0")
        compare(label, "fixed rule", gpu, rule, cpu, rule)
        qts = qm.qtensors(gpu._engine.params)
        for tag, (labels, make_entries, what) in tables.items():
            if label not in labels:
                continue
            entries = make_entries(qts, sizes)
            card_table = os.path.join(tmpdir, f"tiny_{label}_{tag}_card.json")
            cpu_table = os.path.join(tmpdir, f"tiny_{label}_{tag}_cpu.json")
            qm.save_table(card_table, card, entries)
            qm.save_table(cpu_table, "cpu", entries)
            cpu_env = dict(cpu_env, CT_QMM_TILE_CACHE=cpu_table)
            gpu_env = dict(CT_QMM_TILE_CACHE=card_table, CT_QMM_AUTOTUNE="precompiled")
            with env(**gpu_env):
                gpu = AutoModelForCausalLM.from_pretrained(path)
            if gpu._engine.init_timings["autotune_raced"]:
                raise SystemExit(f"tiny {label}: a race under precompiled")
            compare(label, what, gpu, gpu_env, cpu, cpu_env)
            if tag == "qx":  # the captured decode serves the qx kernels too
                with env(**gpu_env):
                    check_fused(gpu, "the big cat", TINY_FAST_TOKENS, TINY_FAST_CHUNK,
                                f"[tiny] {label} {what}")
                rec = gpu._engine.graph_launches()["recorded"]
                if not rec["qmm_qx8"] + rec["qmm_qx8_legacy"]:
                    raise SystemExit(f"tiny {label}: no qx8 kernel in the captured decode step")
        remove_model(path)

    for label, mix in TINY_MODELS + TINY_KSPLIT_MODELS:
        with env(**layout_env(label)):  # ksplit models are packed so at every load
            one(label, mix)
    log(f"[tiny] every kernel call vs its plain version on the same operands: "
        f"calls {calls}, worst rel err {worst_call}")
    if any(worst_call[k] > TOL[k] or not calls[k] for k in worst_call):
        raise SystemExit("tiny: a kernel disagrees with its plain version (or never ran)")


def expected_launches(eng, chunks) -> dict:
    """Kernel launches and dense calls of one forward per chunk size in
    `chunks`: every quantized matmul weight of the loaded engine (QKV and
    gate/up as the engine fused them) once per chunk, a quantized lm_head
    once at m = 1 (the last token), each by the choice in force
    (ops/qmatmul.py:pick_mode: the table's, or the fixed rule's). Fails on
    a kernel that phase 3 did not hold at that key."""
    from ctransformers_tpu_torch.ops import qmatmul as qm
    from ctransformers_tpu_torch.ops import qmm_kernels as K

    def name(m, w):
        choice = qm.pick_mode(m, w)
        if choice == qm.DENSE:
            return "dense"
        kernel = K.kernel_name(choice[0], w)
        if (kernel, qm.cache_key(m, w)) not in HELD:
            raise SystemExit(f"main: {kernel} is launched at key {qm.cache_key(m, w)}, where "
                             "phase 3 did not hold it against its plain version")
        return kernel

    weights = [w for layer in eng.params["layers"] for w in layer.values()
               if isinstance(w, qm.QTensor)]
    counts = collections.Counter()
    for m in chunks:
        counts.update(name(m, w) for w in weights)
        head = eng.params["lm_head"]
        if isinstance(head, qm.QTensor):  # a GPTQ directory's lm_head is dense
            counts[name(1, head)] += 1
    # decode attention: once a layer in every one-token chunk, never in a longer one
    counts["decode_attn"] = eng.spec.n_layer * list(chunks).count(1)
    return {k: counts.get(k, 0) for k in list(K.LAUNCHES) + ["decode_attn", "dense"]}


def counts_now(K) -> dict:
    from ctransformers_tpu_torch.ops import attention as A

    return dict(K.LAUNCHES, decode_attn=A.LAUNCHES["decode_attn"], dense=K.DENSE_CALLS["dense"])


def reset_counts(K) -> None:
    from ctransformers_tpu_torch.ops import attention as A

    K.reset_counts()
    A.reset_counts()


def serve(K, llm, ids, chunks, label: str, what: str, copy_bw: float, wbytes: int,
          launches: collections.Counter, full: bool) -> None:
    """One served run of a loaded model: the 137-token prompt from an empty
    context (TTFT), 32 decode steps, a profiled few, and with `full` a
    seeded generation twice. The counters are set to 0 just before and read
    just after; prompt and decode launches must equal the counts the
    choices in force give, and no race may run inside."""
    from ctransformers_tpu_torch.ops import qmatmul as qm

    eng = llm._engine
    tag = f"[main {label} | {what}]"
    want_prompt = expected_launches(eng, chunks)
    want_decode = expected_launches(eng, [1])
    races = qm.N_RACES
    reset_counts(K)
    empty_context(llm)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    llm.eval(ids)
    prefill_s = time.perf_counter() - t0
    tok = llm.sample(seed=5, top_k=40, temperature=0.8)
    ttft_s = time.perf_counter() - t0
    prefill_launch = counts_now(K)
    if not np.isfinite(llm.logits).all():
        raise SystemExit(f"{tag} non-finite logits after the prompt")
    n_dec = 32
    sample_s = 0.0
    t0 = time.perf_counter()
    for _ in range(n_dec):
        llm.eval([tok])
        t1 = time.perf_counter()
        tok = llm.sample(seed=5, top_k=40, temperature=0.8)
        sample_s += time.perf_counter() - t1
    dec_s = (time.perf_counter() - t0) / n_dec
    now = counts_now(K)
    dec_launch = {k: (now[k] - prefill_launch[k]) / n_dec for k in now}
    busy_ms, _ = profile_decode(llm, tok, dec_s, f"{label} | {what}")
    if full:
        runs = []
        for _ in range(2):  # each from an empty context: chunks 128 + 8 + 1
            empty_context(llm)
            gen = llm.generate(ids, seed=5, top_k=40, temperature=0.8)
            runs.append(list(itertools.islice(gen, 16)))
            gen.close()
        if runs[0] != runs[1]:
            raise SystemExit(f"{tag} same seed, different tokens {runs}")
        log(f"{tag} seeded generate twice -> identical {runs[0]}")
    launches.update(counts_now(K))
    nz = lambda d: {k: v for k, v in d.items() if v}  # noqa: E731
    log(f"{tag} {PROMPT_LEN}-token prompt (chunks {chunks}): launches {nz(prefill_launch)} "
        f"(expected {nz(want_prompt)})")
    log(f"{tag} decode launches per token {nz(dec_launch)} (expected {nz(want_decode)})")
    log(f"{tag} ttft_ms={ttft_s * 1e3:.2f} prefill_tok_s={len(ids) / prefill_s:.1f} "
        f"decode_ms_per_token={dec_s * 1e3:.3f} (host sampling {sample_s / n_dec * 1e3:.3f}) "
        f"device_busy_ms_per_token={busy_ms:.3f} decode_bound_ms={wbytes / copy_bw * 1e3:.3f} "
        f"(copy) {wbytes / PEAK_BYTES_S * 1e3:.3f} (3.35 TB/s)")
    if prefill_launch != want_prompt or dec_launch != want_decode:
        raise SystemExit(f"{tag} launch counts differ from the choices in force")
    if qm.N_RACES != races:
        raise SystemExit(f"{tag} a race ran inside a served forward")


def phase_main(K, tmpdir: str, copy_bw: float, label: str, mix, n_layer: int, how: str,
               launches: collections.Counter, after=None) -> None:
    """One main path (MAIN_PATHS), its nibbles packed as its label says
    (layout_env). `after(llm, path, ids, chunks, wbytes)`, where given, runs
    last with the model file still on disk and the path's table in force."""
    with env(**layout_env(label)):  # ksplit paths are packed so at every load
        _main_path(K, tmpdir, copy_bw, label, mix, n_layer, how, launches, after)


def _main_path(K, tmpdir, copy_bw, label, mix, n_layer, how, launches, after) -> None:
    from ctransformers_tpu_torch import AutoModelForCausalLM
    from ctransformers_tpu_torch.engine.engine import Engine
    from ctransformers_tpu_torch.models.synthetic import LLAMA2_7B
    from ctransformers_tpu_torch.ops import qmatmul as qm

    cfg = dict(LLAMA2_7B, n_layer=n_layer, n_ctx=2048)
    path = model_path(tmpdir, f"llama7b_{n_layer}l_{label}", mix)
    if is_gptq(mix):
        what = (f"GPTQ 4-bit directory, group {mix[1]}, desc_act {mix[2]}, f16 scales, "
                "embedding and lm_head")
    elif mix:
        what = f"GGUF, llama.cpp {mix} types, {mix[:4]} token_embd"
    else:
        what = "GGUF, Q4_K matmuls, F16 embedding"
    if "-ksplit" in label:
        what += ", nibbles packed ksplit"
    t0 = time.perf_counter()
    write_model(path, mix, seed=7, big=True, **cfg)
    log(f"[main {label}] wrote {model_size(path) / 2**30:.3f} GiB ({n_layer} layers, "
        f"llama-2-7B width, {what}) in {time.perf_counter() - t0:.1f} s")
    chunks = Engine._chunks(PROMPT_LEN, cfg["n_ctx"])
    ids = [1] + [int(t) for t in np.random.default_rng(11).integers(3, cfg["n_vocab"], PROMPT_LEN - 1)]
    user_table = os.path.join(tmpdir, f"user_table_{label}.json")
    # "race": an empty user table (and, below, no shipped one), so the load
    # is cold; "kernels": the script's table without the dense candidate;
    # "new" and "rb": a user's table written below from the loaded engine's
    # keys (float_mode_entries, rb_mode_entries)
    load_env = {
        "race": dict(CT_QMM_TILE_CACHE=user_table),
        "kernels": dict(CT_QMATMUL="kernels"),
        "new": dict(CT_QMM_AUTOTUNE="precompiled"),
        "rb": dict(CT_QMM_AUTOTUNE="precompiled"),
        "qx": dict(CT_QMM_AUTOTUNE="precompiled"),
    }[how]

    def load():
        t0 = time.perf_counter()
        llm = AutoModelForCausalLM.from_pretrained(path)
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        llm.eval(ids)  # a first prompt: picks the kernels of its chunk sizes
        tuned = {m: s for m, s in llm._engine.autotuned.items() if m != 1}
        log(f"[main {label}] load {load_s:.2f} s ({llm._engine.init_timings}); first "
            f"{PROMPT_LEN}-token prompt {time.perf_counter() - t0:.2f} s, chunk sizes tuned: "
            f"{ {m: (s['raced'], s['warm'], round(s['seconds'], 3)) for m, s in tuned.items()} } "
            "(raced, warm, seconds)")
        return llm, load_s

    try:
        torch.cuda.reset_peak_memory_stats()
        # "race" loads as on a card no table was shipped for: this path's
        # table is read inside and holds the user's (empty) file alone
        cold_start = no_shipped_table(qm) if how == "race" else contextlib.nullcontext()
        with env(**load_env), cold_start:
            llm, load_s = load()
            eng = llm._engine
            cold = dict(eng.init_timings)
            if how == "race":
                if not cold["autotune_raced"]:
                    raise SystemExit(f"main {label}: the cold load raced nothing")
                del llm, eng
                torch.cuda.empty_cache()
                # the second load reads the champions back from the user's file
                del qm._TILE_CACHE[(torch.cuda.get_device_name(0), user_table)]
                llm, load_s = load()
                eng = llm._engine
                raced_again = sum(s["raced"] for s in eng.autotuned.values())
                if raced_again or not eng.init_timings["autotune_warm"]:
                    raise SystemExit(f"main {label}: the second load was not warm: {eng.autotuned}")
                log(f"[main {label}] cold load autotune_s={cold['autotune_s']} raced="
                    f"{cold['autotune_raced']}; warm load autotune_s="
                    f"{eng.init_timings['autotune_s']} raced=0 warm={eng.init_timings['autotune_warm']}")
            elif how in ("new", "rb", "qx"):
                # the first load told the keys; a user's table for them, and
                # the load a user of that table would make
                make_entries = {"new": qm.float_mode_entries, "rb": qm.rb_mode_entries,
                                "qx": qm.qx_mode_entries}[how]
                entries = make_entries(qm.qtensors(eng.params), sorted(set(chunks)))
                qm.save_table(user_table, torch.cuda.get_device_name(0), entries)
                load_env = dict(load_env, CT_QMM_TILE_CACHE=user_table)
                del llm, eng
                torch.cuda.empty_cache()
                with env(**load_env):
                    llm, load_s = load()
                eng = llm._engine
                if sum(s["raced"] for s in eng.autotuned.values()):
                    raise SystemExit(f"main {label}: a race under precompiled")
        if after is None:
            remove_model(path)
        qts = qm.qtensors(eng.params)
        wbytes = sum(plane_bytes(q) for q in qts)
        kinds = collections.Counter(q.kind for q in qts)
        log(f"[main {label}] {len(qts)} QTensors {dict(kinds)}, {wbytes / 1e9:.3f} GB of weight "
            f"planes; token_embd {tuple(eng.params['wte'].shape)} {eng.params['wte'].dtype}")
        head = eng.params["lm_head"]
        if not isinstance(head, qm.QTensor):  # dense: a torch.matmul per forward
            wbytes += head.numel() * head.element_size()
            log(f"[main {label}] dense lm_head {tuple(head.shape)} {head.dtype}, "
                f"{head.numel() * head.element_size() / 1e9:.3f} GB")
        args = (K, llm, ids, chunks, label)
        with env(**load_env):
            table = {qm.label(c): n for c, n in collections.Counter(
                qm.pick_mode(m, w) for w in qts for m in sorted(set(chunks))).items()}
            log(f"[main {label}] choices over {len(qts)} weights x chunk sizes "
                f"{sorted(set(chunks))}: {table}")
            if how == "race":
                # text under the raced table, then the fixed rule and the
                # table in turns (rule, table, table, rule)
                for prompt in ("hello world", "the big cat is", "tell me a story once"):
                    text = llm(prompt, max_new_tokens=16, seed=42)
                    log(f"[main {label}] llm({prompt!r}) -> {text!r}")
                for i, rule in enumerate((True, False, False, True)):
                    with env(CT_QMM_AUTOTUNE="0" if rule else None):
                        serve(*args, f"{'fixed rule' if rule else 'raced table'} #{i}", copy_bw,
                              wbytes, launches, full=i == 1)
            else:
                text = llm("hello world", max_new_tokens=16, seed=42)
                log(f"[main {label}] llm('hello world') -> {text!r}")
                serve(*args, {"kernels": "best hand-written kernels",
                              "new": "table naming g, '', s, si, sb",
                              "rb": "table naming r, rb",
                              "qx": "table naming qx"}[how], copy_bw, wbytes,
                      launches, full=True)
                if how == "qx":
                    serve_fast(K, llm, f"{label} | table naming qx", launches, wbytes)
        log(f"[main {label}] load_s={load_s:.3f} peak_mem_gb="
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
        if after is not None:
            with env(**load_env):
                after(llm, path, ids, chunks, wbytes)
    finally:
        remove_model(path)


def serve_fast(K, llm, label: str, launches: collections.Counter, wbytes: int) -> None:
    """The fused decode through llm.generate_fast (one captured CUDA graph a
    key, replayed a token): greedy FAST_TOKENS tokens in segments of
    FAST_CHUNK against the eager loop (equal tokens, bitwise segment-end
    logits; the eager loop's ms per token beside the fused), with the
    counters set to 0 just before the fused run and read just after: the
    wrappers count the prompt and each capture's warm-up step and recorded
    step, the replays launch the recorded step once a token, both against
    the choices in force. Then a second fused run for its ms per token (no
    capture), the device's busy ms per token over one replayed segment
    (torch.profiler), the capture ms, and a seeded sampled run twice."""
    from torch.profiler import ProfilerActivity, profile

    from ctransformers_tpu_torch.engine.engine import Engine
    from ctransformers_tpu_torch.ops import qmatmul as qm

    eng = llm._engine
    tag = f"[fast {label}]"
    prompt = prompt_of_len(llm, FAST_PROMPT)
    ids = llm.tokenize(prompt)
    races = qm.N_RACES
    # the eager reference first (its prompt settles the chunk sizes)
    eager = eager_greedy(llm, ids, FAST_TOKENS, FAST_CHUNK)
    c0, t0_us, g0 = eng.n_compile, eng.t_compile_us, eng.graph_launches()
    reset_counts(K)
    fused = fused_greedy(llm, prompt, FAST_TOKENS, FAST_CHUNK)
    wrapped = counts_now(K)
    g1 = eng.graph_launches()
    ends = fused_equals_eager(llm, FAST_TOKENS, fused, eager, tag)
    captures = eng.n_compile - c0
    capture_ms = (eng.t_compile_us - t0_us) / 1e3 / max(captures, 1)
    recorded = g1["recorded"] - g0["recorded"]
    replayed = g1["replayed"] - g0["replayed"]
    steps = ends[-1]  # tokens the replays decoded (a tail dropped at EOS included)
    executed = {k: v - recorded[k] + replayed[k] for k, v in wrapped.items()}
    want_prompt = expected_launches(eng, Engine._chunks(len(ids), eng.spec.n_ctx))
    want_step = expected_launches(eng, [1])
    want_wrapped = {k: want_prompt[k] + 2 * captures * want_step[k] for k in want_step}
    want_exec = {k: want_prompt[k] + (captures + steps) * want_step[k] for k in want_step}
    nz = lambda d: {k: v for k, v in d.items() if v}  # noqa: E731
    log(f"{tag} {len(ids)}-token prompt, segments of {FAST_CHUNK}: "
        f"{captures} capture(s), {steps} replays; launches counted by the wrappers "
        f"{nz(wrapped)} (expected {nz(want_wrapped)}), run on the card {nz(executed)} "
        f"(expected {nz(want_exec)})")
    if wrapped != want_wrapped or executed != want_exec or captures != 1:
        raise SystemExit(f"{tag} launch counts differ from the choices in force")
    launches.update(executed)
    t = eng.timings()
    fused_greedy(llm, prompt, FAST_TOKENS, FAST_CHUNK)  # replays only: the decode's time
    t2 = eng.timings()
    if eng.n_compile != c0 + captures:
        raise SystemExit(f"{tag} the second run captured again")
    fused_ms = (t2["t_eval_ms"] - t["t_eval_ms"]) / (t2["n_eval"] - t["n_eval"])
    # the device's busy time over one replayed segment
    empty_context(llm)
    llm.eval(ids)
    cfg = llm.config
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            e0.record()
            eng.decode(FAST_CHUNK, top_k=cfg.top_k, top_p=cfg.top_p, temperature=0.0,
                       repetition_penalty=1.0, last_tokens=ids, last_n=cfg.last_n_tokens)
            e1.record()
            torch.cuda.synchronize()
        events = prof.key_averages()
    if eng.n_compile != c0 + captures:
        raise SystemExit(f"{tag} the profiled segment captured again")
    rows = sorted(((e.self_device_time_total / FAST_CHUNK, e.count // FAST_CHUNK, e.key)
                   for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    span_ms = e0.elapsed_time(e1) / FAST_CHUNK
    for us, count, key in rows[:6]:
        log(f"{tag}   {us / 1e3:8.4f} ms/token  {count:4d} launches  {key[:90]}")
    # a seeded sampled run twice
    runs = []
    for _ in range(2):
        empty_context(llm)
        text = llm.generate_fast(prompt, max_new_tokens=FAST_TOKENS, seed=5, top_k=40,
                                 temperature=0.8, chunk=FAST_CHUNK)
        runs.append((text, llm._context[len(ids):]))
    if runs[0] != runs[1] or not runs[0][1]:
        raise SystemExit(f"{tag} same seed, different tokens {runs}")
    if qm.N_RACES != races:
        raise SystemExit(f"{tag} a race ran inside a served forward")
    log(f"{tag} fused_decode_ms_per_token={fused_ms:.3f} eager_decode_ms_per_token="
        f"{eager[2]:.3f} capture_ms={capture_ms:.1f} device_busy_ms_per_token={busy_ms:.3f} "
        f"(idle {100 - 100 * busy_ms / fused_ms:.1f}% of the fused token) "
        f"device_span_ms_per_token={span_ms:.3f} decode_bound_ms={wbytes / PEAK_BYTES_S * 1e3:.3f} "
        f"(3.35 TB/s); seeded sampled generate_fast twice -> identical {runs[0][1][:16]}")


def q4km_paths(K, copy_bw: float, launches: collections.Counter, llm, path: str, ids, chunks,
               wbytes: int) -> None:
    """The after-hook of the 32-layer Q4_K_M path (its raced table warm):
    the fused decode (serve_fast), then the KV dtypes and long context."""
    serve_fast(K, llm, "Q4_K_M | raced table", launches, wbytes)
    kv_paths(K, copy_bw, launches, llm, path, ids, chunks, wbytes)


def kv_paths(K, copy_bw: float, launches: collections.Counter, llm, path: str, ids, chunks,
             wbytes: int) -> None:
    """The 32-layer Q4_K_M file (the after-hook of its main path, so its
    table is warm): the long-context decode with the path's f32 cache, then
    the file loaded again with bf16 and with int8 caches, each served as the
    main path is (137-token prompt and decode), through generate_fast
    (serve_fast) and with the long-context decode; and the cost of one
    layer's cache write per dtype."""
    from ctransformers_tpu_torch import AutoModelForCausalLM

    serve_long(K, llm, "Q4_K_M kv f32", launches)
    for name in ("bf16", "int8"):
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()  # the f32 path's model, still loaded
        t0 = time.perf_counter()
        kl = AutoModelForCausalLM.from_pretrained(path, kv_dtype=name)
        kv = kl._engine.kv
        log(f"[main Q4_K_M kv {name}] load {time.perf_counter() - t0:.2f} s "
            f"({kl._engine.init_timings}); cache {kv.k.dtype} {tuple(kv.k.shape)}, "
            f"{sum(a.numel() * a.element_size() for a in kv if a is not None) / 1e9:.3f} GB")
        serve(K, kl, ids, chunks, f"Q4_K_M kv {name}", "raced table", copy_bw, wbytes, launches,
              full=False)
        serve_fast(K, kl, f"Q4_K_M kv {name} | raced table", launches, wbytes)
        log(f"[main Q4_K_M kv {name}] peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f}, "
            f"of which this model {(torch.cuda.max_memory_allocated() - resident) / 1e9:.2f}")
        serve_long(K, kl, f"Q4_K_M kv {name}", launches, resident)
        del kl, kv
        torch.cuda.empty_cache()
    write_cost(llm._bundle.spec)


def serve_long(K, llm, label: str, launches: collections.Counter, resident: int = 0) -> None:
    """The long-context decode: LONG_PROMPT tokens from an empty context in
    chunks of LONG_CHUNK, then LONG_STEPS decode steps at window 2048 and a
    profiled few. Prompt and decode launches must equal the choices in
    force: decode_attn once a layer a decode token, never in a prompt chunk.
    Peak memory is logged beside the part of it above `resident` (another
    model still loaded)."""
    from ctransformers_tpu_torch.models.forward import round_window
    from ctransformers_tpu_torch.ops import qmatmul as qm

    eng = llm._engine
    spec = eng.spec
    tag = f"[long {label}]"
    ids = [1] + [int(t) for t in np.random.default_rng(13).integers(3, spec.n_vocab,
                                                                    LONG_PROMPT - 1)]
    want_prompt = expected_launches(eng, [LONG_CHUNK] * (LONG_PROMPT // LONG_CHUNK))
    want_decode = expected_launches(eng, [1])
    races = qm.N_RACES
    torch.cuda.reset_peak_memory_stats()
    reset_counts(K)
    empty_context(llm)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(0, LONG_PROMPT, LONG_CHUNK):
        llm.eval(ids[i:i + LONG_CHUNK])
    prefill_s = time.perf_counter() - t0
    prompt_launch = counts_now(K)
    tok = llm.sample(seed=5, top_k=40, temperature=0.8)
    t0 = time.perf_counter()
    for _ in range(LONG_STEPS):
        llm.eval([tok])
        tok = llm.sample(seed=5, top_k=40, temperature=0.8)
    dec_s = (time.perf_counter() - t0) / LONG_STEPS
    now = counts_now(K)
    dec_launch = {k: (now[k] - prompt_launch[k]) / LONG_STEPS for k in now}
    if not np.isfinite(llm.logits).all():
        raise SystemExit(f"{tag} non-finite logits")
    busy_ms, rows = profile_decode(llm, tok, dec_s, label)
    attn_ms = sum(us for us, _, key in rows if "decode_attn" in key) / 1e3
    launches.update(counts_now(K))
    n_past = eng.n_past
    kv = eng.kv
    per_pos = sum(a.numel() // spec.n_ctx * a.element_size() for a in kv if a is not None)
    log(f"{tag} prompt {LONG_PROMPT} tokens in {LONG_PROMPT // LONG_CHUNK} chunks of {LONG_CHUNK}: "
        f"{prefill_s:.2f} s; decode at n_past {n_past - LONG_STEPS - 4}..{n_past - 1}, window "
        f"{round_window(n_past, spec.n_ctx)}: decode_ms_per_token={dec_s * 1e3:.3f} "
        f"device_busy_ms_per_token={busy_ms:.3f} decode_attn_ms_per_token={attn_ms:.3f} "
        f"({100 * attn_ms / busy_ms:.1f}% of busy) cache read per token "
        f"{per_pos * n_past / 1e9:.3f} GB, peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f} "
        f"(this model {(torch.cuda.max_memory_allocated() - resident) / 1e9:.2f})")
    nz = lambda d: {k: v for k, v in d.items() if v}  # noqa: E731
    log(f"{tag} launches: prompt {nz(prompt_launch)} (expected {nz(want_prompt)}); per decode "
        f"token {nz(dec_launch)} (expected {nz(want_decode)})")
    if prompt_launch != want_prompt or dec_launch != want_decode:
        raise SystemExit(f"{tag} launch counts differ from the choices in force")
    if dec_launch["decode_attn"] != spec.n_layer or qm.N_RACES != races:
        raise SystemExit(f"{tag} decode_attn ran {dec_launch['decode_attn']} times a token, or a "
                         "race ran inside")


def write_cost(spec, steps: int = 16, device: str = "cuda") -> None:
    """One layer's cache write (models/forward.py:write_kv) of a decode token
    at the spec's KV heads, per cache dtype: device kernels and ms by
    torch.profiler, and both times the layer count for a token."""
    from torch.profiler import ProfilerActivity, profile

    from ctransformers_tpu_torch.models import forward as F

    for name in ("f32", "bf16", "int8"):
        kv = F.KVCache.create(spec.replace(n_layer=1), 1, device, F.resolve_kv_dtype(name))
        k, v = (torch.randn((1, 1, spec.kv_heads, spec.head_dim), device=device) for _ in "kv")
        F.write_kv(kv, 0, 1000, k, v, F.kv_head_major())
        torch.cuda.synchronize()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for i in range(steps):
                    F.write_kv(kv, 0, 1000 + i, k, v, F.kv_head_major())
                torch.cuda.synchronize()
            events = prof.key_averages()
        dev = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
        n = sum(e.count for e in dev) / steps
        ms = sum(e.self_device_time_total for e in dev) / steps / 1e3
        log(f"[write {name}] one layer's cache write: {n:.1f} kernels, {ms:.4f} ms on the device; "
            f"a {spec.n_layer}-layer token: {n * spec.n_layer:.0f} kernels, "
            f"{ms * spec.n_layer:.3f} ms")


def profile_decode(llm, tok: int, dec_s: float, label: str, steps: int = 4) -> tuple:
    """torch.profiler over a few decode steps: device time by kernel and
    the device's busy share of the unprofiled step time. Returns the busy
    ms per token and the (us per token, launches per token, name) rows."""
    from torch.profiler import ProfilerActivity, profile

    with warnings.catch_warnings():  # "clears events at the end of each cycle"
        warnings.simplefilter("ignore")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                llm.eval([tok])
                tok = llm.sample(seed=5, top_k=40, temperature=0.8)
        events = prof.key_averages()
    rows = []
    for e in events:
        # device-side events only: CPU ops carry their kernels' time too
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
            rows.append((e.self_device_time_total / steps, e.count // steps, e.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    log(f"[profile {label}] decode: device busy {busy_ms:.3f} ms per token = "
        f"{100 * busy_ms / (dec_s * 1e3):.1f}% of the {dec_s * 1e3:.3f} ms step "
        f"(idle {100 - 100 * busy_ms / (dec_s * 1e3):.1f}%)")
    for us, count, key in rows[:8]:
        log(f"[profile {label}]   {us / 1e3:8.4f} ms/token  {count:4d} launches  {key[:90]}")
    return busy_ms, rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--write-table", metavar="PATH",
                    help="save the champions of the race phase as a table file")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from ctransformers_tpu_torch.ops import attention as A
    from ctransformers_tpu_torch.ops import probes as PR
    from ctransformers_tpu_torch.ops import qmatmul as qm
    from ctransformers_tpu_torch.ops import qmm_kernels as K

    t_start = time.perf_counter()
    tmpdir = os.path.join(HERE, "build", "smoke")
    shutil.rmtree(tmpdir, ignore_errors=True)
    os.makedirs(tmpdir)
    # the user's table of this run: starts empty, lives beside the models
    os.environ["CT_QMM_TILE_CACHE"] = os.path.join(tmpdir, "user_table.json")
    seconds = {}  # host seconds per phase and main path, for the log

    def lap(name, t0):
        seconds[name] = round(time.perf_counter() - t0, 1)

    t0 = time.perf_counter()
    smi = phase_card(K)
    copy_bw = phase_bandwidth()
    lap("card, build, bandwidth", t0)
    t0 = time.perf_counter()
    results, raced = phase_kernels(K, copy_bw)
    if opts.write_table:
        qm.save_table(opts.write_table, torch.cuda.get_device_name(0), raced, qm.power_limit())
        log(f"[race] wrote {len(raced)} champions to {opts.write_table}")
    lap("kernels and race", t0)
    t0 = time.perf_counter()
    attn_rows = phase_attention(A)
    lap("attention", t0)
    t0 = time.perf_counter()
    probe_held, probe_timed, probe_launches = phase_probes(PR)
    lap("probes", t0)
    t0 = time.perf_counter()
    phase_tiny(K, tmpdir)
    phase_tiny_kv(A, tmpdir)
    lap("tiny", t0)
    launches = collections.Counter()
    for label, mix, n_layer, how in MAIN_PATHS:
        t0 = time.perf_counter()
        # the 32-layer Q4_K_M file also serves the fused decode, the KV dtypes
        # and the long context
        after = (functools.partial(q4km_paths, K, copy_bw, launches) if label == "Q4_K_M"
                 else None)
        phase_main(K, tmpdir, copy_bw, label, mix, n_layer, how, launches, after)
        lap(f"main {label}", t0)
    log(f"[main] launches over the served runs {dict(launches)}")
    missing = [k for k in list(K.LAUNCHES) + list(A.LAUNCHES) if launches[k] == 0]
    if missing:
        raise SystemExit(f"main: kernels never launched on the main paths: {missing}")

    # one entry per kernel: times and bounds summed over its timed shapes and
    # batch sizes in phase 3 (KERNEL_CASES), the worst error over every row
    # it was held at, launches summed over the served runs of phase 5
    kernels = []
    for name in K.KERNELS:
        rows = [r for r in results[name] if r["timed"]]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": K.SOURCE_OF[name],
            "replaces": K.REPLACES[name],
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in results[name]),
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": "operations" if sum(r["ops"] / PEAK_OF[name] for r in rows)
            > sum(r["bytes"] / PEAK_BYTES_S for r in rows) else "bytes",
            "library_ms": sum(r["library_ms"] for r in rows),
        })
    # decode attention: sums over the phase-3 cases that have a library call
    # (the int8 ones have none), the worst error over every case
    timed = [r for r in attn_rows if r["library_ms"] == r["library_ms"]]
    kernels.append({
        "name": "decode_attn",
        "route": "cuda",
        "source": A.SOURCE,
        "replaces": A.REPLACES,
        "launches": launches["decode_attn"],
        "max_abs_err": max(r["max_abs_err"] for r in attn_rows),
        "ms": sum(r["ms"] for r in timed),
        "plain_ms": sum(r["plain_ms"] for r in timed),
        "bound_ms": sum(r["bound_ms"] for r in timed),
        "bound_by": "operations" if sum(r["ops"] / r["peak"] for r in timed)
        > sum(r["bytes"] / PEAK_BYTES_S for r in timed) else "bytes",
        "library_ms": sum(r["library_ms"] for r in timed),
    })
    # the probes: sums over each symbol's timed probes, the worst error over
    # every probe it was held at, launches over the scripts' timed runs; the
    # library ms summed over the probes that have one torch call computing
    # their function (null where none has), beside the kernel ms over those
    # same probes (ms_with_library) and their count (library_of)
    for sym in PR.LAUNCHES:
        rows = [r for r in probe_timed if r["symbol"] == sym]
        lib = [r for r in rows if r["library_ms"] is not None]
        kernels.append({
            "name": sym,
            "route": "cuda",
            "source": PR.SOURCE_OF[sym],
            "replaces": PR.REPLACES[sym],
            "launches": probe_launches[sym],
            "max_abs_err": max(r["max_abs_err"] for r in probe_held if r["symbol"] == sym),
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": "operations" if sum(r["ops"] / r["peak"] for r in rows)
            > sum(r["bytes"] / PEAK_BYTES_S for r in rows) else "bytes",
            "library_ms": sum(r["library_ms"] for r in lib) if lib else None,
            "library_of": f"{len(lib)} of {len(rows)} probes",
            "ms_with_library": sum(r["ms"] for r in lib),
        })
    log(f"[done] {time.perf_counter() - t_start:.1f} s; seconds by phase {seconds}")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
