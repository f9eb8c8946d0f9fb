"""Host token samplers (numpy copies of ctransformers_tpu/engine/sampler.py).

`sample_gpt` is the shared example-model sampler (gpt_sample_top_k_top_p):
temperature scaling, sign-dependent repetition penalty on the scaled
logits, top-k, softmax, top-p truncation + renormalize, categorical draw.

`sample_llama` is the llama.cpp chain of the GGUF path: repetition penalty
on raw logits, top-k, top-p, temperature, draw. `sample_llama_decayed` is
the GPTQ path's: the same chain with a penalty that fades with a token's
age (rep_penalty_mask).

The RNG is numpy's MT19937 (np.random.RandomState), seeded as the JAX
package seeds it, so the port draws the same tokens seed for seed.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np


def _resolve_seed(seed: int) -> int:
    if seed < 0:
        seed = int(time.time())  # reference: time(nullptr) (llm.h:67-69)
    return seed & 0xFFFFFFFF


def _draw(probs: np.ndarray, rng: np.random.RandomState) -> int:
    cdf = np.cumsum(probs)
    u = rng.random_sample() * cdf[-1]
    return int(np.searchsorted(cdf, u, side="right").clip(0, len(probs) - 1))


def sample_gpt(
    logits: np.ndarray,
    *,
    top_k: int,
    top_p: float,
    temperature: float,
    repetition_penalty: float,
    last_tokens: Sequence[int],
    seed: int,
    rng: Optional[np.random.RandomState] = None,
) -> int:
    """gpt_sample_top_k_top_p semantics (common.h:127-207)."""
    if rng is None:
        rng = np.random.RandomState(_resolve_seed(seed))
    n = logits.shape[0]
    # temperature <= 0 is greedy (penalty still applies). The reference
    # multiplies by 1/temp here, which at temp=0 turns zero logits into
    # NaN (0 * inf) and poisons the draw — greedy is the only sane
    # reading and matches sample_llama / the device sampler.
    greedy = temperature <= 0
    scaled = logits.astype(np.float64) * (1.0 if greedy else 1.0 / temperature)

    for tok in set(int(t) for t in last_tokens):
        if 0 <= tok < n:
            if scaled[tok] <= 0:
                scaled[tok] *= repetition_penalty
            else:
                scaled[tok] /= repetition_penalty

    if greedy:
        return int(np.argmax(scaled))

    top_k = max(1, min(int(top_k) if top_k > 0 else n, n))
    idx = np.argpartition(-scaled, top_k - 1)[:top_k]
    idx = idx[np.argsort(-scaled[idx], kind="stable")]
    vals = scaled[idx]

    probs = np.exp(vals - vals.max())
    probs /= probs.sum()

    if top_p < 1.0:
        cum = np.cumsum(probs)
        cut = int(np.searchsorted(cum, top_p, side="left")) + 1
        cut = min(cut, len(probs))
        probs = probs[:cut] / cum[cut - 1]
        idx = idx[:cut]

    return int(idx[_draw(probs, rng)])


def _llama_tail(l: np.ndarray, top_k: int, top_p: float, temperature: float,
                rng: np.random.RandomState) -> int:
    """top_k -> top_p -> temperature -> draw on penalized f64 logits `l`:
    the end of both llama chains."""
    n = l.shape[0]
    if temperature <= 0:
        return int(np.argmax(l))  # greedy path

    top_k = min(int(top_k) if top_k > 0 else n, n)
    idx = np.argpartition(-l, top_k - 1)[:top_k] if top_k < n else np.arange(n)
    idx = idx[np.argsort(-l[idx], kind="stable")]
    vals = l[idx]

    probs = np.exp(vals - vals.max())
    probs /= probs.sum()

    if top_p < 1.0 and len(probs) > 1:
        cum = np.cumsum(probs)
        # llama_sample_top_p keeps at least 1 candidate, cuts when cum >= p
        cut = int(np.searchsorted(cum, top_p, side="left")) + 1
        cut = min(cut, len(probs))
        probs = probs[:cut]
        idx = idx[:cut]

    # temperature applied to remaining logits, then softmax + draw
    vals = vals[: len(idx)] / temperature
    probs = np.exp(vals - vals.max())
    probs /= probs.sum()
    return int(idx[_draw(probs, rng)])


def sample_llama(
    logits: np.ndarray,
    *,
    top_k: int,
    top_p: float,
    temperature: float,
    repetition_penalty: float,
    last_tokens: Sequence[int],
    seed: int,
    rng: Optional[np.random.RandomState] = None,
) -> int:
    """llama.cpp chain: repetition -> top_k -> top_p -> temperature -> draw
    (reference models/llms/llama.cc:53-84, llama.cpp:3805-4332)."""
    if rng is None:
        rng = np.random.RandomState(_resolve_seed(seed))
    n = logits.shape[0]
    l = logits.astype(np.float64).copy()

    # llama_sample_repetition_penalty (llama.cpp:4025)
    for tok in set(int(t) for t in last_tokens):
        if 0 <= tok < n:
            if l[tok] <= 0:
                l[tok] *= repetition_penalty
            else:
                l[tok] /= repetition_penalty

    return _llama_tail(l, top_k, top_p, temperature, rng)


def rep_penalty_mask(
    n_vocab: int,
    last_tokens: Sequence[int],
    penalty_max: float,
    sustain: int,
    decay: int,
) -> np.ndarray:
    """Per-vocab repetition-penalty factors with a decaying window — the
    GPTQ twin's schedule (reference ctransformers/gptq/llm.py:174-176 maps
    token_repetition_penalty_max=penalty, _sustain=last_n_tokens,
    _decay=last_n_tokens//2 onto ExLlama's generator settings).

    Walking back from the newest token: the most recent `sustain` tokens
    carry the full `penalty_max`; each step further back fades the factor
    linearly toward 1.0 over `decay` positions; tokens older than
    sustain+decay are unpenalized. A token appearing at several ages keeps
    its strongest (most recent) factor.
    """
    mask = np.ones(n_vocab, np.float64)
    seq = [int(t) for t in last_tokens]
    sustain, decay = int(sustain), max(int(decay), 0)
    dv = (1.0 - penalty_max) / decay if decay > 0 else 0.0
    for i in range(len(seq) - 1, -1, -1):
        age = len(seq) - 1 - i  # 0 = most recent
        if age < sustain:
            v = float(penalty_max)
        elif age < sustain + decay:
            v = penalty_max + (age - sustain + 1) * dv
        else:
            break  # older tokens are unpenalized
        t = seq[i]
        if 0 <= t < n_vocab and abs(v - 1.0) > abs(mask[t] - 1.0):
            mask[t] = v
    return mask


def sample_llama_decayed(
    logits: np.ndarray,
    *,
    top_k: int,
    top_p: float,
    temperature: float,
    repetition_penalty: float,
    last_tokens: Sequence[int],
    seed: int,
    sustain: int,
    decay: int,
    rng: Optional[np.random.RandomState] = None,
) -> int:
    """llama chain with the GPTQ backend's decaying repetition penalty
    (see rep_penalty_mask). `last_tokens` should cover sustain+decay
    positions of context."""
    if rng is None:
        rng = np.random.RandomState(_resolve_seed(seed))
    n = logits.shape[0]
    l = logits.astype(np.float64).copy()
    mask = rep_penalty_mask(n, last_tokens, repetition_penalty, sustain, decay)
    pen = mask != 1.0
    pos = pen & (l > 0)
    neg = pen & (l <= 0)
    l[pos] /= mask[pos]
    l[neg] *= mask[neg]
    return _llama_tail(l, top_k, top_p, temperature, rng)
