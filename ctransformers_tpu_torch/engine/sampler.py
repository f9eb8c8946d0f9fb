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

`sample_device` is the chain of the fused decode loop (engine/engine.py:
Engine.decode) in torch ops on device tensors, the counterpart of the JAX
package's sample_device: temperature, repetition penalty, top-k, top-p,
then a Gumbel-max draw, argmax(l + G), which is how jax.random.categorical
draws. The noise G comes from `gumbel_noise`, a whole segment at a time
from a torch.Generator seeded by (seed, segment index), as the JAX package
folds the segment index into its key: deterministic per seed, but not the
JAX PRNG's stream, so the two agree in distribution, not draw for draw.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch


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


# -- the on-device chain of the fused decode loop ----------------------------


def sample_device(
    logits: torch.Tensor,  # (V,) f32
    noise: torch.Tensor,  # (V,) f32 Gumbel noise (gumbel_noise), read when temperature > 0
    last_tokens: torch.Tensor,  # (L,) int32, -1 = empty slot
    *,
    top_k: int,
    top_p: float,
    temperature: float,
    repetition_penalty: float,
) -> torch.Tensor:
    """One token id as a (1,) int32 tensor on the logits' device: argmax at
    temperature <= 0; otherwise logits / temperature, the sign-dependent
    repetition penalty on the ids in `last_tokens`, top-k (ties at the k-th
    value kept), top-p (a sorted token stays while the mass before it is
    below top_p), then argmax(l + noise). Only device ops with no host
    synchronisation, so a CUDA graph can capture it."""
    v = logits.shape[0]
    if temperature <= 0.0:
        return torch.argmax(logits).to(torch.int32).view(1)
    inf = float("inf")
    # tensor divisors: on the card torch divides by a Python scalar as a
    # product with its reciprocal, which can miss the IEEE quotient by an ulp
    l = logits.float()
    l = l / torch.full_like(l, temperature)
    if repetition_penalty != 1.0:
        ids = torch.where(last_tokens >= 0, last_tokens, v).to(torch.int64)
        seen = torch.zeros(v + 1, dtype=torch.bool, device=l.device).index_fill_(0, ids, True)
        pen = torch.where(l > 0, l / torch.full_like(l, repetition_penalty),
                          l * repetition_penalty)
        l = torch.where(seen[:v], pen, l)
    k = min(int(top_k) if top_k > 0 else v, v)
    if k < v:
        kth = torch.topk(l, k).values[-1]
        l = torch.where(l < kth, -inf, l)
    if top_p < 1.0:
        vals = torch.sort(l, descending=True).values
        probs = torch.softmax(vals, 0)
        cum = torch.cumsum(probs, 0)
        keep = (cum - probs) < top_p
        thr = torch.where(keep, vals, inf).amin()
        l = torch.where(l < thr, -inf, l)
    return torch.argmax(l + noise).to(torch.int32).view(1)


def segment_seed(seed: int, segment: int) -> int:
    """The generator seed of segment `segment` of a decode seeded `seed`:
    the pair packed into 64 bits and mixed by splitmix64's finalizer (a
    bijection), so distinct pairs get distinct seeds whose low 32 bits, all
    that the CPU generator reads, differ too."""
    mask = (1 << 64) - 1
    z = ((((int(seed) & 0x7FFFFFFF) << 32) | (int(segment) & 0xFFFFFFFF))
         + 0x9E3779B97F4A7C15) & mask
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & mask
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
    return (z ^ (z >> 31)) >> 1


def gumbel_noise(out: torch.Tensor, seed: int, segment: int) -> torch.Tensor:
    """Fill `out` (k, V) f32 with Gumbel noise -log(-log(u)), u uniform from
    a generator on out's device seeded by segment_seed: row i serves the
    segment's i-th draw."""
    gen = torch.Generator(device=out.device).manual_seed(segment_seed(seed, segment))
    torch.rand(out.shape, generator=gen, out=out)
    tiny = torch.finfo(torch.float32).tiny
    return out.clamp_min_(tiny).log_().neg_().log_().neg_()
