"""Inference engine: owns the device params and the KV cache, and runs the
forward pass over prompt chunks and the fused decode loop
(ctransformers_tpu/engine/engine.py).

Prompts are split into power-of-two chunks (largest first), and attention
reads the round_window bucket covering each chunk, exactly as in the JAX
package, so the two run the same sequence of matmul shapes. PyTorch runs
eagerly. As in the JAX package, the kernel of every quantized weight is
picked before it is served (ops/qmatmul.py:autotune): at load for m = 1,
and before the first prompt chunk of each size, outside the timed spans.

The fused decode loop (decode, decode_chunked) is the JAX package's
compiled scan as a CUDA graph: one decode step (the device sampler, then a
one-token forward at a device position) is captured once per graph key and
replayed once per token, reading and writing static device buffers
(_DecodeState) that the step itself advances. Per segment the host uploads
[n_past, last tokens...] once, fills the segment's Gumbel noise on the
device, replays, and downloads (logits, tokens) once. On the CPU (tests,
by request) the same step runs eagerly. A failed capture or replay raises;
there is no switch back to the eager loop on the card.
"""

from __future__ import annotations

import collections
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..models.forward import KVCache, forward, round_window
from ..models.spec import ArchSpec
from ..ops import attention
from ..ops import qmatmul as qm
from ..ops import qmm_kernels
from ..utils import resolve_device
from .sampler import gumbel_noise, sample_device

# f32 matmuls (dense weights, attention) run in full f32 on the card, as the
# JAX package pins "highest" precision: TF32 would keep ~3 decimal digits.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


# the environment a one-token forward reads, so a captured step holds only
# under the values it was captured with: pick_mode's (each matmul's kernel)
# and the KV cache layout (models/forward.py:kv_head_major)
GRAPH_SETTINGS = qm.PICK_SETTINGS + ("CT_KV_LAYOUT",)


def launch_counts() -> Dict[str, int]:
    """The launch counters of every kernel wrapper (ops/qmm_kernels.py, and
    decode_attn of ops/attention.py) and the dense candidate's calls."""
    return dict(qmm_kernels.LAUNCHES, **attention.LAUNCHES, **qmm_kernels.DENSE_CALLS)


class _DecodeState:
    """The static device buffers of the decode step: aux = [n_past, last
    tokens...] int32 (n_past and the `last` ring are views of it, so one
    upload sets both), the logits the next draw reads, the segment's noise
    (cap, V), the step counter and the token of each step (cap,)."""

    def __init__(self, vocab: int, last_n: int, cap: int, device: torch.device):
        self.aux = torch.full((1 + last_n,), -1, dtype=torch.int32, device=device)
        self.n_past = self.aux[:1]
        self.last = self.aux[1:]
        self.logits = torch.zeros(vocab, dtype=torch.float32, device=device)
        self.noise = torch.zeros((cap, vocab), dtype=torch.float32, device=device)
        self.step = torch.zeros(1, dtype=torch.int64, device=device)
        self.toks = torch.zeros(cap, dtype=torch.int32, device=device)


class _Graph:
    """A captured decode step, the kernel launches recorded into it (the
    wrappers count at capture) and how many times it was replayed."""

    def __init__(self, graph, launches: Dict[str, int]):
        self.graph = graph
        self.launches = launches
        self.replays = 0


def _place(a, device: torch.device):
    if isinstance(a, qm.QTensor):
        return a.to(device)
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))
    if t.is_floating_point():
        # f16 file tables upcast on the device after the copy (bit-identical)
        return t.to(device).float()
    return t.to(device)


class Engine:
    def __init__(
        self,
        spec: ArchSpec,
        params,
        device="cuda",
        kv_dtype: torch.dtype = torch.float32,
    ):
        self.spec = spec
        self.device = resolve_device(device)
        t0 = time.perf_counter()
        build_s = 0.0
        if self.device.type == "cuda":
            qmm_kernels.build()
            build_s = time.perf_counter() - t0
        self.params = {
            k: (
                [{lk: _place(lv, self.device) for lk, lv in layer.items()} for layer in v]
                if k == "layers"
                else _place(v, self.device)
            )
            for k, v in params.items()
        }
        # one kernel call for QKV and one for gate+up instead of five
        qm.fuse_layer_params(self.params)
        self._sync()
        place_s = time.perf_counter() - t0 - build_s
        # pick the decode kernels now: a cold table races them here, not
        # inside the first token (a warm one costs nothing)
        tune = qm.autotune(self.params, batch_sizes=(1,))
        self.autotuned = {1: tune}  # chunk size -> autotune stats
        self.init_timings = {
            "kernel_build_s": round(build_s, 3),
            "place_fuse_s": round(place_s, 3),
            "autotune_s": round(tune["seconds"], 3),
            "autotune_raced": tune["raced"],
            "autotune_warm": tune["warm"],
        }
        self.kv_dtype = kv_dtype  # reset and rewind keep it (and the cache)
        self.kv = KVCache.create(spec, 1, self.device, kv_dtype)
        self.n_past = 0
        self._logits_host: Optional[np.ndarray] = None  # (V,) host copy
        self._logits_dev: Optional[torch.Tensor] = None  # (V,) device copy
        # the host copy as last downloaded: decode() reuses the device copy
        # while the host copy still equals it (an edit must steer the draw)
        self._logits_snap: Optional[np.ndarray] = None
        self._hidden_host: Optional[np.ndarray] = None
        self._hidden_dev: Optional[torch.Tensor] = None
        self._states: Dict[tuple, _DecodeState] = {}  # (last_n, cap) -> buffers
        self._graphs: Dict[tuple, _Graph] = {}  # graph_key -> captured step
        self._capture_stream: Optional[torch.cuda.Stream] = None
        # timing counters (reference: llama_get_timings)
        self.t_p_eval_us = 0  # prompt eval
        self.t_eval_us = 0  # decode eval
        self.t_sample_us = 0  # the segments' noise draws (the rest runs in the step)
        self.t_compile_us = 0  # decode-step captures
        self.n_p_eval = 0
        self.n_eval = 0
        self.n_sample = 0
        self.n_compile = 0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @property
    def logits(self) -> Optional[np.ndarray]:
        """(V,) last-token logits, writable (edits affect sampling); copied
        from the device on first read."""
        if self._logits_host is None and self._logits_dev is not None:
            self._logits_host = self._logits_dev.cpu().numpy().copy()
            self._logits_snap = self._logits_host.copy()
        return self._logits_host

    @logits.setter
    def logits(self, value) -> None:
        # a new host value replaces the device copy too: None leaves no
        # stale logits behind for a later read, and decode() raises until
        # the next eval()
        self._logits_host = None if value is None else np.asarray(value, np.float32)
        self._logits_dev = None
        self._logits_snap = None

    @property
    def hidden(self) -> Optional[np.ndarray]:
        """(D,) last hidden state, copied from the device on first read."""
        if self._hidden_host is None and self._hidden_dev is not None:
            self._hidden_host = self._hidden_dev.cpu().numpy().copy()
        return self._hidden_host

    @staticmethod
    def _chunks(n: int, cap: int) -> List[int]:
        """Binary decomposition of n (largest power-of-two chunks first)."""
        out = []
        bit = 1 << (max(n, 1).bit_length() - 1)
        bit = min(bit, 1 << (cap.bit_length() - 1))
        while n > 0:
            while bit > n:
                bit >>= 1
            out.append(bit)
            n -= bit
        return out

    @torch.inference_mode()
    def eval(self, tokens: Sequence[int], n_past: Optional[int] = None) -> None:
        """Run the forward pass over `tokens` starting at `n_past`."""
        if n_past is None:
            n_past = self.n_past
        tokens = list(tokens)
        if not tokens:
            return
        # never write past the window
        n_past = max(min(n_past, self.spec.n_ctx - len(tokens)), 0)
        sizes = self._chunks(len(tokens), self.spec.n_ctx)
        for size in sizes:
            if size not in self.autotuned:
                # the first chunk of this size: pick its kernels before the
                # timed span (one time per weight shape and m; a table hit
                # costs nothing)
                self.autotuned[size] = qm.autotune(self.params, batch_sizes=(size,))
        t0 = time.perf_counter()
        pos = 0
        for size in sizes:
            chunk = torch.tensor(
                [tokens[pos : pos + size]], dtype=torch.int64
            ).to(self.device)
            w = round_window(n_past + pos + size, self.spec.n_ctx)
            logits, hidden = forward(
                self.spec, self.params, chunk, n_past + pos, self.kv, attn_window=w
            )
            pos += size
        self._sync()  # the timer charges device compute
        self._logits_dev = logits[0]
        self._logits_host = None
        self._logits_snap = None
        self._hidden_dev = hidden[0]
        self._hidden_host = None
        self.n_past = n_past + len(tokens)
        dt_us = int((time.perf_counter() - t0) * 1e6)
        if len(tokens) > 1:
            self.t_p_eval_us += dt_us
            self.n_p_eval += len(tokens)
        else:
            self.t_eval_us += dt_us
            self.n_eval += 1

    # -- fused decode loop ------------------------------------------------------

    def _state(self, last_n: int, cap: int) -> _DecodeState:
        key = (last_n, cap)
        if key not in self._states:
            self._states[key] = _DecodeState(self.spec.n_vocab, last_n, cap, self.device)
        return self._states[key]

    def graph_key(self, cap: int, window: int, last_n: int, cfg: tuple) -> tuple:
        """What a captured decode step depends on besides its buffers: the
        noise capacity, the attention window, the `last` ring's length, the
        sampler settings (top_k, top_p, temperature, repetition_penalty),
        the cache dtype and every setting a one-token forward reads
        (GRAPH_SETTINGS, as they are now)."""
        return (cap, window, last_n) + tuple(cfg) + (self.kv_dtype,) + tuple(
            os.environ.get(k) for k in GRAPH_SETTINGS)

    def _decode_step(self, st: _DecodeState, cfg: tuple, window: int) -> None:
        """One token: draw from st.logits with the step's noise row, record
        it, push it on the `last` ring, run the one-token forward at the
        device position st.n_past, and advance n_past and the step. Device
        ops only: this is what a graph captures."""
        top_k, top_p, temperature, repetition_penalty = cfg
        noise = st.noise.index_select(0, st.step)[0]
        tok = sample_device(st.logits, noise, st.last, top_k=top_k, top_p=top_p,
                            temperature=temperature, repetition_penalty=repetition_penalty)
        st.toks.index_copy_(0, st.step, tok)
        st.last.copy_(torch.cat([st.last[1:], tok]))
        logits, _ = forward(self.spec, self.params, tok.view(1, 1).to(torch.int64), st.n_past,
                            self.kv, attn_window=window)
        st.logits.copy_(logits[0])
        st.n_past.add_(1)
        st.step.add_(1)

    def _capture(self, key: tuple, st: _DecodeState, cfg: tuple, window: int) -> _Graph:
        """Capture the decode step on st. One eager step first, on the
        capture stream (it settles every key's kernel outside the capture
        and warms the stream), then st is put back: its cache row is
        written again, with the same values, by the first replay."""
        if self._capture_stream is None:
            self._capture_stream = torch.cuda.Stream(self.device)
        stream = self._capture_stream
        aux, logits = st.aux.clone(), st.logits.clone()
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            self._decode_step(st, cfg, window)
        torch.cuda.current_stream(self.device).wait_stream(stream)
        st.aux.copy_(aux)
        st.logits.copy_(logits)
        st.step.zero_()
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            self._decode_step(st, cfg, window)
        after = launch_counts()
        recorded = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        self._graphs[key] = _Graph(graph, recorded)
        return self._graphs[key]

    def graph_launches(self) -> Dict[str, collections.Counter]:
        """Kernel launches of the captured steps: "recorded", what the
        wrappers counted while graphs were captured (no kernel ran then),
        and "replayed", what the replays launched on the card (each graph's
        recorded launches times its replays)."""
        recorded, replayed = collections.Counter(), collections.Counter()
        for g in self._graphs.values():
            recorded.update(g.launches)
            replayed.update({k: v * g.replays for k, v in g.launches.items()})
        return {"recorded": recorded, "replayed": replayed}

    @torch.inference_mode()
    def decode(
        self,
        n: int,
        *,
        top_k: int = 40,
        top_p: float = 0.95,
        temperature: float = 0.8,
        repetition_penalty: float = 1.1,
        last_tokens: Sequence[int] = (),
        last_n: int = 64,
        seed: int = 0,
        segment: int = 0,
    ) -> List[int]:
        """Generate `n` tokens on the device from the current logits (the
        JAX package's fused decode): one segment, the decode step replayed
        n times from a CUDA graph on the card, run n times eagerly on the
        CPU. `seed` and `segment` seed the segment's noise (decode_chunked
        counts segments, so successive ones never repeat a noise stream).
        The current logits go in from the device while the host copy is
        untouched, else from the host copy (an edit steers the draw); after
        `logits = None` it raises until the next eval()."""
        if self._logits_dev is None and self._logits_host is None:
            raise RuntimeError("decode() requires a prior eval()")
        n = min(n, self.spec.n_ctx - self.n_past)
        if n <= 0:
            return []
        t0 = time.perf_counter()
        last = np.full(max(int(last_n), 1), -1, np.int32)
        lt = list(last_tokens)[-last.size:] if last_n > 0 else []
        if lt:
            last[-len(lt):] = lt
        cfg = (int(top_k), float(top_p), float(temperature), float(repetition_penalty))
        window = round_window(self.n_past + n, self.spec.n_ctx)
        cap = max(32, 1 << (n - 1).bit_length())
        st = self._state(last.size, cap)
        aux = np.empty(1 + last.size, np.int32)
        aux[0] = self.n_past
        aux[1:] = last
        st.aux.copy_(torch.from_numpy(aux))  # the one upload
        st.step.zero_()
        untouched = self._logits_host is None or (
            self._logits_snap is not None and np.array_equal(self._logits_snap, self._logits_host))
        if self._logits_dev is not None and untouched:
            st.logits.copy_(self._logits_dev)
        else:
            st.logits.copy_(torch.from_numpy(np.ascontiguousarray(self._logits_host, np.float32)))
        if cfg[2] > 0:
            ts = time.perf_counter()
            gumbel_noise(st.noise[:n], seed, segment)
            self.t_sample_us += int((time.perf_counter() - ts) * 1e6)
        if self.device.type == "cuda":
            key = self.graph_key(cap, window, last.size, cfg)
            g = self._graphs.get(key)
            if g is None:
                tc = time.perf_counter()
                g = self._capture(key, st, cfg, window)
                dt = time.perf_counter() - tc
                self.t_compile_us += int(dt * 1e6)
                self.n_compile += 1
                t0 += dt
            for _ in range(n):
                g.graph.replay()
            g.replays += n
        else:
            for _ in range(n):
                self._decode_step(st, cfg, window)
        # the one download: the last logits and the segment's tokens
        packed = torch.cat([st.logits, st.toks[:n].view(torch.float32)]).cpu().numpy()
        v = self.spec.n_vocab
        self._logits_dev = st.logits.clone()
        self._logits_host = packed[:v].copy()
        self._logits_snap = self._logits_host.copy()
        self.n_past += n
        out = [int(t) for t in packed[v:].view(np.int32)]
        self.t_eval_us += int((time.perf_counter() - t0) * 1e6)
        self.n_eval += n
        self.n_sample += n
        return out

    def decode_chunked(
        self,
        n: int,
        *,
        chunk: int = 32,
        should_stop=None,
        abort_callback=None,
        top_k: int = 40,
        top_p: float = 0.95,
        temperature: float = 0.8,
        repetition_penalty: float = 1.1,
        last_tokens: Sequence[int] = (),
        last_n: int = 64,
        seed: int = 0,
    ) -> List[int]:
        """decode() in segments of `chunk` tokens with the host between
        them, the cooperative cancellation of the JAX package's
        decode_chunked: `abort_callback() -> bool` is checked before each
        segment; `should_stop(segment) -> int | None` after each, returning
        how many of its tokens to keep to end there (EOS, stop strings) or
        None to go on. The cache is rewound past a dropped tail, so those
        rows are reused."""
        out: List[int] = []
        last = list(last_tokens)
        segment = 0
        while len(out) < n:
            if abort_callback is not None and abort_callback():
                break
            k = min(chunk, n - len(out))
            toks = self.decode(
                k, top_k=top_k, top_p=top_p, temperature=temperature,
                repetition_penalty=repetition_penalty, last_tokens=last[-last_n:] if last_n > 0
                else [], last_n=last_n, seed=seed, segment=segment,
            )
            segment += 1
            if not toks:
                break
            keep = should_stop(toks) if should_stop is not None else None
            if keep is not None:
                keep = max(0, min(int(keep), len(toks)))
                dropped = len(toks) - keep
                if dropped:
                    self.rewind(self.n_past - dropped)
                out.extend(toks[:keep])
                break
            out.extend(toks)
            last.extend(toks)
        return out

    def reset(self) -> None:
        self.n_past = 0
        self.logits = None
        self._hidden_host = None
        self._hidden_dev = None

    def rewind(self, n_past: int) -> None:
        """Drop cached context beyond `n_past` (prefix reuse)."""
        self.n_past = min(self.n_past, n_past)

    def timings(self) -> dict:
        """llama_get_timings-shaped counters, with the JAX package's sample
        and compile keys (compile: the decode-step captures)."""
        return {
            "t_p_eval_ms": self.t_p_eval_us / 1e3,
            "t_eval_ms": self.t_eval_us / 1e3,
            "t_sample_ms": self.t_sample_us / 1e3,
            "t_compile_ms": self.t_compile_us / 1e3,
            "n_p_eval": max(1, self.n_p_eval),
            "n_eval": max(1, self.n_eval),
            "n_sample": max(1, self.n_sample),
            "n_compile": self.n_compile,
        }

    def print_timings(self) -> None:
        t = self.timings()
        print(
            f"    compile time = {t['t_compile_ms']:10.2f} ms / {t['n_compile']} programs"
        )
        print(
            f"prompt eval time = {t['t_p_eval_ms']:10.2f} ms / {t['n_p_eval']} tokens"
            f" ({t['t_p_eval_ms']/t['n_p_eval']:.2f} ms per token)"
        )
        print(
            f"       eval time = {t['t_eval_ms']:10.2f} ms / {t['n_eval']} runs  "
            f" ({t['t_eval_ms']/t['n_eval']:.2f} ms per token)"
        )
        print(
            f"     sample time = {t['t_sample_ms']:10.2f} ms / {t['n_sample']} runs"
        )
