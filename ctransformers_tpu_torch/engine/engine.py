"""Inference engine: owns the device params and the KV cache, and runs the
forward pass over prompt chunks (ctransformers_tpu/engine/engine.py).

Prompts are split into power-of-two chunks (largest first), and attention
reads the round_window bucket covering each chunk, exactly as in the JAX
package, so the two run the same sequence of matmul shapes. PyTorch runs
eagerly: there is no compiled step to cache. As in the JAX package, the
kernel of every quantized weight is picked before it is served
(ops/qmatmul.py:autotune): at load for m = 1, and before the first prompt
chunk of each size, outside the timed spans. The fused on-device decode
loop of the JAX package is a later slice (a CUDA graph, see ROADMAP).
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..models.forward import KVCache, forward, round_window
from ..models.spec import ArchSpec
from ..ops import qmatmul as qm
from ..ops import qmm_kernels
from ..utils import resolve_device

# f32 matmuls (dense weights, attention) run in full f32 on the card, as the
# JAX package pins "highest" precision: TF32 would keep ~3 decimal digits.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


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
        self._hidden_host: Optional[np.ndarray] = None
        self._hidden_dev: Optional[torch.Tensor] = None
        # timing counters (reference: llama_get_timings)
        self.t_p_eval_us = 0  # prompt eval
        self.t_eval_us = 0  # decode eval
        self.n_p_eval = 0
        self.n_eval = 0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @property
    def logits(self) -> Optional[np.ndarray]:
        """(V,) last-token logits, writable (edits affect sampling); copied
        from the device on first read."""
        if self._logits_host is None and self._logits_dev is not None:
            self._logits_host = self._logits_dev.cpu().numpy().copy()
        return self._logits_host

    @logits.setter
    def logits(self, value) -> None:
        # a new host value replaces the device copy too: None leaves no
        # stale logits behind for a later read
        self._logits_host = None if value is None else np.asarray(value, np.float32)
        self._logits_dev = None

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

    def reset(self) -> None:
        self.n_past = 0
        self.logits = None
        self._hidden_host = None
        self._hidden_dev = None

    def rewind(self, n_past: int) -> None:
        """Drop cached context beyond `n_past` (prefix reuse)."""
        self.n_past = min(self.n_past, n_past)

    def timings(self) -> dict:
        """llama_get_timings-shaped counters."""
        return {
            "t_p_eval_ms": self.t_p_eval_us / 1e3,
            "t_eval_ms": self.t_eval_us / 1e3,
            "n_p_eval": max(1, self.n_p_eval),
            "n_eval": max(1, self.n_eval),
        }

    def print_timings(self) -> None:
        t = self.timings()
        print(
            f"prompt eval time = {t['t_p_eval_ms']:10.2f} ms / {t['n_p_eval']} tokens"
            f" ({t['t_p_eval_ms']/t['n_p_eval']:.2f} ms per token)"
        )
        print(
            f"       eval time = {t['t_eval_ms']:10.2f} ms / {t['n_eval']} runs  "
            f" ({t['t_eval_ms']/t['n_eval']:.2f} ms per token)"
        )
