"""Public generation API (ctransformers_tpu/llm.py) on PyTorch.

The `LLM` class keeps the constructor, properties and methods of the JAX
package with the same streaming and stop-sequence semantics; the engine
underneath runs PyTorch with the quantized matmuls on hand-written CUDA
kernels.
It runs on the card unless the caller passes device="cpu".

It serves the classic sampler chains through the per-token host loop
(`__call__`, `generate`) and `generate_fast`, the fused device loop (CUDA
graphs on the card, engine/engine.py:Engine.decode_chunked). The arguments
it does not serve yet raise NotImplementedError: grammar, guidance_scale
and negative_prompt, the extended sampler (tfs_z, typical_p, frequency and
presence penalties, mirostat), sessions, embed and lora (see ROADMAP).
"""

from __future__ import annotations

import os
import time
import warnings
from dataclasses import dataclass
from pathlib import Path
from typing import Generator, List, Optional, Sequence, Union

import numpy as np

from .engine import sampler as samplers
from .engine.engine import Engine
from .logger import logger
from .models.forward import resolve_kv_dtype
from .models.registry import load_model
from .utils import TextStreamer, is_gguf


@dataclass
class Config:
    """Generation/runtime knobs, with the reference Config's names and
    defaults; threads/gpu_layers/mmap/mlock are accepted for compatibility
    and have no effect."""

    top_k: int = 40
    top_p: float = 0.95
    temperature: float = 0.8
    repetition_penalty: float = 1.1
    last_n_tokens: int = 64
    seed: int = -1  # < 0: a fresh seed per call
    batch_size: int = 8
    threads: int = -1
    max_new_tokens: int = 256
    stop: Optional[Sequence[str]] = None
    stream: bool = False
    reset: bool = True
    context_length: int = -1
    gpu_layers: int = 0
    mmap: bool = True
    mlock: bool = False


def get(*values):
    """First value that is not None (per-call kwarg beats Config default)."""
    return next((v for v in values if v is not None), None)


def _not_served(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not yet ported, see ROADMAP")


class LLM:
    def __init__(
        self,
        model_path: str,
        model_type: Optional[str] = None,
        *,
        config: Optional[Config] = None,
        lib: Optional[str] = None,
        lora: Optional[str] = None,
        kv_dtype: Optional[str] = None,
        progress_callback=None,
        device="cuda",
    ):
        """Load a model file and build the engine for it on `device`
        ("cuda" by default; raises when CUDA is absent unless the caller
        asks for "cpu"). `kv_dtype` is the KV cache's storage: "f32"
        (default), "bf16" (also "f16", an alias of bf16 as in the JAX
        package), "ieee_f16" or "int8" (per-token-head quantized rows);
        CT_KV_DTYPE sets it when no name is given, CT_KV_LAYOUT=hm makes the
        cache head-major."""
        del lib  # accepted for API compatibility
        if lora:
            raise _not_served("lora")
        config = config or Config()
        self._model_path = model_path
        self._config = config
        self._kv_dtype = kv_dtype
        self._context: List[int] = []

        if not Path(model_path).is_file():
            raise ValueError(f"Model path '{model_path}' doesn't exist.")
        if not model_type:
            if not is_gguf(model_path):
                raise ValueError(
                    "Unable to detect model type. Please specify a model type using:\n\n"
                    "  AutoModelForCausalLM.from_pretrained(..., model_type='...')\n\n"
                )
            model_type = "gguf"  # GGUF self-describes its architecture
        from .utils import resolve_device

        device = resolve_device(device)  # before the (long) load
        bundle = load_model(
            model_path,
            model_type,
            context_length=config.context_length,
            progress_callback=progress_callback,
        )
        self._init_from_bundle(bundle, model_type, device)

    def _init_from_bundle(self, bundle, model_type: str, device) -> None:
        """Wire up the engine and the sampler from a loaded ModelBundle
        (shared by the GGUF path and the GPTQ backend)."""
        self._bundle = bundle
        self._model_type = bundle.architecture or model_type
        # the GPTQ backend sets no name: CT_KV_DTYPE, else f32
        kv_dtype = resolve_kv_dtype(getattr(self, "_kv_dtype", None))
        self._engine = Engine(bundle.spec, bundle.params, device=device, kv_dtype=kv_dtype)
        self._sample_fn = (
            samplers.sample_llama if bundle.sampler == "llama" else samplers.sample_gpt
        )

    model_path = property(lambda self: self._model_path, doc="Path of the weight file.")
    model_type = property(lambda self: self._model_type, doc="Architecture name.")
    config = property(lambda self: self._config, doc="Generation defaults.")
    device = property(lambda self: self._engine.device, doc="Device the model runs on.")
    eos_token_id = property(
        lambda self: self._bundle.vocab.eos_token_id(), doc="End-of-sequence token id."
    )
    bos_token_id = property(
        lambda self: self._bundle.vocab.bos_token_id(), doc="Beginning-of-sequence token id."
    )
    pad_token_id = property(lambda self: self.eos_token_id, doc="Padding token id (EOS).")
    vocab_size = property(lambda self: len(self._bundle.vocab), doc="Vocabulary size.")
    context_length = property(
        lambda self: self._bundle.spec.n_ctx, doc="Context window in tokens."
    )

    @property
    def logits(self) -> np.ndarray:
        """Next-token logits from the last eval, writable: edits made before
        `sample()` affect the draw."""
        if self._engine.logits is None:
            return np.zeros(0, np.float32)
        return self._engine.logits

    @property
    def embeddings(self) -> List[float]:
        raise _not_served("embeddings")

    def tokenize(self, text: str, add_bos_token: Optional[bool] = None) -> List[int]:
        """Encode `text` to token ids (BOS first for llama models by default)."""
        if add_bos_token is None:
            add_bos_token = self.model_type == "llama"
        return self._bundle.tokenizer.tokenize(text, add_bos_token)

    def detokenize(
        self, tokens: Sequence[int], decode: bool = True
    ) -> Union[str, bytes]:
        """Decode token ids (or one id) to text, or to raw UTF-8 bytes with
        decode=False."""
        if isinstance(tokens, int):
            tokens = [tokens]
        texts = b"".join(self._bundle.tokenizer.detokenize(t) for t in tokens)
        if decode:
            text = texts.decode(errors="ignore")
            # leading space after BOS is stripped
            if list(tokens[:1]) == [self.bos_token_id] and text[:1] == " ":
                text = text[1:]
            return text
        return texts

    def is_eos_token(self, token: int) -> bool:
        return self._bundle.vocab.is_eos_token(token)

    def eval(
        self, tokens: Sequence[int], *,
        batch_size: Optional[int] = None, threads: Optional[int] = None,
    ) -> None:
        """Run the forward pass over `tokens`, appending to the cached
        context; afterwards `logits` holds the next-token distribution."""
        del batch_size, threads  # kept for API compatibility
        n_past = len(self._context)
        if n_past + len(tokens) > self.context_length:
            logger.warning(
                f"Number of tokens ({n_past + len(tokens)}) exceeded maximum "
                f"context length ({self.context_length})."
            )
        self._engine.eval(tokens, n_past=n_past)
        self._context.extend(int(t) for t in tokens)

    def sample(
        self, *,
        top_k: Optional[int] = None, top_p: Optional[float] = None,
        temperature: Optional[float] = None,
        repetition_penalty: Optional[float] = None,
        last_n_tokens: Optional[int] = None, seed: Optional[int] = None,
        tfs_z: Optional[float] = None, typical_p: Optional[float] = None,
        frequency_penalty: Optional[float] = None,
        presence_penalty: Optional[float] = None,
        mirostat: Optional[int] = None, mirostat_tau: Optional[float] = None,
        mirostat_eta: Optional[float] = None,
    ) -> int:
        """Draw one token id from the current `logits` with the classic
        chain of the model (llama: repetition, top-k, top-p, temperature)."""
        if any(
            v is not None
            for v in (tfs_z, typical_p, frequency_penalty, presence_penalty,
                      mirostat, mirostat_tau, mirostat_eta)
        ):
            raise _not_served("the extended sampler")
        cfg = self.config
        last_n_tokens = get(last_n_tokens, cfg.last_n_tokens)
        if last_n_tokens < 0:
            last_n_tokens = self.context_length
        if self._engine.logits is None:
            return self.eos_token_id
        return self._sample_fn(
            self._engine.logits,
            top_k=get(top_k, cfg.top_k),
            top_p=get(top_p, cfg.top_p),
            temperature=get(temperature, cfg.temperature),
            repetition_penalty=get(repetition_penalty, cfg.repetition_penalty),
            last_tokens=self._context[-last_n_tokens:],
            seed=get(seed, cfg.seed),
        )

    def reset(self) -> None:
        """Deprecated since 0.2.27."""
        warnings.warn(
            "`LLM.reset()` method is deprecated since 0.2.27. Please use high-level API."
        )
        self._context.clear()
        self._engine.reset()

    def prepare_inputs_for_generation(
        self, tokens: Sequence[int], *, reset: Optional[bool] = None,
    ) -> Sequence[int]:
        """Trim `tokens` to the suffix that still needs evaluating, reusing
        the longest prefix already in the KV cache."""
        if not get(reset, self.config.reset):
            return tokens
        # shared-prefix scan, one short of the input so logits stay fresh
        limit = min(len(tokens) - 1, len(self._context))
        keep = 0
        while keep < limit and tokens[keep] == self._context[keep]:
            keep += 1
        self._context = self._context[:keep]
        self._engine.rewind(keep)
        return tokens[keep:]

    def generate(
        self, tokens: Sequence[int], *,
        top_k: Optional[int] = None, top_p: Optional[float] = None,
        temperature: Optional[float] = None,
        repetition_penalty: Optional[float] = None,
        last_n_tokens: Optional[int] = None, seed: Optional[int] = None,
        batch_size: Optional[int] = None, threads: Optional[int] = None,
        reset: Optional[bool] = None, grammar=None,
        guidance_scale: Optional[float] = None,
        negative_prompt: Optional[str] = None,
    ) -> Generator[int, None, None]:
        """Token-level generation: eval the prompt once, then yield sampled
        ids until EOS (the caller bounds the length)."""
        if grammar is not None:
            raise _not_served("grammar")
        if guidance_scale not in (None, 1.0) or negative_prompt is not None:
            raise _not_served("classifier-free guidance")
        return self._generate(
            tokens, top_k=top_k, top_p=top_p, temperature=temperature,
            repetition_penalty=repetition_penalty,
            last_n_tokens=last_n_tokens, seed=seed, reset=reset,
        )

    def _generate(self, tokens, *, reset, **sampling) -> Generator[int, None, None]:
        tokens = self.prepare_inputs_for_generation(tokens, reset=reset)
        self.eval(tokens)
        while True:
            token = self.sample(**sampling)
            self.eval([token])
            if self.is_eos_token(token):
                break
            yield token

    def _stream(
        self, prompt: str, *,
        max_new_tokens: Optional[int] = None,
        stop: Optional[Sequence[str]] = None,
        **generate_kwargs,
    ) -> Generator[str, None, None]:
        config = self.config
        max_new_tokens = get(max_new_tokens, config.max_new_tokens)
        stop = get(stop, config.stop) or []
        if isinstance(stop, str):
            stop = [stop]
        streamer = TextStreamer(stop)
        count = 0
        for token in self.generate(self.tokenize(prompt), **generate_kwargs):
            chunk = streamer.feed(self.detokenize([token], decode=False))
            if chunk:
                yield chunk
            if streamer.stopped:
                break
            count += 1
            if count >= max_new_tokens:
                break
        tail = streamer.flush()
        if tail:
            yield tail

    def __call__(
        self, prompt: str, *,
        max_new_tokens: Optional[int] = None,
        top_k: Optional[int] = None, top_p: Optional[float] = None,
        temperature: Optional[float] = None,
        repetition_penalty: Optional[float] = None,
        last_n_tokens: Optional[int] = None, seed: Optional[int] = None,
        batch_size: Optional[int] = None, threads: Optional[int] = None,
        stop: Optional[Sequence[str]] = None, stream: Optional[bool] = None,
        reset: Optional[bool] = None, grammar=None,
        guidance_scale: Optional[float] = None,
        negative_prompt: Optional[str] = None,
    ) -> Union[str, Generator[str, None, None]]:
        """Text in, completion out (or a generator of text chunks with
        stream=True)."""
        text = self._stream(
            prompt, max_new_tokens=max_new_tokens, stop=stop, top_k=top_k,
            top_p=top_p, temperature=temperature,
            repetition_penalty=repetition_penalty, last_n_tokens=last_n_tokens,
            seed=seed, batch_size=batch_size, threads=threads, reset=reset,
            grammar=grammar, guidance_scale=guidance_scale,
            negative_prompt=negative_prompt,
        )
        if get(stream, self.config.stream):
            return text
        return "".join(text)

    def generate_fast(
        self, prompt: str, *,
        max_new_tokens: Optional[int] = None,
        top_k: Optional[int] = None, top_p: Optional[float] = None,
        temperature: Optional[float] = None,
        repetition_penalty: Optional[float] = None,
        last_n_tokens: Optional[int] = None, seed: Optional[int] = None,
        stop: Optional[Sequence[str]] = None, reset: Optional[bool] = None,
        grammar=None, abort_callback=None, chunk: Optional[int] = None,
    ) -> str:
        """Text in, completion out, with the sample -> eval loop on the
        device in `chunk`-token segments (Engine.decode_chunked: a captured
        CUDA graph replayed per token on the card) instead of the per-token
        host loop of `__call__`. The draw is the device sampler's (the same
        chain; deterministic per seed, not draw-identical to the host
        samplers).

        Between segments the host applies EOS and stop strings (TextStreamer,
        as `__call__`) and checks `abort_callback()`, so generation ends
        within `chunk` tokens of a stop. `chunk` defaults to CT_DECODE_CHUNK
        or 32; 0 takes the whole budget in one segment. `grammar` goes to
        `__call__`, which raises NotImplementedError in this port."""
        if grammar is not None:
            return self(
                prompt, max_new_tokens=max_new_tokens, top_k=top_k, top_p=top_p,
                temperature=temperature, repetition_penalty=repetition_penalty,
                last_n_tokens=last_n_tokens, seed=seed, stop=stop, reset=reset,
                grammar=grammar,
            )
        config = self.config
        max_new_tokens = get(max_new_tokens, config.max_new_tokens)
        stop = get(stop, config.stop) or []
        if isinstance(stop, str):
            stop = [stop]
        seed = get(seed, config.seed)
        if seed is not None and seed < 0:
            seed = int(time.time())  # a fresh seed per call, as the host samplers
        last_n = get(last_n_tokens, config.last_n_tokens)
        if last_n < 0:
            last_n = self.context_length
        if chunk is None:
            chunk = int(os.environ.get("CT_DECODE_CHUNK", "32"))
        if chunk <= 0:
            chunk = max_new_tokens

        tokens = self.tokenize(prompt)
        tokens = self.prepare_inputs_for_generation(tokens, reset=reset)
        self.eval(tokens)

        streamer = TextStreamer(stop)
        pieces: List[str] = []

        def should_stop(segment):
            for i, t in enumerate(segment):
                if self.is_eos_token(t):
                    return i  # the EOS token and everything after it go
                piece = streamer.feed(self.detokenize([t], decode=False))
                if piece:
                    pieces.append(piece)
                if streamer.stopped:
                    return i + 1  # the token completing the stop string stays
            return None

        toks = self._engine.decode_chunked(
            max_new_tokens,
            chunk=chunk,
            should_stop=should_stop,
            abort_callback=abort_callback,
            top_k=get(top_k, config.top_k),
            top_p=get(top_p, config.top_p),
            temperature=get(temperature, config.temperature),
            repetition_penalty=get(repetition_penalty, config.repetition_penalty),
            last_tokens=self._context[-last_n:] if last_n > 0 else [],
            last_n=last_n,
            seed=seed,
        )
        self._context.extend(int(t) for t in toks)
        if not streamer.stopped:
            pieces.append(streamer.flush())
        return "".join(pieces)

    def embed(self, input, *, batch_size=None, threads=None) -> List[float]:
        raise _not_served("embed")

    def save_session(self, path: str, format: str = "auto") -> None:
        raise _not_served("sessions")

    def load_session(self, path: str) -> List[int]:
        raise _not_served("sessions")
