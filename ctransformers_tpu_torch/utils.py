"""Small shared utilities (copies of ctransformers_tpu/utils.py) and the
port's device resolution."""

from __future__ import annotations

from typing import Tuple

import torch


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. The default is "cuda"; asking for
    CUDA where none is present raises instead of carrying on quietly on the
    CPU (the CPU runs only when the caller names it, as the tests do)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return device


def is_gguf(path: str) -> bool:
    """4-byte magic sniff."""
    with open(path, "rb") as f:
        return f.read(4) == b"GGUF"


def utf8_split_incomplete(data: bytes) -> Tuple[bytes, bytes]:
    """Split a byte string into (complete, incomplete) UTF-8 parts: a
    trailing partial multi-byte sequence is held back so streamed text
    decodes incrementally."""
    n = len(data)
    i = n
    # walk back over up to 3 continuation bytes
    while i > 0 and n - i < 4 and (data[i - 1] & 0xC0) == 0x80:
        i -= 1
    if i > 0:
        lead = data[i - 1]
        need = 0
        if lead >= 0xF0:
            need = 4
        elif lead >= 0xE0:
            need = 3
        elif lead >= 0xC0:
            need = 2
        if need and n - (i - 1) < need:
            return data[: i - 1], data[i - 1 :]
    return data, b""


class TextStreamer:
    """Incremental text assembly with stop-string semantics.

    Feeds per-token byte fragments, re-assembles UTF-8 safely, truncates the
    output at the FIRST occurrence of any stop string (which may span token
    boundaries), and holds back text whose suffix could still grow into a
    stop string until it completes one or provably cannot.
    """

    def __init__(self, stops=None):
        import re as _re

        self.stops = [s for s in (stops or []) if s]
        self._search = (
            _re.compile("|".join(map(_re.escape, self.stops))).search
            if self.stops
            else None
        )
        self._pending = b""  # trailing partial UTF-8 sequence
        self._held = ""  # text not yet safe to emit
        self.stopped = False

    def _holdback(self) -> int:
        """Length of the longest suffix of the held text that is a proper
        prefix of some stop string."""
        best = 0
        for s in self.stops:
            for n in range(min(len(s), len(self._held)), 0, -1):
                if self._held.endswith(s[:n]):
                    best = max(best, n)
                    break
        return best

    def feed(self, fragment: bytes) -> str:
        """Add one token's bytes; returns the text now safe to emit."""
        if self.stopped:
            return ""
        self._pending += fragment
        complete, self._pending = utf8_split_incomplete(self._pending)
        self._held += complete.decode(errors="ignore")
        if self._search is not None:
            m = self._search(self._held)
            if m:
                out = self._held[: m.start()]
                self._held = ""
                self.stopped = True
                return out
        keep = self._holdback()
        if keep >= len(self._held):
            return ""
        out = self._held[: len(self._held) - keep]
        self._held = self._held[len(self._held) - keep:]
        return out

    def flush(self) -> str:
        """Remaining held text at end-of-generation (no stop was hit)."""
        out, self._held = self._held, ""
        return out
