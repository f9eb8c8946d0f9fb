"""GGUF vocabulary (a copy of ctransformers_tpu/models/vocab.py:GGUFVocab).

Detokenize semantics per llama_token_to_piece_with_model: normal pieces
unescape U+2581 for SPM, unknown -> U+2585, control -> empty, byte tokens
<0xXX> -> the raw byte.
"""

from __future__ import annotations

# GGUF token types (llama_token_type)
TOKEN_TYPE_UNDEFINED = 0
TOKEN_TYPE_NORMAL = 1
TOKEN_TYPE_UNKNOWN = 2
TOKEN_TYPE_CONTROL = 3
TOKEN_TYPE_USER_DEFINED = 4
TOKEN_TYPE_UNUSED = 5
TOKEN_TYPE_BYTE = 6


class GGUFVocab:
    """Vocab for GGUF models (SPM pieces with types, scores, special ids)."""

    def __init__(
        self,
        pieces,  # list[str]
        scores=None,
        token_types=None,
        vocab_type: str = "spm",
        bos_id: int = 1,
        eos_id: int = 2,
        unk_id: int = 0,
        pad_id: int = -1,
    ):
        self.pieces = list(pieces)
        n = len(self.pieces)
        self.scores = [float(s) for s in scores] if scores is not None else [0.0] * n
        self.token_types = (
            [int(t) for t in token_types]
            if token_types is not None
            else [TOKEN_TYPE_NORMAL] * n
        )
        self.vocab_type = vocab_type
        self.bos_id = bos_id
        self.eos_id = eos_id
        self.unk_id = unk_id
        self.pad_id = pad_id
        # later duplicates overwrite (std::map insert-or-assign parity)
        self.piece_to_id = {p: i for i, p in enumerate(self.pieces)}
        self._detok = [self._piece_bytes(i) for i in range(n)]

    def _piece_bytes(self, i: int) -> bytes:
        t = self.token_types[i]
        p = self.pieces[i]
        if t == TOKEN_TYPE_UNKNOWN:
            return "▅".encode("utf-8")
        if t == TOKEN_TYPE_CONTROL:
            return b""
        if t == TOKEN_TYPE_BYTE:
            try:
                return bytes([int(p[3:5], 16)])
            except (ValueError, IndexError):
                return b""
        if self.vocab_type == "spm":
            p = p.replace("▁", " ")
        return p.encode("utf-8")

    def __len__(self) -> int:
        return len(self.pieces)

    def detokenize(self, token_id: int) -> bytes:
        if 0 <= token_id < len(self._detok):
            return self._detok[token_id]
        return b""

    def lookup(self, token):
        if isinstance(token, bytes):
            token = token.decode("utf-8", errors="replace")
        return self.piece_to_id.get(token)

    def eos_token_id(self) -> int:
        return self.eos_id

    def bos_token_id(self) -> int:
        return self.bos_id

    def is_eos_token(self, token_id: int) -> bool:
        return token_id == self.eos_id
