"""Minimal SentencePiece `tokenizer.model` protobuf parser/serializer.

The port's copy of ctransformers_tpu/tokenizers/spm_model.py. The GPTQ
path loads `tokenizer.model` from the checkpoint directory (gptq/llm.py).
Only the pieces list is needed: ModelProto field 1 is a repeated
SentencePiece message {1: piece (string), 2: score (float), 3: type
(enum; NORMAL=1, UNKNOWN=2, CONTROL=3, USER_DEFINED=4, UNUSED=5,
BYTE=6)}. Everything else is skipped wire-compatibly.
"""

from __future__ import annotations

import struct
from typing import List, Tuple


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _skip(buf: bytes, pos: int, wire: int) -> int:
    if wire == 0:
        _, pos = _read_varint(buf, pos)
    elif wire == 1:
        pos += 8
    elif wire == 2:
        n, pos = _read_varint(buf, pos)
        pos += n
    elif wire == 5:
        pos += 4
    else:
        raise ValueError(f"bad wire type {wire}")
    return pos


def _parse_piece(buf: bytes) -> Tuple[str, float, int]:
    piece, score, ptype = "", 0.0, 1  # type defaults to NORMAL
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:
            n, pos = _read_varint(buf, pos)
            piece = buf[pos : pos + n].decode("utf-8", errors="replace")
            pos += n
        elif field == 2 and wire == 5:
            (score,) = struct.unpack("<f", buf[pos : pos + 4])
            pos += 4
        elif field == 3 and wire == 0:
            ptype, pos = _read_varint(buf, pos)
        else:
            pos = _skip(buf, pos, wire)
    return piece, score, ptype


def parse_spm_model(path: str):
    """-> (pieces, scores, types) with GGUF-compatible type values."""
    with open(path, "rb") as f:
        buf = f.read()
    pieces: List[str] = []
    scores: List[float] = []
    types: List[int] = []
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:
            n, pos = _read_varint(buf, pos)
            piece, score, ptype = _parse_piece(buf[pos : pos + n])
            pos += n
            pieces.append(piece)
            scores.append(score)
            types.append(ptype)
        else:
            pos = _skip(buf, pos, wire)
    return pieces, scores, types


# -- serializer (synthetic checkpoints, models/synthetic.py) -----------------


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def write_spm_model(path: str, pieces, scores, types) -> None:
    out = bytearray()
    for piece, score, ptype in zip(pieces, scores, types):
        pb = piece.encode("utf-8")
        msg = bytearray()
        msg += _varint((1 << 3) | 2) + _varint(len(pb)) + pb
        msg += _varint((2 << 3) | 5) + struct.pack("<f", score)
        msg += _varint((3 << 3) | 0) + _varint(ptype)
        out += _varint((1 << 3) | 2) + _varint(len(msg)) + bytes(msg)
    with open(path, "wb") as f:
        f.write(bytes(out))
