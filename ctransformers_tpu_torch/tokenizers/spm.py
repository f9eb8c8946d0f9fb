"""SentencePiece (SPM) tokenizer: bigram merge with byte fallback.

A copy of ctransformers_tpu/tokenizers/spm.py:SPMTokenizer (semantics of
llm_tokenizer_spm): split text into characters, seed a priority queue with
every adjacent pair that forms a vocab piece, repeatedly merge the
highest-scoring pair (ties: leftmost first), then resegment unmatched
symbols through the merge history, falling back to <0xXX> byte tokens. A
leading space is prepended and spaces are escaped to U+2581.
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Tuple

SPACE_ESCAPE = "▁"


class SPMTokenizer:
    def __init__(self, vocab):
        self.vocab = vocab  # GGUFVocab: piece_to_id (str keys) + scores

    def _merge(self, raw: str) -> Tuple[List[str], List[int], Dict]:
        """Run the bigram-merge loop over `raw`; returns (symbols,
        next-links, merge history)."""
        v = self.vocab
        syms: List[str] = list(raw)
        n = len(syms)
        prev = list(range(-1, n - 1))
        nxt = [i + 1 if i + 1 < n else -1 for i in range(n)]
        rev_merge: Dict[str, Tuple[int, int]] = {}
        heap: list = []
        counter = 0  # tie-break stability for equal (score, left)

        def try_add(left: int, right: int) -> None:
            nonlocal counter
            if left == -1 or right == -1:
                return
            t = syms[left] + syms[right]
            tid = v.piece_to_id.get(t)
            if tid is None or tid >= len(v):
                return
            # max-heap on score; ties pop the smallest left index
            heapq.heappush(heap, (-v.scores[tid], left, counter, right, len(t)))
            counter += 1
            rev_merge[t] = (left, right)

        for i in range(1, n):
            try_add(i - 1, i)

        while heap:
            _, left, _, right, size = heapq.heappop(heap)
            if not syms[left] or not syms[right]:
                continue
            if len(syms[left]) + len(syms[right]) != size:
                continue  # stale entry
            syms[left] += syms[right]
            syms[right] = ""
            nxt[left] = nxt[right]
            if nxt[right] >= 0:
                prev[nxt[right]] = left
            try_add(prev[left], left)
            try_add(left, nxt[left])

        return syms, nxt, rev_merge

    def tokenize(self, text: str, add_bos_token: bool = False) -> List[int]:
        v = self.vocab
        out: List[int] = []
        if add_bos_token and v.bos_id >= 0:
            out.append(v.bos_id)
        if not text:
            return out
        raw = (" " + text).replace(" ", SPACE_ESCAPE)
        syms, nxt, rev_merge = self._merge(raw)

        def resegment(i: int) -> None:
            t = syms[i]
            tid = v.piece_to_id.get(t)
            if tid is not None:
                out.append(tid)
                return
            p = rev_merge.get(t)
            if p is None:
                # byte fallback (llama_byte_to_token)
                for b in t.encode("utf-8"):
                    bid = v.piece_to_id.get(f"<0x{b:02X}>")
                    if bid is not None:
                        out.append(bid)
                return
            resegment(p[0])
            resegment(p[1])

        i = 0
        while i != -1:
            resegment(i)
            i = nxt[i]
        return out

    def detokenize(self, token_id: int) -> bytes:
        return self.vocab.detokenize(token_id)
