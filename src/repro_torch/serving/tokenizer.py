"""Deterministic byte-chunk tokenizer stub.

Production fleets put a real BPE here; for the framework we only need
(a) a deterministic text -> ids mapping, (b) token counts that agree
with the router's bytes-per-token EMA convention (~4 bytes/token), and
(c) reversibility for tests.
"""
from __future__ import annotations

from typing import List

BYTES_PER_TOKEN = 4


class ByteChunkTokenizer:
    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size

    def encode(self, text: str) -> List[int]:
        data = text.encode("utf-8")
        ids = []
        for i in range(0, len(data), BYTES_PER_TOKEN):
            chunk = data[i:i + BYTES_PER_TOKEN]
            ids.append(int.from_bytes(chunk, "little") % (self.vocab_size - 1) + 1)
        return ids or [1]

    def count(self, text: str) -> int:
        return max(1, (len(text.encode("utf-8")) + BYTES_PER_TOKEN - 1)
                   // BYTES_PER_TOKEN)
