"""Byte-level fallback tokenizer.

Not part of the reference surface — exists so the decode engine, generation
API, tests, and benchmarks can run end-to-end without Meta's proprietary
tokenizer files (no sentencepiece model / tiktoken BPE ranks are shippable
in this repo).  Vocab: 256 raw bytes + BOS(256) + EOS(257) + PAD(258).
"""

from __future__ import annotations

from typing import List, Sequence


class ByteTokenizer:
    def __init__(self):
        self.n_words = 259
        self.bos_id = 256
        self.eos_id = 257
        self.pad_id = 258

    @property
    def stop_tokens(self) -> List[int]:
        return [self.eos_id]

    def __len__(self) -> int:
        return self.n_words

    def encode(self, s: str, bos: bool = False, eos: bool = False) -> List[int]:
        ids = list(s.encode("utf-8"))
        if bos:
            ids = [self.bos_id] + ids
        if eos:
            ids = ids + [self.eos_id]
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        data = bytes(i for i in ids if 0 <= i < 256)
        return data.decode("utf-8", errors="replace")
