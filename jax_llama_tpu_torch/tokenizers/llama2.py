"""LLaMA-1/2 tokenizer: a SentencePiece wrapper (a copy of
``jax_llama_tpu/tokenizers/llama2.py``; the port imports nothing of the JAX
package).

``sentencepiece`` is imported behind a gate: the module imports without
it, and constructing the tokenizer raises a clear error.
"""

from __future__ import annotations

from typing import List, Sequence

try:
    from sentencepiece import SentencePieceProcessor  # type: ignore

    _HAVE_SENTENCEPIECE = True
except ImportError:  # pragma: no cover - environment dependent
    SentencePieceProcessor = None
    _HAVE_SENTENCEPIECE = False


class Tokenizer:
    """SentencePiece tokenizer (surface parity: encode/decode/bos_id/eos_id/
    pad_id/n_words/__len__)."""

    def __init__(self, model_path: str):
        if not _HAVE_SENTENCEPIECE:
            raise ImportError(
                "sentencepiece is required for the LLaMA-2 tokenizer but is "
                "not installed; `pip install sentencepiece` or use the "
                "LLaMA-3 (tiktoken) tokenizer"
            )
        self.sp = SentencePieceProcessor(model_file=model_path)
        self.n_words: int = self.sp.vocab_size()
        self.bos_id: int = self.sp.bos_id()
        self.eos_id: int = self.sp.eos_id()
        self.pad_id: int = self.sp.pad_id()
        assert self.sp.vocab_size() == self.sp.get_piece_size()

    @property
    def stop_tokens(self) -> List[int]:
        return [self.eos_id]

    def __len__(self) -> int:
        return self.n_words

    def encode(self, s: str, bos: bool = False, eos: bool = False) -> List[int]:
        ids = self.sp.encode(s)
        if bos:
            ids = [self.bos_id] + ids
        if eos:
            ids = ids + [self.eos_id]
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        return self.sp.decode(list(ids))
