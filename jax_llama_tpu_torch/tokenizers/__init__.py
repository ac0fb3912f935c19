"""Tokenizers of the port: the byte-level one, and the Llama-2
(sentencepiece) and Llama-3 (tiktoken) tokenizers, whose packages are
imported behind gates that raise at construction, never at import."""

from .bytes import ByteTokenizer
from .llama2 import Tokenizer as LLaMA2Tokenizer
from .llama3 import ChatFormat, Tokenizer as LLaMA3Tokenizer

__all__ = ["ByteTokenizer", "LLaMA2Tokenizer", "LLaMA3Tokenizer", "ChatFormat"]
