"""Tokenizers of the port (the byte-level one; the Llama-2/3 tokenizers
need vocabulary files the repository does not ship)."""

from .bytes import ByteTokenizer

__all__ = ["ByteTokenizer"]
