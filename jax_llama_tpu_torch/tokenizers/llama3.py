"""LLaMA-3 tokenizer: tiktoken BPE + chat-format dialog encoding (a copy
of ``jax_llama_tpu/tokenizers/llama3.py``; the port imports nothing of the
JAX package).

The token-id layout is a fixed public constant of the Llama-3 model
family: the split regex, the 256-slot special-token block
(begin/end_of_text at 0/1, header ids at 6/7, eot at 9, the rest
reserved) and the chat framing must match bit for bit or checkpoints are
unusable.  As in the JAX package:

  * the BPE ranks file is read by a self-contained parser (base64 token +
    rank per line), with no blobfile dependency;
  * ``Tokenizer.from_ranks`` builds from an in-memory rank table (the
    tests train one; no proprietary vocabulary file ships);
  * oversized input (tiktoken panics beyond ~400k chars and degrades on
    >25k-char same-class runs) is split by a standalone generator.

tiktoken is imported behind a gate: the module imports without it, and
constructing a ``Tokenizer`` raises.
"""

from __future__ import annotations

import base64
from typing import Dict, Iterator, List, Sequence

try:
    import tiktoken

    _HAVE_TIKTOKEN = True
except ImportError:  # pragma: no cover - environment dependent
    tiktoken = None
    _HAVE_TIKTOKEN = False

# Fixed public constants of the Llama-3 tokenizer.
SPLIT_REGEX = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)"
    r"|[^\r\n\p{L}\p{N}]?\p{L}+"
    r"|\p{N}{1,3}"
    r"| ?[^\s\p{L}\p{N}]+[\r\n]*"
    r"|\s*[\r\n]+"
    r"|\s+(?!\S)"
    r"|\s+"
)
NUM_RESERVED_SPECIAL_TOKENS = 256

# tiktoken's rust core panics past ~400k chars, and runs of >25k same-class
# (all-space / all-non-space) chars blow up the split regex.
MAX_ENCODE_CHARS = 400_000
MAX_SAME_CLASS_RUN = 25_000


def special_token_names() -> List[str]:
    """The 256 special tokens in id order (offset from the base vocab)."""
    named = {
        0: "<|begin_of_text|>",
        1: "<|end_of_text|>",
        6: "<|start_header_id|>",
        7: "<|end_header_id|>",
        9: "<|eot_id|>",
    }
    names = []
    reserved = 0
    for i in range(NUM_RESERVED_SPECIAL_TOKENS):
        if i in named:
            names.append(named[i])
        else:
            names.append(f"<|reserved_special_token_{reserved}|>")
            reserved += 1
    return names


def read_bpe_ranks(path: str) -> Dict[bytes, int]:
    """Parse a tiktoken ranks file: one 'base64(token) rank' pair per line."""
    ranks: Dict[bytes, int] = {}
    with open(path, "rb") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            token_b64, rank = line.split()
            ranks[base64.b64decode(token_b64)] = int(rank)
    return ranks


def split_oversized(s: str, max_run: int = MAX_SAME_CLASS_RUN) -> Iterator[str]:
    """Yield substrings whose same-class (space / non-space) runs never
    exceed ``max_run`` characters.  Concatenation of the pieces == s."""
    if not s:
        return
    start = 0
    run_len = 0
    run_is_space = s[0].isspace()
    for i, ch in enumerate(s):
        is_space = ch.isspace()
        if is_space != run_is_space:
            run_is_space = is_space
            run_len = 1
        else:
            run_len += 1
            if run_len > max_run:
                yield s[start:i]
                start = i
                run_len = 1
    yield s[start:]


class Tokenizer:
    """LLaMA-3 BPE tokenizer (surface parity: encode/decode/bos_id/eos_id/
    pad_id/stop_tokens/__len__)."""

    def __init__(self, model_path: str):
        self._init_from_ranks(read_bpe_ranks(model_path), name=model_path)

    @classmethod
    def from_ranks(cls, ranks: Dict[bytes, int], name: str = "custom") -> "Tokenizer":
        self = cls.__new__(cls)
        self._init_from_ranks(ranks, name=name)
        return self

    def _init_from_ranks(self, ranks: Dict[bytes, int], name: str) -> None:
        if not _HAVE_TIKTOKEN:
            raise ImportError(
                "tiktoken is required for the LLaMA-3 tokenizer but is not "
                "installed; `pip install tiktoken` or use ByteTokenizer"
            )
        n_base = len(ranks)
        self.special_tokens: Dict[str, int] = {
            tok: n_base + i for i, tok in enumerate(special_token_names())
        }
        self._enc = tiktoken.Encoding(
            name=name,
            pat_str=SPLIT_REGEX,
            mergeable_ranks=ranks,
            special_tokens=self.special_tokens,
        )
        self.n_words: int = self._enc.n_vocab
        self.bos_id: int = self.special_tokens["<|begin_of_text|>"]
        self.eos_id: int = self.special_tokens["<|end_of_text|>"]
        self.eot_id: int = self.special_tokens["<|eot_id|>"]
        self.pad_id: int = -1
        self.stop_tokens = {self.eos_id, self.eot_id}

    def __len__(self) -> int:
        return self.n_words

    def encode(
        self,
        s: str,
        bos: bool = False,
        eos: bool = False,
        allowed_special=frozenset(),
        disallowed_special=(),
    ) -> List[int]:
        """Encode text.  Special-token text in the input is encoded as plain
        text unless listed in ``allowed_special`` (pass "all" to enable all —
        the reference's contract, llama3_tokenizer.py:99-128)."""
        ids: List[int] = []
        for i in range(0, len(s), MAX_ENCODE_CHARS):
            for piece in split_oversized(s[i : i + MAX_ENCODE_CHARS]):
                ids.extend(
                    self._enc.encode(
                        piece,
                        allowed_special=allowed_special,
                        disallowed_special=disallowed_special,
                    )
                )
        if bos:
            ids.insert(0, self.bos_id)
        if eos:
            ids.append(self.eos_id)
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        return self._enc.decode(list(ids))


class ChatFormat:
    """Dialog → token framing (the reference's llama3_tokenizer.py:205-232).

    Frame:  <|begin_of_text|> then per message
            <|start_header_id|>{role}<|end_header_id|>\\n\\n{content}<|eot_id|>
            and finally an open assistant header for the model to complete.
    """

    def __init__(self, tokenizer: Tokenizer):
        self.tokenizer = tokenizer

    def encode_header(self, message: dict) -> List[int]:
        t = self.tokenizer
        return (
            [t.special_tokens["<|start_header_id|>"]]
            + t.encode(message["role"])
            + [t.special_tokens["<|end_header_id|>"]]
            + t.encode("\n\n")
        )

    def encode_message(self, message: dict) -> List[int]:
        return (
            self.encode_header(message)
            + self.tokenizer.encode(message["content"].strip())
            + [self.tokenizer.eot_id]
        )

    def encode_dialog_prompt(self, dialog: Sequence[dict]) -> List[int]:
        ids = [self.tokenizer.bos_id]
        for message in dialog:
            ids.extend(self.encode_message(message))
        ids.extend(self.encode_header({"role": "assistant", "content": ""}))
        return ids
