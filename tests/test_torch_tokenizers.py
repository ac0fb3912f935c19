"""The port's Llama-2/3 tokenizers held against the JAX package's: on a BPE
rank table trained here (as ``tests/test_tokenizers.py`` trains it; no
proprietary vocabulary ships), the port's ``Tokenizer`` and ``ChatFormat``
give JAX's ids exactly, for text with special-token strings, an oversized
string and a dialog; the import gates raise JAX's errors."""

import base64
import os
import subprocess
import sys

import pytest

from jax_llama_tpu.tokenizers import ChatFormat as JChatFormat
from jax_llama_tpu.tokenizers import LLaMA3Tokenizer as JTokenizer
from jax_llama_tpu.tokenizers import llama2 as jllama2
from jax_llama_tpu.tokenizers import llama3 as jllama3

from jax_llama_tpu_torch.tokenizers import ChatFormat
from jax_llama_tpu_torch.tokenizers import LLaMA3Tokenizer as Tokenizer
from jax_llama_tpu_torch.tokenizers import llama2 as pllama2
from jax_llama_tpu_torch.tokenizers import llama3 as pllama3

from test_tokenizers import _CORPUS, _train_bpe_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

def write_rank_file(path, ranks):
    path.write_text("\n".join(
        f"{base64.b64encode(tok).decode()} {rank}"
        for tok, rank in ranks.items()))
    return path


@pytest.fixture(scope="module")
def rank_file(tmp_path_factory):
    ranks = _train_bpe_ranks(_CORPUS, n_merges=200)
    return ranks, write_rank_file(
        tmp_path_factory.mktemp("vocab") / "trained.model", ranks)


TEXTS = [
    "the quick brown fox jumps over the lazy dog",
    "The Quick BROWN fox!  \n\n  jumps\t\tover",
    "unicode: café 世界 \U0001f600 mixed in",
    "special text <|begin_of_text|> and <|eot_id|> stays plain",
    "   leading and trailing   ",
    "x" * 30_000 + " " * 26_000 + "the end",  # past MAX_SAME_CLASS_RUN
]


def test_constants_match_jax():
    assert pllama3.SPLIT_REGEX == jllama3.SPLIT_REGEX
    assert pllama3.special_token_names() == jllama3.special_token_names()
    assert (pllama3.MAX_ENCODE_CHARS, pllama3.MAX_SAME_CLASS_RUN) == (
        jllama3.MAX_ENCODE_CHARS, jllama3.MAX_SAME_CLASS_RUN)
    s = "ab " * 10 + " " * 12 + "c" * 9
    assert list(pllama3.split_oversized(s, max_run=5)) == list(
        jllama3.split_oversized(s, max_run=5))


def test_read_bpe_ranks_reads_the_written_file(rank_file):
    ranks, path = rank_file
    assert pllama3.read_bpe_ranks(str(path)) == ranks
    assert pllama3.read_bpe_ranks(str(path)) == jllama3.read_bpe_ranks(
        str(path))


@pytest.mark.parametrize("text", TEXTS, ids=[
    "plain", "whitespace", "unicode", "special_text", "edges", "oversized"])
def test_ids_match_jax(rank_file, text):
    _, path = rank_file
    port, jax_tok = Tokenizer(str(path)), JTokenizer(str(path))
    for bos, eos in ((False, False), (True, True)):
        ids = port.encode(text, bos=bos, eos=eos)
        assert ids == jax_tok.encode(text, bos=bos, eos=eos)
    assert port.decode(port.encode(text)) == text
    special = port.encode(text, allowed_special="all")
    assert special == jax_tok.encode(text, allowed_special="all")


def test_special_layout_matches_jax(rank_file):
    ranks, _ = rank_file
    port = Tokenizer.from_ranks(ranks)
    jax_tok = JTokenizer.from_ranks(ranks)
    assert port.special_tokens == jax_tok.special_tokens
    assert (port.n_words, port.bos_id, port.eos_id, port.eot_id,
            port.pad_id) == (jax_tok.n_words, jax_tok.bos_id, jax_tok.eos_id,
                             jax_tok.eot_id, jax_tok.pad_id)
    assert port.stop_tokens == jax_tok.stop_tokens
    assert len(port) == len(ranks) + 256


def test_chat_format_matches_jax(rank_file):
    ranks, _ = rank_file
    dialog = [
        {"role": "system", "content": "answer briefly"},
        {"role": "user", "content": "  the quick fox?  "},
        {"role": "assistant", "content": "jumps over the dog"},
        {"role": "user", "content": "and <|eot_id|> then"},
    ]
    port = ChatFormat(Tokenizer.from_ranks(ranks))
    jax_fmt = JChatFormat(JTokenizer.from_ranks(ranks))
    assert port.encode_dialog_prompt(dialog) == jax_fmt.encode_dialog_prompt(
        dialog)
    assert port.encode_message(dialog[1]) == jax_fmt.encode_message(dialog[1])


@pytest.mark.parametrize("gate", ["llama2", "llama3"])
def test_gates_raise_jax_errors(monkeypatch, gate):
    """With the package reported missing, construction raises the JAX
    package's ImportError, word for word."""
    errors = []
    for mod, flag in ((pllama2, "_HAVE_SENTENCEPIECE"),
                      (jllama2, "_HAVE_SENTENCEPIECE")) if gate == "llama2" \
            else ((pllama3, "_HAVE_TIKTOKEN"), (jllama3, "_HAVE_TIKTOKEN")):
        monkeypatch.setattr(mod, flag, False)
        with pytest.raises(ImportError) as e:
            if gate == "llama2":
                mod.Tokenizer("/nonexistent.model")
            else:
                mod.Tokenizer.from_ranks({b"a": 0})
        errors.append(str(e.value))
    assert errors[0] == errors[1]


_HIDDEN = """
import sys

class Hide:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("tiktoken", "sentencepiece"):
            raise ImportError(f"hidden: {name}")
        return None

sys.meta_path.insert(0, Hide())
from jax_llama_tpu_torch.tokenizers import LLaMA2Tokenizer, LLaMA3Tokenizer
for build in (lambda: LLaMA3Tokenizer.from_ranks({b"a": 0}),
              lambda: LLaMA2Tokenizer("tokenizer.model")):
    try:
        build()
    except ImportError as e:
        print(type(e).__name__, str(e).split(" is required")[0])
"""


def test_gates_raise_at_construction_not_import():
    """With tiktoken and sentencepiece hidden, the tokenizers package
    imports and each tokenizer raises when built."""
    proc = subprocess.run([sys.executable, "-c", _HIDDEN], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split("\n")[:2] == ["ImportError tiktoken",
                                           "ImportError sentencepiece"]

