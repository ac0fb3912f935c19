"""The port's generation held against the JAX package: greedy tokens from
``engine.generate`` and strings from ``LLaMA.generate_from_str`` must be
identical on the same weights (tiny config, float32, CPU), with stop
tokens and chunked prefill.  Also the guards: the port imports with jax
blocked, and its entry points default to the card.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax_llama_tpu as jlt
from jax_llama_tpu.engine import GenerationConfig as JGenConfig
from jax_llama_tpu.engine import generate as jax_generate
from jax_llama_tpu.generation import LLaMA as JLLaMA
from jax_llama_tpu.tokenizers import ByteTokenizer as JByteTokenizer

import jax_llama_tpu_torch as ptl
from jax_llama_tpu_torch import engine as pengine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(vocab_size=96, max_seq_len=32)


@pytest.fixture(scope="module")
def weights():
    params = jlt.init_params(jax.random.PRNGKey(3), jlt.get_config("tiny", **CFG))
    return params, ptl.from_jax_params(jax.tree.map(np.asarray, params),
                                       device="cpu")


def _prompt(B=3, P=12, pads=(0, 4, 9), seed=1):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, CFG["vocab_size"], (B, P)).astype(np.int32)
    mask = np.arange(P)[None, :] >= np.asarray(pads)[:, None]
    return np.where(mask, tokens, 0).astype(np.int32), mask


def _both(weights, impl, **gen):
    jp, pp = weights
    tokens, mask = _prompt()
    jc = jlt.get_config("tiny", **CFG, attn_impl=impl)
    pc = ptl.get_config("tiny", **CFG, attn_impl=impl)
    want = np.asarray(jax_generate(
        jp, jnp.asarray(tokens), jnp.asarray(mask), jax.random.PRNGKey(0),
        config=jc, gen_config=JGenConfig(temperature=0.0, **gen),
    ))
    got = pengine.generate(
        pp, torch.from_numpy(tokens), torch.from_numpy(mask), None,
        config=pc, gen_config=pengine.GenerationConfig(temperature=0.0, **gen),
        device="cpu",
    )
    assert got.dtype == torch.int32
    return got.numpy(), want


@pytest.mark.parametrize("impl,chunk", [
    ("auto", None), ("xla", None), ("flash", None), ("auto", 5),
])
def test_greedy_tokens_identical(weights, impl, chunk):
    got, want = _both(weights, impl, max_new_tokens=8, prefill_chunk=chunk)
    np.testing.assert_array_equal(got, want)


def test_stop_tokens_and_early_exit_identical(weights):
    free, _ = _both(weights, "auto", max_new_tokens=8)
    P = _prompt()[0].shape[1]
    # Stop on the token each row emits at its third step; the loop must
    # exit early once all rows are done and pad the rest.
    stops = tuple(sorted({int(t) for t in free[:, P + 2]}))
    got, want = _both(weights, "auto", max_new_tokens=8, stop_tokens=stops,
                      pad_id=95, prefill_chunk=4)
    np.testing.assert_array_equal(got, want)
    assert (got[:, P + 3:] == 95).all()


def test_generate_from_str_identical():
    tok = JByteTokenizer()
    jc = jlt.get_config("tiny", vocab_size=len(tok), max_seq_len=64,
                        attn_impl="auto")
    jp = jlt.init_params(jax.random.PRNGKey(4), jc)
    pc = ptl.get_config("tiny", vocab_size=len(tok), max_seq_len=64,
                        attn_impl="auto")
    pp = ptl.from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    prompts = ["The quick brown fox", "hi", "jumps over the lazy dog!"]
    want = JLLaMA(jp, jc, tok).generate_from_str(prompts, max_gen_len=10,
                                                  temperature=0.0)
    llm = ptl.LLaMA(pp, pc, ptl.ByteTokenizer(), device="cpu")
    got = llm.generate_from_str(prompts, max_gen_len=10, temperature=0.0)
    assert got == want
    sampled = llm.generate_from_str(prompts, max_gen_len=4, seed=7)
    assert sampled == llm.generate_from_str(prompts, max_gen_len=4, seed=7)


def test_engine_helpers_match():
    mask = np.array([[False, False, True, True], [True, True, True, True]])
    np.testing.assert_array_equal(
        pengine.prompt_positions(torch.from_numpy(mask)).numpy(),
        np.asarray(jlt.engine.prompt_positions(jnp.asarray(mask))),
    )
    for n in (1, 2, 3, 8, 9, 100):
        assert pengine.next_pow2(n) == jlt.engine.next_pow2(n)
    toks = np.array([5, 7, 9], np.int32)
    np.testing.assert_array_equal(
        pengine._is_stop(torch.from_numpy(toks), (7, 9)).numpy(),
        np.asarray(jlt.engine._is_stop(jnp.asarray(toks), (7, 9))),
    )


def test_llama_and_generate_default_to_cuda(weights):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without a GPU")
    _, pp = weights
    pc = ptl.get_config("tiny", **CFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ptl.LLaMA(pp, pc, ptl.ByteTokenizer())
    tokens, mask = _prompt()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pengine.generate(pp, torch.from_numpy(tokens), torch.from_numpy(mask),
                         config=pc, gen_config=pengine.GenerationConfig())


_BLOCKED_IMPORT = r"""
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        for banned in ("jax", "jaxlib", "jax_llama_tpu"):
            if name == banned or name.startswith(banned + "."):
                raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
import jax_llama_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = [m for m in sys.modules if m in ("jax", "jaxlib", "jax_llama_tpu")
       or m.startswith(("jax.", "jaxlib.", "jax_llama_tpu."))]
assert not bad, bad
print("ok", len(names))
"""


def test_port_imports_with_jax_blocked():
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT], cwd=REPO,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")
