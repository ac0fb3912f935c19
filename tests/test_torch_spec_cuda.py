"""The port's speculative batcher on the card.  Marked ``cuda``: each test
skips on a host without a GPU (the paged kernel has no CPU mode).  Like
tests/test_torch_cuda.py, this file imports neither jax nor the JAX
package:

    python -m pytest tests/test_torch_spec_cuda.py -m cuda --noconftest -q

In float32 (matmuls without TF32) the kernel path, the gathered view and
the plain batcher give the same greedy tokens; every speculative forward
runs the paged kernel at T = n_draft + 1: n_draft draft-chain steps, the
draft's landing pass and the verify, once per layer, each round.
"""

import importlib

import numpy as np
import pytest
import torch

import jax_llama_tpu_torch as ptl

pa = importlib.import_module("jax_llama_tpu_torch.ops.paged_attention")


def _model(n_heads):
    cfg = ptl.get_config("tiny", vocab_size=128, dim=64 * n_heads,
                         n_layers=2, n_heads=n_heads, n_kv_heads=1,
                         multiple_of=32, max_seq_len=128, attn_impl="auto")
    return ptl.init_params(cfg, seed=0, device="cuda"), cfg


def _prompts():
    rng = np.random.RandomState(0)
    return [rng.randint(1, 128, size=rng.randint(3, 40)).tolist()
            for _ in range(5)]


@pytest.mark.cuda
@pytest.mark.parametrize("n_heads,spec_rounds", [(2, 1), (4, 4)])
def test_spec_batcher_runs_the_multi_token_kernel_on_card(n_heads,
                                                          spec_rounds):
    """G = 2 (T*G = 8 packed rows) and G = 4 (16), a draft that is the
    target with 5% noise: paged = gathered = plain tokens, and exactly
    (n_draft + 2) * n_layers launches at T = n_draft + 1 per round."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    params, cfg = _model(n_heads)
    gen = torch.Generator(device="cuda").manual_seed(1)
    draft = {k: ({kk: w * (1 + 0.05 * torch.randn(
        w.shape, device="cuda", generator=gen)) for kk, w in v.items()}
        if isinstance(v, dict) else v * (1 + 0.05 * torch.randn(
            v.shape, device="cuda", generator=gen)))
        for k, v in params.items()}
    prompts = _prompts()
    n_draft = 3
    outs = {}
    for path in ("paged", "gathered", "plain"):
        kw = {} if path == "plain" else dict(
            draft_params=draft, draft_config=cfg, n_draft=n_draft,
            spec_rounds=spec_rounds)
        cb = ptl.ContinuousBatcher(params, cfg, n_slots=3, max_len=128,
                                   use_pallas_kernel=path != "gathered",
                                   **kw)
        rids = [cb.submit(p, max_new_tokens=6 + i)
                for i, p in enumerate(prompts)]
        pa.paged_pool_attention.launches_by_t = {}
        res = cb.run_to_completion()
        torch.cuda.synchronize()
        by_t = dict(pa.paged_pool_attention.launches_by_t)
        outs[path] = [res[r] for r in rids]
        if path == "paged":
            assert by_t == {n_draft + 1: (n_draft + 2) * cfg.n_layers
                            * cb.steps_total}
            assert 0.0 < cb.acceptance_rate() < 1.0
        elif path == "gathered":
            assert by_t == {}
    assert outs["paged"] == outs["gathered"] == outs["plain"]


@pytest.mark.cuda
def test_self_draft_accepts_every_draft_on_card():
    """The draft chain replays the block at the verify's shape through the
    same kernel, so in self-draft every draft is accepted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    params, cfg = _model(4)
    cfg = cfg.replace(dtype="bfloat16")
    cb = ptl.ContinuousBatcher(params, cfg, n_slots=3, max_len=128,
                               draft_params=params, draft_config=cfg,
                               n_draft=3, spec_rounds=4)
    for i, p in enumerate(_prompts()):
        cb.submit(p, max_new_tokens=6 + i)
    res = cb.run_to_completion()
    assert sorted(len(t) for t in res.values()) == [6, 7, 8, 9, 10]
    assert cb.drafts_proposed > 0 and cb.acceptance_rate() == 1.0
