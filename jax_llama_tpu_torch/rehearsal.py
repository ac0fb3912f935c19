"""Real-weights dress rehearsal: convert -> save -> load -> generate ->
parity as ONE unattended command (port of ``jax_llama_tpu/rehearsal.py``,
the same CLI).

No real Llama weights exist in the development environment, so the
end-to-end path real checkpoints take is rehearsed three ways:

  * ``--synthetic``: builds a small but real Meta-FORMAT checkpoint
    (sharded ``consolidated.NN.pth`` + ``params.json``, Megatron
    column/row splits), then runs the exact production path: convert ->
    ``save_checkpoint`` -> ``load_checkpoint`` (manifest verified) ->
    greedy ``engine.generate`` -> float32 logit parity against the
    independent torch oracle (``tests/torch_oracle.py``).  Every step is
    the code real weights will take.  The prefill runs the flash kernel
    (``attn_impl="auto"``, prompts longer than ``FLASH_MIN_SEQ``), whose
    CUDA instances take head_dim 64 or 128: on the card pass a geometry
    with such a head_dim (``rehearse_synthetic(dim=256, n_heads=4,
    n_kv_heads=2)``); JAX's default geometry (head_dim 16) raises there.
  * ``--shapes-8b``: validation at full Llama-3-8B geometry on torch's
    ``meta`` device (nothing is materialised): the parameter tree's
    shapes and count, and partition-spec coverage on a virtual tensor = 4
    x data = 2 mesh (``validate_tp``, ``param_partition_specs``,
    ``shard_abstract``), with the largest per-device shard.
  * ``--ckpt-dir ...``: the real thing, unattended, the moment weights
    are available::

        python -m jax_llama_tpu_torch.rehearsal \\
            --ckpt-dir /weights/Meta-Llama-3-8B \\
            --tokenizer /weights/Meta-Llama-3-8B/tokenizer.model \\
            --out /ckpts/llama3-8b-torch

    Runs convert (bf16 storage) -> save -> load -> two greedy completions,
    and -- when the torch oracle is importable (a repo checkout) --
    last-token logit parity in float32 on the prompts, against the
    <1e-3 target.

``--device`` (default "cuda") is where the model runs; "cpu" runs every
kernel's plain version.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, Optional, Sequence

_T0 = time.perf_counter()


def _log(msg: str) -> None:
    print(f"[rehearsal +{time.perf_counter() - _T0:7.1f}s] {msg}", flush=True)


# The card's device memory, for the --shapes-8b fit line (80 GB H100).
DEVICE_BYTES = 80e9


def _write_synthetic_meta_checkpoint(
    tmpdir: Path, *, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
    vocab=256, multiple_of=32, n_shards=2, seed=0,
):
    """A miniature checkpoint in Meta's exact on-disk format: torch
    float32 tensors drawn from a numpy seed, Megatron column/row shard
    splits, ``params.json`` with the SwiGLU sizing fields (JAX :52, the
    same keyword geometry and the same bytes for the same arguments)."""
    import numpy as np
    import torch

    from .config import swiglu_hidden_size

    rng = np.random.RandomState(seed)
    hd = dim // n_heads
    ffn = swiglu_hidden_size(dim, multiple_of)
    full = {
        "tok_embeddings.weight": rng.randn(vocab, dim).astype(np.float32),
        "norm.weight": rng.randn(dim).astype(np.float32),
        "output.weight": rng.randn(vocab, dim).astype(np.float32),
    }
    for l in range(n_layers):
        p = f"layers.{l}."
        full[p + "attention.wq.weight"] = rng.randn(
            n_heads * hd, dim).astype(np.float32)
        full[p + "attention.wk.weight"] = rng.randn(
            n_kv_heads * hd, dim).astype(np.float32)
        full[p + "attention.wv.weight"] = rng.randn(
            n_kv_heads * hd, dim).astype(np.float32)
        full[p + "attention.wo.weight"] = rng.randn(
            dim, n_heads * hd).astype(np.float32)
        full[p + "feed_forward.w1.weight"] = rng.randn(
            ffn, dim).astype(np.float32)
        full[p + "feed_forward.w2.weight"] = rng.randn(
            dim, ffn).astype(np.float32)
        full[p + "feed_forward.w3.weight"] = rng.randn(
            ffn, dim).astype(np.float32)
        full[p + "attention_norm.weight"] = rng.randn(dim).astype(np.float32)
        full[p + "ffn_norm.weight"] = rng.randn(dim).astype(np.float32)

    col_keys = ("wq", "wk", "wv", "w1", "w3", "output")
    row_keys = ("wo", "w2", "tok_embeddings")
    for s in range(n_shards):
        shard = {}
        for key, arr in full.items():
            if any(k in key for k in col_keys):
                shard[key] = torch.from_numpy(
                    np.split(arr, n_shards, axis=0)[s].copy())
            elif any(k in key for k in row_keys):
                shard[key] = torch.from_numpy(
                    np.split(arr, n_shards, axis=1)[s].copy())
            else:
                shard[key] = torch.from_numpy(arr.copy())
        torch.save(shard, tmpdir / f"consolidated.{s:02d}.pth")
    (tmpdir / "params.json").write_text(json.dumps({
        "dim": dim, "n_layers": n_layers, "n_heads": n_heads,
        "n_kv_heads": n_kv_heads, "multiple_of": multiple_of,
        "norm_eps": 1e-5, "rope_theta": 10000.0, "vocab_size": -1,
    }))
    return vocab


def _oracle_module():
    """Import tests/torch_oracle.py (a test helper of torch and numpy
    only) when available (a repo checkout); None otherwise."""
    try:
        import torch_oracle  # repo layout: tests/ on sys.path

        return torch_oracle
    except ImportError:
        tests_dir = Path(__file__).resolve().parent.parent / "tests"
        if (tests_dir / "torch_oracle.py").exists():
            sys.path.insert(0, str(tests_dir))
            try:
                import torch_oracle

                return torch_oracle
            except ImportError:
                return None
    return None


def _pipeline(ckpt_dir: str, out_dir: str, tokenizer, vocab_size, dtype,
              max_seq_len, prompts, max_gen_len, parity_atol,
              device="cuda") -> Dict[str, Any]:
    """convert -> save -> load -> generate -> (optional) parity, on
    ``device``: the shared spine of the synthetic rehearsal and the real
    run (JAX :134).  Returns the generated tokens [B, max_gen_len], the
    float32 logits of each prompt's last token [B, V] (the parity
    forward's), the parity figure (None without the oracle) and the
    parameter count."""
    import numpy as np
    import torch

    from .convert.checkpoint import load_checkpoint, save_checkpoint
    from .convert.meta import convert_meta_checkpoint
    from .engine import GenerationConfig, generate, prompt_positions
    from .models import forward as model_forward
    from .train import tree_leaves

    _log(f"converting Meta checkpoint at {ckpt_dir} (dtype={dtype}, "
         f"device={device})")
    params, config = convert_meta_checkpoint(
        ckpt_dir, tokenizer=tokenizer, vocab_size=vocab_size,
        max_seq_len=max_seq_len, dtype=dtype, device=device,
    )
    # Prefill on the flash kernel: the path a served prompt takes.
    config = config.replace(attn_impl="auto")
    n_params = sum(int(a.numel()) for a in tree_leaves(params))
    _log(f"converted: {n_params / 1e6:.1f}M params, dim={config.dim} "
         f"L={config.n_layers}")

    _log(f"saving checkpoint to {out_dir}")
    save_checkpoint(out_dir, params, config)
    del params
    _log("restoring (manifest verified)")
    restored, rconfig = load_checkpoint(out_dir, device=device)
    if rconfig != config:
        raise SystemExit(f"restored config {rconfig} != saved {config}")

    if tokenizer is not None:
        encode = lambda s: tokenizer.encode(s, bos=True, eos=False)
        decode = tokenizer.decode
    else:
        encode = lambda s: [1] + [ord(c) % (vocab_size - 2) + 2 for c in s]
        decode = lambda ids: repr(ids)

    token_lists = [encode(p) for p in prompts]
    P = max(len(t) for t in token_lists)
    toks = np.zeros((len(prompts), P), np.int32)
    pmask = np.zeros((len(prompts), P), bool)
    for i, t in enumerate(token_lists):
        toks[i, P - len(t):] = t
        pmask[i, P - len(t):] = True
    gc = GenerationConfig(
        max_new_tokens=max_gen_len, temperature=0.0, stop_tokens=()
    )
    _log(f"greedy generate: {len(prompts)} prompts, max_gen_len={max_gen_len}")
    out = generate(
        restored, torch.from_numpy(toks), torch.from_numpy(pmask),
        config=config, gen_config=gc, device=device,
    ).cpu().numpy()
    for i, p in enumerate(prompts):
        _log(f"  prompt {i}: {p!r} -> {decode(out[i, P:].tolist())!r}")

    fp32_cfg = config.replace(dtype="float32")
    d_toks = torch.from_numpy(toks).to(device)
    d_mask = torch.from_numpy(pmask).to(device)
    positions = prompt_positions(d_mask)
    with torch.inference_mode():
        mine = model_forward(restored, d_toks, positions, fp32_cfg,
                             attn_mask=d_mask)[0].float().cpu().numpy()
    result = dict(tokens=out[:, P:], last_logits=mine[:, -1],
                  parity=None, n_params=n_params)
    oracle = _oracle_module()
    if oracle is None:
        _log("torch oracle unavailable -- skipping logit parity (run "
             "from the repo checkout)")
        return result
    _log(f"float32 logit parity vs the independent torch oracle (the "
         f"port's forward on {device}, the oracle on the CPU)")
    host = {
        k: ({kk: vv.float().cpu().numpy() for kk, vv in v.items()}
            if isinstance(v, dict) else v.float().cpu().numpy())
        for k, v in restored.items()
    }
    want = oracle.oracle_forward(host, toks, positions.cpu().numpy(),
                                 fp32_cfg)
    diff = float(np.max(np.abs(
        mine[pmask].astype(np.float64) - want[pmask].astype(np.float64)
    )))
    _log(f"max abs logit diff (fp32, all valid positions): {diff:.2e} "
         f"(target < {parity_atol})")
    if diff >= parity_atol:
        raise SystemExit(f"PARITY FAILURE: {diff:.2e} >= {parity_atol}")
    result["parity"] = diff
    return result


def rehearse_synthetic(device="cuda", **geometry) -> Dict[str, Any]:
    """Scaled-down end-to-end rehearsal on a synthetic Meta checkpoint
    (``geometry``: ``_write_synthetic_meta_checkpoint``'s keywords)."""
    with tempfile.TemporaryDirectory() as td:
        tmp = Path(td)
        ck = tmp / "meta"
        ck.mkdir()
        _log("building synthetic 2-shard Meta-format checkpoint")
        vocab = _write_synthetic_meta_checkpoint(ck, **geometry)
        res = _pipeline(
            str(ck), str(tmp / "ckpt"), tokenizer=None, vocab_size=vocab,
            dtype="float32", max_seq_len=128,
            prompts=["hello tpu", "paged kv"], max_gen_len=8,
            # float32 end to end on the synthetic model: conversion is
            # exact, so only accumulation-order noise remains.
            parity_atol=1e-3, device=device,
        )
        _log(f"synthetic rehearsal PASSED (parity {res['parity']:.2e})"
             if res["parity"] is not None else "synthetic rehearsal PASSED")
        return res


def rehearse_8b_shapes() -> Dict[str, Any]:
    """Full-8B validation on the meta device: shapes, parameter count and
    partition coverage at tensor = 4 x data = 2; nothing is
    materialised.  Returns the leaf count, the parameter total and the
    largest per-device shard's bf16 bytes."""
    from . import get_config, init_params
    from .parallel.mesh import AXES, Mesh
    from .parallel.partition import (param_partition_specs, shard_abstract,
                                     validate_tp)
    from .train import tree_leaves

    config = get_config("llama3-8b")
    _log(f"meta-device init at llama3-8b: dim={config.dim} "
         f"L={config.n_layers} H={config.n_heads}/{config.kv_heads} "
         f"V={config.vocab_size}")
    shapes = init_params(config, device="meta")
    leaves = tree_leaves(shapes)
    total = sum(int(a.numel()) for a in leaves)
    _log(f"param tree: {len(leaves)} leaves, {total / 1e9:.2f}B params, "
         f"{total * 2 / 1e9:.1f} GB bf16")
    if not 7.9e9 < total < 8.4e9:
        raise SystemExit(f"llama3-8b has {total} params, expected ~8.03B")
    # A virtual tensor = 4 x data = 2 mesh (rank 0's view; no devices
    # needed): every leaf must have a spec, every sharded axis must
    # divide, and the largest per-device shard must fit the card.
    axes = dict(tensor=4, data=2)
    n = axes["tensor"] * axes["data"]
    mesh = Mesh({a: axes.get(a, 1) for a in AXES}, ["cpu"] * n, 0, {}, None)
    validate_tp(config, mesh)
    specs = param_partition_specs(config)
    local = shard_abstract(shapes, mesh, config)
    shard_shapes = tree_leaves(local)
    if (len(tree_leaves(specs)) != len(leaves)
            or len(shard_shapes) != len(leaves)):
        raise SystemExit("the partition specs do not cover every leaf")
    shard_bytes = [2 * math.prod(s) for s in shard_shapes]
    largest = max(shard_bytes)
    _log(f"partition specs cover all {len(shard_bytes)} leaves at "
         f"tensor=4 x data=2; largest per-device shard "
         f"{largest / 1e6:.0f} MB bf16 (fits the H100's "
         f"{DEVICE_BYTES / 1e9:.0f} GB)")
    if largest >= DEVICE_BYTES:
        raise SystemExit(f"a {largest} B shard does not fit the card")
    _log("8B shape rehearsal PASSED")
    return dict(leaves=len(leaves), params=total,
                largest_shard_bytes=largest)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--synthetic", action="store_true",
                    help="scaled-down end-to-end rehearsal (no weights "
                         "needed)")
    ap.add_argument("--shapes-8b", action="store_true",
                    help="full-8B shape/partition validation on the meta "
                         "device")
    ap.add_argument("--ckpt-dir", default=None,
                    help="real Meta checkpoint directory (consolidated."
                         "NN.pth + params.json)")
    ap.add_argument("--tokenizer", default=None,
                    help="tokenizer.model path (llama3 tiktoken format, "
                         "or --llama2)")
    ap.add_argument("--llama2", action="store_true")
    ap.add_argument("--out", default=None,
                    help="output checkpoint directory (default: "
                         "<ckpt-dir>-torch)")
    ap.add_argument("--max-seq-len", type=int, default=2048)
    ap.add_argument("--max-gen-len", type=int, default=32)
    ap.add_argument("--parity-atol", type=float, default=1e-3)
    ap.add_argument("--device", default="cuda",
                    help="where the model runs (cuda by default; cpu runs "
                         "the kernels' plain versions)")
    args = ap.parse_args(argv)

    if not (args.synthetic or args.shapes_8b or args.ckpt_dir):
        ap.error("pick at least one of --synthetic / --shapes-8b / "
                 "--ckpt-dir")
    if args.ckpt_dir and args.tokenizer is None:
        raise SystemExit("--ckpt-dir needs --tokenizer")
    if args.synthetic:
        rehearse_synthetic(device=args.device)
    if args.shapes_8b:
        rehearse_8b_shapes()
    if args.ckpt_dir:
        if args.llama2:
            from .tokenizers.llama2 import Tokenizer as Tok
        else:
            from .tokenizers.llama3 import Tokenizer as Tok
        tok = Tok(args.tokenizer)
        out = args.out or (args.ckpt_dir.rstrip("/") + "-torch")
        _pipeline(
            args.ckpt_dir, out, tokenizer=tok, vocab_size=None,
            dtype="bfloat16", max_seq_len=args.max_seq_len,
            prompts=[
                "I believe the meaning of life is",
                "Simply put, the theory of relativity states that",
            ],
            max_gen_len=args.max_gen_len, parity_atol=args.parity_atol,
            device=args.device,
        )
        _log("real-weights rehearsal PASSED")


if __name__ == "__main__":
    main()
