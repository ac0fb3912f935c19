#!/usr/bin/env python3
"""Time the port's host-bound decode paths for one checkout of
``jax_llama_tpu_torch`` on one CUDA card, to compare two commits on the
same card: run it once per checkout, alternating, in one session.

    python3 bench_port_decode.py --root PATH_TO_CHECKOUT --label NAME

``--root`` is the directory that holds the ``jax_llama_tpu_torch`` package
to time (default: this script's directory).  At llama3-8b's full width
(32 layers, bf16 weights from seed 0, byte tokenizer, greedy) it measures:

* generate: decode ms per token of ``engine.generate`` at B=4 over
  prompts padded to 512, as (32 new tokens - 1 new token) / 31 on a
  synchronised host clock, 3 pairs (the median and every sample), and
  the CUDA kernel launches of one 8-token generate (torch.profiler);
* serving: ``ContinuousBatcher`` (8 slots, max_len 2048, decode_chunk 8)
  with 8 requests of 1000, 21, 517, 130, 64, 300, 777 and 45 prompt tokens
  and 64 new tokens each, admitted together; the host clock of every
  ``step()`` that ran with all 8 slots busy and no admission, over its
  iterations, for 3 rounds (the median and every step).

It prints one JSON line.  Only the package under ``--root`` is imported.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

PROMPT_PADS = (0, 111, 311, 491)
SERVE_PROMPT_TOKENS = (1000, 21, 517, 130, 64, 300, 777, 45)
SERVE_NEW = 64
ROUNDS = 3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("bench_port_decode: no CUDA device is available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    import jax_llama_tpu_torch as ptl
    from jax_llama_tpu_torch import engine
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ptl.get_config("llama3-8b", param_dtype="bfloat16",
                         dtype="bfloat16", attn_impl="auto")
    params = ptl.init_params(cfg, seed=0, device="cuda")
    tok = ptl.ByteTokenizer()
    text = ("The quick brown fox jumps over the lazy dog while the port "
            "runs its first slice on the card. ") * 8
    P = 512
    tokens = torch.full((4, P), tok.pad_id, dtype=torch.int32)
    mask = torch.zeros((4, P), dtype=torch.bool)
    for i, pad in enumerate(PROMPT_PADS):
        ids = tok.encode(text[:P - pad - 1], bos=True)
        tokens[i, P - len(ids):] = torch.tensor(ids)
        mask[i, P - len(ids):] = True
    tokens, mask = tokens.cuda(), mask.cuda()

    def gen_ms(n):
        gc = engine.GenerationConfig(max_new_tokens=n, temperature=0.0)
        torch.cuda.synchronize()
        t = time.perf_counter()
        engine.generate(params, tokens, mask, config=cfg, gen_config=gc,
                        device="cuda")
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    gen_ms(1)
    samples = []
    for _ in range(3):
        one = gen_ms(1)
        samples.append((gen_ms(32) - one) / 31)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        gen_ms(8)
    launches_8 = sum(e.count for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA)

    serve_text = ("The quick brown fox jumps over the lazy dog while the port "
                  "serves a continuous batch from its paged pool on the "
                  "card. ") * 24
    prompts = [tok.encode(serve_text[7 * i:7 * i + n - 1], bos=True)
               for i, n in enumerate(SERVE_PROMPT_TOKENS)]
    cb = ptl.ContinuousBatcher(params, cfg, n_slots=8, max_len=2048,
                               decode_chunk=8, device="cuda")
    step_ms = []
    for _ in range(ROUNDS):
        for p in prompts:
            cb.submit(p, max_new_tokens=SERVE_NEW)
        while cb.pending():
            busy = all(s is not None for s in cb.slots.values())
            quiet = not cb._dirty_rows and not cb.queue
            before = cb.stats()["insert_dispatches_total"]
            torch.cuda.synchronize()
            t = time.perf_counter()
            cb.step()
            wall = (time.perf_counter() - t) * 1e3
            st = cb.stats()
            if busy and quiet and st["insert_dispatches_total"] == before:
                step_ms.append(wall / st["decode_chunk_size"])
    print(json.dumps(dict(
        bench="port_decode", label=args.label,
        root=os.path.relpath(os.path.abspath(args.root)),
        device=torch.cuda.get_device_name(0),
        decode_ms_per_token=sorted(samples)[1],
        decode_ms_per_token_samples=samples,
        generate_8_tokens_kernel_launches=launches_8,
        serving_ms_per_iteration=sorted(step_ms)[len(step_ms) // 2]
        if step_ms else None,
        serving_ms_per_iteration_steps=step_ms,
    )), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
