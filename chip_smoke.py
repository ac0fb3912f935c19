#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``jax_llama_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds every CUDA kernel of the port from ``jax_llama_tpu_torch/csrc``,
then runs these phases and prints one JSON line for each; any failure
raises and exits non-zero:

1. device: the card's name and power limit as ``nvidia-smi`` reports
   them; TF32 off for matmuls and cuDNN.
2. build, then kernel_check: each kernel against its plain PyTorch
   version in bf16 at the main path's shapes (flash forward: prefill B=4
   T=512 H=32 KVH=8 d=128 with left padding; decode T=1 over a 1024-slot
   cache with unwritten slots; a prefill chunk window at a non-zero base
   with a -1 tail; the serving phase's first insert, 8 right-padded rows
   at P=1024 with two padding rows), held to a max abs error below
   ``REL_BOUND`` times the shape's largest output, with its time, the
   plain version's, one PyTorch library call's
   (``scaled_dot_product_attention`` with the same boolean mask, timed
   here as a yardstick only) and the least time the card could take.
   Times are cold-L2: launches rotate over copies of the inputs that
   together exceed the 50 MB L2, as a decode step finds each layer's
   cache; the warm figure (one input set) is reported beside.
3. generate: ``LLaMA.generate_from_str`` at the full published width of
   llama3-8b (32 layers, bf16 weights drawn on the card from a seed,
   attn_impl="auto", byte tokenizer, greedy, 4 prompts padded to 512
   tokens, 32 new tokens).  Launch counts are zeroed just before and read
   just after; the flash kernel must have run once per layer of the one
   prefill forward.  Prefill ms (CUDA events) and decode ms per token
   (median of 3 pairs of 32- and 1-token generates) are timed apart, and
   torch.profiler gives the device busy share of one generate.
4. cached_decode: at the same width, decoding token by token over the
   cache must give the full forward's logits, under attn_impl "flash"
   (every step runs the kernel) and "auto": rel < 0.02 in bf16 at the
   verify recipe's depth of 8 layers, rel < 1e-3 in float32 activations
   at the full 32 (the bf16 32-layer figure is reported); and the flash
   forward must agree with the plain "xla" forward in float32 activations.
   The paged decode kernel is held against its plain version in the same
   phase 2 (``kernel_check``, shape ``serving``): bf16 at llama3-8b's
   serving shape (8 rows, KVH 8, G 4, d 128, blocks of 128, 16 table
   entries a row, a 32-layer pool read at layer 31; fills
   2047/1000/700/513/129/64/1/0 in shuffled physical blocks, row 5
   inactive, a sentinel table entry and an all -1 block; the output error
   is held per live row, against that row's largest output), with cold-L2
   times from rotating the layer over planes that exceed L2, the warm
   time, the plain time, the bound from the live slots' bytes, and
   ``scaled_dot_product_attention`` over a pre-gathered contiguous view
   with a boolean mask as the yardstick (the gather is not timed).
5. serving: ``ContinuousBatcher`` at llama3-8b width (bf16 weights from
   seed 0, 8 slots, max_len 2048, blocks of 128, decode_chunk 8, greedy):
   12 byte-tokenizer requests of 21-1000 prompt tokens and 16-64 new
   tokens, the second half submitted while the first decodes.  Launch
   counts are zeroed just before and read just after: the paged kernel
   must have run once per layer per decode iteration, the flash kernel
   once per layer per insert.  Every request must end with exactly its
   max_new tokens, all in the vocabulary, and every step that owed no
   admission or sync must have made one fetch and no upload.  Reported:
   decode ms per iteration and tokens/s at 8 busy slots (synchronised
   host clock), insert ms (8 rows), and the device busy share of three
   steady steps from torch.profiler.
6. paged_decode_invariant: 4 of those requests through the paged
   batcher, the gathered-view batcher and per-request
   ``engine.generate``, at 8 layers in bf16 and at 32 layers in float32
   activations: greedy tokens identical in float32 (the first divergence
   per request is reported in bf16, where late near-ties flip); one
   decode step's logits, paged vs gathered, rel < 0.02 (bf16, 8 layers)
   and < 1e-3 (float32, 32 layers).
7. kernels: one JSON object for every kernel of the port.

The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or outside a checkout of the repository, it exits non-zero before printing
any result.
"""

from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (dense): bf16 tensor-core FLOP/s, HBM bytes/s.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
# Kernel vs plain version in bf16: max abs error over max |plain output|.
# bf16's relative half-ulp is 2**-9 ~ 2e-3 (output rounding, and P rounded
# to bf16 for P.V); measured 1.0e-3..3.5e-3 over the flash shapes.
REL_BOUND = 1e-2
L2_BYTES = 50 * 2**20
DECODE_REL = 0.02    # cached decode vs full forward, bf16 (verify recipe)
DECODE_DEPTH = 8     # the verify recipe's depth for the bf16 bound
F32_REL = 1e-3       # the same checks in float32 activations, full depth

PREFILL_PADS = (0, 111, 311, 491)  # left padding of the 4 prompts at P=512

# Paged decode kernel at llama3-8b's serving shape: tokens held by each of
# the 8 rows, and the inactive row.
PAGED_FILLS = (2047, 1000, 700, 513, 129, 64, 1, 0)
PAGED_INACTIVE = (5,)
# |lse - plain lse| on rows with a live slot: both are float32 from the
# same bf16 inputs and differ only in summation order (~1e-6 measured).
LSE_BOUND = 1e-3
# The serving phase's 12 requests: BOS-prefixed prompt tokens, max_new.
SERVE_PROMPT_TOKENS = (1000, 21, 517, 130, 64, 300, 777, 45, 256, 900, 128,
                       600)
SERVE_MAX_NEW = (64, 16, 48, 32, 24, 56, 40, 16, 64, 32, 48, 24)
INVARIANT_REQUESTS = (1, 3, 4, 7)  # 4 of them, short, for the invariant
# The first admission of the serving phase: requests 0-5 (kb = 8 rows,
# the last two padding) prefill together at P = 1024.
INSERT_ROWS = SERVE_PROMPT_TOKENS[:6] + (0, 0)
FLASH_SHAPES = ("prefill", "decode", "chunk_window", "insert")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(torch, fns, iters=20, warmup=3) -> float:
    """Mean ms per call of ``fns`` (one callable, or a list called in
    rotation), launched back to back between two CUDA events."""
    fns = fns if isinstance(fns, list) else [fns]
    for i in range(warmup):
        fns[i % len(fns)]()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fns[i % len(fns)]()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def cold_copies(args):
    """Copies of one input set, enough that together they exceed L2 four
    times over, so each launch in a rotation finds its inputs cold."""
    nbytes = sum(t.numel() * t.element_size() for t in args)
    n = max(2, -(-4 * L2_BYTES // nbytes))
    return [args] + [tuple(t.clone() for t in args) for _ in range(n - 1)]


def flash_inputs(torch, name, gen):
    """bf16 inputs of the flash kernel at one main-path shape."""
    B, H, KVH, d = 4, 32, 8, 128
    dev = "cuda"
    if name == "insert":
        # The serving phase's first admission as _paged_insert builds it:
        # 8 right-padded rows at P=1024 into a fresh cache (no unwritten
        # slot past the prompt), padding queries at position 0.
        B, T = len(INSERT_ROWS), 1024
        S = T
        slots = torch.arange(S, device=dev)[None, :]
        lens = torch.tensor(INSERT_ROWS, device=dev)[:, None]
        kv_pos = torch.where(slots < lens, slots, -1)
        q_pos = kv_pos.clamp(min=0)
    elif name == "prefill":
        T = S = 512
        pos = torch.arange(S, device=dev)[None, :] - torch.tensor(
            PREFILL_PADS, device=dev)[:, None]
        kv_pos = torch.where(pos >= 0, pos, -1)
        q_pos = kv_pos.clamp(min=0)
    elif name == "decode":
        T, S = 1, 1024
        fill = torch.tensor([1000, 700, 513, 64], device=dev)
        slots = torch.arange(S, device=dev)[None, :]
        kv_pos = torch.where(slots < fill[:, None], slots, -1)
        q_pos = (fill - 1)[:, None]
    elif name == "chunk_window":
        T, S, base = 256, 1024, 512
        slots = torch.arange(S, device=dev)[None, :].expand(B, S)
        kv_pos = torch.where(slots < base + T, slots, -1)
        q_pos = (base + torch.arange(T, device=dev))[None, :].expand(B, T)
    else:
        raise KeyError(name)
    q = torch.randn(B, T, H, d, device=dev, generator=gen).to(torch.bfloat16)
    k = torch.randn(B, S, KVH, d, device=dev, generator=gen).to(torch.bfloat16)
    v = torch.randn(B, S, KVH, d, device=dev, generator=gen).to(torch.bfloat16)
    return (q, k, v, q_pos.to(torch.int32).contiguous(),
            kv_pos.to(torch.int32).contiguous())


def flash_bound(q, k, v, q_pos, kv_pos):
    """Least time (ms) the card could take: the bytes this data needs moved
    over HBM bandwidth -- q, the positions and the output once, and only
    the K/V rows some query of the row may attend (0 <= kv_pos <= the
    row's largest q_pos; padding and unwritten slots are never read) --
    vs the tensor-core FLOPs that this data's live (query, slot) pairs
    need (QK and PV, 2*d each, per head) over the bf16 peak."""
    needed = ((kv_pos >= 0)
              & (kv_pos <= q_pos.max(dim=1, keepdim=True).values)).sum().item()
    kv_row = k.shape[2] * k.shape[3] * k.element_size()
    nbytes = (2 * q.numel() * q.element_size() + 2 * needed * kv_row
              + sum(t.numel() * t.element_size() for t in (q_pos, kv_pos)))
    kp = kv_pos[:, None, :]
    live = ((kp >= 0) & (kp <= q_pos[:, :, None])).sum().item()
    flops = 4.0 * q.shape[-1] * q.shape[2] * live
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def library_attention(torch, q, k, v, q_pos, kv_pos):
    """One PyTorch call computing the same function (yardstick only)."""
    import torch.nn.functional as F

    kp = kv_pos[:, None, :]
    mask = ((kp >= 0) & (kp <= q_pos[:, :, None]))[:, None]  # [B,1,T,S]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True)


def check_flash(torch, fa, gen):
    results = {}
    for name in FLASH_SHAPES:
        args = flash_inputs(torch, name, gen)
        out = fa.flash_attention(*args)
        torch.cuda.synchronize()
        ref = fa.flash_attention_reference(*args)
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"flash {name}: non-finite output")
        err = (out.float() - ref.float()).abs().max().item()
        rel = err / ref.float().abs().max().item()
        copies = cold_copies(args)
        ms = time_ms(torch, [lambda a=a: fa.flash_attention(*a)
                             for a in copies], iters=4 * len(copies))
        warm_ms = time_ms(torch, lambda: fa.flash_attention(*args))
        plain_ms = time_ms(torch, [
            lambda a=a: fa.flash_attention_reference(*a) for a in copies
        ], iters=len(copies))
        library_ms = time_ms(torch, [library_attention(torch, *a)
                                     for a in copies], iters=4 * len(copies))
        del copies
        bound_ms, bound_by = flash_bound(*args)
        row = dict(
            phase="kernel_check", kernel="flash_fwd", shape=name,
            B=args[0].shape[0], T=args[0].shape[1], S=args[1].shape[1],
            H=args[0].shape[2], KVH=args[1].shape[2], d=args[0].shape[3],
            dtype="bfloat16", max_abs_err=err, max_rel_err=rel,
            rel_bound=REL_BOUND, ms=ms, warm_ms=warm_ms, plain_ms=plain_ms,
            library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
            roofline_share=bound_ms / ms,
        )
        emit(row)
        if not rel < REL_BOUND:
            raise AssertionError(
                f"flash {name}: max abs err {err} is {rel} of max |plain|, "
                f"bound {REL_BOUND}")
        results[name] = row
    return results


def paged_inputs(torch, gen, B=8, KVH=8, G=4, d=128, BLK=128, MB=16,
                 L=32):
    """bf16 inputs of the paged kernel at llama3-8b's serving shape: row b
    holds PAGED_FILLS[b] tokens in shuffled physical blocks of a 32-layer
    pool, with one spare reserved block, and queries at position
    PAGED_FILLS[b] (-1 for the inactive row); row 2's table has a sentinel
    entry inside it and row 1 an all -1 block."""
    NB = B * MB
    perm = torch.randperm(NB, generator=gen, device="cuda").tolist()
    table = torch.full((B, MB), NB, dtype=torch.int32)
    pos = torch.full((NB, BLK), -1, dtype=torch.int32)
    q_pos = torch.empty((B,), dtype=torch.int32)
    for b, f in enumerate(PAGED_FILLS):
        for j in range(min(MB, -(-f // BLK) + 1)):
            blk = perm.pop()
            table[b, j] = blk
            m = max(0, min(BLK, f - j * BLK))
            pos[blk, :m] = torch.arange(j * BLK, j * BLK + m)
        q_pos[b] = -1 if b in PAGED_INACTIVE else f
    table[2, 2:] = torch.cat([torch.tensor([NB], dtype=torch.int32),
                              table[2, 2:-1]])
    pos[table[1, 2]] = -1
    q = torch.randn(B, KVH, G, d, device="cuda", generator=gen)
    k = torch.randn(L, KVH, NB, BLK, d, device="cuda", generator=gen)
    v = torch.randn(L, KVH, NB, BLK, d, device="cuda", generator=gen)
    return ([t.to(torch.bfloat16) for t in (q, k, v)]
            + [t.cuda() for t in (pos, table, q_pos)])


def paged_gathered_mask(torch, pos, table, q_pos):
    """Each row's table blocks as one contiguous slot axis: the gather
    index [B, MB] and the attendable mask [B, MB*BLK]."""
    NB, BLK = pos.shape
    blk = table.long().clamp(0, NB - 1)
    dead = (table < 0) | (table >= NB)
    kp = torch.where(dead[:, :, None], -1, pos[blk]).reshape(blk.shape[0], -1)
    return blk, (kp >= 0) & (kp <= q_pos[:, None])


def paged_bound(torch, q, k, pos, table, q_pos):
    """Least time (ms): the live slots' K/V (0 <= pos <= q_pos, read once
    per KV head) plus q, out, lse, table and the position plane over HBM
    bandwidth, vs the live (query head, slot) pairs' QK and PV FLOPs over
    the bf16 peak."""
    _, allowed = paged_gathered_mask(torch, pos, table, q_pos)
    live = allowed.sum().item()
    B, KVH, G, d = q.shape
    nbytes = (2 * live * KVH * d * k.element_size()
              + q.numel() * q.element_size() + B * KVH * G * (d + 1) * 4
              + table.numel() * 4 + pos.numel() * 4)
    flops = 4.0 * d * G * KVH * live
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_paged(torch, pa, gen):
    """paged_decode against its plain version at the serving shape."""
    import torch.nn.functional as F

    args = paged_inputs(torch, gen)
    q, k, v, pos, table, q_pos = args
    L, KVH, NB, BLK, d = k.shape
    B, _, G, _ = q.shape
    layer = L - 1
    out, lse = pa.paged_pool_attention(*args, layer=layer)
    torch.cuda.synchronize()
    ref_out, ref_lse = pa.paged_pool_attention_reference(*args, layer=layer)
    live = ref_lse > pa.MASK_VALUE / 2
    finite = bool(torch.isfinite(out).all() and torch.isfinite(lse).all())
    err = (out - ref_out).abs().max().item()
    # Per live row: its max abs error over its own max |plain|, so a long
    # row (small, averaged outputs) is not held to a short row's scale.
    row_err = (out - ref_out).abs().amax(dim=(1, 2, 3))
    row_scale = ref_out.abs().amax(dim=(1, 2, 3))
    live_rows = live.all(dim=(1, 2))
    row_rel = (row_err / row_scale)[live_rows]
    rel = row_rel.max().item()
    lse_err = (lse - ref_lse)[live].abs().max().item()
    dead_ok = bool((lse[~live] == pa.MASK_VALUE).all()
                   and (out[~live] == 0).all())
    # Cold: each launch reads another layer's plane (67 MB of K/V each).
    ms = time_ms(torch, [
        lambda i=i: pa.paged_pool_attention(q, k, v, pos, table, q_pos, i)
        for i in range(L)], iters=4 * L)
    warm_ms = time_ms(torch, lambda: pa.paged_pool_attention(
        q, k, v, pos, table, q_pos, layer))
    plain_ms = time_ms(torch, [
        lambda i=i: pa.paged_pool_attention_reference(
            q, k, v, pos, table, q_pos, i) for i in range(L)], iters=L)
    # Yardstick: SDPA over views gathered beforehand (gather not timed),
    # enough layers that their views exceed L2 four times.
    blk, allowed = paged_gathered_mask(torch, pos, table, q_pos)
    mask = allowed[:, None, None, :]
    qt = q.reshape(B, KVH * G, 1, d)
    view_bytes = 2 * KVH * blk.numel() * BLK * d * k.element_size()
    n_views = max(2, -(-4 * L2_BYTES // view_bytes))
    views = []
    for i in range(n_views):
        kg, vg = (t[i % L][:, blk].reshape(KVH, B, -1, d).transpose(0, 1)
                  .contiguous() for t in (k, v))
        views.append((kg, vg))
    library_ms = time_ms(torch, [
        lambda kg=kg, vg=vg: F.scaled_dot_product_attention(
            qt, kg, vg, attn_mask=mask, enable_gqa=True)
        for kg, vg in views], iters=4 * n_views)
    del views
    bound_ms, bound_by = paged_bound(torch, q, k, pos, table, q_pos)
    row = dict(
        phase="kernel_check", kernel="paged_decode", shape="serving",
        B=B, KVH=KVH, G=G, d=d, BLK=BLK, MB=table.shape[1], L=L,
        layer=layer, fills=list(PAGED_FILLS), inactive=list(PAGED_INACTIVE),
        dtype="bfloat16", max_abs_err=err, max_rel_err=rel,
        rel_err_by_live_row=row_rel.tolist(),
        rel_bound=REL_BOUND, lse_max_abs_err=lse_err, lse_bound=LSE_BOUND,
        dead_rows_ok=dead_ok, ms=ms, warm_ms=warm_ms, plain_ms=plain_ms,
        library_ms=library_ms, library="scaled_dot_product_attention over "
        "a pre-gathered view, bool mask, gather not timed",
        bound_ms=bound_ms, bound_by=bound_by, roofline_share=bound_ms / ms,
    )
    emit(row)
    if not (finite and dead_ok and rel < REL_BOUND and lse_err < LSE_BOUND):
        raise AssertionError(
            f"paged_decode: finite {finite}, dead rows {dead_ok}, max abs "
            f"err {err} (worst live row: {rel} of its max |plain|, bound "
            f"{REL_BOUND}), lse err "
            f"{lse_err} (bound {LSE_BOUND})")
    return row


def prompts_for():
    """4 prompts whose BOS-prefixed lengths are 512 - PREFILL_PADS."""
    text = ("The quick brown fox jumps over the lazy dog while the port "
            "runs its first slice on the card. ") * 8
    return [text[:512 - pad - 1] for pad in PREFILL_PADS]


def device_profile(torch, fn):
    """Device busy share and the top kernels by device time over ``fn()``,
    from torch.profiler; None where the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return dict(
        wall_ms=wall_ms,
        device_ms=device_ms or None,
        device_busy_share=(device_ms / wall_ms) if device_ms else None,
        kernel_launches=sum(e.count for e in kernels),
        top_kernels=[dict(name=e.key[:60], ms=e.self_device_time_total / 1e3,
                          count=e.count) for e in top],
    )


def serve_prompts(tok):
    """The serving phase's 12 byte-tokenizer prompts (BOS included)."""
    text = ("The quick brown fox jumps over the lazy dog while the port "
            "serves a continuous batch from its paged pool on the card. ") * 24
    return [tok.encode(text[7 * i:7 * i + n - 1], bos=True)
            for i, n in enumerate(SERVE_PROMPT_TOKENS)]


def drive_serving(torch, ptl, fa, pa, params, cfg, tok):
    """Phase 5: the batcher at llama3-8b width, staggered admissions."""
    prompts = serve_prompts(tok)
    assert [len(p) for p in prompts] == list(SERVE_PROMPT_TOKENS)
    t0 = time.perf_counter()
    cb = ptl.ContinuousBatcher(params, cfg, n_slots=8, max_len=2048,
                               decode_chunk=8, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    L = cfg.n_layers
    results, rids = {}, {}
    steady_ms, steady_iters, steady_tokens = [], 0, 0
    quiet_steps, quiet_bad = 0, []
    fa.flash_attention.launches = 0
    pa.paged_pool_attention.launches = 0
    t0 = time.perf_counter()
    for i in range(6):
        rids[cb.submit(prompts[i], max_new_tokens=SERVE_MAX_NEW[i])] = i
    n_steps = 0
    while cb.pending():
        if n_steps == 2:  # the second half lands while the first decodes
            for i in range(6, 12):
                rids[cb.submit(prompts[i],
                               max_new_tokens=SERVE_MAX_NEW[i])] = i
        free = any(s is None for s in cb.slots.values())
        quiet = not cb._dirty_rows and not (cb.queue and free)
        busy = not free
        before = cb.stats()
        torch.cuda.synchronize()
        t = time.perf_counter()
        events = cb.step()
        wall = (time.perf_counter() - t) * 1e3
        after = cb.stats()
        n_steps += 1
        for rid, tok_id, _ in events:
            results.setdefault(rid, []).append(tok_id)
        if quiet:
            quiet_steps += 1
            if (after["state_uploads_total"] != before["state_uploads_total"]
                    or after["host_syncs_total"]
                    != before["host_syncs_total"] + 1):
                quiet_bad.append(n_steps)
        if (quiet and busy and after["insert_dispatches_total"]
                == before["insert_dispatches_total"]):
            steady_ms.append(wall)
            steady_iters += after["decode_chunk_size"]
            steady_tokens += len(events)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    stats = cb.stats()
    launches = {"flash_fwd": fa.flash_attention.launches,
                "paged_decode": pa.paged_pool_attention.launches}
    lens = {rids[r]: len(t) for r, t in results.items()}
    in_vocab = all(0 <= t < cfg.vocab_size
                   for toks in results.values() for t in toks)
    exact = lens == {i: SERVE_MAX_NEW[i] for i in range(12)}

    # Insert time: 8 of the requests admitted into the idle batcher.
    for i in range(8):
        cb.submit(prompts[i], max_new_tokens=SERVE_MAX_NEW[i])
    torch.cuda.synchronize()
    t = time.perf_counter()
    cb._admit()
    torch.cuda.synchronize()
    insert_ms = (time.perf_counter() - t) * 1e3
    cb.step()  # the K=1 step after an admission
    profile = device_profile(torch, lambda: [cb.step() for _ in range(3)])
    for b, s in list(cb.slots.items()):
        if s is not None:
            cb.cancel(s.request_id)
    del cb

    wall = sum(steady_ms)
    row = dict(
        phase="serving", config="llama3-8b", n_layers=L, dtype="bfloat16",
        n_slots=8, max_len=2048, block_size=128, decode_chunk=8,
        prompt_tokens=list(SERVE_PROMPT_TOKENS),
        max_new=list(SERVE_MAX_NEW), batcher_init_s=build_s,
        serve_s=serve_s, steps=n_steps, launches=launches, stats=stats,
        tokens_exact=exact, tokens_in_vocab=in_vocab,
        quiet_steps=quiet_steps, quiet_steps_with_upload_or_extra_fetch=(
            quiet_bad),
        steady_steps=len(steady_ms), steady_iterations=steady_iters,
        decode_ms_per_iteration=wall / steady_iters if steady_iters else None,
        tokens_per_s=steady_tokens / wall * 1e3 if wall else None,
        insert_ms=insert_ms, insert_rows=8,
        profile_3_steps=profile,
    )
    emit(row)
    want = {"paged_decode": L * stats["decode_steps_total"],
            "flash_fwd": L * stats["insert_dispatches_total"]}
    if launches != want:
        raise AssertionError(f"serving launches {launches}, expected {want}")
    if not (exact and in_vocab):
        raise AssertionError(f"serving tokens: lengths {lens}, in vocab "
                             f"{in_vocab}")
    if quiet_steps == 0 or quiet_bad or not steady_iters:
        raise AssertionError(
            f"steady state: {quiet_steps} quiet steps, {quiet_bad} with an "
            f"upload or more than one fetch, {steady_iters} iterations at 8 "
            f"busy slots")
    if stats["insert_dispatches_total"] < 2:
        raise AssertionError("no admission landed between decode steps")
    return row


def first_divergence(a, b):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                None if len(a) == len(b) else min(len(a), len(b)))


def step_logits_rel(torch, ptl, serving, params, cfg, prompts):
    """One decode step's logits over the same admitted pool: the paged
    kernel vs the gathered view (active rows)."""
    cb = ptl.ContinuousBatcher(params, cfg, n_slots=len(prompts),
                               max_len=2048, device="cuda")
    for p in prompts:
        cb.submit(p, max_new_tokens=8)
    with torch.inference_mode():
        cb._admit()
        cb._sync_device_rows()
        positions = torch.where(cb.d_active, cb.d_pos, -1)[:, None]
        args = (cb.tau[:, None], positions, cfg)
        mask = cb.d_active[:, None]
        view = serving._gather_cache(cb.pool, cb.d_table, cb.d_n_alloc,
                                     cb.d_fill)
        want = ptl.forward(params, *args, cache=view, attn_mask=mask)[0]
        del view
        paged = ptl.PagedKVCache(cb.pool.k, cb.pool.v, cb.pool.pos,
                                 cb.d_table, cb.d_fill)
        got = ptl.forward(params, *args, cache=paged, attn_mask=mask)[0]
    return rel_err(got[:, 0], want[:, 0])


def paged_invariant(torch, ptl, engine, serving, params, cfg, tok):
    """Phase 6: paged batcher = gathered batcher = engine.generate."""
    prompts = [serve_prompts(tok)[i] for i in INVARIANT_REQUESTS]
    max_new = [SERVE_MAX_NEW[i] for i in INVARIANT_REQUESTS]
    shallow = dict(params, layers={k: w[:DECODE_DEPTH]
                                   for k, w in params["layers"].items()})
    cells = {}
    for name, p, depth, dtype, bound in (
        ("bf16_8_layers", shallow, DECODE_DEPTH, "bfloat16", DECODE_REL),
        ("f32_32_layers", params, cfg.n_layers, "float32", F32_REL),
    ):
        c = cfg.replace(n_layers=depth, dtype=dtype)
        toks = {}
        for path in ("paged", "gathered"):
            cb = ptl.ContinuousBatcher(p, c, n_slots=4, max_len=2048,
                                       decode_chunk=8, device="cuda",
                                       use_pallas_kernel=path == "paged")
            rids = [cb.submit(pr, max_new_tokens=n)
                    for pr, n in zip(prompts, max_new)]
            res = cb.run_to_completion()
            toks[path] = [res[r] for r in rids]
            del cb
        toks["generate"] = [
            engine.generate(
                p, torch.tensor([pr], dtype=torch.int32),
                torch.ones((1, len(pr)), dtype=torch.bool), config=c,
                gen_config=engine.GenerationConfig(max_new_tokens=n,
                                                   temperature=0.0),
                device="cuda")[0, len(pr):].tolist()
            for pr, n in zip(prompts, max_new)]
        rel = step_logits_rel(torch, ptl, serving, p, c, prompts)
        cells[name] = dict(
            identical=toks["paged"] == toks["gathered"] == toks["generate"],
            first_divergence={
                f"paged_vs_{o}": [first_divergence(a, b) for a, b in
                                  zip(toks["paged"], toks[o])]
                for o in ("gathered", "generate")},
            step_logits_rel=rel, step_logits_bound=bound,
        )
    row = dict(phase="paged_decode_invariant", config="llama3-8b",
               requests=list(INVARIANT_REQUESTS),
               prompt_tokens=[len(p) for p in prompts], max_new=max_new,
               **cells)
    emit(row)
    held = (cells["f32_32_layers"]["identical"]
            and all(cells[n]["step_logits_rel"] < cells[n]["step_logits_bound"]
                    for n in cells))
    if not held:
        raise AssertionError(f"paged decode invariant failed: {cells}")
    return row


def rel_err(a, b) -> float:
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import jax_llama_tpu_torch as ptl
    from jax_llama_tpu_torch import engine, serving
    from jax_llama_tpu_torch.ops import _build

    fa = importlib.import_module("jax_llama_tpu_torch.ops.flash_attention")
    pa = importlib.import_module("jax_llama_tpu_torch.ops.paged_attention")

    # Phase 1: the card.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    emit(dict(phase="device", nvidia_smi=smi, kind=kind,
              count=torch.cuda.device_count(), torch=torch.__version__,
              cuda=torch.version.cuda))

    # Phase 2: build every kernel (one nvcc per source, in parallel),
    # check each against its plain version.
    t0 = time.perf_counter()
    libs = _build.build_all()
    ptxas = {name: [ln.strip() for ln in _build.build_log(name).splitlines()
                    if "registers" in ln or "spill" in ln] for name in libs}
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              libraries=[os.path.relpath(p, HERE) for p in libs.values()],
              ptxas=ptxas))
    gen = torch.Generator(device="cuda").manual_seed(0)
    flash_rows = check_flash(torch, fa, gen)
    paged_row = check_paged(torch, pa, gen)

    # Phase 3: the main path, llama3-8b width, bf16, attn_impl="auto".
    cfg = ptl.get_config("llama3-8b", param_dtype="bfloat16",
                         dtype="bfloat16", attn_impl="auto")
    t0 = time.perf_counter()
    params = ptl.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tok = ptl.ByteTokenizer()
    llm = ptl.LLaMA(params, cfg, tok, device="cuda")
    prompts = prompts_for()
    lens = [len(tok.encode(p, bos=True)) for p in prompts]
    assert all(n > 9 for n in lens), lens

    fa.flash_attention.launches = 0
    pa.paged_pool_attention.launches = 0
    t0 = time.perf_counter()
    texts = llm.generate_from_str(prompts, max_gen_len=32, temperature=0.0)
    torch.cuda.synchronize()
    generate_s = time.perf_counter() - t0
    launches = {"flash_fwd": fa.flash_attention.launches,
                "paged_decode": pa.paged_pool_attention.launches}
    if launches["flash_fwd"] != cfg.n_layers:
        raise AssertionError(
            f"flash kernel launched {launches['flash_fwd']} times in the "
            f"main path, expected {cfg.n_layers} (one prefill forward)"
        )

    # Timing apart from the counted run: prefill alone, and decode per
    # token as the difference of 32 and 1 new tokens (no stop tokens).
    P = 512
    tokens = torch.full((4, P), tok.pad_id, dtype=torch.int32)
    mask = torch.zeros((4, P), dtype=torch.bool)
    for i, p in enumerate(prompts):
        ids = tok.encode(p, bos=True)
        tokens[i, P - len(ids):] = torch.tensor(ids)
        mask[i, P - len(ids):] = True
    tokens, mask = tokens.cuda(), mask.cuda()
    positions = engine.prompt_positions(mask)

    def prefill():
        cache = ptl.init_cache(cfg, 4, max_len=P + 32, device="cuda")
        with torch.inference_mode():
            return ptl.forward(params, tokens, positions, cfg, cache=cache,
                               attn_mask=mask)[0]

    logits = prefill()
    finite = bool(torch.isfinite(logits).all())
    prefill_ms = time_ms(torch, prefill, iters=5, warmup=1)
    del logits

    def gen_ms(n):
        gc = engine.GenerationConfig(max_new_tokens=n, temperature=0.0)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = engine.generate(params, tokens, mask, config=cfg, gen_config=gc,
                              device="cuda")
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3, out

    # The decode step is host-bound and the host's cores are shared, so
    # one pair is noisy: take the median of 3 pairs, report all of them.
    gen_ms(1)
    samples = []
    for _ in range(3):
        one_ms, _ = gen_ms(1)
        many_ms, out = gen_ms(32)
        samples.append((many_ms - one_ms) / 31)
    decode_ms = sorted(samples)[1]
    out_ok = (tuple(out.shape) == (4, P + 32)
              and bool((out[:, P:] >= 0).all())
              and bool((out[:, P:] < cfg.vocab_size).all()))
    emit(dict(phase="generate", config="llama3-8b", n_layers=cfg.n_layers,
              dim=cfg.dim, dtype="bfloat16", attn_impl="auto", batch=4,
              prompt_tokens=lens, padded_len=P, max_gen_len=32,
              init_params_s=init_s, generate_from_str_s=generate_s,
              launches=launches, prefill_ms=prefill_ms,
              decode_ms_per_token=decode_ms,
              decode_ms_per_token_samples=samples, logits_finite=finite,
              tokens_ok=out_ok, sample=texts[0][:40]))
    if not (finite and out_ok and len(texts) == 4):
        raise AssertionError("generate phase produced bad output")

    gc = engine.GenerationConfig(max_new_tokens=32, temperature=0.0)
    profile = device_profile(torch, lambda: engine.generate(
        params, tokens, mask, config=cfg, gen_config=gc, device="cuda"))
    emit(dict(phase="generate_profile", max_new_tokens=32, **profile))

    # Phase 4: the verify recipe's invariant -- 8 tokens decoded one at a
    # time over a 1024-slot cache give the full forward's logits -- under
    # "flash" (every step runs the kernel) and "auto" (T <= 8: the plain
    # path).  In bf16 the two sides round at different points (GEMMs of
    # 16 rows against 2), and random 32-layer stacks amplify that: the
    # bf16 bound is held at the recipe's depth of 8 layers, the full
    # depth is held in float32 activations (same bf16 weights), and the
    # bf16 full-depth figure is reported.  Then the flash forward against
    # the plain "xla" forward at T=16, held in float32 activations.
    g = torch.Generator(device="cuda").manual_seed(1)
    T = 16
    toks = torch.randint(0, cfg.vocab_size, (2, T), device="cuda",
                         generator=g, dtype=torch.int32)
    pos = torch.arange(T, device="cuda", dtype=torch.int32)[None].repeat(2, 1)
    shallow = dict(params, layers={k: w[:DECODE_DEPTH]
                                   for k, w in params["layers"].items()})
    cells = {}
    with torch.inference_mode():
        for impl in ("flash", "auto"):
            for name, p, depth, dtype in (
                ("bf16_8_layers", shallow, DECODE_DEPTH, "bfloat16"),
                ("bf16_32_layers", params, cfg.n_layers, "bfloat16"),
                ("f32_32_layers", params, cfg.n_layers, "float32"),
            ):
                c = cfg.replace(attn_impl=impl, n_layers=depth, dtype=dtype)
                full = ptl.forward(p, toks[:, :8], pos[:, :8], c)[0]
                cache = ptl.init_cache(c, 2, max_len=1024, device="cuda")
                before = fa.flash_attention.launches
                outs = []
                for i in range(8):
                    lg, cache = ptl.forward(p, toks[:, i:i + 1],
                                            pos[:, i:i + 1], c, cache=cache)
                    outs.append(lg[:, 0])
                cells[f"{impl}_{name}_rel"] = rel_err(torch.stack(outs, 1),
                                                      full)
                cells[f"{impl}_{name}_decode_launches"] = (
                    fa.flash_attention.launches - before)
                del full, cache, outs
        for dtype in ("float32", "bfloat16"):
            full = {
                impl: ptl.forward(params, toks, pos, cfg.replace(
                    attn_impl=impl, dtype=dtype))[0]
                for impl in ("flash", "xla")
            }
            cells[f"flash_vs_xla_{dtype}_rel"] = rel_err(
                full["flash"], full["xla"])
            del full
    emit(dict(phase="cached_decode", config="llama3-8b", cache_len=1024,
              bf16_bound=DECODE_REL, f32_bound=F32_REL, **cells))
    held = [cells[f"{i}_bf16_8_layers_rel"] < DECODE_REL
            for i in ("flash", "auto")]
    held += [cells[f"{i}_f32_32_layers_rel"] < F32_REL
             for i in ("flash", "auto")]
    held.append(cells["flash_vs_xla_float32_rel"] < F32_REL)
    if not all(held):
        raise AssertionError(f"cached decode invariant failed: {cells}")
    if cells["flash_f32_32_layers_decode_launches"] != 8 * cfg.n_layers:
        raise AssertionError("flash decode did not run the kernel each step")

    # Phase 5: the serving path, counted from zero.
    serve_row = drive_serving(torch, ptl, fa, pa, params, cfg, tok)

    # Phase 6: paged = gathered = standalone generate.
    paged_invariant(torch, ptl, engine, serving, params, cfg, tok)

    # Phase 7: every kernel of the port.  ``launches`` counts the serving
    # path's run (this slice's main path); each path's count is beside it.
    # The flash times are the serving insert's shape, the launches' path.
    pre = flash_rows["insert"]
    served = serve_row["launches"]
    emit({"kernels": [
        dict(name="flash_fwd", route="cuda",
             source="jax_llama_tpu_torch/csrc/flash_fwd.cu",
             replaces="jax_llama_tpu/ops/flash_attention.py:868",
             launches=served["flash_fwd"],
             launches_by_path={"generate": launches["flash_fwd"],
                               "serving": served["flash_fwd"]},
             max_abs_err=max(r["max_abs_err"] for r in flash_rows.values()),
             shape="insert", ms=pre["ms"], kernel_ms=pre["ms"],
             plain_ms=pre["plain_ms"],
             bound_ms=pre["bound_ms"], bound_by=pre["bound_by"],
             library_ms=pre["library_ms"]),
        dict(name="paged_decode", route="cuda",
             source="jax_llama_tpu_torch/csrc/paged_decode.cu",
             replaces="jax_llama_tpu/ops/paged_attention.py:371",
             launches=served["paged_decode"],
             launches_by_path={"generate": launches["paged_decode"],
                               "serving": served["paged_decode"]},
             shape="serving", max_abs_err=paged_row["max_abs_err"],
             ms=paged_row["ms"],
             kernel_ms=paged_row["ms"], plain_ms=paged_row["plain_ms"],
             bound_ms=paged_row["bound_ms"], bound_by=paged_row["bound_by"],
             library_ms=paged_row["library_ms"]),
    ]})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
