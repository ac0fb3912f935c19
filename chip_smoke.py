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
   at P=1024 with two padding rows; and in float32 the cached_decode
   phase's step, 2 rows at T=1 over a 1024-slot cache with 8 written),
   each packed query row held to a max abs error below ``REL_BOUND``
   (float32: 1e-4) times that row's largest plain output
   (``row_rel_err``), with its time, the
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
   with a boolean mask as the yardstick (the gather is not timed).  And
   at the speculative verify shape (``kernel_check`` shape
   ``spec_verify``): 4 rows, KVH 8, T = 4 tokens (n_draft 3 + 1) x G 4 =
   16 packed query rows, d 128, blocks of 128, fills 500/516/532/548 in a
   32-layer pool, in bf16 and in float32: each packed query row held to
   ``REL_BOUND`` (bf16) or 1e-4 (float32) of its own max |plain|, the lse
   below 1e-3 abs; the same times, the yardstick with the [T, S]
   positional mask.
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
   Phase 2 also holds the training kernels (``kernel_check`` shape
   ``train``): the flash forward with lse and the backward kernels
   ``flash_bwd_dq`` and ``flash_bwd_dkv`` at the training shape (B=4,
   T=S=2048, H=32, KVH=8, d=128, bf16, causal positions), without and
   with dropout (rate 0.1, fixed seed words), against their plain
   versions, each row against its own scale (out and dq per packed query
   row, dk and dv per KV slot: the row's max abs error over the row's max
   |plain|; under the causal mask values shrink along the sequence, so
   one scale for the whole tensor would hold the late rows loosely)
   below 1e-2 for out and 2e-2 for dq, dk and dv, and the lse's max abs
   error below 1e-3; the float32 path below 1e-4 at B=2, T=S=256, H=8,
   KVH=2.  The dq row of a query that sees one or two slots is held
   against the tensor's max |plain| (``short_rows``: its exact value is
   zero, or one difference dP0 - dP1 scales the whole row, so a near tie
   leaves the plain value at its rounding noise), as is a row whose plain
   value is all zero.  Each has its
   cold-L2 time, the plain version's,
   ``scaled_dot_product_attention``'s forward or its backward through
   autograd (``is_causal``, ``enable_gqa``; a yardstick only) and its
   bound: the larger of its bytes (each input read once, each output
   written once) over 3.35 TB/s and its FLOPs over 989 TFLOP/s, counted
   per live (packed row, slot) pair as 4*d (forward), 6*d (dQ: S, dP,
   dS K) and 8*d (dK/dV: S, dP, P^T dO, dS^T Q).
7. spec_serving: ``ContinuousBatcher(n_slots=4, max_len=1024,
   block_size=128, n_draft=3, spec_rounds=8)`` at llama3-8b width and
   depth (bf16), 4 prompts of 500 random ids (numpy seed 0), 48 new tokens
   each (the JAX bench's speculative setup).  Self-draft
   (``draft_params=params``): launch counts zeroed just before and read
   just after; every round must launch the paged kernel (3 + 1) x 32 + 32
   = 160 times, all at T = 4, the flash kernel 64 times per admission
   burst (target and draft prefill); acceptance exactly 1.0 and 48 tokens
   per request.  Then the target nudged by +-2% relative noise (seeded
   generator) as the draft, one request sampled (temperature 0.8, top_p
   0.95, a fixed seed): acceptance below 1.0.  Reported: tokens/s, ms per
   round, host syncs per token, the busy share of one round
   (torch.profiler), and the plain batcher's tokens/s on the same prompts.
   Invariants: the verify's T = 4 logits against four T = 1 paged steps
   over the same pool, rel < 0.02 in bf16 at 8 layers and < 1e-3 in
   float32 activations at 32 layers, where the greedy speculative tokens
   (perturbed draft) must equal the plain batcher's.  The 16 GB draft
   copy is freed before the next phase.
   Phase 2 also holds the int8 kernels: ``flash_fwd_int8`` at the serving
   insert shape (8 right-padded rows, P = 1024, K/V quantized with
   ``quantize_kv``) in bf16 and float32 q, and the int8 paged kernel at
   the serving shape (T = 1), the spec_verify shape (T = 4, bf16 and
   float32) and a G = 8, T = 5 verify whose 40 packed rows run as one
   launch under the kernel's 64-row cap (``launches_by_t`` must be
   {5: 1}): each
   packed row within ``REL_BOUND`` (bf16) or 1e-4 (float32) of its own
   max |plain|, the lse within 1e-3; cold-L2, warm and plain times, SDPA
   over a dequantized copy (the dequantize not timed) as the yardstick,
   and a bound that counts 1 byte per K/V element plus 4 bytes per slot
   and KV head for each scale plane.
8. int8: ``quantize_params`` of the phase-3 weights with
   ``kv_cache_dtype="int8"``.  ``int8_serving`` runs phase 5's 12
   staggered requests through int8 pools, counted from zero: the int8
   paged kernel once per layer per decode iteration (all at T = 1), the
   int8 flash kernel once per layer per insert, no bf16 kernel; every
   request its exact max_new tokens; the same figures as phase 5, and an
   ``int8_vs_bf16_serving`` line puts them beside phase 5's with the
   device ms by kernel group (int8 weights are cast to bf16 per call, so
   they stream more bytes than bf16 weights in this port).
   ``int8_paged_decode_invariant``: phase 6's float32 cell with int8
   weights and pools (paged = gathered = ``engine.generate`` tokens).
   ``int8_spec_serving``: phase 7's self-draft over int8 target and draft
   pools: acceptance exactly 1.0, 160 int8 paged launches a round, all at
   T = 4.  The int8 weights are freed before the next phase.
9. train: ``train_step`` at llama3-8b width cut to 8 layers (a copy of
   the first 8 layers of phase 3's weights: params, grads and AdamW's
   two moments in bf16 at 32 layers would be ~64 GB beside the 16 GB of
   weights), bf16, remat "dots", attn_impl "flash", ``make_optimizer()``
   defaults, one batch of 4 x 2048 tokens packed by ``data.batches`` from
   random documents (numpy seed 0).  Launch counts are zeroed just before
   and read just after 5 steps: every step must launch the flash forward
   2 x 8 times (once per layer, once more where remat recomputes the
   block), ``flash_bwd_dq`` 8 and ``flash_bwd_dkv`` 8 times.  The first
   loss lies within 1.0 of ln(vocab) and the loss falls; step ms (CUDA
   events, median of the 3 steps after 2 warm), tokens/s, MFU (bench.py's
   count: 6 x matmul params x tokens + 3 x 2 B T^2 dim L over 989
   TFLOP/s), peak memory and the device busy share of one more step.
   Before it, the gradients are held at 2 layers in float32 activations
   and weights, T=256: ``lm_loss`` through the kernels against the plain
   xla path, loss rel < 1e-4 and every gradient's max abs error over its
   max |value| < 1e-3; and one ``train_step`` with attn_pdrop = resid_pdrop
   = 0.1 runs the dropout branch of all three kernels to a finite loss.
10. kernels: one JSON object for every kernel instance of the port
   (flash_fwd, flash_fwd_int8, paged_decode, paged_decode_int8,
   flash_bwd_dq, flash_bwd_dkv, stock_paged, splash_prefill), each with
   its launches on every path; the paged entries hold their spec_verify
   (and, int8, split_verify) shapes.

The kernel-selection layer (``ops/kernels.py``) adds:

* phase 2 ``kernel_check`` rows for the two slots' kernels, each against
  its plain version in bf16 and float32: ``stock_paged`` at the paged
  kernel's serving shape (8 rows, KVH 8, G 4, d 128, blocks of 128, 16
  table entries, PAGED_FILLS, a 32-layer pool read at layer 31, the step's
  own K/V merged in), cold-L2 over the 32 layers; ``splash_prefill`` at
  the serving insert (B=8, T=S=1024, offset 0) and at a chunk (T=512,
  S=1024, offset 512).  Each with its warm, plain and library times
  (SDPA over a pre-gathered view with the step's own slot appended, or
  with the boolean causal-offset mask) and its bound;
* ``selected_serving``: phase 5's 12 requests on a batcher with
  ``prefill_kernel="splash", decode_kernel="stock-paged"``, counted from
  zero: the splash kernel once per layer per insert, the stock kernels
  (split and combine) twice per layer per decode iteration, no flash or
  paged launch; with phase 5's figures beside (``selected_vs_serving``);
* ``selected_decode_invariant`` (float32 activations, 32 layers): the
  splash batcher's greedy tokens equal the flash batcher's, the stock
  batcher's are identical at decode_chunk 1 and 8, one step's logits
  under stock against the paged kernel rel < 2e-2, and "auto" on
  llama3-8b resolves to splash and paged;
* in ``spec_serving``: a batcher whose draft selects stock-paged runs one
  round with 160 paged launches at T = 4 and no stock launch.

The redesigned kernels (split-KV paged decode, the Hopper instances of
the flash forward and of the backward pair) add:

* in their ``kernel_check`` rows (flash_fwd, flash_bwd_dq, flash_bwd_dkv,
  paged_decode, paged_decode_int8): the ``instance`` that ran, read from
  the wrapper's ``launches_by_instance`` (for flash, checked against the
  one ``flash_instance`` or ``flash_bwd_instance`` picks; for the
  backward pair and paged, the instance that the C entry point reports),
  torch.profiler's ``device_ms`` beside the
  cold-L2 events, and ``earlier_ms``, the replaced design's figure at
  the same shape (``EARLIER_MS``, from PERF.md's kernel table, printed
  only in these rows); the paged serving row checks that a launch runs
  both passes, as the C entry point reports them and as the profiler
  counts the split and combine kernels over its timed launches;
* in ``generate``, ``serving`` and ``train``: the flash kernels'
  launches by instance (``instances``): all 32 of generate's prefill,
  16 forwards and 8 + 8 backward launches a train step and every
  serving insert on the Hopper ("wgmma") instances, and the float32
  instances in ``train_grad_check``'s dropout step; in the serving
  phases, 2 paged kernels
  (``paged_pool_attention.kernel_launches``) for every paged wrapper
  launch.

The selection layer's redesigned kernels (splash's TMA + wgmma instance,
stock-paged's split pass on the tensor cores) add:

* in ``build``: ptxas's registers and spill bytes by kernel (``ptxas``);
  the run fails if ``splash_wgmma_kernel`` or ``stock_split_kernel``
  spills;
* in their ``kernel_check`` rows: the ``instance`` that ran (from the
  wrappers' ``launches_by_instance``, which count the instance each C
  entry point reports it launched, checked against ``splash_instance``
  and ``stock_instance``), ``bit_identical`` (two calls on the same
  inputs, required), ``earlier_ms`` and ``earlier_device_ms`` (the
  replaced design's events and device ms, from PERF.md), device ms
  over the launches the profiler saw (``profiled_calls``); for stock the
  wrapper's host ms per call and a ``split_sweep`` over ``STOCK_SPLITS``
  through ``stock_paged_launch`` (each split's output held to the same
  bound; the record behind ``STOCK_SPLIT``);
* in ``selected_serving``: splash and stock launches by instance (every
  call on the bf16 instance), and in each serving row one insert's
  device ms by kernel group (``profile_insert``), which
  ``selected_vs_serving`` puts side by side.

The last two kernel cells' redesigns (the flash forward's split-KV
instance for T = 1 decode, the int8 forward's TMA + wgmma instance) add:

* in ``build``: the spill check covers ``flash_fwd_split_kernel``,
  ``flash_fwd_combine_kernel`` and ``flash_fwd_int8_wgmma_kernel``;
* every flash forward launch (``flash_attention``,
  ``flash_attention_quantized``) counted by the instance its C entry
  point reports; ``kernel_check``'s flash rows check it against
  ``flash_instance`` (the ``decode`` row: "split_kv") and
  ``flash_int8_instance`` (the bf16 int8 row: "wgmma");
* in the ``decode`` row: the profiler's device ms of both passes over the
  calls the trace saw (``profiled_calls``; each pass's profiled launches
  apart), the kernels a call ran, the lse against the plain version's
  (< 1e-3), ``bit_identical``, the plain split-and-combine version's
  error (``flash_split_reference``), a ``split_sweep`` over
  ``FLASH_SPLITS`` through ``flash_attention_launch`` (the record behind
  ``FLASH_SPLIT``), and the replaced mma.sync design's device ms on the
  same inputs in this run (``replaced_device_ms``);
* in the int8 rows: ``instance``, ``launches_by_instance``, ``device_ms``,
  ``bit_identical``, and for bf16 the replaced mma.sync design's events
  and device ms on the same inputs in this run;
* in ``cached_decode``: the flash kernel's launches by instance per cell,
  every bf16 ``flash`` cell on "split_kv" and the float32 cell on
  "float32", as the C entry point reports them; ``int8_serving`` and
  ``int8_spec_serving``: every int8 flash launch on "wgmma".

Checkpoint load, the tokenizers and ``run.py`` (ROADMAP A5) add the
phase ``checkpoint``, after ``cached_decode``, on that phase's 8-layer
tree (llama3-8b at full width, bf16, one shard, as Meta publishes it):

* the tree written as a Meta checkpoint (``consolidated.00.pth`` under
  Meta's names through ``split_qkv``, ``params.json`` with llama3-8b's
  published keys, ``n_layers`` 8) in a temporary directory, converted by
  ``convert_meta_checkpoint(device="cuda")`` (every leaf bit-identical to
  the tree, the config llama3-8b's cut to 8 layers), saved by
  ``save_checkpoint`` and loaded by ``load_checkpoint(device="cuda")``
  (bit-identical), ``verify_manifest`` passing and refusing a copy of the
  manifest that records one wrong byte count;
* ``jax_llama_tpu_torch.run.main()`` in this process on the saved
  directory (argv patched, stdin and stdout captured, ``--byte-tokenizer
  --temperature 0``): one-shot with ``prompts_for()``'s 4 prompts and 32
  new tokens, first without ``--attn`` (the converter's ``attn_impl``
  "xla": plain attention, which must launch no kernel), then with
  ``--attn auto`` (as every later run), then with ``--quantize``, each
  against
  ``LLaMA(...).generate_from_str`` on the same tree (or
  ``quantize_params`` of it); ``--serve`` with 4 of the serving phase's
  prompts on stdin (4 slots, 32 new tokens), at the defaults and with
  ``--prefill-kernel splash --decode-kernel stock-paged``, each against a
  ``ContinuousBatcher`` with the arguments run.py gives it.  Printed
  completions and the ids the byte tokenizer decoded must be equal, and
  the launches exact, counted from zero around each run: none in the
  run without ``--attn``, the flash forward 8 times on "wgmma" in each
  other one-shot run; per serve run the flash
  (splash) kernel 8 times per insert and the paged (stock, split and
  combine) kernel 8 (16) times per decode iteration, as the reference
  batcher's stats and its own counts say; ``--http 0`` with the same 4
  prompts POSTed one at a time as text from run.py's test hook, each
  reply's tokens against a batcher with the same arguments serving that
  prompt alone (or a bf16 near-tie below DECODE_REL), the flash forward
  8 times per insert and the paged kernel 8 times per decode iteration by
  the server's /metrics, no recovery and no quarantine;
* reported: the free bytes of the temporary directory, bytes written,
  seconds and GB/s to write, convert, save, hash and load, run.py's load
  and wall seconds per run, the launches, and the card; the directory is
  removed at the end of the phase.

The HTTP server and its host layers (ROADMAP A7) add two phases after
``selected_serving``:

* ``http_serving``: ``LLMServer`` on 127.0.0.1 (an ephemeral port) over a
  batcher of the serving phase's geometry at llama3-8b's full width (32
  layers, bf16, the phase-3 weights, ``cost_models=True``, priority
  classes on, the byte tokenizer); the serving phase's 12 requests POSTed
  to /generate from client threads, 6 blocking and 6 NDJSON streams, all
  sent before the first completes.  Every reply 200; each stream's tokens
  equal its final record; each request's greedy tokens equal the serving
  phase's for it, or the first divergence is a bf16 near-tie (logit gap
  over the row's max |logit| below DECODE_REL); the flash forward
  launched n_layers times per insert on "wgmma" and the paged kernel
  n_layers times per decode iteration, by /metrics'
  ``insert_dispatches_total`` and ``decode_steps_total``; no recovery and
  no quarantine; /healthz ok, /metrics parses as Prometheus text with no
  unregistered series, /debug/bundle parses.  Reported: requests/s, TTFT
  and ITL p50/p95 from the server's histograms, the analytic cost model's
  utilization gauges, the loop's and the batcher's ms per decode
  iteration beside the serving phase's, and the card.  Each insert is
  timed on the device (CUDA events, recorded after the next fetch): its
  wall time is at least the cost model's roofline time for it, and the
  overload controller's prefill rate is what those records give.
* ``http_drill``: the server at DECODE_DEPTH layers in float32
  activations, a ``FaultInjector`` from ``FaultSpec`` and the degrade
  manager's clock injected.  A ``step`` fault mid-decode: one recovery,
  tokens equal to the fault-free run.  ``splash_kernel`` (with
  ``prefill_kernel="splash"``) and ``stock_paged_kernel`` (with
  ``decode_kernel="stock-paged"``) faulted twice each: the feature is
  quarantined, every request completes on the fallback kernel (flash,
  paged) with the fallback's fault-free tokens and none of the faulted
  kernel's launches; past the cooldown on the injected clock a probe
  restores it, its launches resume and the tokens are the kernel path's
  fault-free ones; /debug/decisions reads recovery, quarantine, recovery,
  probe and the annotations quarantined, probing, healthy.  A differing
  token must be a near-tie below DRILL_TIE.  Then faults at ``step``,
  ``paged_kernel`` and ``flash_kernel`` on every call, past
  ``max_recoveries``: no quarantine (on the card the flash and paged
  kernels have no kernel to fall back to, and plain PyTorch is not one),
  the breaker trips, every client 503, a later one 503 with Retry-After,
  /healthz 503.  Every drill's launches are exactly those its dispatch
  records imply, and none is plain attention or the gathered view.

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

# H100 SXM published peaks (dense): bf16 tensor-core FLOP/s, float32
# outside the tensor cores, HBM bytes/s.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# Kernel vs plain version in bf16, per row: the row's max abs error over
# its max |plain output|.  bf16's relative half-ulp is 2**-9 ~ 2e-3
# (output rounding, and P rounded to bf16 for P.V); one ulp flipped by
# rounding the output is at most 2**-7 of the row's largest element.
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
FLASH_SHAPES = ("prefill", "decode", "chunk_window", "insert",
                "cached_decode")
# The cached_decode phase's float32 flash step: 2 rows, T = 1 over a
# 1024-slot cache, the 8th token (8 slots written).
CACHED_DECODE_FILL = 8

# The training kernels: shape, dropout, bounds (TRAIN_ERR_IS).
TRAIN_SHAPE = dict(B=4, T=2048, H=32, KVH=8, d=128)
TRAIN_F32_SHAPE = dict(B=2, T=256, H=8, KVH=2, d=128)
TRAIN_DROPOUT = 0.1
TRAIN_SEED_WORDS = (0x2545F491, 0x9E3779B9)
TRAIN_BOUNDS = dict(out=1e-2, lse=1e-3, dq=2e-2, dk=2e-2, dv=2e-2)
F32_KERNEL_BOUND = 1e-4
TRAIN_ERR_IS = ("out, dq (per packed query row) and dk, dv (per KV slot): "
                "the worst row's max abs err over its own max |plain|; "
                "lse: max abs err")
TRAIN_LAYERS = 8       # llama3-8b depth cut for params + grads + AdamW
TRAIN_STEPS = 5        # 2 warm, 3 timed
GRAD_LAYERS, GRAD_T = 2, 256
GRAD_LOSS_REL, GRAD_REL = 1e-4, 1e-3
LLAMA3_EOS = 128001

# Speculative serving (the JAX bench's speculative setup, bench.py:1403-
# 1421): 4 prompts of 500 random ids, 48 new tokens, n_draft 3, up to 8
# rounds a step; the perturbed draft is the target with +-2% relative
# noise (bench.py:1381-1401).  The verify kernel check's rows hold the
# fills such a round meets (500 .. 548).
SPEC_SLOTS, SPEC_MAX_LEN, SPEC_BLOCK = 4, 1024, 128
SPEC_PROMPT, SPEC_NEW, SPEC_DRAFT, SPEC_ROUNDS = 500, 48, 3, 8
SPEC_NOISE = 0.02
SPEC_SAMPLED = dict(temperature=0.8, top_p=0.95, seed=1234)
VERIFY_FILLS = (500, 516, 532, 548)
# The 70b head layout's verify (the C1 shape): G = 8 query heads per KV
# head at T = 5 tokens, 40 packed rows: one launch under the paged
# kernel's cap of 64.
SPLIT_VERIFY = (8, 5)
# The paged kernel's design, printed beside the split pass's instance
# that its C entry point reports, and the substrings of its two kernels'
# names in the profiler.
PAGED_DESIGN = ("split-KV: a split pass over 256-slot runs of each row's "
                "table, then a combine pass")
PAGED_KERNELS = ("paged_decode_split", "paged_decode_combine")
# The cold-L2 ms of the designs that the split-KV paged kernel and the
# Hopper instances of the flash forward and backward replaced, at the same
# kernel_check shapes (PERF.md's kernel table: chip_smoke.py kernel_check
# on an NVIDIA H100 80GB HBM3, 700.00 W), printed beside the new figures
# as earlier_ms.
EARLIER_MS = {
    ("flash_fwd", "prefill"): 0.0879, ("flash_fwd", "insert"): 0.3023,
    ("flash_fwd", "train"): 1.445, ("flash_fwd", "train_dropout"): 1.283,
    ("flash_bwd_dq", "train"): 1.311,
    ("flash_bwd_dq", "train_dropout"): 1.493,
    ("flash_bwd_dkv", "train"): 3.182,
    ("flash_bwd_dkv", "train_dropout"): 3.330,
    ("flash_fwd", "decode"): 0.0915, ("flash_fwd_int8", "insert"): 0.2988,
    ("paged_decode", "serving"): 0.1482,
    ("paged_decode", "spec_verify_bfloat16"): 0.1744,
    ("paged_decode", "spec_verify_float32"): 0.2304,
    ("paged_decode_int8", "serving"): 0.1674,
    ("paged_decode_int8", "spec_verify_bfloat16"): 0.1938,
    ("paged_decode_int8", "spec_verify_float32"): 0.1932,
    ("paged_decode_int8", "split_verify"): 0.3643,
    ("stock_paged", "serving_bfloat16"): 0.0772,
    ("stock_paged", "serving_float32"): 0.0659,
    ("splash_prefill", "insert_bfloat16"): 0.5057,
    ("splash_prefill", "chunk_bfloat16"): 0.3654,
}
EARLIER_IS = ("cold-L2 ms of the replaced design at this shape (PERF.md "
              "kernel table; chip_smoke.py kernel_check, NVIDIA H100 80GB "
              "HBM3, 700.00 W); null where none was recorded")
# The same designs' torch.profiler device ms, where recorded (the selection
# layer's kernels: PERF.md's record of this script on the same card).
EARLIER_DEVICE_MS = {
    ("flash_fwd", "decode"): 0.0897,
    ("stock_paged", "serving_bfloat16"): 0.03810,
    ("stock_paged", "serving_float32"): 0.04673,
    ("splash_prefill", "insert_bfloat16"): 0.4926,
    ("splash_prefill", "chunk_bfloat16"): 0.3552,
}
# The redesigned kernels, which must compile without spills (substrings of
# their mangled names in ptxas's report).
NO_SPILL_KERNELS = ("splash_wgmma_kernel", "stock_split_kernel",
                    "flash_fwd_split_kernel", "flash_fwd_combine_kernel",
                    "flash_fwd_int8_wgmma_kernel")
# Run lengths of the flash forward's split-KV instance timed at the decode
# shape beside the wrapper's own (FLASH_SPLIT).
FLASH_SPLITS = (128, 256, 512)
FLASH_SPLIT_KERNELS = ("flash_fwd_split", "flash_fwd_combine")
# Split sizes (slots per block of the stock kernel's split pass) timed at
# the serving shape beside the wrapper's own (STOCK_SPLIT).
STOCK_SPLITS = (128, 256, 512)
# The selection layer's slots as a user selects them, and the splash
# kernel's checked shapes: (B, T, S, chunk_offset) of the serving phase's
# first insert (8 rows at P = 1024) and of a chunk at offset 512.
SELECTED = dict(prefill_kernel="splash", decode_kernel="stock-paged")
SPLASH_SHAPES = {"insert": (8, 1024, 1024, 0), "chunk": (8, 512, 1024, 512)}
STEP_STOCK_REL = 2e-2  # one step's logits, stock vs paged kernel, float32
# The checkpoint phase: llama3-8b's published params.json (n_layers cut to
# DECODE_DEPTH), the converted context length, run.py's --serve slots and
# the requests fed on its stdin, and the new tokens of every run.
LLAMA3_8B_PARAMS_JSON = dict(dim=4096, n_layers=32, n_heads=32, n_kv_heads=8,
                             vocab_size=128256, multiple_of=1024,
                             ffn_dim_multiplier=1.3, norm_eps=1e-05,
                             rope_theta=500000.0)
CKPT_MAX_SEQ = 2048
CKPT_SLOTS = 4
CKPT_GEN = 32


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
    """Inputs of the flash kernel at one main-path shape: bf16, float32 at
    the cached_decode phase's float32 step."""
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
    elif name == "cached_decode":
        B, T, S = 2, 1, 1024
        slots = torch.arange(S, device=dev)[None, :].expand(B, S)
        kv_pos = torch.where(slots < CACHED_DECODE_FILL, slots, -1)
        q_pos = torch.full((B, T), CACHED_DECODE_FILL - 1, device=dev)
    else:
        raise KeyError(name)
    dtype = torch.float32 if name == "cached_decode" else torch.bfloat16
    q = torch.randn(B, T, H, d, device=dev, generator=gen).to(dtype)
    k = torch.randn(B, S, KVH, d, device=dev, generator=gen).to(dtype)
    v = torch.randn(B, S, KVH, d, device=dev, generator=gen).to(dtype)
    return (q, k, v, q_pos.to(torch.int32).contiguous(),
            kv_pos.to(torch.int32).contiguous())


def flash_bound(q, k, v, q_pos, kv_pos, scale_planes=0,
                peak=PEAK_BF16_FLOPS):
    """Least time (ms) the card could take: the bytes this data needs moved
    over HBM bandwidth -- q, the positions and the output once, and only
    the K/V rows some query of the row may attend (0 <= kv_pos <= the
    row's largest q_pos; padding and unwritten slots are never read; an
    int8 k counts 1 byte an element, plus 4 bytes per slot and KV head for
    each of its ``scale_planes``) -- vs the tensor-core FLOPs that this
    data's live (query, slot) pairs need (QK and PV, 2*d each, per head)
    over ``peak`` (the bf16 tensor-core rate unless given)."""
    needed = ((kv_pos >= 0)
              & (kv_pos <= q_pos.max(dim=1, keepdim=True).values)).sum().item()
    kv_row = k.shape[2] * k.shape[3] * k.element_size()
    nbytes = (2 * q.numel() * q.element_size() + 2 * needed * kv_row
              + scale_planes * needed * k.shape[2] * 4
              + sum(t.numel() * t.element_size() for t in (q_pos, kv_pos)))
    kp = kv_pos[:, None, :]
    live = ((kp >= 0) & (kp <= q_pos[:, :, None])).sum().item()
    flops = 4.0 * q.shape[-1] * q.shape[2] * live
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def library_attention(torch, q, k, v, q_pos, kv_pos):
    """One PyTorch call computing the same function (yardstick only)."""
    import torch.nn.functional as F

    kp = kv_pos[:, None, :]
    mask = ((kp >= 0) & (kp <= q_pos[:, :, None]))[:, None]  # [B,1,T,S]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True)


def ran_instance(after, before):
    """The one instance launched since ``before``, a copy of a wrapper's
    ``launches_by_instance`` (``after``), or what ran if not exactly
    one."""
    ran = {k: n - before.get(k, 0) for k, n in after.items()
           if n != before.get(k, 0)}
    return next(iter(ran)) if list(ran.values()) == [1] else ran


def split_device_ms(torch, fns):
    """Device ms per call of split-KV launches ``fns`` (both passes) over
    the calls the profiler saw (at least 16 profiled), and each pass's
    profiled launches: (ms, {kernel: launches}, calls profiled)."""
    fns = list(fns) * max(1, -(-16 // len(fns)))
    counts = dict.fromkeys(FLASH_SPLIT_KERNELS, 0)
    ms = kernel_device_ms(torch, fns, ("flash_fwd",), counts)
    seen = counts[FLASH_SPLIT_KERNELS[0]]
    return (ms * len(fns) / seen if ms and seen else None), counts, len(fns)


def check_split_kv(torch, fa, args, ref, copies):
    """The decode row's extras for the split-KV instance: the lse (with
    lse, as a training forward asks), bit-identical calls, the plain
    split-and-combine version, both passes' device ms, the run-length
    sweep and the replaced mma.sync design on the same inputs."""
    before = fa.flash_attention.kernel_launches
    out, lse = fa._forward(*args, 0.0, None, True)
    torch.cuda.synchronize()
    kernels = fa.flash_attention.kernel_launches - before
    again, lse2 = fa._forward(*args, 0.0, None, True)
    ref_out, ref_lse = fa.flash_attention_reference(*args, return_lse=True)
    extra = dict(
        kernels_per_call=kernels,
        bit_identical=bool(torch.equal(out, again) and torch.equal(lse, lse2)),
        lse_max_abs_err=lse_abs_err(torch, lse, ref_lse), lse_bound=LSE_BOUND,
        with_lse_worst_row_rel=row_rel_err(torch, out, ref_out),
        split_reference_worst_row_rel=row_rel_err(
            torch, fa.flash_split_reference(*args), ref),
        split_slots=fa.FLASH_SPLIT)
    cold = [lambda a=a: fa.flash_attention(*a) for a in copies]
    (extra["device_ms"], extra["profiled_launches"],
     extra["profiled_calls"]) = split_device_ms(torch, cold)
    sweep = {}
    for split in FLASH_SPLITS:
        runs = [lambda a=a, split=split: fa.flash_attention_launch(
            *a, "split_kv", split=split) for a in copies]
        got = fa.flash_attention_launch(*args, "split_kv", split=split)
        torch.cuda.synchronize()
        sweep[split] = dict(worst_row_rel=row_rel_err(torch, got, ref),
                            device_ms=split_device_ms(torch, runs)[0],
                            ms=time_ms(torch, runs, iters=4 * len(runs)))
    extra["split_sweep"] = sweep
    old = [lambda a=a: fa.flash_attention_launch(*a, "mma_sync")
           for a in copies]
    extra.update(
        replaced="mma_sync",
        replaced_worst_row_rel=row_rel_err(
            torch, fa.flash_attention_launch(*args, "mma_sync"), ref),
        replaced_ms=time_ms(torch, old, iters=4 * len(old)),
        replaced_device_ms=device_ms_per_launch(
            torch, old, ("flash_fwd",), "flash_fwd")[0])
    ok = (extra["bit_identical"] and kernels == 2
          and extra["lse_max_abs_err"] < LSE_BOUND
          and extra["with_lse_worst_row_rel"] < REL_BOUND
          and extra["split_reference_worst_row_rel"] < REL_BOUND
          and extra["replaced_worst_row_rel"] < REL_BOUND
          and all(r["worst_row_rel"] < REL_BOUND for r in sweep.values()))
    return extra, ok


def check_flash(torch, fa, gen):
    results = {}
    for name in FLASH_SHAPES:
        args = flash_inputs(torch, name, gen)
        q, k = args[0], args[1]
        want = fa.flash_instance(q.dtype, q.shape[3], q.shape[1], k.shape[1],
                                 q.shape[2] // k.shape[2])
        before = dict(fa.flash_attention.launches_by_instance)
        out = fa.flash_attention(*args)
        torch.cuda.synchronize()
        instance = ran_instance(fa.flash_attention.launches_by_instance,
                                before)
        ref = fa.flash_attention_reference(*args)
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"flash {name}: non-finite output")
        err = (out.float() - ref.float()).abs().max().item()
        rel = row_rel_err(torch, out, ref)
        copies = cold_copies(args)
        ms = time_ms(torch, [lambda a=a: fa.flash_attention(*a)
                             for a in copies], iters=4 * len(copies))
        warm_ms = time_ms(torch, lambda: fa.flash_attention(*args))
        plain_ms = time_ms(torch, [
            lambda a=a: fa.flash_attention_reference(*a) for a in copies
        ], iters=len(copies))
        library_ms = time_ms(torch, [library_attention(torch, *a)
                                     for a in copies], iters=4 * len(copies))
        extra, extra_ok = {}, True
        if want == "split_kv":
            extra, extra_ok = check_split_kv(torch, fa, args, ref, copies)
            device_ms = extra.pop("device_ms")
        else:
            device_ms = kernel_device_ms(torch, [
                lambda a=a: fa.flash_attention(*a) for a in copies],
                ("flash_fwd",))
        del copies
        f32 = args[0].dtype == torch.float32
        # float32 runs on the CUDA cores.
        bound_ms, bound_by = flash_bound(
            *args, peak=PEAK_F32_FLOPS if f32 else PEAK_BF16_FLOPS)
        rel_bound = F32_KERNEL_BOUND if f32 else REL_BOUND
        row = dict(
            phase="kernel_check", kernel="flash_fwd", shape=name,
            B=args[0].shape[0], T=args[0].shape[1], S=args[1].shape[1],
            H=args[0].shape[2], KVH=args[1].shape[2], d=args[0].shape[3],
            dtype=str(args[0].dtype).split(".")[-1], instance=instance,
            max_abs_err=err, worst_row_rel=rel, rel_bound=rel_bound, ms=ms,
            device_ms=device_ms, warm_ms=warm_ms, plain_ms=plain_ms,
            library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
            roofline_share=bound_ms / ms,
            device_roofline_share=bound_ms / device_ms if device_ms else None,
            earlier_ms=EARLIER_MS.get(("flash_fwd", name)),
            earlier_device_ms=EARLIER_DEVICE_MS.get(("flash_fwd", name)),
            earlier_is=EARLIER_IS, **extra,
        )
        emit(row)
        if not (rel < rel_bound and instance == want and extra_ok):
            raise AssertionError(
                f"flash {name}: worst packed query row's max abs err is "
                f"{rel} of its max |plain|, bound {rel_bound}; instance "
                f"{instance}, expected {want}; split-KV checks {extra}")
        results[name] = row
    return results


def paged_inputs(torch, gen, B=8, KVH=8, G=4, d=128, BLK=128, MB=16,
                 L=32, dtype=None):
    """Inputs (bf16 unless ``dtype`` says) of the paged kernel at
    llama3-8b's serving shape: row b
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
    return ([t.to(dtype or torch.bfloat16) for t in (q, k, v)]
            + [t.cuda() for t in (pos, table, q_pos)])


def paged_gathered_mask(torch, pos, table, q_pos, T=1):
    """Each row's table blocks as one contiguous slot axis: the gather
    index [B, MB] and the attendable mask [B, T, MB*BLK] of the row's T
    tokens at positions q_pos + t ([B, MB*BLK] at T = 1)."""
    NB, BLK = pos.shape
    blk = table.long().clamp(0, NB - 1)
    dead = (table < 0) | (table >= NB)
    kp = torch.where(dead[:, :, None], -1, pos[blk]).reshape(blk.shape[0], -1)
    limit = q_pos[:, None] + torch.arange(T, device=q_pos.device)[None]
    allowed = ((kp[:, None] >= 0) & (kp[:, None] <= limit[:, :, None])
               & (q_pos >= 0)[:, None, None])
    return blk, allowed[:, 0] if T == 1 else allowed


def paged_bound(torch, q, k, pos, table, q_pos, T=1, scale_planes=0):
    """Least time (ms): the K/V of the slots some token of the row may
    attend (read once per KV head for all T tokens; an int8 pool 1 byte an
    element plus 4 bytes per slot and KV head for each of its
    ``scale_planes``) plus q, out, lse, table and the position plane over
    HBM bandwidth, vs the live (packed query row, slot) pairs' QK and PV
    FLOPs over the bf16 peak."""
    _, allowed = paged_gathered_mask(torch, pos, table, q_pos, T)
    allowed = allowed.reshape(allowed.shape[0], T, -1)
    needed = allowed.any(dim=1).sum().item()
    pairs = allowed.sum().item()  # (token, slot) pairs per query head
    B, KVH, TG, d = q.shape
    G = TG // T
    nbytes = (2 * needed * KVH * d * k.element_size()
              + scale_planes * needed * KVH * 4
              + q.numel() * q.element_size() + B * KVH * TG * (d + 1) * 4
              + table.numel() * 4 + pos.numel() * 4)
    flops = 4.0 * d * G * KVH * pairs
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
    before = (pa.paged_pool_attention.kernel_launches,
              dict(pa.paged_pool_attention.launches_by_instance))
    out, lse = pa.paged_pool_attention(*args, layer=layer)
    torch.cuda.synchronize()
    passes = pa.paged_pool_attention.kernel_launches - before[0]
    instance = ran_instance(pa.paged_pool_attention.launches_by_instance,
                            before[1])
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
    # The profiler sees each of the L launches run both kernels.
    profiled = dict.fromkeys(PAGED_KERNELS, 0)
    device_ms = kernel_device_ms(torch, [
        lambda i=i: pa.paged_pool_attention(q, k, v, pos, table, q_pos, i)
        for i in range(L)], ("paged_decode",), profiled)
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
        dtype="bfloat16", design=PAGED_DESIGN, instance=instance,
        kernels_per_launch=passes, profiled_launches=profiled,
        profiled_calls=L, max_abs_err=err, max_rel_err=rel,
        rel_err_by_live_row=row_rel.tolist(),
        rel_bound=REL_BOUND, lse_max_abs_err=lse_err, lse_bound=LSE_BOUND,
        dead_rows_ok=dead_ok, ms=ms, device_ms=device_ms, warm_ms=warm_ms,
        earlier_ms=EARLIER_MS[("paged_decode", "serving")],
        earlier_is=EARLIER_IS, plain_ms=plain_ms,
        library_ms=library_ms, library="scaled_dot_product_attention over "
        "a pre-gathered view, bool mask, gather not timed",
        bound_ms=bound_ms, bound_by=bound_by, roofline_share=bound_ms / ms,
    )
    emit(row)
    if not (finite and dead_ok and rel < REL_BOUND and lse_err < LSE_BOUND
            and passes == 2 and set(profiled.values()) == {L}):
        raise AssertionError(
            f"paged_decode: kernels a launch {passes} (profiled over {L} "
            f"launches: {profiled}), finite {finite}, "
            f"dead rows {dead_ok}, max abs "
            f"err {err} (worst live row: {rel} of its max |plain|, bound "
            f"{REL_BOUND}), lse err "
            f"{lse_err} (bound {LSE_BOUND})")
    return row


def verify_inputs(torch, gen, dtype, B=4, KVH=8, G=4, d=128, BLK=128, MB=8,
                  L=32, T=SPEC_DRAFT + 1):
    """Inputs of the paged kernel at the spec_serving phase's verify shape:
    row b holds VERIFY_FILLS[b] tokens in shuffled physical blocks of a
    32-layer pool (MB = 1024 / 128 table entries a row, the unused ones
    the sentinel), and its T = n_draft + 1 queries sit at positions
    VERIFY_FILLS[b] .. + T - 1, packed r = t*G + g."""
    NB = B * MB
    perm = torch.randperm(NB, generator=gen, device="cuda").tolist()
    table = torch.full((B, MB), NB, dtype=torch.int32)
    pos = torch.full((NB, BLK), -1, dtype=torch.int32)
    for b, f in enumerate(VERIFY_FILLS):
        for j in range(-(-(f + T) // BLK)):
            blk = perm.pop()
            table[b, j] = blk
            m = max(0, min(BLK, f - j * BLK))
            pos[blk, :m] = torch.arange(j * BLK, j * BLK + m)
    q_pos = torch.tensor(VERIFY_FILLS, dtype=torch.int32)
    q = torch.randn(B, KVH, T * G, d, device="cuda", generator=gen)
    k = torch.randn(L, KVH, NB, BLK, d, device="cuda", generator=gen)
    v = torch.randn(L, KVH, NB, BLK, d, device="cuda", generator=gen)
    return ([t.to(dtype) for t in (q, k, v)]
            + [t.cuda() for t in (pos, table, q_pos)])


def check_paged_verify(torch, pa, gen):
    """paged_decode at the speculative verify shape (T = 4) against its
    plain version, in bf16 and float32: each packed query row against its
    own max |plain| (``row_rel_err``), the lse by max abs error; cold-L2,
    warm, plain and library times (SDPA over a pre-gathered view with the
    [T, S] positional mask, gather not timed) and the bound."""
    import torch.nn.functional as F

    T = SPEC_DRAFT + 1
    rows = {}
    for dtype, bound in ((torch.bfloat16, REL_BOUND),
                         (torch.float32, F32_KERNEL_BOUND)):
        args = verify_inputs(torch, gen, dtype)
        q, k, v, pos, table, q_pos = args
        L, KVH, NB, BLK, d = k.shape
        B, _, TG, _ = q.shape
        G = TG // T
        layer = L - 1
        before = dict(pa.paged_pool_attention.launches_by_instance)
        out, lse = pa.paged_pool_attention(*args, layer=layer, t_tokens=T)
        torch.cuda.synchronize()
        instance = ran_instance(pa.paged_pool_attention.launches_by_instance,
                                before)
        ref_out, ref_lse = pa.paged_pool_attention_reference(
            *args, layer=layer, t_tokens=T)
        finite = bool(torch.isfinite(out).all() and torch.isfinite(lse).all())
        rel = row_rel_err(torch, out, ref_out)
        lse_err = (lse - ref_lse).abs().max().item()

        # Cold: each launch reads another layer's plane.
        ms = time_ms(torch, [
            lambda i=i: pa.paged_pool_attention(*args, i, T)
            for i in range(L)], iters=4 * L)
        warm_ms = time_ms(torch, lambda: pa.paged_pool_attention(
            *args, layer, T))
        device_ms = kernel_device_ms(torch, [
            lambda i=i: pa.paged_pool_attention(*args, i, T)
            for i in range(L)], ("paged_decode",))
        plain_ms = time_ms(torch, [
            lambda i=i: pa.paged_pool_attention_reference(*args, i, T)
            for i in range(L)], iters=L)
        blk, allowed = paged_gathered_mask(torch, pos, table, q_pos, T)
        mask = allowed[:, None]  # [B, 1, T, S]
        qt = q.reshape(B, KVH, T, G, d).transpose(2, 3).reshape(
            B, KVH * G, T, d)
        view_bytes = 2 * KVH * blk.numel() * BLK * d * k.element_size()
        n_views = max(2, -(-4 * L2_BYTES // view_bytes))
        views = [tuple(t[i % L][:, blk].reshape(KVH, B, -1, d).transpose(0, 1)
                       .contiguous() for t in (k, v)) for i in range(n_views)]
        library_ms = time_ms(torch, [
            lambda kg=kg, vg=vg: F.scaled_dot_product_attention(
                qt, kg, vg, attn_mask=mask, enable_gqa=True)
            for kg, vg in views], iters=4 * n_views)
        del views
        bound_ms, bound_by = paged_bound(torch, q, k, pos, table, q_pos, T)
        name = "bfloat16" if dtype == torch.bfloat16 else "float32"
        row = dict(
            phase="kernel_check", kernel="paged_decode", shape="spec_verify",
            B=B, KVH=KVH, G=G, T=T, d=d, BLK=BLK, MB=table.shape[1], L=L,
            layer=layer, fills=list(VERIFY_FILLS), dtype=name,
            design=PAGED_DESIGN, instance=instance,
            worst_row_rel=rel, rel_bound=bound, lse_max_abs_err=lse_err,
            lse_bound=LSE_BOUND, finite=finite, ms=ms, device_ms=device_ms,
            warm_ms=warm_ms,
            earlier_ms=EARLIER_MS[("paged_decode", f"spec_verify_{name}")],
            earlier_is=EARLIER_IS, plain_ms=plain_ms, library_ms=library_ms,
            library="scaled_dot_product_attention over a pre-gathered "
            "view, [T, S] positional mask, gather not timed",
            bound_ms=bound_ms, bound_by=bound_by,
            roofline_share=bound_ms / ms)
        emit(row)
        if not (finite and rel < bound and lse_err < LSE_BOUND):
            raise AssertionError(
                f"paged_decode spec_verify ({name}): finite {finite}, worst "
                f"packed row {rel} of its max |plain| (bound {bound}), lse "
                f"err {lse_err} (bound {LSE_BOUND})")
        rows[name] = row
    return rows


def int8_pool(quant, k, v):
    """A pool's K/V as the int8 path stores them: (k, v int8, k_scale,
    v_scale float32 [..., KVH, NB, BLK] or [B, S, KVH])."""
    (kq, ks), (vq, vs) = quant.quantize_kv(k), quant.quantize_kv(v)
    return kq, vq, ks, vs


def dequantized(x8, scale, dtype):
    return (x8.float() * scale[..., None]).to(dtype)


def check_flash_int8(torch, fa, quant, gen):
    """flash_fwd_int8 against its plain version at the serving insert
    shape (8 right-padded rows, P = 1024, INSERT_ROWS' lengths; K/V
    quantized as the insert quantizes them), bf16 and float32 q: each
    packed query row within REL_BOUND (bf16) or F32_KERNEL_BOUND of its
    own max |plain|.  Each row is timed: cold-L2, warm, plain, and SDPA
    over a dequantized copy in q's dtype (the dequantize not timed); the
    bound counts 1 byte per K/V element plus both scale planes."""
    q, k, v, q_pos, kv_pos = flash_inputs(torch, "insert", gen)
    kq, vq, ks, vs = int8_pool(quant, k, v)
    del k, v
    rows = {}
    w = fa.flash_attention_quantized
    for dtype, bound in ((torch.bfloat16, REL_BOUND),
                         (torch.float32, F32_KERNEL_BOUND)):
        name = str(dtype).split(".")[-1]
        args = (q.to(dtype), kq, vq, ks, vs, q_pos, kv_pos)
        want = fa.flash_int8_instance(dtype, q.shape[3], q.shape[1],
                                      kq.shape[1])
        before = dict(w.launches_by_instance)
        out = w(*args)
        torch.cuda.synchronize()
        by_instance = {key: n - before.get(key, 0)
                       for key, n in w.launches_by_instance.items()
                       if n != before.get(key, 0)}
        instance = ran_instance(w.launches_by_instance, before)
        identical = bool(torch.equal(out, w(*args)))
        ref = fa.flash_attention_quantized_reference(*args)
        finite = bool(torch.isfinite(out).all())
        rel = row_rel_err(torch, out, ref)
        row = dict(phase="kernel_check", kernel="flash_fwd_int8",
                   shape="insert", B=q.shape[0], T=q.shape[1],
                   S=kq.shape[1], H=q.shape[2], KVH=kq.shape[2],
                   d=q.shape[3], dtype=name, kv="int8 + float32 scales",
                   instance=instance, launches_by_instance=by_instance,
                   worst_row_rel=rel, rel_bound=bound, finite=finite,
                   bit_identical=identical)
        copies = cold_copies(args)
        cold = [lambda a=a: w(*a) for a in copies]
        row["ms"] = time_ms(torch, cold, iters=4 * len(copies))
        row["device_ms"], row["profiled_calls"] = device_ms_per_launch(
            torch, cold, ("flash_fwd",), "flash_fwd")
        if want == "wgmma":
            # The replaced design (mma.sync, one tile at a time) on the
            # same inputs in this run.
            old = [lambda a=a: fa.flash_attention_quantized_launch(
                *a, "mma_sync") for a in copies]
            row.update(
                replaced="mma_sync",
                replaced_worst_row_rel=row_rel_err(
                    torch, fa.flash_attention_quantized_launch(
                        *args, "mma_sync"), ref),
                replaced_ms=time_ms(torch, old, iters=4 * len(copies)),
                replaced_device_ms=device_ms_per_launch(
                    torch, old, ("flash_fwd",), "flash_fwd")[0],
                earlier_ms=EARLIER_MS[("flash_fwd_int8", "insert")],
                earlier_is=EARLIER_IS)
        del out, ref
        row["warm_ms"] = time_ms(
            torch, lambda: fa.flash_attention_quantized(*args))
        row["plain_ms"] = time_ms(torch, [
            lambda a=a: fa.flash_attention_quantized_reference(*a)
            for a in copies], iters=len(copies))
        del copies
        deq = (args[0], dequantized(kq, ks, dtype),
               dequantized(vq, vs, dtype), q_pos, kv_pos)
        copies = cold_copies(deq)
        row["library_ms"] = time_ms(torch, [
            library_attention(torch, *a) for a in copies],
            iters=4 * len(copies))
        row["library"] = ("scaled_dot_product_attention over a dequantized "
                          "copy, bool mask, the dequantize not timed")
        del copies, deq
        row["bound_ms"], row["bound_by"] = flash_bound(
            args[0], kq, vq, q_pos, kv_pos, scale_planes=2)
        row["roofline_share"] = row["bound_ms"] / row["ms"]
        if row["device_ms"]:
            row["device_roofline_share"] = row["bound_ms"] / row["device_ms"]
        emit(row)
        if not (finite and rel < bound and identical and instance == want
                and row.get("replaced_worst_row_rel", 0.0) < bound):
            raise AssertionError(f"flash_fwd_int8 ({name}): finite {finite}, "
                                 f"worst packed row {rel}, bound {bound}, "
                                 f"bit-identical {identical}, instance "
                                 f"{instance} (expected {want})")
        rows[name] = row
    return rows


def paged_int8_row(torch, pa, args, scales, T, **extra):
    """One int8 paged kernel_check row: the kernel (through the wrapper,
    so a block of more than MAX_ROWS packed rows runs split) against its
    plain version at the pool's last layer, each packed query row against
    its own max |plain| (an all-zero row, one that attends nothing,
    against the tensor's max), the lse on rows with a live slot, dead rows
    exactly 0 / MASK_VALUE; cold-L2 (each launch another layer's plane),
    warm and plain times, SDPA over a dequantized gathered view (dequantize
    and gather not timed) and the bound."""
    import torch.nn.functional as F

    q, kq, vq, pos, table, q_pos = args
    L, KVH, NB, BLK, d = kq.shape
    B, _, TG, _ = q.shape
    G = TG // T
    layer = L - 1
    before = (dict(pa.paged_pool_attention.launches_by_t),
              dict(pa.paged_pool_attention.launches_by_instance))
    out, lse = pa.paged_pool_attention(*args, layer=layer, t_tokens=T,
                                       **scales)
    torch.cuda.synchronize()
    after = pa.paged_pool_attention.launches_by_t
    by_t = {t: n - before[0].get(t, 0) for t, n in after.items()
            if n != before[0].get(t, 0)}
    instance = ran_instance(pa.paged_pool_attention.launches_by_instance,
                            before[1])
    ref_out, ref_lse = pa.paged_pool_attention_reference(
        *args, layer=layer, t_tokens=T, **scales)
    live = ref_lse > pa.MASK_VALUE / 2
    finite = bool(torch.isfinite(out).all() and torch.isfinite(lse).all())
    rel = row_rel_err(torch, out, ref_out)
    lse_err = (lse - ref_lse)[live].abs().max().item()
    dead_ok = bool((lse[~live] == pa.MASK_VALUE).all()
                   and (out[~live] == 0).all())
    del out, lse, ref_out, ref_lse
    ms = time_ms(torch, [
        lambda i=i: pa.paged_pool_attention(*args, i, T, **scales)
        for i in range(L)], iters=4 * L)
    warm_ms = time_ms(torch, lambda: pa.paged_pool_attention(
        *args, layer, T, **scales))
    device_ms = kernel_device_ms(torch, [
        lambda i=i: pa.paged_pool_attention(*args, i, T, **scales)
        for i in range(L)], ("paged_decode",))
    plain_ms = time_ms(torch, [
        lambda i=i: pa.paged_pool_attention_reference(*args, i, T, **scales)
        for i in range(L)], iters=L)
    blk, allowed = paged_gathered_mask(torch, pos, table, q_pos, T)
    mask = allowed.reshape(B, 1, T, -1)
    qt = q.reshape(B, KVH, T, G, d).transpose(2, 3).reshape(B, KVH * G, T, d)
    view_bytes = 2 * KVH * blk.numel() * BLK * d * q.element_size()
    n_views = max(2, -(-4 * L2_BYTES // view_bytes))
    views = [tuple(
        dequantized(x[i % L][:, blk], s[i % L][:, blk], q.dtype)
        .reshape(KVH, B, -1, d).transpose(0, 1).contiguous()
        for x, s in ((kq, scales["k_scale"]), (vq, scales["v_scale"])))
        for i in range(n_views)]
    library_ms = time_ms(torch, [
        lambda kg=kg, vg=vg: F.scaled_dot_product_attention(
            qt, kg, vg, attn_mask=mask, enable_gqa=True)
        for kg, vg in views], iters=4 * n_views)
    del views
    bound_ms, bound_by = paged_bound(torch, q, kq, pos, table, q_pos, T,
                                     scale_planes=2)
    name = str(q.dtype).split(".")[-1]
    bound = REL_BOUND if q.dtype == torch.bfloat16 else F32_KERNEL_BOUND
    key = extra["shape"] if extra["shape"] != "spec_verify" else (
        f"spec_verify_{name}")
    row = dict(
        phase="kernel_check", kernel="paged_decode_int8", **extra, B=B,
        KVH=KVH, G=G, T=T, d=d, BLK=BLK, MB=table.shape[1], L=L,
        layer=layer, dtype=name, pool="int8 + float32 scales",
        design=PAGED_DESIGN + (
            "; int8 tiles widened to bf16" if name == "bfloat16" else
            "; int8 tiles converted per product"), instance=instance,
        launches_by_t=by_t, worst_row_rel=rel, rel_bound=bound,
        lse_max_abs_err=lse_err, lse_bound=LSE_BOUND, dead_rows_ok=dead_ok,
        finite=finite, ms=ms, device_ms=device_ms, warm_ms=warm_ms,
        earlier_ms=EARLIER_MS.get(("paged_decode_int8", key)),
        earlier_is=EARLIER_IS, plain_ms=plain_ms,
        library_ms=library_ms, library="scaled_dot_product_attention over "
        "a dequantized gathered view, bool mask, dequantize and gather not "
        "timed", bound_ms=bound_ms, bound_by=bound_by,
        roofline_share=bound_ms / ms)
    emit(row)
    if not (finite and dead_ok and rel < bound and lse_err < LSE_BOUND):
        raise AssertionError(
            f"paged_decode_int8 {extra} ({name}): finite {finite}, dead "
            f"rows {dead_ok}, worst packed row {rel} (bound {bound}), lse "
            f"err {lse_err} (bound {LSE_BOUND})")
    return row


def check_paged_int8(torch, pa, quant, gen):
    """The int8 paged kernel at the serving shape (T = 1, bf16), at the
    spec_verify shape (T = 4, bf16 and float32), and at a G = 8, T = 5
    verify (40 packed rows, the C1 shape: one launch under the 64-row
    cap), each against its plain version (``paged_int8_row``)."""
    rows = {}

    def run(key, inputs, T, **extra):
        q, k, v, pos, table, q_pos = inputs
        kq, vq, ks, vs = int8_pool(quant, k, v)
        del k, v
        rows[key] = paged_int8_row(
            torch, pa, (q, kq, vq, pos, table, q_pos),
            dict(k_scale=ks, v_scale=vs), T, **extra)

    run("serving", paged_inputs(torch, gen), 1, shape="serving",
        fills=list(PAGED_FILLS), inactive=list(PAGED_INACTIVE))
    for dtype in (torch.bfloat16, torch.float32):
        run(f"spec_verify_{str(dtype).split('.')[-1]}",
            verify_inputs(torch, gen, dtype), SPEC_DRAFT + 1,
            shape="spec_verify", fills=list(VERIFY_FILLS))
    G, T = SPLIT_VERIFY
    run("split", verify_inputs(torch, gen, torch.bfloat16, KVH=4, G=G, T=T),
        T, shape="split_verify", fills=list(VERIFY_FILLS))
    want = {T: 1}  # G*T = 40 packed rows: one launch under MAX_ROWS = 64
    if G * T > pa.MAX_ROWS or rows["split"]["launches_by_t"] != want:
        raise AssertionError(f"G={G}, T={T}: launches by T "
                             f"{rows['split']['launches_by_t']}, expected "
                             f"{want}")
    return rows


def device_ms_per_launch(torch, fns, names, key):
    """Device ms per call of ``fns`` (``kernel_device_ms``) over the calls
    the profiler saw: each call launches one kernel whose name holds
    ``key``, and a trace that dropped some events is scaled to the
    launches it holds.  At least 16 calls are profiled.  Returns (ms,
    [launches the profiler saw, calls profiled])."""
    fns = list(fns) * max(1, -(-16 // len(fns)))
    counts = {key: 0}
    ms = kernel_device_ms(torch, fns, names, counts)
    seen = counts[key]
    return (ms * len(fns) / seen if ms and seen else None), [seen, len(fns)]


def kernel_device_ms(torch, fns, names, counts=None):
    """Device ms per call of ``fns`` (each called once, in turn, after one
    untimed round) from torch.profiler: the device time of the kernels
    whose name holds one of ``names``, over the number of calls; None
    where the profiler saw none.  Where a wrapper's host work outlasts its
    kernels, CUDA events around back-to-back calls time the host; this
    times the kernels.  ``counts`` ({substring: 0}), where given, gets
    the profiled launches of the kernels whose name holds each key."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for fn in fns:
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    for key in counts or ():
        counts[key] = sum(e.count for e in kernels if key in e.key)
    total = sum(e.self_device_time_total for e in kernels
                if any(n in e.key for n in names))
    return total / 1e3 / len(fns) if total else None


def stock_attended(torch, table, q_pos, NB, BLK):
    """[B, MB*BLK] True where the stock kernel's row attends a slot: the
    first max(q_pos, 0) slots of its table, sentinel entries excluded."""
    slots = torch.arange(table.shape[1] * BLK, device=table.device)
    real = ((table >= 0) & (table < NB)).repeat_interleave(BLK, dim=1)
    return (slots[None] < q_pos.clamp(min=0)[:, None]) & real


def stock_bound(torch, q, k, table, q_pos, peak):
    """Least time (ms) of one stock-paged step: the attended slots' K/V
    read once per KV head, q, k_new, v_new and the output once, the table
    and q_pos, over HBM bandwidth, vs the QK and PV FLOPs (4*d per query
    head) of the attended slots and each row's own slot over ``peak``."""
    L, KVH, NB, BLK, d = k.shape
    B, _, H, _ = q.shape
    live = stock_attended(torch, table, q_pos, NB, BLK).sum().item()
    nbytes = (2 * live * KVH * d * k.element_size()
              + 2 * q.numel() * q.element_size()
              + 2 * B * KVH * d * q.element_size()
              + table.numel() * 4 + q_pos.numel() * 4)
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_ops = 4.0 * d * H * (live + B) / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_stock(torch, kn, gen):
    """stock_paged (split and combine pass) against its plain version at
    the paged kernel's serving shape, bf16 and float32 (pools and q of one
    dtype), the step's own K/V merged in: each live row's query heads
    against their own max |plain| (``row_rel_err``), the inactive row
    finite; cold-L2 (layer rotated over the 32 planes), warm, plain and
    library times (SDPA over a pre-gathered view of the attended slots
    with the step's own slot appended, gather not timed) and the bound."""
    import torch.nn.functional as F

    rows = {}
    for dtype, bound, peak in (
            (torch.bfloat16, REL_BOUND, PEAK_BF16_FLOPS),
            (torch.float32, F32_KERNEL_BOUND, PEAK_F32_FLOPS)):
        q, k, v, _, table, q_pos = paged_inputs(torch, gen, dtype=dtype)
        L, KVH, NB, BLK, d = k.shape
        B, _, G, _ = q.shape
        H = KVH * G
        q = q.reshape(B, 1, H, d)
        k_new, v_new = (torch.randn(B, 1, KVH, d, device="cuda",
                                    generator=gen).to(dtype)
                        for _ in range(2))
        args = (q, k_new, v_new, k, v, table, q_pos)
        layer = L - 1
        name = "bfloat16" if dtype == torch.bfloat16 else "float32"
        before = dict(kn.stock_paged_decode.launches_by_instance)
        out = kn.stock_paged_decode(*args, layer=layer)
        torch.cuda.synchronize()
        instance = ran_instance(kn.stock_paged_decode.launches_by_instance,
                                before)
        again = kn.stock_paged_decode(*args, layer=layer)
        torch.cuda.synchronize()
        identical = bool(torch.equal(out, again))
        ref = kn.stock_paged_decode_reference(*args, layer=layer)
        live = q_pos >= 0
        finite = bool(torch.isfinite(out).all())
        rel = row_rel_err(torch, out[live], ref[live])

        cold = [lambda i=i: kn.stock_paged_decode(*args, layer=i)
                for i in range(L)]
        ms = time_ms(torch, cold, iters=4 * L)
        stock_names = ("stock_split", "stock_combine")
        device_ms, profiled = device_ms_per_launch(torch, cold, stock_names,
                                                   "stock_split")
        warm_ms = time_ms(torch, lambda: kn.stock_paged_decode(
            *args, layer=layer))
        # The wrapper's host time per call: back-to-back calls on the host
        # clock, ended by one synchronise (the kernels finish sooner).
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i in range(4 * L):
            cold[i % L]()
        host_ms = (time.perf_counter() - t) * 1e3 / (4 * L)
        torch.cuda.synchronize()
        # The split size, by measurement: each candidate's output held to
        # the same bound, its device and event ms.
        sweep = {}
        for split in STOCK_SPLITS:
            runs = [lambda i=i, split=split: kn.stock_paged_launch(
                *args, layer=i, split=split) for i in range(L)]
            got = runs[layer]()
            torch.cuda.synchronize()
            sweep[split] = dict(
                worst_row_rel=row_rel_err(torch, got[live], ref[live]),
                device_ms=device_ms_per_launch(torch, runs, stock_names,
                                               "stock_split")[0],
                ms=time_ms(torch, runs, iters=4 * L))
        plain_ms = time_ms(torch, [
            lambda i=i: kn.stock_paged_decode_reference(*args, layer=i)
            for i in range(L)], iters=L)
        blk = table.long().clamp(0, NB - 1)
        attend = stock_attended(torch, table, q_pos, NB, BLK)
        mask = torch.cat([attend, torch.ones_like(attend[:, :1])], 1)[
            :, None, None, :]
        qt = q.transpose(1, 2)
        view_bytes = 2 * KVH * B * (blk.numel() * BLK + 1) * d \
            * k.element_size()
        n_views = max(2, -(-4 * L2_BYTES // view_bytes))
        views = [tuple(
            torch.cat([t[i % L][:, blk].reshape(KVH, B, -1, d)
                       .transpose(0, 1), new.transpose(1, 2)], dim=2)
            .contiguous() for t, new in ((k, k_new), (v, v_new)))
            for i in range(n_views)]
        library_ms = time_ms(torch, [
            lambda kg=kg, vg=vg: F.scaled_dot_product_attention(
                qt, kg, vg, attn_mask=mask, enable_gqa=True)
            for kg, vg in views], iters=4 * n_views)
        del views
        bound_ms, bound_by = stock_bound(torch, q, k, table, q_pos, peak)
        key = ("stock_paged", f"serving_{name}")
        row = dict(
            phase="kernel_check", kernel="stock_paged", shape="serving",
            B=B, KVH=KVH, G=G, d=d, BLK=BLK, MB=table.shape[1], L=L,
            layer=layer, fills=list(PAGED_FILLS),
            inactive=list(PAGED_INACTIVE), dtype=name, instance=instance,
            launches_per_call=kn.STOCK_KERNELS_PER_CALL,
            split_slots=kn.STOCK_SPLIT, split_sweep=sweep,
            worst_row_rel=rel, rel_bound=bound, finite=finite,
            bit_identical=identical, ms=ms, device_ms=device_ms,
            profiled_calls=profiled, host_ms=host_ms,
            warm_ms=warm_ms,
            earlier_ms=EARLIER_MS[key],
            earlier_device_ms=EARLIER_DEVICE_MS[key], earlier_is=EARLIER_IS,
            plain_ms=plain_ms,
            library_ms=library_ms,
            library="scaled_dot_product_attention over a pre-gathered "
            "view with the step's own slot appended, bool mask, gather "
            "not timed", bound_ms=bound_ms, bound_by=bound_by,
            roofline_share=bound_ms / ms,
            device_roofline_share=bound_ms / device_ms if device_ms
            else None)
        emit(row)
        want = kn.stock_instance(dtype, dtype)
        if not (finite and rel < bound and identical and instance == want
                and all(r["worst_row_rel"] < bound for r in sweep.values())):
            raise AssertionError(
                f"stock_paged ({name}): finite {finite}, worst live row "
                f"{rel} of its max |plain| (bound {bound}), bit-identical "
                f"{identical}, instance {instance} (expected {want}), "
                f"splits {sweep}")
        rows[name] = row
    return rows


def splash_bound(q, k, offset, peak):
    """Least time (ms) of one splash call: q and out once and the K/V
    columns some query attends (min(S, T + offset) per row and KV head)
    over HBM bandwidth, vs the QK and PV FLOPs (4*d per query head) of
    the attended (query, column) pairs over ``peak``."""
    B, T, H, d = q.shape
    S, KVH = k.shape[1], k.shape[2]
    cols = min(S, T + offset)
    pairs = sum(min(S, t + offset + 1) for t in range(T))
    nbytes = (2 * q.numel() * q.element_size()
              + 2 * B * cols * KVH * d * k.element_size())
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_ops = 4.0 * d * H * B * pairs / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_splash(torch, kn, fa, gen):
    """splash_prefill against its plain version at SPLASH_SHAPES (H=32,
    KVH=8, d=128), bf16 and float32: each query row against its own max
    |plain| (``row_rel_err``); cold-L2, warm, plain and library times
    (SDPA with the boolean causal-offset mask) and the bound (bf16 peak
    for bf16, the float32 CUDA-core peak for float32).  In bf16 also the
    port's flash forward on the same inputs and the same causal window
    (query t at position offset + t, every slot written), its device ms
    beside splash's: the same work through the positional kernel."""
    import torch.nn.functional as F

    rows = {}
    H, KVH, d = 32, 8, 128
    for shape, (B, T, S, off) in SPLASH_SHAPES.items():
        for dtype, bound, peak in (
                (torch.bfloat16, REL_BOUND, PEAK_BF16_FLOPS),
                (torch.float32, F32_KERNEL_BOUND, PEAK_F32_FLOPS)):
            args = tuple(torch.randn(sh, device="cuda", generator=gen)
                         .to(dtype) for sh in ((B, T, H, d), (B, S, KVH, d),
                                               (B, S, KVH, d)))
            before = dict(kn.splash_prefill.launches_by_instance)
            out = kn.splash_prefill(*args, chunk_offset=off)
            torch.cuda.synchronize()
            instance = ran_instance(kn.splash_prefill.launches_by_instance,
                                    before)
            identical = bool(torch.equal(
                out, kn.splash_prefill(*args, chunk_offset=off)))
            ref = kn.splash_prefill_reference(*args, chunk_offset=off)
            finite = bool(torch.isfinite(out).all())
            rel = row_rel_err(torch, out, ref)
            del ref
            copies = cold_copies(args)
            cold = [lambda a=a: kn.splash_prefill(*a, chunk_offset=off)
                    for a in copies]
            ms = time_ms(torch, cold, iters=4 * len(copies))
            device_ms, profiled = device_ms_per_launch(
                torch, cold, ("splash_",), "splash_")
            warm_ms = time_ms(torch, lambda: kn.splash_prefill(
                *args, chunk_offset=off))
            plain_ms = time_ms(torch, [
                lambda a=a: kn.splash_prefill_reference(
                    *a, chunk_offset=off) for a in copies],
                iters=len(copies), warmup=1)
            flash = {}
            if dtype == torch.bfloat16:
                i32 = dict(device="cuda", dtype=torch.int32)
                q_pos = (off + torch.arange(T, **i32))[None].expand(
                    B, T).contiguous()
                kv_pos = torch.arange(S, **i32)[None].expand(B, S).contiguous()
                flash_ms, flash_seen = device_ms_per_launch(torch, [
                    lambda a=a: fa.flash_attention(*a, q_pos, kv_pos)
                    for a in copies], ("flash_fwd",), "flash_fwd")
                flash = dict(flash_same_work_device_ms=flash_ms,
                             flash_instance=fa.flash_instance(dtype, d, T, S),
                             flash_profiled_calls=flash_seen)
            mask = (torch.arange(S, device="cuda")[None, :]
                    <= torch.arange(T, device="cuda")[:, None] + off)
            library_ms = time_ms(torch, [
                lambda a=a: F.scaled_dot_product_attention(
                    *(x.transpose(1, 2) for x in a), attn_mask=mask,
                    enable_gqa=True) for a in copies],
                iters=4 * len(copies))
            del copies
            bound_ms, bound_by = splash_bound(args[0], args[1], off, peak)
            name = "bfloat16" if dtype == torch.bfloat16 else "float32"
            key = ("splash_prefill", f"{shape}_{name}")
            row = dict(
                phase="kernel_check", kernel="splash_prefill", shape=shape,
                B=B, T=T, S=S, H=H, KVH=KVH, d=d, chunk_offset=off,
                dtype=name, instance=instance, worst_row_rel=rel,
                rel_bound=bound, finite=finite, bit_identical=identical,
                ms=ms, device_ms=device_ms,
                profiled_calls=profiled, warm_ms=warm_ms,
                earlier_ms=EARLIER_MS.get(key),
                earlier_device_ms=EARLIER_DEVICE_MS.get(key),
                earlier_is=EARLIER_IS, plain_ms=plain_ms, **flash,
                library_ms=library_ms,
                library="scaled_dot_product_attention, bool causal-offset "
                "mask, enable_gqa", bound_ms=bound_ms, bound_by=bound_by,
                roofline_share=bound_ms / ms)
            emit(row)
            want = kn.splash_instance(dtype)
            if not (finite and rel < bound and identical
                    and instance == want):
                raise AssertionError(
                    f"splash_prefill {shape} ({name}): finite {finite}, "
                    f"worst row {rel} of its max |plain| (bound {bound}), "
                    f"bit-identical {identical}, instance {instance} "
                    f"(expected {want})")
            rows[f"{shape}_{name}"] = row
    return rows


def train_kernel_inputs(torch, gen, dtype, B, T, H, KVH, d):
    """q, k, v, a cotangent g, and causal positions 0..T-1 (no padding)."""
    shapes = ((B, T, H, d), (B, T, KVH, d), (B, T, KVH, d), (B, T, H, d))
    q, k, v, g = (torch.randn(sh, device="cuda", generator=gen).to(dtype)
                  for sh in shapes)
    pos = torch.arange(T, device="cuda", dtype=torch.int32)[None].repeat(B, 1)
    return q, k, v, g, pos, pos.clone()


def train_kernel_bounds(torch, q, k, q_pos, kv_pos):
    """Least time (ms) and its bound for the forward, dQ and dK/dV kernels:
    FLOPs of this data's live (packed row, slot) pairs (4*d, 6*d and 8*d
    per pair and query head) over the bf16 peak, vs each input read once
    and each output written once over HBM bandwidth."""
    B, T, H, d = q.shape
    kp = kv_pos[:, None, :]
    live = ((kp >= 0) & (kp <= q_pos[:, :, None])).sum().item() * H
    esz = q.element_size()
    qb, kb = q.numel() * esz, k.numel() * esz
    rows = B * H * T * 4  # one float32 per packed row (lse, delta)
    pos = (q_pos.numel() + kv_pos.numel()) * 4
    work = {
        "flash_fwd": (4 * d, qb + 2 * kb + qb + rows + pos),
        "flash_bwd_dq": (6 * d, qb + 2 * kb + qb + 2 * rows + pos + qb),
        "flash_bwd_dkv": (8 * d, qb + 2 * kb + qb + 2 * rows + pos + 2 * kb),
    }
    out = {}
    for name, (per_pair, nbytes) in work.items():
        t_ops = per_pair * live / PEAK_BF16_FLOPS * 1e3
        t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
        out[name] = (max(t_ops, t_bytes),
                     "operations" if t_ops >= t_bytes else "bytes")
    return out


def row_rel_err(torch, got, want, loose=None) -> float:
    """The worst row's max abs error over that row's own max |plain| (a row
    is everything but the last axis: a packed query row of out or dq, a KV
    slot of dk or dv), so a long causal row's small values are not held
    to the first rows' scale.  A row whose plain value is all zero, or is
    flagged in ``loose`` (its exact value is zero and the plain version's
    is rounding noise), is held against the tensor's max |plain|."""
    err = (got.float() - want.float()).abs().amax(-1)
    scale = want.float().abs().amax(-1)
    odd = scale == 0
    if loose is not None:
        odd = odd | loose
    return (err / torch.where(odd, scale.max(), scale)).max().item()


def short_rows(q_pos, kv_pos, H):
    """[B, T, H] True where a query attends fewer than 3 slots.  With one
    slot P = 1, so dS = P (dP - Delta) and dq are exactly zero; with two,
    dS = -/+ P0 P1 (dP0 - dP1) and dq = dS (k0 - k1) scale, so one near
    tie of dP0 and dP1 shrinks the whole row to its rounding noise."""
    kp = kv_pos[:, None, :]
    live = ((kp >= 0) & (kp <= q_pos[:, :, None])).sum(-1)
    return (live < 3)[:, :, None].expand(-1, -1, H)


def lse_abs_err(torch, lse, ref):
    """Max abs error of the row lse; rows with no live slot (+inf in both)
    count 0."""
    same_inf = torch.isinf(ref) & (lse == ref)
    return torch.where(same_inf, 0.0, lse - ref).abs().max().item()


def train_kernel_errors(torch, fa, args, rate, seed):
    """Kernel vs plain for out, lse (forward) and dq, dk, dv (backward on
    the kernel forward's own out and lse): per row for out, dq, dk and dv
    (``row_rel_err``), max abs error for lse."""
    q, k, v, g, q_pos, kv_pos = args
    out, lse = fa._forward(q, k, v, q_pos, kv_pos, rate, seed, True)
    ref_out, ref_lse = fa.flash_attention_reference(
        q, k, v, q_pos, kv_pos, rate, seed, return_lse=True)
    errs = dict(out=row_rel_err(torch, out, ref_out),
                lse=lse_abs_err(torch, lse, ref_lse))
    del ref_out, ref_lse
    got = fa.flash_backward(q, k, v, q_pos, kv_pos, out, lse, g, rate, seed)
    want = fa.flash_backward_reference(q, k, v, q_pos, kv_pos, out, lse, g,
                                       rate, seed)
    loose = dict(dq=short_rows(q_pos, kv_pos, q.shape[2]))
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        errs[name] = row_rel_err(torch, a, b, loose.get(name))
    finite = all(bool(t.isfinite().all()) for t in (lse, out, *got))
    return errs, finite, out, lse


def check_train_kernels(torch, fa, gen):
    """kernel_check at the training shape, without and with dropout, and
    the float32 path on a smaller shape."""
    import torch.nn.functional as F

    rows = {}
    args = train_kernel_inputs(torch, gen, torch.bfloat16, **TRAIN_SHAPE)
    q, k, v, g, q_pos, kv_pos = args
    bounds = train_kernel_bounds(torch, q, k, q_pos, kv_pos)
    wrappers = {"flash_fwd": fa.flash_attention,
                "flash_bwd_dq": fa.flash_bwd_dq,
                "flash_bwd_dkv": fa.flash_bwd_dkv}
    for rate in (0.0, TRAIN_DROPOUT):
        seed = TRAIN_SEED_WORDS if rate else None
        before = {name: dict(w.launches_by_instance)
                  for name, w in wrappers.items()}
        errs, finite, out, lse = train_kernel_errors(torch, fa, args, rate,
                                                     seed)
        torch.cuda.synchronize()
        # The instance each wrapper counted in that one call (observed:
        # the backward kernels' C entry points report what they ran).
        instance = {name: ran_instance(w.launches_by_instance, before[name])
                    for name, w in wrappers.items()}
        delta = fa.flash_delta(out, g, k.shape[2])
        copies = cold_copies((q, k, v, g, q_pos, kv_pos, out, lse, delta))
        n = len(copies)
        ms = {
            "flash_fwd": time_ms(torch, [
                lambda a=a: fa._forward(a[0], a[1], a[2], a[4], a[5], rate,
                                        seed, True) for a in copies],
                iters=4 * n),
            "flash_bwd_dq": time_ms(torch, [
                lambda a=a: fa.flash_bwd_dq(a[0], a[1], a[2], a[4], a[5],
                                            a[7], a[8], a[3], rate, seed)
                for a in copies], iters=4 * n),
            "flash_bwd_dkv": time_ms(torch, [
                lambda a=a: fa.flash_bwd_dkv(a[0], a[1], a[2], a[4], a[5],
                                             a[7], a[8], a[3], rate, seed)
                for a in copies], iters=4 * n),
        }
        device_ms = {
            "flash_fwd": kernel_device_ms(torch, [
                lambda a=a: fa._forward(a[0], a[1], a[2], a[4], a[5], rate,
                                        seed, True) for a in copies],
                ("flash_fwd",)),
            "flash_bwd_dq": kernel_device_ms(torch, [
                lambda a=a: fa.flash_bwd_dq(a[0], a[1], a[2], a[4], a[5],
                                            a[7], a[8], a[3], rate, seed)
                for a in copies], ("flash_bwd_dq",)),
            "flash_bwd_dkv": kernel_device_ms(torch, [
                lambda a=a: fa.flash_bwd_dkv(a[0], a[1], a[2], a[4], a[5],
                                             a[7], a[8], a[3], rate, seed)
                for a in copies], ("flash_bwd_dkv",)),
        }
        del copies
        plain_fwd = time_ms(torch, lambda: fa.flash_attention_reference(
            q, k, v, q_pos, kv_pos, rate, seed, return_lse=True),
            iters=2, warmup=1)
        plain_bwd = time_ms(torch, lambda: fa.flash_backward_reference(
            q, k, v, q_pos, kv_pos, out, lse, g, rate, seed),
            iters=2, warmup=1)
        # Yardstick: SDPA (causal, GQA) forward, and its backward through
        # autograd (one call computes dq, dk and dv).
        qt, kt, vt, gt = (x.transpose(1, 2) for x in (q, k, v, g))
        lib_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True, dropout_p=rate))
        leaves = [x.detach().clone().requires_grad_() for x in (qt, kt, vt)]
        lib_out = F.scaled_dot_product_attention(
            *leaves, is_causal=True, enable_gqa=True, dropout_p=rate)
        lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
            lib_out, leaves, gt, retain_graph=True))
        del lib_out, leaves, out, lse, delta
        label = "dropout" if rate else "no_dropout"
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            fwd = name == "flash_fwd"
            keys = ("out", "lse") if fwd else (
                ("dq",) if name == "flash_bwd_dq" else ("dk", "dv"))
            row = dict(
                phase="kernel_check", kernel=name, shape="train",
                dropout=rate, **TRAIN_SHAPE, dtype="bfloat16",
                err={key: errs[key] for key in keys},
                err_is=TRAIN_ERR_IS, bound={key: TRAIN_BOUNDS[key]
                                            for key in keys},
                worst_row_rel=max(errs[key] for key in keys
                                  if key != "lse"),
                finite=finite, ms=ms[name],
                plain_ms=plain_fwd if fwd else plain_bwd,
                plain="flash_attention_reference (lse)" if fwd else
                "flash_backward_reference (dq, dk and dv in one call)",
                library_ms=lib_fwd if fwd else lib_bwd,
                library="scaled_dot_product_attention" + (
                    "" if fwd else " backward via autograd (dq, dk, dv)"),
                bound_ms=bounds[name][0], bound_by=bounds[name][1],
                roofline_share=bounds[name][0] / ms[name],
                instance=instance[name], device_ms=device_ms[name],
                device_roofline_share=(bounds[name][0] / device_ms[name]
                                       if device_ms[name] else None),
                earlier_ms=EARLIER_MS[(
                    name, "train_dropout" if rate else "train")],
                earlier_is=EARLIER_IS,
            )
            emit(row)
            rows[(name, label)] = row
        bad = [key for key, e in errs.items() if not e < TRAIN_BOUNDS[key]]
        want = {"flash_fwd": fa.flash_instance(q.dtype, q.shape[3],
                                               q.shape[1], k.shape[1])}
        want["flash_bwd_dq"] = want["flash_bwd_dkv"] = fa.flash_bwd_instance(
            q.dtype, q.shape[3], q.shape[1], k.shape[1])
        if bad or not finite or instance != want:
            raise AssertionError(
                f"train kernels ({label}): {errs} against {TRAIN_BOUNDS}, "
                f"finite {finite}, instances {instance} (expected {want})")

    # The float32 path, smaller shape.
    f32 = {}
    args = train_kernel_inputs(torch, gen, torch.float32, **TRAIN_F32_SHAPE)
    for rate in (0.0, TRAIN_DROPOUT):
        seed = TRAIN_SEED_WORDS if rate else None
        errs, finite, _, _ = train_kernel_errors(torch, fa, args, rate, seed)
        f32["dropout" if rate else "no_dropout"] = dict(errs, finite=finite)
    emit(dict(phase="kernel_check", kernel="flash_fwd+flash_bwd_dq+"
              "flash_bwd_dkv", shape="train_f32", **TRAIN_F32_SHAPE,
              dtype="float32", err=f32, err_is=TRAIN_ERR_IS,
              bound=F32_KERNEL_BOUND))
    for label, errs in f32.items():
        if not (errs.pop("finite")
                and all(e < F32_KERNEL_BOUND for e in errs.values())):
            raise AssertionError(f"float32 train kernels ({label}): {errs}")
    return rows


NO_LAUNCHES = dict.fromkeys(("flash_fwd", "flash_fwd_int8", "flash_bwd_dq",
                            "flash_bwd_dkv", "paged_decode",
                            "paged_decode_int8", "stock_paged",
                            "splash_prefill"), 0)


def selection_kernels():
    return importlib.import_module("jax_llama_tpu_torch.ops.kernels")


def bwd_counts(fa):
    return {"flash_fwd": fa.flash_attention.launches,
            "flash_bwd_dq": fa.flash_bwd_dq.launches,
            "flash_bwd_dkv": fa.flash_bwd_dkv.launches}


def launch_counts(fa, pa):
    """Every kernel instance's launches since the last ``zero_counts``;
    ``paged_decode`` counts the bf16/float32-pool launches,
    ``paged_decode_int8`` the int8-pool ones."""
    paged = pa.paged_pool_attention
    kn = selection_kernels()
    return dict(bwd_counts(fa),
                flash_fwd_int8=fa.flash_attention_quantized.launches,
                paged_decode=paged.launches - paged.launches_int8,
                paged_decode_int8=paged.launches_int8,
                stock_paged=kn.stock_paged_decode.launches,
                splash_prefill=kn.splash_prefill.launches)


def instance_counts(fa, pa):
    """Since the last ``zero_counts``: the flash forward's (bf16/float32
    and int8) and the backward kernels' launches per instance their C
    entry points report (and the forward's kernels: two a split-KV call),
    the paged kernel's per split-pass instance, the kernels
    (split and combine passes) its C entry point reports launched, and
    the selection layer's wrapper calls per instance."""
    paged = pa.paged_pool_attention
    kn = selection_kernels()
    return dict(splash_by_instance=dict(
                    kn.splash_prefill.launches_by_instance),
                stock_by_instance=dict(
                    kn.stock_paged_decode.launches_by_instance),
                flash_fwd_by_instance=dict(
                    fa.flash_attention.launches_by_instance),
                flash_fwd_kernel_launches=fa.flash_attention.kernel_launches,
                flash_fwd_int8_by_instance=dict(
                    fa.flash_attention_quantized.launches_by_instance),
                flash_bwd_dq_by_instance=dict(
                    fa.flash_bwd_dq.launches_by_instance),
                flash_bwd_dkv_by_instance=dict(
                    fa.flash_bwd_dkv.launches_by_instance),
                paged_by_instance=dict(paged.launches_by_instance),
                paged_kernel_launches=paged.kernel_launches)


def zero_counts(fa, pa):
    for w in (fa.flash_attention, fa.flash_attention_quantized,
              fa.flash_bwd_dq, fa.flash_bwd_dkv):
        w.launches = 0
        w.kernel_launches = 0
        w.launches_by_instance = {}
    pa.paged_pool_attention.launches = 0
    pa.paged_pool_attention.launches_int8 = 0
    pa.paged_pool_attention.launches_by_t = {}
    pa.paged_pool_attention.launches_by_instance = {}
    pa.paged_pool_attention.kernel_launches = 0
    kn = selection_kernels()
    kn.stock_paged_decode.launches = 0
    kn.stock_paged_decode.launches_by_instance = {}
    kn.splash_prefill.launches = 0
    kn.splash_prefill.launches_by_instance = {}


def ptxas_report(log):
    """Each kernel's registers and spill bytes from ``nvcc -Xptxas -v``'s
    output: {mangled name: {"registers": n, "spill_stores": bytes,
    "spill_loads": bytes}}."""
    import re

    report, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            report[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            report[name].update(spill_stores=int(m.group(1)),
                                spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            report[name]["registers"] = int(m.group(1))
    return report


def layer_copy(torch, params, n_layers, dtype=None):
    """A copy of the first n_layers of params (all other weights copied
    too), optionally cast."""
    def cp(t):
        return t.detach().to(dtype or t.dtype).clone()

    out = {k: (cp(v) if isinstance(v, torch.Tensor)
               else {kk: cp(vv) for kk, vv in v.items()})
           for k, v in params.items() if k != "layers"}
    out["layers"] = {k: cp(w[:n_layers]) for k, w in params["layers"].items()}
    return out


def train_documents(np, vocab, n_docs=16):
    """Random documents of 100-3000 token ids, each ending in EOS."""
    rng = np.random.default_rng(0)
    return [list(rng.integers(0, vocab, rng.integers(100, 3001)))
            + [LLAMA3_EOS] for _ in range(n_docs)]


def train_grad_check(torch, train, fa, pa, params, cfg, tokens):
    """Gradients through the kernels against the plain xla path (float32,
    GRAD_LAYERS layers, T = GRAD_T), and one dropout step."""
    c = cfg.replace(n_layers=GRAD_LAYERS, dtype="float32",
                    param_dtype="float32")
    p32 = layer_copy(torch, params, GRAD_LAYERS, torch.float32)
    names, leaves = zip(*train.tree_items(p32))
    for t in leaves:
        t.requires_grad_(True)
    toks = tokens[:2, :GRAD_T].contiguous()
    losses, grads = {}, {}
    for impl in ("flash", "xla"):
        loss = train.lm_loss(p32, toks, c.replace(attn_impl=impl))
        losses[impl] = loss.item()
        grads[impl] = torch.autograd.grad(loss, leaves)
    grad_rel = {n: rel_err(a, b) for n, a, b in
                zip(names, grads["flash"], grads["xla"])}
    loss_rel = abs(losses["flash"] - losses["xla"]) / abs(losses["xla"])
    del grads
    opt = train.make_optimizer()
    state = train.init_train_state(p32, opt)
    zero_counts(fa, pa)
    state, dloss = train.train_step(
        state, toks, c.replace(attn_impl="flash", attn_pdrop=0.1,
                               resid_pdrop=0.1), opt, dropout_seed=0)
    dloss = dloss.item()
    drop_launches = bwd_counts(fa)
    drop_instances = instance_counts(fa, pa)
    drop_instances = {k: drop_instances[k] for k in (
        "flash_fwd_by_instance", "flash_bwd_dq_by_instance",
        "flash_bwd_dkv_by_instance")}
    del state, p32, leaves
    row = dict(phase="train_grad_check", config="llama3-8b",
               n_layers=GRAD_LAYERS, T=GRAD_T, batch=2, dtype="float32",
               remat=cfg.remat_policy, losses=losses, loss_rel=loss_rel,
               loss_rel_bound=GRAD_LOSS_REL, grad_rel=grad_rel,
               grad_rel_bound=GRAD_REL, dropout_step_loss=dloss,
               dropout_step_launches=drop_launches,
               dropout_step_instances=drop_instances)
    emit(row)
    want = {"flash_fwd": 2 * GRAD_LAYERS, "flash_bwd_dq": GRAD_LAYERS,
            "flash_bwd_dkv": GRAD_LAYERS}
    want_instances = {f"{name}_by_instance": {"float32": n}
                      for name, n in want.items()}
    if not (loss_rel < GRAD_LOSS_REL
            and all(e < GRAD_REL for e in grad_rel.values())
            and drop_launches == want
            and drop_instances == want_instances
            and bool(torch.isfinite(torch.tensor(dloss)))):
        raise AssertionError(f"train gradient check failed: {row}")
    return row


def drive_train(torch, np, ptl, fa, pa, params, base_cfg):
    """Phase 7: train_step at llama3-8b width, TRAIN_LAYERS layers."""
    import math

    from jax_llama_tpu_torch import data, train

    cfg = base_cfg.replace(n_layers=TRAIN_LAYERS, remat=True,
                           remat_policy="dots", attn_impl="flash")
    B, T = 4, 2048
    batch = next(data.batches(train_documents(np, cfg.vocab_size), B, T))
    batch = data.to_device(batch, "cuda")
    grad_row = train_grad_check(torch, train, fa, pa, params, cfg,
                                batch.tokens)

    tparams = layer_copy(torch, params, TRAIN_LAYERS)
    opt = train.make_optimizer()
    state = train.init_train_state(tparams, opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    L = TRAIN_LAYERS
    want_step = {"flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkv": L}
    losses, step_ms, per_step = [], [], []
    zero_counts(fa, pa)
    for _ in range(TRAIN_STEPS):
        before = bwd_counts(fa)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, loss = train.train_step(state, batch.tokens, cfg, opt,
                                       loss_mask=batch.loss_mask)
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
        losses.append(loss.item())
        after = bwd_counts(fa)
        per_step.append({k: after[k] - before[k] for k in after})
    launches = launch_counts(fa, pa)
    instances = instance_counts(fa, pa)
    peak = torch.cuda.max_memory_allocated()

    def one_step():
        nonlocal state
        state, _ = train.train_step(state, batch.tokens, cfg, opt,
                                    loss_mask=batch.loss_mask)

    profile = device_profile(torch, one_step, top=12, categories={
        "flash_fwd": ("flash_fwd",), "flash_bwd_dq": ("flash_bwd_dq",),
        "flash_bwd_dkv": ("flash_bwd_dkv",),
        "gemm": ("nvjet", "gemm", "sm90_xmma", "cutlass"),
        "elementwise": ("elementwise", "reduce", "index", "gather",
                        "scatter", "cat", "copy"),
    })
    step = sorted(step_ms[2:])[len(step_ms[2:]) // 2]
    n_matmul = (ptl.param_count(tparams)
                - cfg.vocab_size * cfg.dim)  # bench.py: params - embedding
    flops = 6 * n_matmul * B * T + 3 * (2 * B * T * T * cfg.dim * L)
    row = dict(
        phase="train", config="llama3-8b", n_layers=L,
        reduced=f"depth 32 -> {L} layers (params, grads and AdamW moments "
        "in bf16 fit one card beside the 16 GB of phase-3 weights)",
        dim=cfg.dim, dtype="bfloat16", param_dtype="bfloat16",
        remat="dots", attn_impl="flash", batch=B, seq_len=T,
        loss_mask_fraction=batch.loss_mask.float().mean().item(),
        optimizer="make_optimizer() defaults (AdamW lr 3e-4, wd 0.1, "
        "b1 0.9, b2 0.95, clip 1.0)", losses=losses,
        ln_vocab=math.log(cfg.vocab_size), step_ms_all=step_ms,
        step_ms=step, tokens_per_s=B * T / step * 1e3,
        matmul_params=n_matmul, mfu=flops / (step / 1e3) / PEAK_BF16_FLOPS,
        peak_memory_bytes=peak, launches=launches, instances=instances,
        launches_per_step=per_step, profile_1_step=profile,
        grad_check_loss_rel=grad_row["loss_rel"],
    )
    emit(row)
    ok = (abs(losses[0] - math.log(cfg.vocab_size)) < 1.0
          and losses[-1] < losses[0]
          and all(math.isfinite(x) for x in losses)
          and all(c == want_step for c in per_step)
          and instances["flash_fwd_by_instance"] == {
              "wgmma": 2 * L * TRAIN_STEPS}
          and instances["flash_bwd_dq_by_instance"] == {
              "wgmma": L * TRAIN_STEPS}
          and instances["flash_bwd_dkv_by_instance"] == {
              "wgmma": L * TRAIN_STEPS}
          and launches["paged_decode"] == launches["paged_decode_int8"]
          == launches["flash_fwd_int8"] == 0)
    if not ok:
        raise AssertionError(f"train phase failed: {row}")
    del state, tparams
    return row


def prompts_for():
    """4 prompts whose BOS-prefixed lengths are 512 - PREFILL_PADS."""
    text = ("The quick brown fox jumps over the lazy dog while the port "
            "runs its first slice on the card. ") * 8
    return [text[:512 - pad - 1] for pad in PREFILL_PADS]


def device_profile(torch, fn, top=6, categories=None):
    """Device busy share and the top kernels by device time over ``fn()``,
    from torch.profiler; None where the profiler saw no device time.
    ``categories`` ({label: name substrings}) adds device ms per label,
    the first label whose substring a kernel's name holds, else "other"."""
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
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)
    out = dict(
        wall_ms=wall_ms,
        device_ms=device_ms or None,
        device_busy_share=(device_ms / wall_ms) if device_ms else None,
        kernel_launches=sum(e.count for e in kernels),
        top_kernels=[dict(name=e.key[:60], ms=e.self_device_time_total / 1e3,
                          count=e.count) for e in ranked[:top]],
    )
    if categories:
        ms = dict.fromkeys([*categories, "other"], 0.0)
        for e in kernels:
            label = next((c for c, subs in categories.items()
                          if any(sub in e.key for sub in subs)), "other")
            ms[label] += e.self_device_time_total / 1e3
        out["by_category_ms"] = ms
    return out


def serve_texts():
    """The text of the serving phase's 12 prompts (no newline in any)."""
    text = ("The quick brown fox jumps over the lazy dog while the port "
            "serves a continuous batch from its paged pool on the card. ") * 24
    return [text[7 * i:7 * i + n - 1]
            for i, n in enumerate(SERVE_PROMPT_TOKENS)]


def serve_prompts(tok):
    """The serving phase's 12 byte-tokenizer prompts (BOS included)."""
    return [tok.encode(t, bos=True) for t in serve_texts()]


# The serving profiles' kernel groups (device ms per group).
SERVE_CATEGORIES = {
    "paged_decode": ("paged_decode",), "flash_fwd": ("flash_fwd",),
    "stock_paged": ("stock_split", "stock_combine"), "splash": ("splash_",),
    "gemm": ("nvjet", "gemm", "sm90_xmma", "cutlass"),
    "elementwise": ("elementwise", "reduce", "index", "gather", "scatter",
                    "cat", "copy"),
}


def drive_serving(torch, ptl, fa, pa, params, cfg, tok, phase="serving",
                  kernels=None, tokens_out=None):
    """Phase 5 (and, with int8 weights and an int8 KV config, phase
    ``int8_serving``; with ``kernels`` = SELECTED, phase
    ``selected_serving``): the batcher at llama3-8b width, staggered
    admissions.  ``tokens_out``, when given, receives each request's
    tokens by its index in ``SERVE_PROMPT_TOKENS``."""
    int8 = cfg.kv_cache_dtype == "int8"
    kernels = kernels or {}
    prompts = serve_prompts(tok)
    assert [len(p) for p in prompts] == list(SERVE_PROMPT_TOKENS)
    t0 = time.perf_counter()
    cb = ptl.ContinuousBatcher(params, cfg, n_slots=8, max_len=2048,
                               decode_chunk=8, device="cuda", **kernels)
    resolved = dict(prefill_kernel=cb.config.prefill_kernel,
                    decode_kernel=cb.config.decode_kernel)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    L = cfg.n_layers
    results, rids = {}, {}
    steady_ms, steady_iters, steady_tokens = [], 0, 0
    quiet_steps, quiet_bad = 0, []
    zero_counts(fa, pa)
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
    launches = launch_counts(fa, pa)
    instances = instance_counts(fa, pa)
    by_t = dict(pa.paged_pool_attention.launches_by_t)
    lens = {rids[r]: len(t) for r, t in results.items()}
    in_vocab = all(0 <= t < cfg.vocab_size
                   for toks in results.values() for t in toks)
    exact = lens == {i: SERVE_MAX_NEW[i] for i in range(12)}
    if tokens_out is not None:
        tokens_out.update({rids[r]: t for r, t in results.items()})

    # Insert time: 8 of the requests admitted into the idle batcher.
    for i in range(8):
        cb.submit(prompts[i], max_new_tokens=SERVE_MAX_NEW[i])
    torch.cuda.synchronize()
    t = time.perf_counter()
    cb._admit()
    torch.cuda.synchronize()
    insert_ms = (time.perf_counter() - t) * 1e3
    cb.step()  # the K=1 step after an admission
    profile = device_profile(torch, lambda: [cb.step() for _ in range(3)],
                             categories=SERVE_CATEGORIES)

    def free_all():
        for s in list(cb.slots.values()):
            if s is not None:
                cb.cancel(s.request_id)

    # One insert's device time by kernel group: the same 8 requests
    # admitted again into the emptied batcher, under the profiler.
    free_all()
    for i in range(8):
        cb.submit(prompts[i], max_new_tokens=SERVE_MAX_NEW[i])
    insert_profile = device_profile(torch, cb._admit,
                                    categories=SERVE_CATEGORIES)
    free_all()
    del cb

    wall = sum(steady_ms)
    row = dict(
        phase=phase, config="llama3-8b", n_layers=L, dtype="bfloat16",
        weights="int8 (quantize_params)" if int8 else "bfloat16",
        kv_cache_dtype=cfg.kv_cache_dtype, kernels=resolved,
        n_slots=8, max_len=2048, block_size=128, decode_chunk=8,
        prompt_tokens=list(SERVE_PROMPT_TOKENS),
        max_new=list(SERVE_MAX_NEW), batcher_init_s=build_s,
        serve_s=serve_s, steps=n_steps, launches=launches,
        instances=instances, paged_launches_by_t=by_t, stats=stats,
        tokens_exact=exact, tokens_in_vocab=in_vocab,
        quiet_steps=quiet_steps, quiet_steps_with_upload_or_extra_fetch=(
            quiet_bad),
        steady_steps=len(steady_ms), steady_iterations=steady_iters,
        decode_ms_per_iteration=wall / steady_iters if steady_iters else None,
        tokens_per_s=steady_tokens / wall * 1e3 if wall else None,
        insert_ms=insert_ms, insert_rows=8,
        busy_share=profile["device_busy_share"], profile_3_steps=profile,
        profile_insert=insert_profile,
    )
    emit(row)
    suffix = "_int8" if int8 else ""
    steps = stats["decode_steps_total"]
    inserts = stats["insert_dispatches_total"]
    want, want_by_t = dict(NO_LAUNCHES), {1: L * steps}
    if resolved["prefill_kernel"] == "splash":
        want["splash_prefill"] = L * inserts
    else:
        want["flash_fwd" + suffix] = L * inserts
    if resolved["decode_kernel"] == "stock-paged":
        want["stock_paged"] = (selection_kernels().STOCK_KERNELS_PER_CALL
                               * L * steps)
        want_by_t = {}
    else:
        want["paged_decode" + suffix] = L * steps
    # The selection layer's kernels ran their bf16 instances throughout.
    kn = selection_kernels()
    want_inst = dict(
        splash_by_instance={kn.splash_instance(torch.bfloat16):
                            want["splash_prefill"]}
        if want["splash_prefill"] else {},
        stock_by_instance={kn.stock_instance(torch.bfloat16, torch.bfloat16):
                           want["stock_paged"] // kn.STOCK_KERNELS_PER_CALL}
        if want["stock_paged"] else {})
    got_inst = {k: instances[k] for k in want_inst}
    if got_inst != want_inst:
        raise AssertionError(f"{phase}: selection-layer instances "
                             f"{got_inst}, expected {want_inst}")
    if resolved != dict(prefill_kernel=kernels.get("prefill_kernel", "flash"),
                        decode_kernel=kernels.get("decode_kernel", "paged")):
        raise AssertionError(f"{phase}: the batcher resolved {resolved}")
    if launches != want or by_t != want_by_t:
        raise AssertionError(f"{phase} launches {launches} (paged by T "
                             f"{by_t}), expected {want} (by T {want_by_t})")
    # Every insert ran the flash forward's Hopper instance (blocks of 128
    # pad each insert to a multiple of 128), and every paged launch both
    # of its passes, as its C entry point reports them.
    by_instance = instances["flash_fwd_by_instance"]
    by_instance_int8 = instances["flash_fwd_int8_by_instance"]
    paged = launches["paged_decode"] + launches["paged_decode_int8"]
    if (by_instance != ({"wgmma": launches["flash_fwd"]}
                        if launches["flash_fwd"] else {})
            or by_instance_int8 != ({"wgmma": launches["flash_fwd_int8"]}
                                    if launches["flash_fwd_int8"] else {})
            or sum(instances["paged_by_instance"].values()) != paged
            or instances["paged_kernel_launches"] != 2 * paged):
        raise AssertionError(f"{phase}: flash instances {by_instance}, "
                             f"int8 {by_instance_int8}, paged kernels "
                             f"{instances}, launches {launches}")
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


# The HTTP phases: the port's LLMServer in this process, its requests
# from client threads over 127.0.0.1.
HTTP_STREAMS = tuple(range(1, 12, 2))  # 6 of the 12 requests stream
# The histogram families whose quantiles http_serving reports.
HTTP_QUANTILES = (0.5, 0.95)
# Series that /metrics must carry (the JAX package's names; every other
# scalar is checked against the port's registry, obs.METRICS).
HTTP_SERIES = (
    "llm_emitted_tokens_total", "llm_decode_steps_total",
    "llm_insert_dispatches_total", "llm_server_recoveries_total",
    "llm_quarantine_rebuilds_total", "llm_slo_attainment",
    "llm_goodput_tokens_total", "llm_overload_rung",
    "llm_ttft_ms_bucket", "llm_itl_ms_bucket", "llm_dispatch_ms_bucket",
    "llm_mxu_utilization", "llm_hbm_utilization", "llm_host_overhead_ratio",
    "llm_jit_cache_entries", "llm_feature_quarantined_paged_kernel",
)
# http_drill: 4 of the serving phase's requests at DECODE_DEPTH layers in
# float32 activations; a feature quarantines after 2 attributed failures
# and is probed 30 s (of the injected clock) later; a token that differs
# from the fault-free run must be a near-tie: its logit gap, over the
# row's max |logit| in a plain float32 forward, below DRILL_TIE.
DRILL_SLOTS, DRILL_THRESHOLD, DRILL_COOLDOWN_S = 4, 2, 30.0
DRILL_TIE = 1e-4
# (feature, fault site, the batcher's arguments, the fallback's): each
# quarantine drill's faults are the site's first two calls.
DRILLS = (
    ("splash_prefill", "splash_kernel", dict(prefill_kernel="splash"),
     dict(prefill_kernel="flash")),
    ("stock_paged", "stock_paged_kernel", dict(decode_kernel="stock-paged"),
     dict(decode_kernel="paged")),
)
# The breaker drills' sites, each faulted on every call: the generic step
# and the two kernels whose only fallback would be plain PyTorch.
BREAKER_SITES = (("step", None), ("paged_kernel", "paged_kernel"),
                 ("flash_kernel", "flash_attention"))


def http_request(url, path, payload=None, timeout=900):
    """(status, headers, body bytes) of one request; an HTTP error status
    is an answer too."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url + path, data=data)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def http_json(url, path):
    status, _, body = http_request(url, path)
    return status, json.loads(body)


def http_tokens(reply):
    """(status, tokens) of a /generate reply, blocking or NDJSON; a stream
    must end in a record whose tokens are the ones it streamed."""
    status, headers, body = reply
    if status != 200:
        return status, None
    if "ndjson" not in headers.get("Content-Type", ""):
        return status, json.loads(body)["tokens"]
    lines = [json.loads(x) for x in body.splitlines()]
    final = lines[-1]
    streamed = [ln["token"] for ln in lines[:-1]]
    if not final.get("done") or streamed != final["tokens"]:
        raise AssertionError(f"stream {streamed} ends in {final}")
    return status, streamed


def prometheus_samples(text):
    """{sample line's name and labels: value} of a Prometheus text
    exposition; raises on a line that does not parse, an unregistered
    metric's help line, or a sample of a family without a TYPE line."""
    import re

    sample = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})? (\S+)$')
    typed, out = set(), {}
    for line in text.splitlines():
        if line.startswith("# HELP"):
            if "UNREGISTERED" in line:
                raise AssertionError(f"/metrics: {line}")
            continue
        if line.startswith("# TYPE"):
            typed.add(line.split()[2])
            continue
        m = sample.match(line)
        if not m:
            raise AssertionError(f"/metrics line does not parse: {line!r}")
        name = m.group(1)
        family = re.sub(r"_(bucket|sum|count)$", "", name)
        if name not in typed and family not in typed:
            raise AssertionError(f"/metrics sample without a TYPE: {line}")
        out[name + (m.group(2) or "")] = float(m.group(3))
    return out


def histogram_quantile(samples, family, q):
    """Prometheus' histogram_quantile: the q-quantile of ``family``'s
    cumulative buckets, linear inside the bucket that holds it."""
    import re

    buckets = sorted(
        (float(re.search(r'le="([^"]+)"', k).group(1)), v)
        for k, v in samples.items()
        if k.startswith(f"llm_{family}_bucket{{"))
    total = buckets[-1][1]
    if not total:
        return None
    rank, lo, below = q * total, 0.0, 0.0
    for le, cum in buckets:
        if cum >= rank:
            if le == float("inf"):
                return lo
            return lo + (le - lo) * (rank - below) / max(cum - below, 1e-12)
        lo, below = le, cum
    return lo


def logit_gap(torch, ptl, params, cfg, prompt, prefix, a, b):
    """|logit a - logit b| over the max |logit| at the position after
    ``prompt + prefix``, in a plain forward of ``cfg``."""
    ids = torch.tensor([list(prompt) + list(prefix)], device="cuda",
                       dtype=torch.int32)
    pos = torch.arange(ids.shape[1], device="cuda",
                       dtype=torch.int32)[None]
    with torch.inference_mode():
        lg = ptl.forward(params, ids, pos, cfg.replace(attn_impl="xla"))[0]
    lg = lg[0, -1].float()
    return ((lg[a] - lg[b]).abs() / lg.abs().max()).item()


def token_divergences(torch, ptl, params, cfg, prompts, got, want, tie):
    """Each request whose tokens differ from ``want``: its first
    divergence and the logit gap there; raises unless every gap is a
    near-tie (below ``tie``)."""
    out = []
    for i, (g, w) in enumerate(zip(got, want)):
        j = first_divergence(g, w)
        if j is None:
            continue
        if j >= min(len(g), len(w)):
            raise AssertionError(f"request {i}: {len(g)} tokens, "
                                 f"expected {len(w)}")
        gap = logit_gap(torch, ptl, params, cfg, prompts[i], w[:j], g[j],
                        w[j])
        out.append(dict(request=i, at=j, got=g[j], want=w[j],
                        logit_gap_rel=gap))
        if gap >= tie:
            raise AssertionError(
                f"request {i} diverges at token {j} ({g[j]} vs {w[j]}) "
                f"with a logit gap of {gap} (bound {tie})")
    return out


def drive_http_serving(torch, ptl, fa, pa, params, cfg, tok, smi, serve_row,
                       serve_tokens):
    """Phase ``http_serving``: the serving phase's 12 requests through
    ``LLMServer`` (POST /generate from client threads, 6 blocking and 6
    NDJSON streams, all sent before the first completes) over a batcher
    of the serving phase's geometry with cost models on."""
    import threading

    from jax_llama_tpu_torch.server import LLMServer

    prompts = serve_prompts(tok)
    L = cfg.n_layers
    cb = ptl.ContinuousBatcher(params, cfg, n_slots=8, max_len=2048,
                               decode_chunk=8, device="cuda",
                               cost_models=True)
    replies, sent, done = [None] * 12, [None] * 12, [None] * 12

    def call(i):
        payload = {"prompt": prompts[i], "max_new_tokens": SERVE_MAX_NEW[i]}
        if i in HTTP_STREAMS:
            payload["stream"] = True
        sent[i] = time.perf_counter()
        replies[i] = http_request(srv.address, "/generate", payload)
        done[i] = time.perf_counter()

    with LLMServer(cb, tokenizer=tok) as srv:
        zero_counts(fa, pa)
        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        launches = launch_counts(fa, pa)
        instances = instance_counts(fa, pa)
        if any(t.is_alive() for t in threads):
            raise AssertionError("http_serving: a client never returned")
        metrics_status, _, metrics_body = http_request(srv.address,
                                                       "/metrics")
        health_status, health = http_json(srv.address, "/healthz")
        bundle_status, bundle = http_json(srv.address, "/debug/bundle")
        _, dispatches = http_json(srv.address, "/debug/dispatches?n=4096")
    samples = prometheus_samples(metrics_body.decode())
    missing = [n for n in HTTP_SERIES
               if not any(k == n or k.startswith(n + "{") for k in samples)]
    got = [http_tokens(r) for r in replies]
    statuses = [s for s, _ in got]
    tokens = [t for _, t in got]
    steps = int(samples["llm_decode_steps_total"])
    inserts = int(samples["llm_insert_dispatches_total"])
    want = dict(NO_LAUNCHES, flash_fwd=L * inserts, paged_decode=L * steps)
    divergences = (token_divergences(
        torch, ptl, params, cfg, prompts, tokens,
        [serve_tokens[i] for i in range(12)], DECODE_REL)
        if statuses == [200] * 12 else None)

    # The loop's period per decode iteration (dispatch start to the next
    # one's, over its K) at 8 busy slots, beside the batcher's own wall
    # time per iteration (dispatch and fetch).
    recs = dispatches["dispatches"]
    own, period = [], []
    for a, b in zip(recs, recs[1:]):
        if (a["kind"] == "decode" and a["occupancy"] == 8
                and b["seq"] == a["seq"] + 1):
            own.append(a["wall_ms"] / a["k"])
            period.append((b["start_ms"] - a["start_ms"]) / a["k"])
    # Each insert's record: its device time between CUDA events, which
    # the roofline time of its analytic cost bounds from below.
    ins = [r for r in recs if r["kind"] == "insert"]
    ins_ms = sum(r["wall_ms"] for r in ins)
    util = {k[len("llm_"):]: v for k, v in samples.items()
            if k.split("{")[0] in ("llm_mxu_utilization",
                                   "llm_hbm_utilization",
                                   "llm_host_overhead_ratio")}
    span = max(done) - min(sent)
    row = dict(
        phase="http_serving", card=smi, config="llama3-8b", n_layers=L,
        dtype="bfloat16", n_slots=8, max_len=2048, decode_chunk=8,
        cost_models=True, requests=12, streams=len(HTTP_STREAMS),
        statuses=statuses, all_sent_before_first_done=max(sent) < min(done),
        launches=launches, instances=instances, expected_launches=want,
        decode_steps=steps, insert_dispatches=inserts,
        recoveries=samples["llm_server_recoveries_total"],
        quarantine_rebuilds=samples["llm_quarantine_rebuilds_total"],
        compiles=samples["llm_compiles_total"],
        divergences_from_serving=divergences,
        requests_per_s=12 / span, wall_s=span,
        ttft_ms={q: histogram_quantile(samples, "ttft_ms", q)
                 for q in HTTP_QUANTILES},
        itl_ms={q: histogram_quantile(samples, "itl_ms", q)
                for q in HTTP_QUANTILES},
        quantiles_from="the server's /metrics histograms (Prometheus "
        "histogram_quantile, linear within a bucket)",
        utilization=util, peaks=dict(flops=srv.obs.peak_flops,
                                     bytes_per_s=srv.obs.peak_bytes_per_s),
        utilization_is="obs.CostModel's FLOPs and bytes over dispatch "
        "wall time: a decode dispatch's ends in its packed fetch; an "
        "insert's is its device time between CUDA events",
        insert_records=len(ins),
        insert_device_ms=[r["wall_ms"] for r in ins],
        insert_roofline_ms=[r.get("device_est_ms") for r in ins],
        insert_tokens_per_device_s=(
            sum(r["prefill_tokens"] for r in ins) / (ins_ms / 1000.0)
            if ins_ms else None),
        prefill_tokens_per_s_ewma=samples["llm_prefill_tokens_per_s_ewma"],
        batcher_ms_per_iteration=(sorted(own)[len(own) // 2]
                                  if own else None),
        loop_ms_per_iteration=(sorted(period)[len(period) // 2]
                               if period else None),
        steady_iterations_seen=len(period),
        serving_decode_ms_per_iteration=serve_row["decode_ms_per_iteration"],
        metrics_series=len(samples), missing_series=missing,
        healthz=dict(status=health_status, ok=health["ok"],
                     quarantined=health["quarantined"]),
        bundle_keys=sorted(bundle), http_status=dict(
            metrics=metrics_status, bundle=bundle_status),
    )
    emit(row)
    if statuses != [200] * 12 or not row["all_sent_before_first_done"]:
        raise AssertionError(f"http_serving: statuses {statuses}, all sent "
                             f"first: {row['all_sent_before_first_done']}")
    if launches != want or instances["flash_fwd_by_instance"] != (
            {"wgmma": want["flash_fwd"]}) or (
            instances["paged_kernel_launches"] != 2 * want["paged_decode"]):
        raise AssertionError(f"http_serving launches {launches}, "
                             f"{instances}, expected {want}")
    if row["recoveries"] or row["quarantine_rebuilds"]:
        raise AssertionError("http_serving recovered or quarantined")
    if len(ins) != inserts or not all(
            r.get("device_est_ms") and r["wall_ms"] >= r["device_est_ms"]
            for r in ins):
        raise AssertionError(
            f"http_serving: {len(ins)} insert records for {inserts} "
            f"inserts, device ms {row['insert_device_ms']} against the "
            f"roofline {row['insert_roofline_ms']}")
    if (health_status != 200 or not health["ok"] or missing
            or metrics_status != 200 or bundle_status != 200
            or "trace" not in bundle):
        raise AssertionError(f"http_serving surfaces: {row['healthz']}, "
                             f"missing {missing}")
    return row


class DrillClock:
    """The degrade manager's clock in http_drill: seconds that pass only
    when the drill says so."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def drive_http_drill(torch, ptl, fa, pa, params, cfg, tok, smi):
    """Phase ``http_drill``: LLMServer at DECODE_DEPTH layers in float32
    activations with a fault injector armed through FaultSpec and the
    degrade manager's clock injected.  A ``step`` fault mid-decode
    recovers; the splash and stock kernels' sites faulted twice
    quarantine their feature onto the fallback kernel and a probe (after
    the clock passes the cooldown) restores it, with the launches
    switching; faults at the step, paged and flash sites past
    ``max_recoveries`` trip the breaker without a quarantine.  Tokens
    are held against fault-free runs of the path that served them."""
    import threading

    from jax_llama_tpu_torch.degrade import DegradeManager
    from jax_llama_tpu_torch.faults import FaultInjector, FaultSpec
    from jax_llama_tpu_torch.server import LLMServer

    L = DECODE_DEPTH
    shallow = dict(params, layers={k: w[:L]
                                   for k, w in params["layers"].items()})
    dcfg = cfg.replace(n_layers=L, dtype="float32")
    prompts = [serve_prompts(tok)[i] for i in INVARIANT_REQUESTS]
    max_new = [SERVE_MAX_NEW[i] for i in INVARIANT_REQUESTS]

    def batcher(kw, injector=None):
        return ptl.ContinuousBatcher(
            shallow, dcfg, n_slots=DRILL_SLOTS, max_len=2048, decode_chunk=8,
            device="cuda", fault_injector=injector, **kw)

    def fault_free(kw, together):
        """Greedy tokens of the drill's requests: all admitted together,
        or each alone (as the drill's phases send them)."""
        cb = batcher(kw)
        if together:
            rids = [cb.submit(p, max_new_tokens=n)
                    for p, n in zip(prompts, max_new)]
            out = cb.run_to_completion()
            return [out[r] for r in rids]
        res = []
        for p, n in zip(prompts, max_new):
            rid = cb.submit(p, max_new_tokens=n)
            res.append(cb.run_to_completion()[rid])
        return res

    def send(srv, together):
        def call(i, out):
            out[i] = http_request(srv.address, "/generate", {
                "prompt": prompts[i], "max_new_tokens": max_new[i]})

        out = [None] * len(prompts)
        if together:
            threads = [threading.Thread(target=call, args=(i, out))
                       for i in range(len(prompts))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=900)
        else:
            for i in range(len(prompts)):
                call(i, out)
        return out

    def server(spec, kw, **srv_kw):
        clock = DrillClock()
        degrade = DegradeManager(threshold=DRILL_THRESHOLD, window_s=600.0,
                                 cooldown_s=DRILL_COOLDOWN_S, clock=clock)
        inj = FaultInjector(FaultSpec.parse(spec))
        return LLMServer(batcher(kw, inj), tokenizer=tok, degrade=degrade,
                         **srv_kw), clock, inj

    def expected(recs):
        """The launches the dispatch records imply: an insert runs the
        flash (or splash) kernel once per layer, a decode iteration the
        paged kernel (or the stock kernel's two passes) once per layer."""
        want = dict(NO_LAUNCHES)
        for r in recs:
            if r["kind"] == "insert:splash":
                want["splash_prefill"] += L
            elif r["kind"] == "insert":
                want["flash_fwd"] += L
            elif r["kind"] == "decode:stock-paged":
                want["stock_paged"] += 2 * L * r["k"]
            elif r["kind"] == "decode":
                want["paged_decode"] += L * r["k"]
        return {k: v for k, v in want.items() if v}

    def window(srv, seq0, before):
        """The dispatch records since ``seq0`` and the kernels launched
        since ``before`` (those launched at all)."""
        _, d = http_json(srv.address, "/debug/dispatches?n=4096")
        after = launch_counts(fa, pa)
        return ([r for r in d["dispatches"] if r["seq"] >= seq0],
                {k: after[k] - before[k] for k in after
                 if after[k] != before[k]})

    def check(name, cond, detail):
        if not cond:
            raise AssertionError(f"http_drill {name}: {detail}")

    zero_counts(fa, pa)
    t_start = time.perf_counter()
    drills = []

    # 1. A step fault mid-decode: one recovery, the replay token-identical.
    want = fault_free({}, together=True)
    srv, _, inj = server("step@3:error", {})
    with srv:
        before = launch_counts(fa, pa)
        got = [http_tokens(r) for r in send(srv, together=True)]
        recs, launched = window(srv, 0, before)
        _, health = http_json(srv.address, "/healthz")
        _, dec = http_json(srv.address, "/debug/decisions")
    toks = [t for _, t in got]
    row = dict(drill="step", spec="step@3:error",
               statuses=[s for s, _ in got],
               recoveries=health["recoveries_total"],
               quarantined=health["quarantined"],
               decisions=[d["kind"] for d in dec["decisions"]],
               launches=launched, expected_launches=expected(recs))
    drills.append(row)
    check("step", row["statuses"] == [200] * 4, row)
    row["divergences"] = token_divergences(torch, ptl, shallow, dcfg,
                                           prompts, toks, want, DRILL_TIE)
    check("step", row["recoveries"] == 1 and row["decisions"] == ["recovery"]
          and not row["quarantined"] and inj.injected_total == 1, row)
    check("step", launched == row["expected_launches"], row)

    # 2-3. The splash and stock kernels' sites faulted twice: quarantine
    # onto the fallback kernel, then a probe restores the kernel.
    for feature, site, kernel_kw, fallback_kw in DRILLS:
        spec = f"{site}@0:error,{site}@1:error"
        want_fallback = fault_free(dict(kernel_kw, **fallback_kw),
                                   together=False)
        want_kernel = fault_free(kernel_kw, together=False)
        srv, clock, inj = server(spec, kernel_kw)
        row = dict(drill=feature, spec=spec, kernels=kernel_kw,
                   fallback=fallback_kw)
        with srv:
            before = launch_counts(fa, pa)
            got = [http_tokens(r) for r in send(srv, together=False)]
            recs, launched = window(srv, 0, before)
            _, health = http_json(srv.address, "/healthz")
            row["quarantined"] = dict(
                statuses=[s for s, _ in got], launches=launched,
                expected_launches=expected(recs),
                healthz_quarantined=health["quarantined"],
                state=health["features"][feature]["state"])
            check(feature, row["quarantined"]["statuses"] == [200] * 4, row)
            row["quarantined"]["divergences"] = token_divergences(
                torch, ptl, shallow, dcfg, prompts, [t for _, t in got],
                want_fallback, DRILL_TIE)
            seq0 = recs[-1]["seq"] + 1
            clock.t += DRILL_COOLDOWN_S + 1.0
            deadline = time.monotonic() + 120
            while (srv.probe_rebuilds_total < 1
                   and time.monotonic() < deadline):
                time.sleep(0.01)
            before = launch_counts(fa, pa)
            got = [http_tokens(r) for r in send(srv, together=False)]
            recs, launched = window(srv, seq0, before)
            _, health = http_json(srv.address, "/healthz")
            _, dec = http_json(srv.address, "/debug/decisions")
            _, bundle = http_json(srv.address, "/debug/bundle?trace=0")
            row["probed"] = dict(
                statuses=[s for s, _ in got], launches=launched,
                expected_launches=expected(recs),
                probe_rebuilds=srv.probe_rebuilds_total,
                state=health["features"][feature]["state"],
                healthz_quarantined=health["quarantined"])
            row["decisions"] = [d["kind"] for d in dec["decisions"]]
            row["transitions"] = [
                a["fields"].get("state") for a in bundle["annotations"]
                if a["name"] == "quarantine_transition"
                and a["fields"].get("feature") == feature]
            row["injected"] = inj.injected_total
        drills.append(row)
        q, p = row["quarantined"], row["probed"]
        check(feature, q["healthz_quarantined"] == [feature]
              and q["state"] == "quarantined", row)
        check(feature, q["launches"] == q["expected_launches"], row)
        check(feature, p["statuses"] == [200] * 4, row)
        p["divergences"] = token_divergences(
            torch, ptl, shallow, dcfg, prompts, [t for _, t in got],
            want_kernel, DRILL_TIE)
        check(feature, p["launches"] == p["expected_launches"], row)
        check(feature, p["state"] == "healthy" and p["probe_rebuilds"] == 1
              and not p["healthz_quarantined"] and row["injected"] == 2, row)
        check(feature, row["decisions"] == [
            "recovery", "quarantine", "recovery", "probe"], row)
        check(feature, row["transitions"] == [
            "quarantined", "probing", "healthy"], row)
        fallback = "flash_fwd" if feature == "splash_prefill" else (
            "paged_decode")
        check(feature, feature not in q["launches"]
              and feature in p["launches"] and fallback in q["launches"],
              row)

    # 4-6. Faults on every call of the step, paged and flash sites, past
    # max_recoveries: no quarantine (plain PyTorch is no kernel's fallback
    # on the card), the breaker trips, every client gets 503, a later
    # client 503 with Retry-After.
    for site, feature in BREAKER_SITES:
        spec = f"{site}~1.0:error"
        srv, _, _ = server(spec, {}, max_recoveries=2)
        with srv:
            before = launch_counts(fa, pa)
            replies = send(srv, together=True)
            drained = srv.wait_drained(120)
            late = http_request(srv.address, "/generate",
                                {"prompt": prompts[0], "max_new_tokens": 4})
            recs, launched = window(srv, 0, before)
            h_status, health = http_json(srv.address, "/healthz")
            _, dec = http_json(srv.address, "/debug/decisions")
        name = f"breaker:{site}"
        row = dict(drill=name, spec=spec, max_recoveries=2,
                   statuses=[r[0] for r in replies], drained=drained,
                   late_status=late[0],
                   late_retry_after=late[1].get("Retry-After"),
                   healthz_status=h_status, loop_alive=health["loop_alive"],
                   recoveries=health["recoveries_total"],
                   quarantined=health["quarantined"],
                   quarantine_rebuilds=srv.quarantine_rebuilds_total,
                   feature_state=(health["features"][feature]["state"]
                                  if feature else None),
                   decisions=[d["kind"] for d in dec["decisions"]],
                   launches=launched, expected_launches=expected(recs))
        drills.append(row)
        check(name, row["statuses"] == [503] * 4 and drained
              and row["late_status"] == 503 and row["late_retry_after"]
              and h_status == 503 and not row["loop_alive"], row)
        check(name, row["decisions"] == [
            "recovery", "recovery", "recovery_breaker_tripped"], row)
        check(name, not row["quarantined"] and not row["quarantine_rebuilds"]
              and row["feature_state"] in (None, "healthy"), row)
        check(name, launched == row["expected_launches"], row)

    launches = launch_counts(fa, pa)
    out = dict(phase="http_drill", card=smi, config="llama3-8b", n_layers=L,
               dtype="float32 activations, bf16 weights",
               n_slots=DRILL_SLOTS, quarantine_threshold=DRILL_THRESHOLD,
               cooldown_s=DRILL_COOLDOWN_S, tie_bound=DRILL_TIE,
               drills=drills, launches=launches,
               seconds=time.perf_counter() - t_start)
    emit(out)
    return out


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
        paged = cb.pool.paged(cb.d_table, cb.d_fill)
        got = ptl.forward(params, *args, cache=paged, attn_mask=mask)[0]
    return rel_err(got[:, 0], want[:, 0])


def paged_invariant(torch, ptl, engine, serving, params, cfg, tok,
                    phase="paged_decode_invariant", only_f32=False):
    """Phase 6: paged batcher = gathered batcher = engine.generate (at 8
    layers in bf16 and 32 in float32 activations; ``only_f32``: the
    float32 cell alone, as the int8 phase runs it)."""
    prompts = [serve_prompts(tok)[i] for i in INVARIANT_REQUESTS]
    max_new = [SERVE_MAX_NEW[i] for i in INVARIANT_REQUESTS]
    shallow = dict(params, layers={k: w[:DECODE_DEPTH]
                                   for k, w in params["layers"].items()})
    cells = {}
    for name, p, depth, dtype, bound in (
        ("bf16_8_layers", shallow, DECODE_DEPTH, "bfloat16", DECODE_REL),
        ("f32_32_layers", params, cfg.n_layers, "float32", F32_REL),
    )[only_f32:]:
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
    row = dict(phase=phase, config="llama3-8b",
               kv_cache_dtype=cfg.kv_cache_dtype,
               weights="int8" if ptl.is_quantized(params) else "bfloat16",
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


def selected_invariant(torch, ptl, llama, params, cfg, tok):
    """Phase ``selected_decode_invariant`` (float32 activations, 32
    layers, 4 of the serving requests): splash tokens = flash tokens,
    stock tokens identical at decode_chunk 1 and 8, one paged_forward
    step's logits under stock against the paged kernel on one admitted
    pool (no write-back), and what "auto" resolves to on llama3-8b."""
    prompts = [serve_prompts(tok)[i] for i in INVARIANT_REQUESTS]
    max_new = [SERVE_MAX_NEW[i] for i in INVARIANT_REQUESTS]
    c32 = cfg.replace(dtype="float32")

    def batcher(**kw):
        return ptl.ContinuousBatcher(params, c32, n_slots=4, max_len=2048,
                                     device="cuda", **kw)

    def tokens(**kw):
        cb = batcher(**kw)
        rids = [cb.submit(p, max_new_tokens=n)
                for p, n in zip(prompts, max_new)]
        res = cb.run_to_completion()
        return [res[r] for r in rids]

    kn = selection_kernels()
    before = kn.splash_prefill.launches
    toks = {"splash": tokens(prefill_kernel="splash", decode_chunk=8)}
    splash_ran = kn.splash_prefill.launches - before
    toks["flash"] = tokens(prefill_kernel="flash", decode_chunk=8)
    before = kn.stock_paged_decode.launches
    for k in (1, 8):
        toks[f"stock_k{k}"] = tokens(decode_kernel="stock-paged",
                                     decode_chunk=k)
    stock_ran = kn.stock_paged_decode.launches - before

    cb = batcher(decode_kernel="stock-paged")
    for p in prompts:
        cb.submit(p, max_new_tokens=8)
    with torch.inference_mode():
        cb._admit()
        cb._sync_device_rows()
        positions = torch.where(cb.d_active, cb.d_pos, -1)[:, None]
        logits = {
            name: llama.paged_forward(
                params, cb.tau[:, None], positions,
                c32.replace(decode_kernel=name),
                cb.pool.paged(cb.d_table, cb.d_fill),
                attn_mask=cb.d_active[:, None], write_back=False)[0][:, 0]
            for name in ("paged", "stock-paged")}
    del cb
    step_rel = rel_err(logits["stock-paged"], logits["paged"])
    auto = ptl.ContinuousBatcher(params, cfg, n_slots=1, max_len=256,
                                 prefill_kernel="auto", decode_kernel="auto",
                                 device="cuda")
    auto_names = [auto.config.prefill_kernel, auto.config.decode_kernel]
    del auto
    torch.cuda.empty_cache()
    row = dict(
        phase="selected_decode_invariant", config="llama3-8b",
        n_layers=cfg.n_layers, dtype="float32",
        requests=list(INVARIANT_REQUESTS), max_new=max_new,
        splash_equals_flash=toks["splash"] == toks["flash"],
        splash_first_divergence=[first_divergence(a, b) for a, b in
                                 zip(toks["splash"], toks["flash"])],
        splash_launches=splash_ran,
        stock_k1_equals_k8=toks["stock_k1"] == toks["stock_k8"],
        stock_launches=stock_ran,
        stock_first_divergence_vs_flash=[
            first_divergence(a, b)
            for a, b in zip(toks["stock_k8"], toks["flash"])],
        step_logits_rel_stock_vs_paged=step_rel, step_bound=STEP_STOCK_REL,
        auto_resolves_to=auto_names)
    emit(row)
    if not (row["splash_equals_flash"] and row["stock_k1_equals_k8"]
            and splash_ran > 0 and stock_ran > 0
            and step_rel < STEP_STOCK_REL
            and auto_names == ["splash", "paged"]):
        raise AssertionError(f"selected decode invariant failed: {row}")
    return row


def spec_prompts(np):
    """The spec_serving phase's prompts: SPEC_PROMPT random ids each
    (numpy seed 0)."""
    rng = np.random.default_rng(0)
    return [rng.integers(1, 128000, SPEC_PROMPT).tolist()
            for _ in range(SPEC_SLOTS)]


def perturbed_copy(torch, params, noise, seed):
    """A copy of ``params`` with +-``noise`` relative noise per weight from a
    seeded generator (bench.py's perturbed draft)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def nudge(w):
        return (w.float() * (1 + noise * torch.randn(
            w.shape, device="cuda", generator=gen))).to(w.dtype)

    return {k: ({kk: nudge(w) for kk, w in v.items()}
                if isinstance(v, dict) else nudge(v))
            for k, v in params.items()}


def run_batcher(torch, cb, prompts, per_request=None):
    """Submit ``prompts`` (SPEC_NEW tokens each; ``per_request`` maps an
    index to extra submit arguments) and drain the batcher.  Returns the
    tokens per prompt, the wall seconds of the steps after the admission
    step (synchronised host clock) and the tokens those steps emitted."""
    per_request = per_request or {}
    rids = [cb.submit(p, max_new_tokens=SPEC_NEW, **per_request.get(i, {}))
            for i, p in enumerate(prompts)]
    results, wall, tokens, first = {}, 0.0, 0, True
    while cb.pending():
        torch.cuda.synchronize()
        t = time.perf_counter()
        events = cb.step()
        torch.cuda.synchronize()
        if not first:
            wall += time.perf_counter() - t
            tokens += len(events)
        first = False
        for rid, tok, _ in events:
            results.setdefault(rid, []).append(tok)
    return [results.get(r, []) for r in rids], wall, tokens


def verify_vs_steps_rel(torch, ptl, llama, params, cfg, prompts):
    """The verify's T = n_draft + 1 logits against n_draft + 1 T = 1 paged
    steps over the same admitted pool (rel: max abs diff over max |T=1|)."""
    T = SPEC_DRAFT + 1
    cb = ptl.ContinuousBatcher(params, cfg, n_slots=len(prompts),
                               max_len=SPEC_MAX_LEN, block_size=SPEC_BLOCK,
                               device="cuda")
    for p in prompts:
        cb.submit(p, max_new_tokens=SPEC_NEW)
    g = torch.Generator(device="cuda").manual_seed(3)
    with torch.inference_mode():
        cb._admit()
        cb._sync_device_rows()
        B = len(prompts)
        block = torch.cat([cb.tau[:, None], torch.randint(
            1, 128000, (B, T - 1), device="cuda", generator=g,
            dtype=torch.int32)], dim=1)
        block_pos = cb.d_pos[:, None] + torch.arange(
            T, device="cuda", dtype=torch.int32)[None]
        mask = cb.d_active[:, None].expand(B, T)
        pool = cb.pool
        verify = llama.paged_forward(
            params, block, block_pos, cfg,
            ptl.PagedKVCache(pool.k, pool.v, pool.pos, cb.d_table,
                             cb.d_fill), attn_mask=mask, write_back=False)[0]
        steps = [ptl.forward(
            params, block[:, t:t + 1], block_pos[:, t:t + 1], cfg,
            cache=ptl.PagedKVCache(pool.k, pool.v, pool.pos, cb.d_table,
                                   cb.d_fill + t),
            attn_mask=mask[:, :1])[0][:, 0] for t in range(T)]
    del cb
    return rel_err(verify, torch.stack(steps, dim=1))


def drive_spec_serving(torch, np, ptl, llama, fa, pa, params, cfg, smi):
    """Phase 7: speculative serving at llama3-8b width and depth (bf16):
    self-draft (counted from zero), the perturbed draft with one sampled
    request, the plain batcher on the same prompts, and the invariants."""
    prompts = spec_prompts(np)
    L = cfg.n_layers
    T = SPEC_DRAFT + 1

    def spec_batcher(p, c, draft, draft_cfg):
        return ptl.ContinuousBatcher(
            p, c, n_slots=SPEC_SLOTS, max_len=SPEC_MAX_LEN,
            block_size=SPEC_BLOCK, draft_params=draft,
            draft_config=draft_cfg, n_draft=SPEC_DRAFT,
            spec_rounds=SPEC_ROUNDS, device="cuda")

    seconds = {}
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        seconds[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    # Self-draft: the counted run.
    cb = spec_batcher(params, cfg, params, cfg)
    zero_counts(fa, pa)
    toks, wall, n_tok = run_batcher(torch, cb, prompts)
    launches = dict(launch_counts(fa, pa), paged_decode_by_t=dict(
        pa.paged_pool_attention.launches_by_t))
    stats = cb.stats()
    rounds = stats["decode_steps_total"]
    lap("self_draft")
    # Busy share of one round: re-admit, then the first step runs R = 1.
    for p in prompts:
        cb.submit(p, max_new_tokens=SPEC_NEW)
    cb._admit()
    profile = device_profile(torch, cb.step, top=8)
    del cb
    lap("profile")
    self_row = dict(
        acceptance=stats["draft_acceptance_rate"], rounds=rounds,
        tokens=[len(t) for t in toks], launches=launches,
        tokens_per_s=n_tok / wall, ms_per_round=wall * 1e3 / max(1, rounds - 1),
        host_syncs_per_token=stats["host_syncs_per_token"],
        spec_host_syncs_per_token=stats["spec_host_syncs_per_token"],
        busy_share=profile["device_busy_share"], profile_1_round=profile,
        stats=stats)
    want = dict(NO_LAUNCHES,
                flash_fwd=2 * L * stats["insert_dispatches_total"],
                paged_decode=(SPEC_DRAFT + 2) * L * rounds,
                paged_decode_by_t={T: (SPEC_DRAFT + 2) * L * rounds})

    # A draft that selects stock-paged: one round, counted from zero.  The
    # chain replays the block at T = n_draft + 1, so the stock slot never
    # runs.
    cb = ptl.ContinuousBatcher(
        params, cfg, n_slots=SPEC_SLOTS, max_len=SPEC_MAX_LEN,
        block_size=SPEC_BLOCK, draft_params=params,
        draft_config=cfg.replace(decode_kernel="stock-paged"),
        n_draft=SPEC_DRAFT, spec_rounds=1, device="cuda")
    for p in prompts:
        cb.submit(p, max_new_tokens=SPEC_NEW)
    cb._admit()
    zero_counts(fa, pa)
    cb.step()
    stock_draft = dict(
        draft_decode_kernel=cb.draft_config.decode_kernel,
        rounds=cb.stats()["decode_steps_total"],
        launches=dict(launch_counts(fa, pa), paged_decode_by_t=dict(
            pa.paged_pool_attention.launches_by_t)))
    del cb
    lap("stock_draft")

    # The plain batcher on the same prompts.
    plain = ptl.ContinuousBatcher(params, cfg, n_slots=SPEC_SLOTS,
                                  max_len=SPEC_MAX_LEN,
                                  block_size=SPEC_BLOCK, decode_chunk=8,
                                  device="cuda")
    plain_toks, plain_wall, plain_n = run_batcher(torch, plain, prompts)
    del plain
    lap("plain")

    # The perturbed draft, one request sampled.
    draft = perturbed_copy(torch, params, SPEC_NOISE, seed=7)
    cb = spec_batcher(params, cfg, draft, cfg)
    p_toks, p_wall, p_n = run_batcher(torch, cb, prompts,
                                      {1: SPEC_SAMPLED})
    p_stats = cb.stats()
    del cb
    lap("perturbed")
    pert_row = dict(
        acceptance=p_stats["draft_acceptance_rate"],
        rounds=p_stats["decode_steps_total"],
        tokens=[len(t) for t in p_toks], sampled_request=1,
        sampled=SPEC_SAMPLED, tokens_per_s=p_n / p_wall,
        ms_per_round=p_wall * 1e3 / max(1, p_stats["decode_steps_total"] - 1),
        host_syncs_per_token=p_stats["host_syncs_per_token"],
        greedy_first_divergence_vs_plain=[
            first_divergence(a, b) for i, (a, b) in
            enumerate(zip(p_toks, plain_toks)) if i != 1])

    # Invariants: T=4 verify logits vs 4 T=1 steps (bf16 at 8 layers,
    # float32 activations at 32), and greedy spec tokens = plain tokens in
    # float32 activations at 32 layers.
    shallow = dict(params, layers={k: w[:DECODE_DEPTH]
                                   for k, w in params["layers"].items()})
    rel_bf16 = verify_vs_steps_rel(torch, ptl, llama, shallow,
                                   cfg.replace(n_layers=DECODE_DEPTH),
                                   prompts)
    c32 = cfg.replace(dtype="float32")
    rel_f32 = verify_vs_steps_rel(torch, ptl, llama, params, c32, prompts)
    cb = spec_batcher(params, c32, draft, c32)
    f32_spec, _, _ = run_batcher(torch, cb, prompts)
    f32_rate = cb.acceptance_rate()
    del cb, draft
    plain = ptl.ContinuousBatcher(params, c32, n_slots=SPEC_SLOTS,
                                  max_len=SPEC_MAX_LEN,
                                  block_size=SPEC_BLOCK, decode_chunk=8,
                                  device="cuda")
    f32_plain, _, _ = run_batcher(torch, plain, prompts)
    del plain
    torch.cuda.empty_cache()
    lap("invariants")
    inv = dict(verify_vs_steps_rel_bf16_8_layers=rel_bf16,
               bf16_bound=DECODE_REL,
               verify_vs_steps_rel_f32_32_layers=rel_f32, f32_bound=F32_REL,
               f32_greedy_spec_equals_plain=f32_spec == f32_plain,
               f32_first_divergence=[first_divergence(a, b) for a, b in
                                     zip(f32_spec, f32_plain)],
               f32_acceptance=f32_rate)
    row = dict(phase="spec_serving", card=smi, config="llama3-8b",
               n_layers=L, dtype="bfloat16", n_slots=SPEC_SLOTS,
               max_len=SPEC_MAX_LEN, block_size=SPEC_BLOCK,
               n_draft=SPEC_DRAFT, spec_rounds=SPEC_ROUNDS,
               prompt_tokens=SPEC_PROMPT, max_new=SPEC_NEW, seconds=seconds,
               self_draft=self_row, perturbed_draft=pert_row,
               plain_tokens_per_s=plain_n / plain_wall,
               plain_tokens_exact=[len(t) for t in plain_toks] == [SPEC_NEW]
               * SPEC_SLOTS, stock_draft=stock_draft, invariants=inv)
    emit(row)
    exact = [SPEC_NEW] * SPEC_SLOTS
    problems = []
    if launches != want:
        problems.append(f"launches {launches}, expected {want}")
    n = stock_draft["rounds"] * (SPEC_DRAFT + 2) * L
    want_stock = dict(NO_LAUNCHES, paged_decode=n, paged_decode_by_t={T: n})
    if stock_draft["rounds"] != 1 or stock_draft["launches"] != want_stock:
        problems.append(f"stock-paged draft {stock_draft}, expected one "
                        f"round with {want_stock}")
    if self_row["acceptance"] != 1.0 or self_row["tokens"] != exact:
        problems.append("self-draft acceptance / token counts")
    if not (pert_row["acceptance"] < 1.0 and pert_row["tokens"] == exact):
        problems.append("perturbed draft acceptance / token counts")
    if not all(0 <= t < cfg.vocab_size for r in toks + p_toks for t in r):
        problems.append("a token outside the vocabulary")
    if not (rel_bf16 < DECODE_REL and rel_f32 < F32_REL
            and inv["f32_greedy_spec_equals_plain"]):
        problems.append(f"invariants {inv}")
    if problems:
        raise AssertionError(f"spec_serving failed: {problems}")
    return row


def drive_int8(torch, np, ptl, engine, serving, fa, pa, params, cfg, tok,
               serve_row):
    """Phase 8: int8 weights (``quantize_params`` of the phase-3 weights)
    and int8 KV pools at llama3-8b width and depth.  ``int8_serving``: the
    serving phase's 12 staggered requests, counted from zero, beside the
    bf16 serving phase of this run; the paged invariant in float32
    activations (int8 paged = int8 gathered = int8 engine.generate); and
    a self-draft speculative pass over int8 target and draft pools
    (acceptance exactly 1.0, 160 int8 paged launches per round, all at
    T = 4).  The int8 weights are freed at the end."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    qparams = ptl.quantize_params(params)
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    c8 = cfg.replace(kv_cache_dtype="int8")
    L = cfg.n_layers
    row = drive_serving(torch, ptl, fa, pa, qparams, c8, tok,
                        phase="int8_serving")
    inv = paged_invariant(torch, ptl, engine, serving, qparams, c8, tok,
                          phase="int8_paged_decode_invariant", only_f32=True)

    # Self-draft over int8 target and draft pools, counted from zero.
    T = SPEC_DRAFT + 1
    cb = ptl.ContinuousBatcher(
        qparams, c8, n_slots=SPEC_SLOTS, max_len=SPEC_MAX_LEN,
        block_size=SPEC_BLOCK, draft_params=qparams, draft_config=c8,
        n_draft=SPEC_DRAFT, spec_rounds=SPEC_ROUNDS, device="cuda")
    zero_counts(fa, pa)
    toks, wall, n_tok = run_batcher(torch, cb, spec_prompts(np))
    launches = dict(launch_counts(fa, pa), paged_decode_by_t=dict(
        pa.paged_pool_attention.launches_by_t))
    int8_by_instance = dict(fa.flash_attention_quantized.launches_by_instance)
    stats = cb.stats()
    del cb
    rounds = stats["decode_steps_total"]
    spec = dict(
        phase="int8_spec_serving", config="llama3-8b", n_layers=L,
        weights="int8", kv_cache_dtype="int8", n_slots=SPEC_SLOTS,
        n_draft=SPEC_DRAFT, spec_rounds=SPEC_ROUNDS,
        acceptance=stats["draft_acceptance_rate"], rounds=rounds,
        tokens=[len(t) for t in toks], launches=launches,
        flash_fwd_int8_by_instance=int8_by_instance,
        tokens_per_s=n_tok / wall,
        ms_per_round=wall * 1e3 / max(1, rounds - 1),
        peak_memory_bytes=torch.cuda.max_memory_allocated(),
        quantize_params_s=quantize_s)
    emit(spec)
    del qparams
    torch.cuda.empty_cache()
    want = dict(NO_LAUNCHES,
                flash_fwd_int8=2 * L * stats["insert_dispatches_total"],
                paged_decode_int8=(SPEC_DRAFT + 2) * L * rounds,
                paged_decode_by_t={T: (SPEC_DRAFT + 2) * L * rounds})
    problems = []
    if launches != want:
        problems.append(f"launches {launches}, expected {want}")
    if int8_by_instance != {"wgmma": want["flash_fwd_int8"]}:
        problems.append(f"int8 flash launches by instance "
                        f"{int8_by_instance}, expected all on wgmma")
    if spec["acceptance"] != 1.0 or spec["tokens"] != [SPEC_NEW] * SPEC_SLOTS:
        problems.append("self-draft acceptance / token counts")
    if not all(0 <= t < cfg.vocab_size for r in toks for t in r):
        problems.append("a token outside the vocabulary")
    if problems:
        raise AssertionError(f"int8_spec_serving failed: {problems}")

    bf16 = {k: serve_row[k] for k in ("decode_ms_per_iteration",
                                       "tokens_per_s", "insert_ms",
                                       "busy_share")}
    int8 = {k: row[k] for k in bf16}
    emit(dict(phase="int8_vs_bf16_serving", bf16=bf16, int8=int8,
              ratio_int8_over_bf16={
                  k: (int8[k] / bf16[k] if int8[k] and bf16[k] else None)
                  for k in bf16},
              device_ms_by_category_3_steps=dict(
                  bf16=serve_row["profile_3_steps"].get("by_category_ms"),
                  int8=row["profile_3_steps"].get("by_category_ms"))))
    return row, inv, spec


def write_meta_checkpoint(torch, params, cfg, path):
    """``params`` (the port's layout, ``cfg.n_layers`` layers) written as a
    Meta checkpoint: ``consolidated.00.pth`` under Meta's [out, in] names
    (``split_qkv`` unpacks the fused qkv and undoes the RoPE feature
    permutation) and ``params.json`` with llama3-8b's published keys.
    Returns the tensor bytes written."""
    from jax_llama_tpu_torch.models.llama import split_qkv

    D, H, KVH, hd = cfg.dim, cfg.n_heads, cfg.kv_heads, cfg.head_dim
    lp = params["layers"]

    def host(t):  # a compact host copy: torch.save writes whole storages
        return t.contiguous().cpu()

    sd = {"tok_embeddings.weight": host(params["embed"]["embedding"]),
          "norm.weight": host(params["final_norm"]),
          "output.weight": host(params["lm_head"].T)}
    for i in range(cfg.n_layers):
        pre = f"layers.{i}."
        q, k, v = split_qkv(lp["qkv"][i])
        sd[pre + "attention.wq.weight"] = host(q.reshape(D, H * hd).T)
        sd[pre + "attention.wk.weight"] = host(k.reshape(D, KVH * hd).T)
        sd[pre + "attention.wv.weight"] = host(v.reshape(D, KVH * hd).T)
        sd[pre + "attention.wo.weight"] = host(
            lp["o"][i].reshape(H * hd, D).T)
        sd[pre + "feed_forward.w1.weight"] = host(lp["gate_up"][i, 0].T)
        sd[pre + "feed_forward.w3.weight"] = host(lp["gate_up"][i, 1].T)
        sd[pre + "feed_forward.w2.weight"] = host(lp["down"][i].T)
        sd[pre + "attention_norm.weight"] = host(lp["attn_norm"][i])
        sd[pre + "ffn_norm.weight"] = host(lp["mlp_norm"][i])
    torch.save(sd, path / "consolidated.00.pth")
    with open(path / "params.json", "w") as f:
        json.dump(dict(LLAMA3_8B_PARAMS_JSON, n_layers=cfg.n_layers), f)
    return sum(t.numel() * t.element_size() for t in sd.values())


def flat_tree(tree, prefix=""):
    """{"a/b": tensor} of a parameter dictionary (a QuantizedTensor as its
    payload and scale)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_tree(v, f"{prefix}{k}/"))
        elif hasattr(v, "scale"):
            out[f"{prefix}{k}/q"], out[f"{prefix}{k}/scale"] = v.q, v.scale
        else:
            out[prefix + k] = v
    return out


def trees_equal(torch, a, b) -> bool:
    """Same leaves, dtypes, shapes and bits."""
    fa, fb = flat_tree(a), flat_tree(b)
    return sorted(fa) == sorted(fb) and all(
        fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]) for k in fa)


class recorded_decode:
    """Within the block, every ``ByteTokenizer.decode`` call also records
    the ids it was given (``.ids``): the byte tokenizer decodes only ids
    below 256, so two runs are compared by these ids as well as by text."""

    def __enter__(self):
        from jax_llama_tpu_torch.tokenizers.bytes import ByteTokenizer

        self.cls, self.orig, self.ids = ByteTokenizer, ByteTokenizer.decode, []
        orig, ids = self.orig, self.ids

        def decode(tok, seq):
            ids.append(list(seq))
            return orig(tok, seq)

        ByteTokenizer.decode = decode
        return self

    def __exit__(self, *exc):
        self.cls.decode = self.orig


def run_cli(torch, argv, stdin=""):
    """``jax_llama_tpu_torch.run.main()`` in this process, as
    ``python -m jax_llama_tpu_torch.run *argv`` would run it with
    ``stdin``: (its stdout, the ids its tokenizer decoded, wall s)."""
    import contextlib
    import gc
    import io

    from jax_llama_tpu_torch import run as prun

    saved = sys.argv, sys.stdin
    out = io.StringIO()
    sys.argv, sys.stdin = ["run", *argv], io.StringIO(stdin)
    t = time.perf_counter()
    try:
        with recorded_decode() as rec, contextlib.redirect_stdout(out):
            prun.main()
        torch.cuda.synchronize()
    finally:
        sys.argv, sys.stdin = saved
    wall = time.perf_counter() - t
    gc.collect()
    torch.cuda.empty_cache()
    return out.getvalue(), rec.ids, wall


def cli_blocks(out, end):
    """run.py's '=== prompt' blocks (each ``repr(prompt)\\ncompletion``, the
    newline its print ends with dropped), up to the line starting with
    ``end``."""
    body = out[out.index("\n=== "):out.rindex("\n" + end)]
    return [b[:-1] for b in body.split("\n=== ")[1:]]


def cli_seconds(out):
    """The load seconds of run.py's checkpoint_restored log line."""
    line = next(ln for ln in out.splitlines()
                if ln.startswith("checkpoint_restored"))
    return float(line.split("seconds=")[1].split()[0])


def cli_batcher(ptl, params, cfg, kernels):
    """The batcher ``run.py --serve`` and ``--http`` build at the flags
    the checkpoint phase gives them (greedy, CKPT_SLOTS slots,
    decode_chunk 8, the byte tokenizer's stop token)."""
    return ptl.ContinuousBatcher(
        params, cfg, n_slots=CKPT_SLOTS, max_len=cfg.max_seq_len,
        stop_tokens=(ptl.ByteTokenizer().eos_id,), temperature=0.0,
        top_p=0.95, seed=0, prefix_cache=False, decode_chunk=8, n_draft=4,
        spec_rounds=8, prefill_budget=0, prefix_index="off", device="cuda",
        **kernels)


def serve_reference(torch, ptl, params, cfg, texts, kernels):
    """What ``run.py --serve`` computes for ``texts`` on its stdin, with
    the batcher arguments its defaults give: (the printed blocks, the
    decoded ids, stats)."""
    tok = ptl.ByteTokenizer()
    stops = (tok.eos_id,)
    cb = cli_batcher(ptl, params, cfg, kernels)
    rid_text = {cb.submit(tok.encode(t, bos=True), max_new_tokens=CKPT_GEN): t
                for t in texts}
    emitted, blocks = {}, []
    with recorded_decode() as rec:
        while cb.pending():
            for rid, t, done in cb.step():
                emitted.setdefault(rid, []).append(t)
                if done:
                    toks = emitted[rid]
                    if toks and toks[-1] in stops:
                        toks = toks[:-1]
                    blocks.append(f"{rid_text[rid]!r}\n{tok.decode(toks)}")
    stats = cb.stats()
    del cb
    return blocks, rec.ids, stats


def run_http_cli(torch, argv, texts):
    """``run.main()`` with ``--http``, as ``run_cli`` runs it: run.py's
    test hook POSTs each of ``texts`` to /generate in turn, then reads
    /metrics and /healthz, and the server shuts down.  Returns (the
    replies, the metrics samples, the health reply, stdout, wall s)."""
    from jax_llama_tpu_torch import run as prun

    got = {}

    def hook(srv):
        got["replies"] = [
            http_request(srv.address, "/generate",
                         {"text": t, "max_new_tokens": CKPT_GEN})
            for t in texts]
        got["metrics"] = http_request(srv.address, "/metrics")[2].decode()
        got["health"] = http_json(srv.address, "/healthz")

    orig = prun._serve_http
    prun._serve_http = lambda *a, **kw: orig(*a, _test_hook=hook, **kw)
    try:
        out, _, wall = run_cli(torch, argv)
    finally:
        prun._serve_http = orig
    return (got["replies"], prometheus_samples(got["metrics"]),
            got["health"], out, wall)


def drive_checkpoint(torch, ptl, fa, pa, shallow, cfg, smi):
    """Phase ``checkpoint``: the first DECODE_DEPTH layers of the seed-0
    weights written as a Meta checkpoint, converted, saved, loaded, and
    completed through ``run.py`` (one-shot, ``--serve`` twice,
    ``--quantize``), each held to the in-process path on the same tree."""
    import gc
    import shutil
    import tempfile
    from pathlib import Path

    from jax_llama_tpu_torch.convert import (
        convert_meta_checkpoint,
        load_checkpoint,
        save_checkpoint,
        verify_manifest,
    )
    from jax_llama_tpu_torch.convert.checkpoint import (
        MANIFEST_NAME,
        PARAMS_NAME,
    )

    L = DECODE_DEPTH
    kn = selection_kernels()
    cfg8 = cfg.replace(n_layers=L, max_seq_len=CKPT_MAX_SEQ)
    tok = ptl.ByteTokenizer()
    row = dict(phase="checkpoint", card=smi, config="llama3-8b", n_layers=L,
               dtype="bfloat16", shards=1, max_seq_len=CKPT_MAX_SEQ)
    failures = []

    def check(ok, what):
        if not ok:
            failures.append(what)

    def sync_s(t):
        torch.cuda.synchronize()
        return time.perf_counter() - t

    runs = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        tmp = Path(tmp)
        row["disk_free_bytes"] = shutil.disk_usage(tmp).free
        meta = tmp / "meta"
        meta.mkdir()
        t = time.perf_counter()
        row["meta_tensor_bytes"] = write_meta_checkpoint(torch, shallow, cfg8,
                                                         meta)
        row["write_s"] = time.perf_counter() - t
        row["meta_file_bytes"] = (meta / "consolidated.00.pth").stat().st_size

        t = time.perf_counter()
        converted, conv_cfg = convert_meta_checkpoint(
            meta, vocab_size=cfg.vocab_size, max_seq_len=CKPT_MAX_SEQ,
            dtype="bfloat16", device="cuda")
        row["convert_s"] = sync_s(t)
        shutil.rmtree(meta)
        check(conv_cfg == cfg8.replace(attn_impl="xla"),
              f"converted config {conv_cfg}")
        row["converted_bit_identical"] = trees_equal(torch, converted,
                                                     shallow)
        check(row["converted_bit_identical"], "converted tree")

        saved = tmp / "saved"
        t = time.perf_counter()
        save_checkpoint(saved, converted, conv_cfg)
        row["save_s"] = time.perf_counter() - t
        row["params_file_bytes"] = (saved / PARAMS_NAME).stat().st_size
        t = time.perf_counter()
        check(verify_manifest(saved) is True, "verify_manifest")
        row["hash_s"] = time.perf_counter() - t
        # A copy of the manifest that records one wrong byte count, beside
        # hard links to the same files.
        bad = tmp / "bad"
        bad.mkdir()
        for name in (PARAMS_NAME, "config.json"):
            os.link(saved / name, bad / name)
        manifest = json.loads((saved / MANIFEST_NAME).read_text())
        manifest["files"][PARAMS_NAME]["bytes"] += 1
        (bad / MANIFEST_NAME).write_text(json.dumps(manifest))
        try:
            verify_manifest(bad)
            row["bad_manifest_refused"] = False
        except ValueError as e:
            row["bad_manifest_refused"] = "truncated/resized" in str(e)
        check(row["bad_manifest_refused"], "a wrong byte count passed")

        t = time.perf_counter()
        loaded, load_cfg = load_checkpoint(saved, device="cuda")
        row["load_s"] = sync_s(t)
        row["loaded_bit_identical"] = (load_cfg == conv_cfg and trees_equal(
            torch, loaded, converted))
        check(row["loaded_bit_identical"], "loaded tree")
        del converted, loaded
        gc.collect()
        torch.cuda.empty_cache()
        nbytes = row["params_file_bytes"]
        row["gb_per_s"] = dict(
            write=row["meta_file_bytes"] / row["write_s"] / 1e9,
            convert=row["meta_file_bytes"] / row["convert_s"] / 1e9,
            save=nbytes / row["save_s"] / 1e9,
            hash=nbytes / row["hash_s"] / 1e9,
            load=nbytes / row["load_s"] / 1e9)

        # run.py, one-shot: as the converter's config has it (attn_impl
        # "xla": plain attention, no kernel launch), with --attn auto
        # (flash prefill at P = 512), then with --quantize.
        auto = conv_cfg.replace(attn_impl="auto")
        prompts = prompts_for()
        default = ["--ckpt-dir", str(saved), "--byte-tokenizer",
                   *[a for p in prompts for a in ("--prompt", p)],
                   "--max-gen-len", str(CKPT_GEN), "--temperature", "0"]
        one_shot = default + ["--attn", "auto"]
        flash = (dict(NO_LAUNCHES, flash_fwd=L), {"wgmma": L})
        for name, argv, weights, run_cfg, (want_launches, want_inst) in (
                ("one_shot_default", default, shallow, conv_cfg,
                 (dict(NO_LAUNCHES), {})),
                ("one_shot", one_shot, shallow, auto, flash),
                ("quantize", one_shot + ["--quantize"], None, auto, flash)):
            if weights is None:
                weights = ptl.quantize_params(shallow)
            with recorded_decode() as rec:
                texts = ptl.LLaMA(weights, run_cfg, tok, device="cuda"
                                  ).generate_from_str(prompts, CKPT_GEN,
                                                      temperature=0.0)
            del weights
            want = [f"{p!r}\n{o}" for p, o in zip(prompts, texts)]
            zero_counts(fa, pa)
            out, ids, wall = run_cli(torch, argv)
            launches = launch_counts(fa, pa)
            instances = instance_counts(fa, pa)
            got = cli_blocks(out, "[")
            runs[name] = dict(
                completions_equal=got == want, ids_equal=ids == rec.ids,
                decoded_tokens=sum(len(i) for i in ids), launches=launches,
                flash_by_instance=instances["flash_fwd_by_instance"],
                load_s=cli_seconds(out), wall_s=wall,
                summary=out.strip().splitlines()[-1])
            check(got == want and ids == rec.ids and len(ids) == len(prompts),
                  f"{name} completions")
            check(launches == want_launches
                  and instances["flash_fwd_by_instance"] == want_inst,
                  f"{name} launches {launches} {instances}, expected "
                  f"{want_launches} {want_inst}")

        # run.py --serve over stdin, at the defaults and on the selected
        # slots, against the batcher with the same arguments.
        texts = [serve_texts()[i] for i in INVARIANT_REQUESTS]
        stdin = "".join(t + "\n" for t in texts)
        serve = ["--ckpt-dir", str(saved), "--byte-tokenizer", "--serve",
                 "--slots", str(CKPT_SLOTS), "--max-gen-len", str(CKPT_GEN),
                 "--temperature", "0", "--attn", "auto"]
        for name, kernels in (("serve", {}), ("serve_selected", SELECTED)):
            zero_counts(fa, pa)
            want, want_ids, stats = serve_reference(torch, ptl, shallow, auto,
                                                    texts, kernels)
            ref_launches = launch_counts(fa, pa)
            flags = [a for k, v in kernels.items()
                     for a in ("--" + k.replace("_", "-"), v)]
            zero_counts(fa, pa)
            out, ids, wall = run_cli(torch, serve + flags, stdin)
            launches = launch_counts(fa, pa)
            instances = instance_counts(fa, pa)
            steps = stats["decode_steps_total"]
            inserts = stats["insert_dispatches_total"]
            expect = dict(NO_LAUNCHES)
            if kernels:
                expect.update(splash_prefill=L * inserts, stock_paged=(
                    kn.STOCK_KERNELS_PER_CALL * L * steps))
                want_inst = dict(
                    splash_by_instance={kn.splash_instance(torch.bfloat16):
                                        L * inserts},
                    stock_by_instance={kn.stock_instance(
                        torch.bfloat16, torch.bfloat16): L * steps})
            else:
                expect.update(flash_fwd=L * inserts, paged_decode=L * steps)
                want_inst = dict(flash_fwd_by_instance={"wgmma": L * inserts})
            got = cli_blocks(out, "served")
            runs[name] = dict(
                completions_equal=sorted(got) == sorted(want),
                ids_equal=sorted(ids) == sorted(want_ids),
                decoded_tokens=sum(len(i) for i in ids),
                decode_iterations=steps, inserts=inserts, launches=launches,
                reference_launches=ref_launches,
                instances={k: instances[k] for k in want_inst},
                load_s=cli_seconds(out), wall_s=wall,
                not_ported_note=any(ln.startswith("serve_options_not_ported")
                                    for ln in out.splitlines()),
                summary=out.strip().splitlines()[-1])
            check(sorted(got) == sorted(want) and len(got) == len(texts)
                  and sorted(ids) == sorted(want_ids), f"{name} completions")
            check(launches == ref_launches == expect,
                  f"{name} launches {launches}, reference {ref_launches}, "
                  f"expected {expect}")
            check(runs[name]["instances"] == want_inst,
                  f"{name} instances {instances}, expected {want_inst}")
            check(steps > 0 and inserts > 0, f"{name} stats {stats}")

        # run.py --http, the command a user serves with: the same texts
        # POSTed one at a time, each held to the batcher with the same
        # arguments serving it alone.
        want = []
        for t in texts:
            cb = cli_batcher(ptl, shallow, auto, {})
            rid = cb.submit(tok.encode(t, bos=True), max_new_tokens=CKPT_GEN)
            want.append(cb.run_to_completion()[rid])
            del cb
        http_argv = serve[:serve.index("--serve")] + ["--http", "0"] + (
            serve[serve.index("--serve") + 1:])
        zero_counts(fa, pa)
        replies, samples, (h_status, health), out, wall = run_http_cli(
            torch, http_argv, texts)
        launches = launch_counts(fa, pa)
        instances = instance_counts(fa, pa)
        got = [http_tokens(r) for r in replies]
        steps = int(samples["llm_decode_steps_total"])
        inserts = int(samples["llm_insert_dispatches_total"])
        expect = dict(NO_LAUNCHES, flash_fwd=L * inserts,
                      paged_decode=L * steps)
        statuses = [st for st, _ in got]
        runs["http"] = dict(
            statuses=statuses, decode_iterations=steps, inserts=inserts,
            launches=launches, expected_launches=expect,
            flash_by_instance=instances["flash_fwd_by_instance"],
            recoveries=samples["llm_server_recoveries_total"],
            quarantine_rebuilds=samples["llm_quarantine_rebuilds_total"],
            healthz=dict(status=h_status, ok=health["ok"]),
            decoded_tokens=sum(len(t or ()) for _, t in got),
            load_s=cli_seconds(out), wall_s=wall)
        check(statuses == [200] * len(texts), f"http statuses {statuses}")
        if statuses == [200] * len(texts):
            runs["http"]["divergences"] = token_divergences(
                torch, ptl, shallow, auto, [tok.encode(t, bos=True)
                                            for t in texts],
                [t for _, t in got], want, DECODE_REL)
        check(launches == expect and inserts == len(texts) and steps > 0,
              f"http launches {launches}, expected {expect}")
        check(not runs["http"]["recoveries"]
              and not runs["http"]["quarantine_rebuilds"]
              and h_status == 200 and health["ok"],
              f"http server {runs['http']}")
    row["runs"] = runs
    row["launches"] = {k: sum(r["launches"][k] for r in runs.values())
                       for k in NO_LAUNCHES}
    row["failures"] = failures
    emit(row)
    if failures:
        raise AssertionError(f"checkpoint phase failed: {failures}")
    return row


def rel_err(a, b) -> float:
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import jax_llama_tpu_torch as ptl
    from jax_llama_tpu_torch import engine, serving
    from jax_llama_tpu_torch.models import llama
    from jax_llama_tpu_torch.ops import _build
    from jax_llama_tpu_torch.ops import quant

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
    ptxas = {name: ptxas_report(_build.build_log(name)) for name in libs}
    spilled = {fn: r for rep in ptxas.values() for fn, r in rep.items()
               if any(k in fn for k in NO_SPILL_KERNELS)
               and (r.get("spill_stores") or r.get("spill_loads"))}
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              libraries=[os.path.relpath(p, HERE) for p in libs.values()],
              ptxas=ptxas, no_spill_kernels=list(NO_SPILL_KERNELS),
              spilled=spilled))
    if spilled:
        raise AssertionError(f"ptxas spilled in {sorted(spilled)}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    flash_rows = check_flash(torch, fa, gen)
    paged_row = check_paged(torch, pa, gen)
    verify_rows = check_paged_verify(torch, pa, gen)
    flash_int8_rows = check_flash_int8(torch, fa, quant, gen)
    paged_int8_rows = check_paged_int8(torch, pa, quant, gen)
    kn = selection_kernels()
    stock_rows = check_stock(torch, kn, gen)
    splash_rows = check_splash(torch, kn, fa, gen)
    train_rows = check_train_kernels(torch, fa, gen)

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

    zero_counts(fa, pa)
    t0 = time.perf_counter()
    texts = llm.generate_from_str(prompts, max_gen_len=32, temperature=0.0)
    torch.cuda.synchronize()
    generate_s = time.perf_counter() - t0
    launches = launch_counts(fa, pa)
    instances = instance_counts(fa, pa)
    if (launches["flash_fwd"] != cfg.n_layers
            or instances["flash_fwd_by_instance"] != {"wgmma": cfg.n_layers}):
        raise AssertionError(
            f"flash kernel launched {launches['flash_fwd']} times in the "
            f"main path ({instances['flash_fwd_by_instance']} by instance), "
            f"expected {cfg.n_layers} on the Hopper instance (one prefill "
            f"forward at P = 512)"
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
              launches=launches, instances=instances, prefill_ms=prefill_ms,
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
                by_before = dict(fa.flash_attention.launches_by_instance)
                outs = []
                for i in range(8):
                    lg, cache = ptl.forward(p, toks[:, i:i + 1],
                                            pos[:, i:i + 1], c, cache=cache)
                    outs.append(lg[:, 0])
                cells[f"{impl}_{name}_rel"] = rel_err(torch.stack(outs, 1),
                                                      full)
                cells[f"{impl}_{name}_decode_launches"] = (
                    fa.flash_attention.launches - before)
                cells[f"{impl}_{name}_decode_by_instance"] = {
                    key: n - by_before.get(key, 0) for key, n in
                    fa.flash_attention.launches_by_instance.items()
                    if n != by_before.get(key, 0)}
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
    # Every T = 1 step of a flash cell on the instance its rule picks, as
    # the C entry point reports it: bf16 on split-KV, float32 on float32;
    # the auto cells run the plain path.
    want_by = {"flash_bf16_8_layers": {"split_kv": 8 * DECODE_DEPTH},
               "flash_bf16_32_layers": {"split_kv": 8 * cfg.n_layers},
               "flash_f32_32_layers": {"float32": 8 * cfg.n_layers},
               "auto_bf16_8_layers": {}, "auto_bf16_32_layers": {},
               "auto_f32_32_layers": {}}
    got_by = {k: cells[f"{k}_decode_by_instance"] for k in want_by}
    if got_by != want_by:
        raise AssertionError(f"cached decode launches by instance {got_by}, "
                             f"expected {want_by}")

    # Phase 4b: checkpoint load and run.py over the 8-layer tree.
    ckpt_row = drive_checkpoint(torch, ptl, fa, pa, shallow, cfg, smi)
    del shallow

    # Phase 5: the serving path, counted from zero.
    serve_tokens = {}
    serve_row = drive_serving(torch, ptl, fa, pa, params, cfg, tok,
                              tokens_out=serve_tokens)

    # Phase 5b: the same requests on the selected slots (splash prefill,
    # stock-paged decode), counted from zero, beside phase 5.
    sel_row = drive_serving(torch, ptl, fa, pa, params, cfg, tok,
                            phase="selected_serving", kernels=SELECTED)
    figures = ("decode_ms_per_iteration", "tokens_per_s", "insert_ms",
               "busy_share")
    emit(dict(phase="selected_vs_serving",
              serving={k: serve_row[k] for k in figures},
              selected={k: sel_row[k] for k in figures},
              ratio_selected_over_serving={
                  k: (sel_row[k] / serve_row[k]
                      if sel_row[k] and serve_row[k] else None)
                  for k in figures},
              device_ms_by_category_3_steps=dict(
                  serving=serve_row["profile_3_steps"].get("by_category_ms"),
                  selected=sel_row["profile_3_steps"].get(
                      "by_category_ms")),
              device_ms_by_category_insert=dict(
                  serving=serve_row["profile_insert"].get("by_category_ms"),
                  selected=sel_row["profile_insert"].get("by_category_ms")),
              insert_device_ms=dict(
                  serving=serve_row["profile_insert"]["device_ms"],
                  selected=sel_row["profile_insert"]["device_ms"])))

    # Phase 5c: the same requests over HTTP (LLMServer), counted from
    # zero; then the recovery and quarantine drill on 8 layers.
    http_row = drive_http_serving(torch, ptl, fa, pa, params, cfg, tok, smi,
                                  serve_row, serve_tokens)
    drill_row = drive_http_drill(torch, ptl, fa, pa, params, cfg, tok, smi)

    # Phase 6: paged = gathered = standalone generate.
    paged_invariant(torch, ptl, engine, serving, params, cfg, tok)
    # Phase 6b: the selected slots' invariants in float32 activations.
    selected_invariant(torch, ptl, llama, params, cfg, tok)

    # Phase 7: speculative serving, counted from zero.
    spec_row = drive_spec_serving(torch, np, ptl, llama, fa, pa, params, cfg,
                                  smi)

    # Phase 8: int8 weights and int8 KV pools, counted from zero.
    int8_row, _, int8_spec = drive_int8(torch, np, ptl, engine, serving, fa,
                                        pa, params, cfg, tok, serve_row)

    # Phase 9: the training path, counted from zero.
    train_row = drive_train(torch, np, ptl, fa, pa, params, cfg)

    # Phase 10: every kernel of the port.  ``launches`` counts the run of
    # the path each kernel serves (train for the flash kernels;
    # int8_serving for the int8 ones; serving for the paged kernel at
    # T = 1, with its spec_verify shape's own count from spec_serving
    # beside it; selected_serving for the stock-paged and splash
    # kernels); every path's count is beside it.  The flash times are
    # the training shape's (forward with lse, no dropout), the train
    # path's launches.
    spec_launches = dict(spec_row["self_draft"]["launches"])
    spec_launches.pop("paged_decode_by_t")
    int8_spec_launches = dict(int8_spec["launches"])
    int8_spec_launches.pop("paged_decode_by_t")
    paths = {"generate": launches, "serving": serve_row["launches"],
             "selected_serving": sel_row["launches"],
             "spec_serving": spec_launches,
             "int8_serving": int8_row["launches"],
             "int8_spec_serving": int8_spec_launches,
             "train": train_row["launches"],
             "checkpoint": ckpt_row["launches"],
             "http_serving": http_row["launches"],
             "http_drill": drill_row["launches"]}

    paths_instances = {"generate": instances,
                       "serving": serve_row["instances"],
                       "http_serving": http_row["instances"],
                       "train": train_row["instances"]}

    def by_path(name):
        return {path: counts[name] for path, counts in paths.items()}

    def train_kernel(name, replaces):
        row = train_rows[(name, "no_dropout")]
        drop = train_rows[(name, "dropout")]
        return dict(
            name=name, route="cuda",
            source="jax_llama_tpu_torch/csrc/" + (
                "flash_fwd.cu" if name == "flash_fwd" else "flash_bwd.cu"),
            replaces=replaces, launches=paths["train"][name],
            launches_by_path=by_path(name), shape="train",
            max_abs_err=max(row["worst_row_rel"], drop["worst_row_rel"]),
            max_abs_err_is="the worst row's max abs error over its own "
            "max |plain| (out, dq: packed query rows; dk, dv: KV slots)",
            ms=row["ms"], device_ms=row["device_ms"], dropout_ms=drop["ms"],
            dropout_device_ms=drop["device_ms"], instance=row["instance"],
            launches_by_instance={
                path: inst[f"{name}_by_instance"]
                for path, inst in paths_instances.items()},
            plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row["library_ms"])

    def flash_sub(name):
        row = flash_rows[name]
        return {k: row[k] for k in (
            "T", "S", "dtype", "instance", "ms", "device_ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")}

    pre = flash_rows["insert"]
    fwd = train_kernel("flash_fwd", "jax_llama_tpu/ops/flash_attention.py:868")
    fwd.update(insert_ms=pre["ms"], insert_bound_ms=pre["bound_ms"],
               insert_plain_ms=pre["plain_ms"],
               insert_library_ms=pre["library_ms"],
               insert_instance=pre["instance"],
               decode=dict(flash_sub("decode"), replaced_device_ms=flash_rows[
                   "decode"]["replaced_device_ms"]),
               cached_decode=flash_sub("cached_decode"))
    fi8 = flash_int8_rows["bfloat16"]
    pi8 = paged_int8_rows["serving"]

    def int8_sub(row, **extra):
        return dict(extra, max_abs_err=row["worst_row_rel"], ms=row["ms"],
                    device_ms=row["device_ms"], warm_ms=row["warm_ms"],
                    plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                    bound_by=row["bound_by"], library_ms=row["library_ms"],
                    instance=row["instance"])

    emit({"kernels": [
        fwd,
        dict(name="flash_fwd_int8", route="cuda",
             source="jax_llama_tpu_torch/csrc/flash_fwd.cu",
             replaces="jax_llama_tpu/ops/flash_attention.py:868 "
             "(flash_attention_quantized, :629)",
             launches=paths["int8_serving"]["flash_fwd_int8"],
             launches_by_path=by_path("flash_fwd_int8"), shape="insert",
             max_abs_err=max(r["worst_row_rel"]
                             for r in flash_int8_rows.values()),
             max_abs_err_is="the worst packed query row's max abs err over "
             "its own max |plain|, bf16 and float32",
             ms=fi8["ms"], device_ms=fi8["device_ms"], warm_ms=fi8["warm_ms"],
             plain_ms=fi8["plain_ms"], bound_ms=fi8["bound_ms"],
             bound_by=fi8["bound_by"], library_ms=fi8["library_ms"],
             instance=fi8["instance"],
             replaced_device_ms=fi8["replaced_device_ms"],
             launches_by_instance={
                 "int8_serving": int8_row["instances"][
                     "flash_fwd_int8_by_instance"],
                 "int8_spec_serving": int8_spec[
                     "flash_fwd_int8_by_instance"]},
             float32_ms=flash_int8_rows["float32"]["ms"],
             float32_device_ms=flash_int8_rows["float32"]["device_ms"]),
        dict(name="paged_decode_int8", route="cuda",
             source="jax_llama_tpu_torch/csrc/paged_decode.cu",
             replaces="jax_llama_tpu/ops/paged_attention.py:371 "
             "(int8 branch of _paged_kernel)",
             launches=paths["int8_serving"]["paged_decode_int8"],
             launches_by_path=by_path("paged_decode_int8"), shape="serving",
             max_abs_err=pi8["worst_row_rel"],
             max_abs_err_is="the worst packed query row's max abs err over "
             "its own max |plain|",
             ms=pi8["ms"], warm_ms=pi8["warm_ms"], plain_ms=pi8["plain_ms"],
             bound_ms=pi8["bound_ms"], bound_by=pi8["bound_by"],
             library_ms=pi8["library_ms"], device_ms=pi8["device_ms"],
             instance=pi8["instance"],
             kernel_launches_in_serving=int8_row["instances"][
                 "paged_kernel_launches"],
             spec_verify=int8_sub(
                 paged_int8_rows["spec_verify_bfloat16"], T=SPEC_DRAFT + 1,
                 launches=int8_spec["launches"]["paged_decode_by_t"],
                 float32_ms=paged_int8_rows["spec_verify_float32"]["ms"],
                 float32_max_abs_err=paged_int8_rows[
                     "spec_verify_float32"]["worst_row_rel"]),
             split_verify=int8_sub(
                 paged_int8_rows["split"], G=SPLIT_VERIFY[0],
                 T=SPLIT_VERIFY[1],
                 launches_by_t=paged_int8_rows["split"]["launches_by_t"])),
        dict(name="paged_decode", route="cuda",
             source="jax_llama_tpu_torch/csrc/paged_decode.cu",
             replaces="jax_llama_tpu/ops/paged_attention.py:371",
             launches=paths["serving"]["paged_decode"],
             launches_by_path=by_path("paged_decode"),
             shape="serving", max_abs_err=paged_row["max_abs_err"],
             ms=paged_row["ms"],
             kernel_ms=paged_row["ms"], plain_ms=paged_row["plain_ms"],
             bound_ms=paged_row["bound_ms"], bound_by=paged_row["bound_by"],
             library_ms=paged_row["library_ms"],
             device_ms=paged_row["device_ms"],
             instance=paged_row["instance"],
             kernels_per_launch=paged_row["kernels_per_launch"],
             kernel_launches_in_serving=serve_row["instances"][
                 "paged_kernel_launches"],
             spec_verify=dict(
                 shape="spec_verify", T=SPEC_DRAFT + 1,
                 launches=spec_row["self_draft"]["launches"][
                     "paged_decode_by_t"],
                 max_abs_err=max(r["worst_row_rel"]
                                 for r in verify_rows.values()),
                 max_abs_err_is="the worst packed query row's max abs err "
                 "over its own max |plain|, bf16 and float32",
                 ms=verify_rows["bfloat16"]["ms"],
                 warm_ms=verify_rows["bfloat16"]["warm_ms"],
                 plain_ms=verify_rows["bfloat16"]["plain_ms"],
                 bound_ms=verify_rows["bfloat16"]["bound_ms"],
                 bound_by=verify_rows["bfloat16"]["bound_by"],
                 library_ms=verify_rows["bfloat16"]["library_ms"],
                 device_ms=verify_rows["bfloat16"]["device_ms"],
                 instance=verify_rows["bfloat16"]["instance"],
                 float32_ms=verify_rows["float32"]["ms"])),
        train_kernel("flash_bwd_dq",
                     "jax_llama_tpu/ops/flash_attention.py:1271"),
        train_kernel("flash_bwd_dkv",
                     "jax_llama_tpu/ops/flash_attention.py:1301"),
        dict(name="stock_paged", route="cuda",
             source="jax_llama_tpu_torch/csrc/stock_paged.cu",
             replaces="jax_llama_tpu/ops/kernels.py:428 (_stock_launch, "
             ":361, <- stock_paged_decode, :473)",
             launches=paths["selected_serving"]["stock_paged"],
             launches_by_path=by_path("stock_paged"), shape="serving",
             max_abs_err=max(r["worst_row_rel"] for r in stock_rows.values()),
             max_abs_err_is="the worst live row's max abs err over its own "
             "max |plain|, bf16 and float32",
             ms=stock_rows["bfloat16"]["device_ms"],
             ms_is="torch.profiler device time per call (split and "
             "combine), cold-L2; event_ms times the host-bound wrapper",
             event_ms=stock_rows["bfloat16"]["ms"],
             **{k: stock_rows["bfloat16"][k] for k in (
                 "host_ms", "warm_ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms", "instance")},
             launches_by_instance=sel_row["instances"]["stock_by_instance"],
             float32_ms=stock_rows["float32"]["device_ms"],
             float32_instance=stock_rows["float32"]["instance"]),
        dict(name="splash_prefill", route="cuda",
             source="jax_llama_tpu_torch/csrc/splash_prefill.cu",
             replaces="jax_llama_tpu/ops/kernels.py:264 (splash_prefill, "
             ":224)",
             launches=paths["selected_serving"]["splash_prefill"],
             launches_by_path=by_path("splash_prefill"), shape="insert",
             max_abs_err=max(r["worst_row_rel"]
                             for r in splash_rows.values()),
             max_abs_err_is="the worst query row's max abs err over its "
             "own max |plain|, bf16 and float32, insert and chunk",
             **{k: splash_rows["insert_bfloat16"][k] for k in (
                 "ms", "device_ms", "warm_ms", "plain_ms", "bound_ms",
                 "bound_by", "library_ms", "instance")},
             launches_by_instance=sel_row["instances"]["splash_by_instance"],
             float32_ms=splash_rows["insert_float32"]["ms"],
             chunk={k: splash_rows["chunk_bfloat16"][k] for k in (
                 "T", "S", "chunk_offset", "ms", "device_ms", "warm_ms",
                 "plain_ms", "bound_ms", "bound_by", "library_ms",
                 "instance")}),
    ]})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
