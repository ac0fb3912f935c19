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

The prefix cache, the host tier and prefix export/import (ROADMAP A11)
are on by default (``prefix_index="radix"``), so every batcher above runs
with them: each phase whose prompts share no block (``serve_texts()``
starts its 12 prompts 7 characters apart, the speculative prompts are
random ids) checks ``prefix_requests_hit_total`` == 0 and keeps its exact
counts; ``serving``'s insert timings run on a ``rebuild()`` (an empty
store), and ``checkpoint`` and ``http_drill`` count the flash forward
from their ``insert`` dispatch records (a ``suffix_insert`` launches no
kernel).  Two phases after ``http_drill``:

* ``prefix_serving``: llama3-8b at full width (32 layers, bf16, the
  phase-3 weights), 8 slots, max_len 2048, blocks of 128, decode_chunk 8,
  ``prefix_index="radix"``, ``host_kv_blocks`` 32 (~0.54 GB of pinned
  slabs, allocated once).  A chat with one shared system prompt of 1024
  byte-tokenizer tokens (8 blocks): one warm request, then 15 with
  distinct user turns of 64-159 tokens, 32 new tokens each; 8 second
  turns (a first-turn prompt, its completion and a new 64-token turn, so
  the hit reaches past the system prompt); then, with 4 unrelated rows
  decoding, 4 requests on the system prompt, each after ``demote_idle``
  has moved it into the tier, each held ``swap_poll_min`` 4 polls in
  ``restoring`` while its slabs copy on the side stream.  Checks: hits,
  reused blocks and hit tokens exactly as ``chain_keys`` predicts on the
  host; the flash forward 32 times per ``insert`` record and the paged
  kernel 32 times per decode iteration, no other launch; a hit's suffix
  insert 0 flash launches, a miss insert of the same prompt 32; each
  swap-in 8 blocks, >= 2 decode chunks dispatched while it is in flight
  with one host sync each (the chunk's fetch) and none added; the swap
  ledger (4 swap-ins, 32 blocks in, every demoted block out); every
  completion equal to a ``prefix_cache=False`` batcher's on the same
  prompts, or a bf16 near-tie below DECODE_REL.  Reported: hit rate and
  prefill tokens saved, device ms of the hit's suffix insert and of the
  miss insert, TTFT p50 of hits (this batcher) and misses (the no-cache
  batcher), each demotion sweep's host ms and GB/s, the 8-block D2H and
  H2D copies alone between CUDA events (GB/s), each adopt's device ms,
  the chunks dispatched during each swap-in, and ms per decode
  iteration and busy share beside ``serving``'s.
* ``prefix_invariant``: DECODE_DEPTH layers in float32 activations
  (bf16 weights), a 384-token system prompt; tokens exactly identical
  for a hit against a cold batcher; a demote -> restore -> hit against
  cold, with the adopted blocks' k, v and pos bit-identical to the
  demoted ones; 3 sessions revisited on a pool that holds 2, completed
  through the tier; ``export_prefix`` from one batcher and
  ``import_prefix`` into another (a hit at full depth); int8 pools (rows
  2 and 4-int8): a hit over restored blocks against one over blocks
  never demoted, scale planes bit-identical; a self-draft speculative
  batcher's tier round trip (``d_`` twins in the slabs, acceptance
  exactly 1.0); a ``kv_swap`` fault that fails only its request; and
  ``suffix_insert`` faulted twice through ``LLMServer``, which
  quarantines ``prefix_cache`` onto the flash insert (cache off) with
  the cold tokens (``server._attribute`` maps ``suffix_insert`` to
  ``prefix_cache`` on the card; ``kv_swap`` never leaves the batcher).
  Launches exactly as every batcher's dispatch records imply.

Fused prefill-decode scheduling and logprobs (ROADMAP A9, A17) add a
``kernel_check`` cell to each flash forward row and two phases after
``prefix_invariant``:

* ``kernel_check`` shape ``fused_chunk``: the fused lane's flash call,
  one row (B = 1), a 512-token chunk (T = 512, the budget) at base 1024
  of a 2048-slot view (S = 2048), H 32, KVH 8, d 128, bf16, live slots up
  to the chunk's end and a -1 tail: instance "wgmma", each query row
  within REL_BOUND of its own max |plain|, the lse within LSE_BOUND, with
  its times, bound and SDPA's bool-mask time; and the same cell of
  ``flash_fwd_int8`` over int8 K/V.
* ``fused_serving``: llama3-8b at full width (32 layers, bf16), the
  serving phase's geometry with ``prefill_budget`` 512 and ``logprobs``:
  its 12 requests, 4 into the cold pool, the other 8 submitted while
  those rows decode, so that the fused lane carries them one at a time
  (what a ``run.py --http`` user gets by default).  The same arrivals
  through a classic batcher (budget 0) and through the fused batcher
  without logprobs (the run profiled).  Checks: 8 fused admissions and
  as many prefill
  chunks as ``_pf_chunk`` predicts for the 8 prompts; the flash forward
  32 times per chunk and per classic insert, all "wgmma", the paged
  kernel 32 times per decode iteration (two kernels a launch); the
  stall-free property (every row decoding when a fused admission began
  emits in every dispatch of it, until it finishes) and no decode stall
  booked; one fetch a dispatch in all three runs, and the logprobs
  change neither the tokens nor the host syncs per token; every request
  its max_new tokens, equal to the classic run's or a bf16 near-tie
  below DECODE_REL.  Reported: the decode stall of both runs, wall ms
  per dispatch and per iteration of fused, decode and insert
  dispatches, device ms of one fused and one plain decode dispatch
  (torch.profiler), TTFT and ITL p50/p95 of both runs, and each emitted
  token's logprob against ``engine.score`` of the finished sequence.
* ``fused_invariant``: DECODE_DEPTH layers in float32 activations, exact:
  fused against classic admission, greedy and sampled, at budgets of one
  block, two blocks and 4096: tokens identical, logprobs within 1e-5 abs
  of the classic insert at the same prefill chunking and within the JAX
  package's fused-oracle tolerance (rtol 1e-5, atol 1e-6) of the
  single-shot insert; a prefix hit whose walk starts at fill0 (against
  the classic hit's xla suffix, JAX's tolerance); a swap-in landing in
  the fused lane while a row decodes; int8 pools against the classic
  path at the same prefill chunking (JAX's oracle and tolerance there);
  self-draft speculation's logprobs at 4 rounds a
  dispatch against the per-round loop (a budget keeps its admission
  classic); a cancel mid-prefill that frees every block; the brownout-2
  rung's budget shrink (512 -> 128: 1 -> 3 chunks, the same tokens); a
  ``prefill_chunk`` fault mid-prefill through ``LLMServer``, recovered
  once with the delivered tokens replayed; ``engine.score`` against a
  plain forward's log-softmax (1e-4) on the flash path, and
  ``forward(output_hidden_states=True)`` on the flash path (8 launches)
  and ``output_attentions=True`` with no kernel launch.

The checkpoint phase's ``--serve`` and ``--http`` runs take run.py's
default ``--prefill-budget 512`` (their requests come into an idle pool,
so ``fused_admissions_total`` stays 0 there, checked).

The replica router (ROADMAP A12 part 1) adds two phases after
``fused_invariant``, a router run to ``checkpoint`` and a check to
``http_serving``:

* ``http_serving`` also replays its dispatch records through a fresh
  ``OverloadController`` (the records the server's controller took): the
  decode record right after each classic insert must have a wall per
  iteration within C2_RATIO times the median of the steady decode
  records (it carried the insert's device time before the repair), and
  the decode-rate EWMA just before and just after each admission is
  printed; and ``c2_cell`` (one row decoding, then 7 prompts of 1900
  tokens in one classic insert whose device time outlasts the host's
  enqueue of it and of the next chunk): the decode record after it
  within C2_RATIO, beside a batcher whose decode records keep the host
  wall (the fault unrepaired), for comparison.
* ``checkpoint``: after its ``--http 0`` run, ``run.main()`` with
  ``--replicas 2 --route cache-aware --http 0``: two replicas on the one
  loaded tree, two /generate replies equal to the single server's, one on
  each replica, launches as their dispatch records imply.
* ``router_serving``: llama3-8b at full width (FLEET_LAYERS = 16 of the
  phase-3 weights' layers, bf16), two ``LLMServer`` replicas on the one
  weight copy
  (8 slots, max_len 2048, blocks of 128, the ``run.py --http`` defaults:
  prefill budget 512, radix prefix cache) behind
  ``ReplicaRouter(policy="cache-aware")`` with manual health polls and
  canaries.  Two tenants, each a 1024-token system prompt (8 blocks) and
  user turns of 20-120 tokens, 32 new tokens: one cold request each; a
  health poll; 6 concurrent revisits, each routed to its tenant's holder
  with hit depth 8; then one holder filled with 8 long generations
  (ROUTER_LONG_NEW tokens, prompts that share no block) and the other
  kept decoding two more, so that a revisit spills to the other replica
  and schedules one handoff of its chain, which lands there before the
  spilled request's own fused prefill publishes it; after a health poll a
  last revisit hits at the handoff's destination.  Checks: every reply
  the tokens of one ``ContinuousBatcher`` of the same geometry, or a bf16
  near-tie below DECODE_REL; one handoff completed, none aborted; no
  duplicate block in ``/debug/kv/fleet``; the flash forward once per
  layer per insert and per fused chunk, all "wgmma", the paged kernel
  once per layer per decode iteration (split-KV: two kernels a launch),
  summed over both replicas; both batchers hold the same embedding
  tensor and the phase's peak memory holds no second weight copy.
  Reported: the route decision's ms, the relay's TTFT overhead, the
  handoff's bytes, ms and GB/s, the phase's wall time and tokens/s.
* ``router_drill``: DECODE_DEPTH layers in float32 activations, two
  replicas and the router on one fault injector: a ``router_replica``
  fault on the first forward marks replica 0 unhealthy and the request
  re-routes to replica 1 with the reference tokens (``/debug/decisions``
  joins route, reroute, route by request id); a handoff whose import
  outlasts an injected ``handoff_timeout_s`` unwinds (counted aborted,
  the destination's digest version unchanged, the source still serving
  the chain as a hit); a completed handoff shows in ``/debug/trace`` as
  the router's span and both replicas' export/import instants under one
  request id; the canary oracle pins, one replica's front door dies, its
  canaries fail, its verdict flips and the anomaly counter fires; and
  ``/debug/bundle`` parses.  Launches exactly as the records imply.

The fleet controller (ROADMAP A12 part 2) and the live profiler (A16
part 1) add two phases after ``router_drill``, a check to
``http_serving`` and a flag to ``checkpoint``'s router run; and each
flash ``kernel_check`` row names the kernels one call of its library
yardstick ran (``library_kernels``, through
``utils.profiling.device_op_times``), which says which SDPA backend
``library_ms`` times:

* ``http_serving``, after its measured part: POST /debug/profiler
  brackets PROFILE_REQUESTS more requests on the live server (the
  session starts and stops on the serving loop), GET
  /debug/profile/summary must give ``_paged_decode_chunk`` and
  ``_paged_insert`` device ms > 0, its ``total_device_ms`` must equal the
  trace's summed kernel time within PROFILE_TOTAL_REL, and the paged
  wrapper's count of the kernels it launched over the bracket must equal
  the trace's split and combine events.
* ``checkpoint``: the ``--replicas 2`` run adds ``--autoscale`` (floor 2,
  ceiling 3, a 0.05 s period): /debug/fleet shows the armed controller
  with those bounds, which scaled nothing.
* ``fleet_serving``: router_serving's geometry (llama3-8b at full width,
  FLEET_LAYERS deep, two replicas) with a ``FleetController``
  (``interval_s=0``, driven by ``tick()``; floor 2, ceiling 3; dwell and
  cooldown 0; ``queue_wait_high_ms`` FLEET_QUEUE_WAIT_HIGH_MS).  Two
  tenants' 24 chats arrive together (16 slots) and, while they are
  served, a health poll and a tick run every FLEET_TICK_S until the
  queued admissions' wait p90 is pressure and a tick grows a third
  replica through the factory, which shares the embedding tensor; two
  new tenants' sessions and a hit each are then routed to it (the seeds
  retiring meanwhile).  Once the burst's waits have aged out of the
  signal window the fleet is calm and one tick scales down: the victim
  must be the grown replica with a healthy sentinel verdict, the drain
  must migrate every chain ``resident_chain_keys`` listed, and the
  card's allocated memory must be back within FLEET_MEMORY_SLACK of its
  level before the burst (two idle replicas, each of which has served
  one short request, so that its loop's cuBLAS workspace is in the
  baseline; the scale-up came within the burst), having freed at least
  the grown replica's pool.  Each
  session's revisit then hits its migration destination at its full 8
  blocks, with its first turn's tokens (or a bf16 near-tie below
  DECODE_REL).  Reported: the tick decision ms, the factory's ms, the
  drain's ms, the sessions, blocks and bytes migrated, the migration
  copies' GB/s (on the stopped survivors), the revisits' TTFT before and
  after the drain; launches exactly as every replica's records imply.
* ``fleet_drill``: DECODE_DEPTH layers in float32 activations, two
  replicas and a controller driven by hand: ``scale_event`` faults abort
  a scale-up and a scale-down with the membership unchanged;
  ``session_migrate`` fails the one session's move, the drain reports
  ``migration-failures``, the source resumes and the revisit hits there;
  a rollout on the same weights passes both rungs (``oracle-pinned``,
  ``oracle-match``); a rollout to a tree whose final norm carries seeded
  noise (every other tensor shared), gated on the old canary tokens,
  fails rung 0 (``oracle-mismatch``) and rolls back, after which every
  canary gives the old tokens; with replica 0 made non-healthy (three
  failed canaries fed to the sentinel) a scale-down picks another victim;
  and a drain with no survivor fails cleanly.  Every reply has the
  reference batcher's tokens (DRILL_TIE) and launches are exactly what
  every instance's records imply.

Tensor and data parallelism (ROADMAP A14 part 1): ``kernel_check`` rows
``tp2_insert`` / ``tp2_serving`` hold the flash forward, the paged
decode, stock-paged and splash at a tensor = 2 rank's heads (H = 16, KVH
= 4, d = 128, bf16) against their plain versions, with their times and
bounds.  Right after ``generate_profile``, ``mesh_generate`` and
``mesh_serving`` spawn two ranks once on cuda:0 over gloo (NCCL refuses
two ranks on one device; the ranks prove the sharded path, not a
parallel speed; ``drive_mesh``): the generate phase's prompts at full
width and 32 layers on a tensor = 2 mesh, with each rank's weights drawn
as its half of the seed-0 tree (tokens the unsharded run's or a near-tie
below DECODE_REL; 32 flash launches a rank, "wgmma", at H = 16), then
the serving phase's first 6 requests at 8 layers on ``--serve-mesh 1,2``
against the unsharded batcher (the same tokens or a near-tie, block
tables, free list and radix digest identical on both ranks, the
unsharded batcher's launches on each), the same in float32 activations
with tokens identical (no near-tie allowed), and a data = 2 cell
(``--serve-mesh 2,1``) whose prefix hit reads blocks the other data rank
computed.  ``checkpoint`` adds ``run.py --tensor 2`` under ``python -m
torch.distributed.run --nproc-per-node 2`` (its completions the
single-rank one-shot's, or a near-tie; each rank counts its own
launches: 8 flash on "wgmma").  The ``kernels`` line gives each
on-path kernel's ``tp2`` cell and launches per rank on the mesh paths.

The HTTP server and the router over a serving mesh (ROADMAP A14 part
3), inside ``checkpoint`` on its DECODE_DEPTH-layer checkpoint and on the
same two ranks: ``mesh_http`` runs ``run.main()`` with ``--http 0
--serve-mesh 1,2`` on both ranks through run.py's test hook (rank 0
leads: HTTP, the server's loop; rank 1 follows the lockstep log) beside
the unsharded ``run.main()`` in this process: six requests under a
fault drill (a timeout mid-generation, a failed dispatch that replays, a
blocking /generate, a stream, a /chat, a prefix-hit revisit) in bf16,
whose tokens equal the unsharded server's or a near-tie below
DECODE_REL, and two in float32 activations on the splash and stock-paged
kernels, token-identical; both
ranks' host states, taken through the log after each request, equal;
each rank's launches the unsharded server's (flash "wgmma" and the paged
kernel, then splash and stock-paged, at H = 16); the log's records per
iteration and ms per record.  ``mesh_router`` runs ``--replicas 2
--route cache-aware --autoscale --serve-mesh 1,2``, both replicas
time-sharing the mesh: a routed prefix hit, a handoff whose serve on the
other replica gives the cold serve's tokens, a FleetController scale-up
and a drain by migration, the 1 x 2 mesh in each replica's /healthz,
equal host states, and each rank's launches those of the unsharded
router's ``run.main()`` on the same traffic in this process and the ones
the replicas' dispatch records imply.

The dress rehearsal and the runtime host-sync audit (ROADMAP A16 part
2) add two phases after ``fleet_drill``:

* ``rehearsal``: ``rehearsal.rehearse_synthetic`` on the card at a
  head_dim-64 geometry (REHEARSAL_GEOMETRY, float32): a Meta-format
  checkpoint converted, saved, loaded (manifest verified), generated
  from greedily and held against the torch oracle (parity below 1e-3);
  exactly 2 x its layers flash launches, all on the "float32" instance
  (the prefill and the parity forward; decode steps are T = 1, "auto"'s
  plain path), nothing else; JAX's default geometry (head_dim 16) must
  raise on the card, not fall back; then ``rehearse_8b_shapes`` (leaf
  count, parameter total, largest shard bytes at tensor = 4 x data = 2).
* ``hostsync_runtime``: 8 layers of llama3-8b in bf16, a batcher of four
  decoding rows (their inserts launch the flash forward), then
  HOSTSYNC_STEPS steady ``step()``s (no dirty row, nothing admissible)
  under ``torch.cuda.set_sync_debug_mode("warn")``: every sync warning
  mapped to the port's file and line through its Python stack; each
  site must carry an ``# audit: host-fetch`` pragma (the static lint's
  grammar), and each step's syncs must equal its rise in
  ``host_syncs_total`` (one packed fetch); the paged kernel's launches
  are 8 a decode iteration.

With them three checks of earlier phases: ``mesh_router`` holds every
request whose tokens part from the unsharded router's to a near-tie
below DECODE_REL (``divergences_unsharded``); ``http_serving`` prints
its worst decode record after a classic insert (``c2_worst``: its
cell, index, ratio to the steady median, whether it started before the
insert's end event, its device ms beside its host wall; C2_RATIO
unchanged); and ``kernel_check``'s ``tp2_train`` rows add a dropout
cell keyed on global offsets (TP2_DROPOUT_OFFSETS: a rank's slice of a
split mesh's mask) for the forward, dQ and dK/dV kernels.

A ``total`` line gives the script's seconds so far, before the
``kernels`` line.  The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device,
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
                "cached_decode", "fused_chunk")
# The fused prefill lane's flash cell (fused_serving's chunks): one row, a
# FUSED_BUDGET-token chunk at base 1024 of a 2048-slot view, live slots up
# to the chunk's end and a -1 tail past it.
FUSED_BUDGET = 512
FUSED_CHUNK = dict(T=FUSED_BUDGET, S=2048, base=1024)
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


def flash_inputs(torch, name, gen, H=32, KVH=8):
    """Inputs of the flash kernel at one main-path shape: bf16, float32 at
    the cached_decode phase's float32 step; ``H``/``KVH`` a rank's heads
    under tensor parallelism (``check_shard_kernels``)."""
    B, d = 4, 128
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
    elif name == "fused_chunk":
        B, T, S, base = 1, FUSED_CHUNK["T"], FUSED_CHUNK["S"], FUSED_CHUNK[
            "base"]
        slots = torch.arange(S, device=dev)[None, :]
        kv_pos = torch.where(slots < base + T, slots, -1)
        q_pos = (base + torch.arange(T, device=dev))[None, :]
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


def library_kernels(fn, top=3):
    """The kernels of one call of ``fn`` by device time
    (``utils.profiling.device_op_times``, after one warm call): they name
    the backend a library call ran."""
    from jax_llama_tpu_torch.utils.profiling import device_op_times

    fn()
    ps = device_op_times(fn)
    return [dict(name=k[:96], device_us=v / 1e6)
            for k, v in sorted(ps.items(), key=lambda kv: -kv[1])[:top]]


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
        lib_kernels = library_kernels(library_attention(torch, *args))
        extra, extra_ok = {}, True
        if name == "fused_chunk":
            # Every query row sees slots 0 .. its own position, across the
            # tiles before the chunk's own: its lse as a training forward
            # asks for it, against the plain version's.
            _, lse = fa._forward(*args, 0.0, None, True)
            _, ref_lse = fa.flash_attention_reference(*args,
                                                      return_lse=True)
            extra = dict(base=FUSED_CHUNK["base"],
                         lse_max_abs_err=lse_abs_err(torch, lse, ref_lse),
                         lse_bound=LSE_BOUND)
            extra_ok = extra["lse_max_abs_err"] < LSE_BOUND
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
            library_ms=library_ms, library_kernels=lib_kernels,
            bound_ms=bound_ms, bound_by=bound_by,
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
    # csrc/paged_decode.cu launch_split: bf16 q at T = 1 packs G rows
    # into 16-row m-tiles.
    want_inst = pa.split_instance_name(16 if G <= 16 else 32 if G <= 32
                                       else 64)
    emit(row)
    if not (finite and dead_ok and rel < REL_BOUND and lse_err < LSE_BOUND
            and passes == 2 and set(profiled.values()) == {L}
            and instance == want_inst):
        raise AssertionError(
            f"paged_decode: instance {instance} (expected {want_inst}), "
            f"kernels a launch {passes} (profiled over {L} "
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
    quantized as the insert quantizes them), bf16 and float32 q, and at
    the fused prefill lane's chunk (``fused_chunk``, bf16; the key
    "fused_chunk"): each packed query row within REL_BOUND (bf16) or
    F32_KERNEL_BOUND of its own max |plain|.  Each row is timed: cold-L2,
    warm, plain, and SDPA over a dequantized copy in q's dtype (the
    dequantize not timed); the bound counts 1 byte per K/V element plus
    both scale planes."""
    rows = {}
    w = fa.flash_attention_quantized
    for shape, dtype, bound in (
            ("insert", torch.bfloat16, REL_BOUND),
            ("insert", torch.float32, F32_KERNEL_BOUND),
            ("fused_chunk", torch.bfloat16, REL_BOUND)):
        q, k, v, q_pos, kv_pos = flash_inputs(torch, shape, gen)
        kq, vq, ks, vs = int8_pool(quant, k, v)
        del k, v
        name = (str(dtype).split(".")[-1] if shape == "insert"
                else shape)
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
                   shape=shape, B=q.shape[0], T=q.shape[1],
                   S=kq.shape[1], H=q.shape[2], KVH=kq.shape[2],
                   d=q.shape[3], dtype=str(dtype).split(".")[-1],
                   kv="int8 + float32 scales",
                   instance=instance, launches_by_instance=by_instance,
                   worst_row_rel=rel, rel_bound=bound, finite=finite,
                   bit_identical=identical)
        copies = cold_copies(args)
        cold = [lambda a=a: w(*a) for a in copies]
        row["ms"] = time_ms(torch, cold, iters=4 * len(copies))
        row["device_ms"], row["profiled_calls"] = device_ms_per_launch(
            torch, cold, ("flash_fwd",), "flash_fwd")
        if want == "wgmma" and shape == "insert":
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


def check_train_kernels(torch, fa, gen, shape_name="train",
                        shape=TRAIN_SHAPE, f32=True, offsets=None):
    """kernel_check at the training shape (``shape_name``: "train", or
    "tp2_train", a tensor = 2 rank's heads), without and with dropout,
    with ``offsets`` also with dropout keyed on those global (row, KV
    head) offsets (a rank's slice of a split mesh's mask), and (``f32``)
    the float32 path on a smaller shape."""
    import torch.nn.functional as F

    rows = {}
    args = train_kernel_inputs(torch, gen, torch.bfloat16, **shape)
    q, k, v, g, q_pos, kv_pos = args
    bounds = train_kernel_bounds(torch, q, k, q_pos, kv_pos)
    wrappers = {"flash_fwd": fa.flash_attention,
                "flash_bwd_dq": fa.flash_bwd_dq,
                "flash_bwd_dkv": fa.flash_bwd_dkv}
    cells = [(0.0, None), (TRAIN_DROPOUT, None)]
    if offsets is not None:
        cells.append((TRAIN_DROPOUT, offsets))
    for rate, off in cells:
        seed = (TRAIN_SEED_WORDS + tuple(off or ())) if rate else None
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
        lib_kernels = dict(
            fwd=library_kernels(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True,
                dropout_p=rate)),
            bwd=library_kernels(lambda: torch.autograd.grad(
                lib_out, leaves, gt, retain_graph=True)))
        del lib_out, leaves, out, lse, delta
        label = ("dropout_offsets" if off else "dropout" if rate
                 else "no_dropout")
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            fwd = name == "flash_fwd"
            keys = ("out", "lse") if fwd else (
                ("dq",) if name == "flash_bwd_dq" else ("dk", "dv"))
            row = dict(
                phase="kernel_check", kernel=name, shape=shape_name,
                dropout=rate, dropout_offsets=off, **shape,
                dtype="bfloat16",
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
                library_kernels=lib_kernels["fwd" if fwd else "bwd"],
                bound_ms=bounds[name][0], bound_by=bounds[name][1],
                roofline_share=bounds[name][0] / ms[name],
                instance=instance[name], device_ms=device_ms[name],
                device_roofline_share=(bounds[name][0] / device_ms[name]
                                       if device_ms[name] else None),
                earlier_ms=EARLIER_MS.get((
                    name, f"{shape_name}_dropout" if rate else shape_name)),
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
                f"{shape_name} kernels ({label}): {errs} against "
                f"{TRAIN_BOUNDS}, finite {finite}, instances {instance} "
                f"(expected {want})")
    if not f32:
        return rows

    # The float32 path, smaller shape.
    f32_errs = {}
    args = train_kernel_inputs(torch, gen, torch.float32, **TRAIN_F32_SHAPE)
    for rate in (0.0, TRAIN_DROPOUT):
        seed = TRAIN_SEED_WORDS if rate else None
        errs, finite, _, _ = train_kernel_errors(torch, fa, args, rate, seed)
        f32_errs["dropout" if rate else "no_dropout"] = dict(errs, finite=finite)
    emit(dict(phase="kernel_check", kernel="flash_fwd+flash_bwd_dq+"
              "flash_bwd_dkv", shape="train_f32", **TRAIN_F32_SHAPE,
              dtype="float32", err=f32_errs, err_is=TRAIN_ERR_IS,
              bound=F32_KERNEL_BOUND))
    for label, errs in f32_errs.items():
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
    the first label whose substring a kernel's name holds, else "other".
    Only CUDA activity is recorded: every figure here sums device events,
    and the host ops of a full-width step (tens of thousands) cost the
    profiler's processing far more time than the step itself."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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

    # Insert time: 8 of the requests admitted into an idle batcher.  Its
    # prefix store must be empty, or the requests served above would hit
    # their cached chains and the suffix insert would be timed: a rebuild
    # (the same construction, a fresh pool and store) each time.
    cb = cb.rebuild()
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
    # admitted again into an emptied batcher, under the profiler.
    free_all()
    cb = cb.rebuild()
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
        prefix_hits=stats["prefix_requests_hit_total"],
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
    # The 12 prompts share no 128-token block: with the prefix cache on
    # (the default), no request hits, and every count above is unchanged.
    if stats["prefix_requests_hit_total"] != 0:
        raise AssertionError(f"{phase}: {stats['prefix_requests_hit_total']}"
                             f" prefix hits, expected none")
    return row


# The HTTP phases: the port's LLMServer in this process, its requests
# from client threads over 127.0.0.1.
HTTP_STREAMS = tuple(range(1, 12, 2))  # 6 of the 12 requests stream
# The histogram families whose quantiles http_serving reports.
HTTP_QUANTILES = (0.5, 0.95)
# The decode record after a classic insert, per iteration, over the steady
# decode records' median (ROADMAP C2: it carried the insert's device time).
# c2_cell's long insert while a row decodes: rows, prompt tokens, and the
# decoding row's new tokens.
C2_RATIO = 1.5
C2_ROWS, C2_PROMPT_TOKENS, C2_DECODE_NEW = 7, 1900, 64
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


def http_request(url, path, payload=None, timeout=900, headers=None):
    """(status, headers, body bytes) of one request; an HTTP error status
    is an answer too."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url + path, data=data,
                                 headers=headers or {})
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


def insert_timing(recs):
    """The decode records whose fetch waited for a classic insert (the
    record right after each insert's: an insert is recorded when the next
    fetch settles it) beside the other decode records, per iteration, and
    the decode-rate EWMA of a fresh ``OverloadController`` fed the records
    in order, just before each such insert and just after its decode
    record."""
    import numpy as np

    from jax_llama_tpu_torch.overload import OverloadController

    oc = OverloadController()
    waited, steady, ewma = [], [], []
    pre = None
    for i, r in enumerate(recs):
        if r["kind"] == "insert":
            pre = oc.stats()["decode_tokens_per_s_ewma"]
        oc.on_dispatch(r)
        if r["kind"] != "decode":
            continue
        if i and recs[i - 1]["kind"] == "insert":
            waited.append(dict(seq=r["seq"], k=r["k"], wall_ms=r["wall_ms"],
                               ms_per_iteration=r["wall_ms"] / r["k"],
                               insert_device_ms=recs[i - 1]["wall_ms"],
                               occupancy=r["occupancy"]))
            ewma.append(dict(before_admission=pre, after_admission=oc.stats()[
                "decode_tokens_per_s_ewma"]))
        else:
            steady.append(r["wall_ms"] / r["k"])
    median = float(np.median(steady)) if steady else None
    for w in waited:
        w["ratio_to_steady_median"] = (w["ms_per_iteration"] / median
                                       if median else None)
    return dict(steady_ms_per_iteration_median=median,
                steady_records=len(steady), waited=waited,
                decode_tokens_per_s_ewma=ewma)


def c2_probe(torch, cb):
    """ROADMAP C4: instrument ``cb`` so that every decode dispatch whose
    fetch waited for classic inserts (``_wall_past_inserts`` given an
    event) leaves, in order, its device time (an event recorded where
    the dispatch starts, at ``_dispatch_cost``, to the event before its
    fetch) beside its host wall, whether it started before the last
    insert's end event (the insert's device time inside it), and the
    wall its record kept.  Returns the list it fills."""
    probes, start = [], {}
    dispatch_cost, wall_past = cb._dispatch_cost, cb._wall_past_inserts

    def mark_start(program, count):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        start["ev"] = ev
        return dispatch_cost(program, count)

    def measured(wall_ms, fetched):
        out = wall_past(wall_ms, fetched)
        if fetched is not None and "ev" in start:
            end = cb._unsettled[-1][3]
            probes.append(dict(
                host_wall_ms=wall_ms,
                device_ms=start["ev"].elapsed_time(fetched),
                insert_end_to_fetch_ms=end.elapsed_time(fetched),
                start_before_insert_end=start["ev"].elapsed_time(end) > 0,
                recorded_wall_ms=out))
        return out

    cb._dispatch_cost = mark_start
    cb._wall_past_inserts = measured
    return probes


def c2_worst(cells):
    """C4: the worst decode record after a classic insert over ``cells``
    ({name: (insert_timing's result, c2_probe's list)}): its cell, index
    among that cell's waited records, seq, ratio to the steady median and
    its probe (insert overlap, device time beside host wall), found as
    the probe whose recorded wall is the record's (a fetch after two
    inserts, or a fused dispatch's, leaves a probe and no waited
    record)."""
    worst = None
    for name, (timing, probes) in cells.items():
        for i, w in enumerate(timing["waited"]):
            ratio = w["ratio_to_steady_median"]
            if ratio is None or (worst and ratio <= worst["ratio"]):
                continue
            probe = min(probes, default=None, key=lambda p: abs(
                p["recorded_wall_ms"] - w["wall_ms"]))
            if probe is not None and abs(
                    probe["recorded_wall_ms"] - w["wall_ms"]) > 0.01:
                probe = None
            worst = dict(cell=name, index=i, seq=w["seq"], ratio=ratio,
                         steady_median_ms_per_iteration=timing[
                             "steady_ms_per_iteration_median"],
                         wall_ms=w["wall_ms"], k=w["k"],
                         insert_device_ms=w["insert_device_ms"],
                         probe=probe)
    return worst


def c2_cell(torch, ptl, params, cfg, tok):
    """ROADMAP C2 at its largest: one row decoding, then C2_ROWS prompts
    of C2_PROMPT_TOKENS tokens admitted in one classic insert, whose
    device time outlasts the host's enqueue of it and of the next chunk;
    the decode record right after it (``insert_timing``) on a batcher as
    it is ("repaired") and on one whose decode records keep the host wall
    ("unrepaired").  The admitted rows' upload before that decode
    dispatch is a pageable copy, which waits for the insert, so the two
    read alike while that upload stays blocking."""
    import numpy as np

    rng = np.random.default_rng(3)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz      .,"))
    longs = [tok.encode("".join(rng.choice(letters, size=C2_PROMPT_TOKENS
                                           - 1)), bos=True)
             for _ in range(C2_ROWS)]
    out = {}
    for variant in ("repaired", "unrepaired"):
        cb = ptl.ContinuousBatcher(params, cfg, n_slots=8, max_len=2048,
                                   decode_chunk=8, device="cuda")
        if variant == "unrepaired":
            cb._wall_past_inserts = lambda wall_ms, fetched: wall_ms
        probes = c2_probe(torch, cb)
        cb.submit(serve_prompts(tok)[1], max_new_tokens=C2_DECODE_NEW)
        for _ in range(3):
            cb.step()
        for p in longs:
            cb.submit(p, max_new_tokens=4)
        while cb.pending():
            cb.step()
        out[variant] = dict(insert_timing(records(cb)), probes=probes)
        del cb
    torch.cuda.empty_cache()
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
    probes = c2_probe(torch, cb)
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
        # After the measured part: the live profiler over three more
        # requests (its launches are not in this phase's counts).
        profile = profiler_bracket(torch, pa, srv, prompts)
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
    c2 = insert_timing(recs)
    c2_probes = list(probes)
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
        prefix_hits=samples["llm_prefix_requests_hit_total"],
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
        insert_timing=dict(c2, probes=c2_probes),
        insert_timing_bound=C2_RATIO,
        c2_cell=c2_cell(torch, ptl, params, cfg, tok),
        metrics_series=len(samples), missing_series=missing,
        healthz=dict(status=health_status, ok=health["ok"],
                     quarantined=health["quarantined"]),
        bundle_keys=sorted(bundle), http_status=dict(
            metrics=metrics_status, bundle=bundle_status),
        profiler=profile,
    )
    # C4: the worst decode record after a classic insert, on every run.
    row["c2_worst"] = c2_worst({
        "http_serving": (c2, c2_probes),
        "c2_cell": (row["c2_cell"]["repaired"],
                    row["c2_cell"]["repaired"]["probes"])})
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
    if row["prefix_hits"]:
        raise AssertionError("http_serving: a prefix hit, expected none")
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
    waited = c2["waited"] + row["c2_cell"]["repaired"]["waited"]
    if not c2["waited"] or not row["c2_cell"]["repaired"]["waited"] or any(
            w["ratio_to_steady_median"] > C2_RATIO for w in waited):
        raise AssertionError(f"http_serving: the decode records after a "
                             f"classic insert: worst {row['c2_worst']}; "
                             f"{c2}, {row['c2_cell']}")
    if not profile["ok"]:
        raise AssertionError(f"http_serving: the profiler cross-check "
                             f"{profile}")
    return row


PROFILE_REQUESTS = 3     # http_serving's profiled bracket, after its checks
PROFILE_NEW = 8
PROFILE_TOTAL_REL = 0.01  # the summary's device ms against the trace's


def profiler_bracket(torch, pa, srv, prompts):
    """``http_serving``'s profiler cross-check on its live server: POST
    /debug/profiler brackets PROFILE_REQUESTS requests, GET
    /debug/profile/summary splits the capture by serving program, and the
    trace file itself gives the kernels' summed time and the paged
    kernel's events (split and combine), held against the wrapper's
    count of the kernels it launched over the bracket."""
    import shutil
    import tempfile
    import threading

    paged = pa.paged_pool_attention
    log_dir = tempfile.mkdtemp(prefix="chip_smoke_profile_")
    replies = [None] * PROFILE_REQUESTS

    def call(i):
        replies[i] = http_request(srv.address, "/generate", {
            "prompt": prompts[i], "max_new_tokens": PROFILE_NEW})

    try:
        k0, l0 = paged.kernel_launches, paged.launches
        st_start, _, body = http_request(srv.address, "/debug/profiler", {
            "action": "start", "log_dir": log_dir})
        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(PROFILE_REQUESTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        st_stop, _, _ = http_request(srv.address, "/debug/profiler",
                                     {"action": "stop"})
        kernel_launches = paged.kernel_launches - k0
        wrapper_launches = paged.launches - l0
        st_sum, summary = http_json(srv.address, "/debug/profile/summary")
        with open(summary["trace"]) as f:
            events = json.load(f)["traceEvents"]
        trace_bytes = os.path.getsize(summary["trace"])
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    kernels = [e for e in events
               if e.get("ph") == "X" and e.get("cat") == "kernel"]
    kernel_ms = sum(float(e["dur"]) for e in kernels) / 1e3
    paged_events = sum(1 for e in kernels
                       if any(n in e["name"] for n in PAGED_KERNELS))
    progs = summary.get("programs", {})
    total = summary.get("total_device_ms") or 0.0
    out = dict(
        statuses=dict(start=st_start, stop=st_stop, summary=st_sum,
                      requests=[r[0] for r in replies]),
        requests=PROFILE_REQUESTS, max_new=PROFILE_NEW, programs=progs,
        total_device_ms=total, total_host_ms=summary.get("total_host_ms"),
        trace_kernel_ms=kernel_ms, trace_kernel_events=len(kernels),
        attributed_share=total / kernel_ms if kernel_ms else None,
        paged_kernel_events=paged_events,
        paged_kernel_launches=kernel_launches,
        paged_wrapper_launches=wrapper_launches, trace_bytes=trace_bytes,
        bound=PROFILE_TOTAL_REL)
    out["ok"] = bool(
        (st_start, st_stop, st_sum) == (200, 200, 200)
        and all(r[0] == 200 for r in replies)
        and progs.get("_paged_decode_chunk", {}).get("device_ms", 0) > 0
        and progs.get("_paged_insert", {}).get("device_ms", 0) > 0
        and kernel_ms > 0
        and abs(total - kernel_ms) <= PROFILE_TOTAL_REL * kernel_ms
        and paged_events == kernel_launches > 0)
    return out


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
    if stats["prefix_requests_hit_total"] or p_stats[
            "prefix_requests_hit_total"]:
        problems.append("a prefix hit among the random-id prompts")
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
    if stats["prefix_requests_hit_total"]:
        problems.append("a prefix hit among the random-id prompts")
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
    decode_chunk 8, the byte tokenizer's stop token, the radix prefix
    cache without a host tier, fused prefill at the JAX CLI's default
    budget: the phase's requests come into an idle pool, so they admit
    classically)."""
    return ptl.ContinuousBatcher(
        params, cfg, n_slots=CKPT_SLOTS, max_len=cfg.max_seq_len,
        stop_tokens=(ptl.ByteTokenizer().eos_id,), temperature=0.0,
        top_p=0.95, seed=0, prefix_cache=True, decode_chunk=8, n_draft=4,
        spec_rounds=8, prefill_budget=FUSED_BUDGET, prefix_index="radix",
        host_kv_blocks=0, device="cuda", **kernels)


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
    # Full inserts launch the prefill kernel; a prefix hit's suffix insert
    # launches none.
    stats = dict(cb.stats(), full_inserts=len(records(
        cb, ("insert", "insert:splash"))))
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
        got["dispatches"] = http_json(
            srv.address, "/debug/dispatches?n=4096")[1]["dispatches"]

    orig = prun._serve_http
    prun._serve_http = lambda *a, **kw: orig(*a, _test_hook=hook, **kw)
    try:
        out, _, wall = run_cli(torch, argv)
    finally:
        prun._serve_http = orig
    return (got["replies"], prometheus_samples(got["metrics"]),
            got["health"], got["dispatches"], out, wall)


def run_router_cli(torch, argv, texts):
    """``run.main()`` with ``--http`` and ``--replicas``, as
    ``run_http_cli`` runs it: run.py's test hook POSTs each of ``texts``
    to the router's /generate in turn, then reads the router's health,
    each replica's dispatch records, the router's /debug/fleet and the
    embedding tensor each batcher holds.  Returns (that dict, stdout, wall
    s)."""
    from jax_llama_tpu_torch import run as prun

    got = {}

    def hook(router, servers):
        got["replies"] = [
            http_request(router.address, "/generate",
                         {"text": t, "max_new_tokens": CKPT_GEN})
            for t in texts]
        got["health"] = router.health()
        got["fleet"] = http_json(router.address, "/debug/fleet")[1]
        got["records"] = [records(s.batcher) for s in servers]
        got["embeds"] = [s.batcher.params["embed"]["embedding"].data_ptr()
                         for s in servers]

    orig = prun._serve_router
    prun._serve_router = lambda *a, **kw: orig(*a, **dict(kw,
                                                         _test_hook=hook))
    try:
        out, _, wall = run_cli(torch, argv)
    finally:
        prun._serve_router = orig
    return got, out, wall


def drive_checkpoint(torch, ptl, fa, pa, shallow, cfg, smi, mesh_ranks):
    """Phase ``checkpoint``: the first DECODE_DEPTH layers of the seed-0
    weights written as a Meta checkpoint, converted, saved, loaded, and
    completed through ``run.py`` (one-shot, ``--serve`` twice,
    ``--quantize``), each held to the in-process path on the same tree;
    then, on the same checkpoint and ``mesh_ranks``, the phases
    ``mesh_http`` and ``mesh_router``.  Returns the three rows."""
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
        wants = {}
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
            wants[name] = (want, texts)
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

        # run.py one-shot under torchrun (ROADMAP A14 part 1): --tensor 2
        # over two ranks on the one card (gloo: NCCL refuses two ranks on
        # one device), each loading only its shard; only rank 0 prints.
        # Each rank counts its own launches from zero: L flash launches
        # on "wgmma" at H = 16, as the unsharded one-shot's at H = 32.
        rc, out, err, wall, ranks = torchrun_one_shot(
            one_shot + ["--tensor", str(MESH_RANKS)])
        got = cli_blocks(out, "[") if rc == 0 else []
        want, texts = wants["one_shot"]
        run = dict(rc=rc, ranks=MESH_RANKS, tensor=MESH_RANKS,
                   backend="gloo", completions_equal=got == want,
                   wall_s=wall,
                   launches=(ranks[0]["launches"] if ranks[0]
                             else dict(NO_LAUNCHES)),
                   launches_per_rank=[r and r["launches"] for r in ranks],
                   flash_by_instance_per_rank=[
                       r and r["flash_by_instance"] for r in ranks],
                   stderr_tail=err if rc else None)
        check(rc == 0 and len(got) == len(prompts),
              f"torchrun one-shot rc {rc}: {err}")
        for i, r in enumerate(ranks):
            check(r is not None and r["launches"] == flash[0]
                  and r["flash_by_instance"] == flash[1],
                  f"torchrun one-shot rank {i} launches {r}, expected "
                  f"{flash}")
        if rc == 0 and got != want:
            # A bf16 near-tie at 8 layers: the completions' byte tokens
            # against the unsharded run's, gap bounded by DECODE_REL.
            try:
                run["divergences"] = token_divergences(
                    torch, ptl, shallow, auto,
                    [tok.encode(p, bos=True) for p in prompts],
                    [tok.encode(b.split("\n", 1)[1], bos=False)
                     for b in got],
                    [tok.encode(t, bos=False) for t in texts], DECODE_REL)
            except AssertionError as e:
                check(False, f"torchrun one-shot completions: {e}")
        if rc == 0:
            run["summary"] = out.strip().splitlines()[-1]
        runs["one_shot_tensor2"] = run

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
            inserts = stats["full_inserts"]
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
                summary=out.strip().splitlines()[-1])
            check(sorted(got) == sorted(want) and len(got) == len(texts)
                  and sorted(ids) == sorted(want_ids), f"{name} completions")
            check(launches == ref_launches == expect,
                  f"{name} launches {launches}, reference {ref_launches}, "
                  f"expected {expect}")
            check(runs[name]["instances"] == want_inst,
                  f"{name} instances {instances}, expected {want_inst}")
            check(steps > 0 and inserts > 0, f"{name} stats {stats}")
            runs[name]["fused_admissions"] = stats["fused_admissions_total"]
            check(stats["fused_admissions_total"] == 0,
                  f"{name} admitted through the fused lane")

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
        replies, samples, (h_status, health), recs, out, wall = run_http_cli(
            torch, http_argv, texts)
        launches = launch_counts(fa, pa)
        instances = instance_counts(fa, pa)
        got = [http_tokens(r) for r in replies]
        steps = int(samples["llm_decode_steps_total"])
        inserts = int(samples["llm_insert_dispatches_total"])
        full = sum(r["kind"] == "insert" for r in recs)
        expect = dict(NO_LAUNCHES, flash_fwd=L * full,
                      paged_decode=L * steps)
        statuses = [st for st, _ in got]
        runs["http"] = dict(
            statuses=statuses, decode_iterations=steps, inserts=inserts,
            full_inserts=full,
            fused_admissions=samples["llm_fused_admissions_total"],
            prefix_hits=samples["llm_prefix_requests_hit_total"],
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
        check(not runs["http"]["fused_admissions"],
              "http admitted through the fused lane")
        check(not runs["http"]["recoveries"]
              and not runs["http"]["quarantine_rebuilds"]
              and h_status == 200 and health["ok"],
              f"http server {runs['http']}")

        # run.py --http --replicas 2 --route cache-aware --autoscale: the
        # router over two replicas of the one loaded tree (canaries
        # manual, so that only the two requests run) with the fleet
        # controller armed (its floor the two replicas, so that its loop
        # defers and acts on nothing); the first two texts, one on each
        # replica (least-loaded: they share no block), give the single
        # server's replies.
        single = [t for _, t in got[:2]]
        zero_counts(fa, pa)
        routed, out, wall = run_router_cli(
            torch, http_argv + ["--replicas", "2", "--route", "cache-aware",
                                "--canary-interval-s", "0", "--autoscale",
                                "--autoscale-min", "2", "--autoscale-max",
                                "3", "--autoscale-interval-s", "0.05"],
            texts[:2])
        launches = launch_counts(fa, pa)
        instances = instance_counts(fa, pa)
        got = [http_tokens(r) for r in routed["replies"]]
        expect = record_launches(
            [r for rs in routed["records"] for r in rs], L)
        runs["http_router"] = dict(
            statuses=[st for st, _ in got],
            replicas=[r[1].get("X-Replica-Id") for r in routed["replies"]],
            equal_to_single=[t for _, t in got] == single,
            launches=launches, expected_launches=expect,
            flash_by_instance=instances["flash_fwd_by_instance"],
            policy=routed["health"]["policy"],
            routed_ok=routed["health"]["ok"],
            one_weight_copy=len(set(routed["embeds"])) == 1,
            controller=routed["fleet"].get("controller"),
            autoscale_armed="autoscale_armed" in out,
            load_s=cli_seconds(out), wall_s=wall)
        rr = runs["http_router"]
        ctl = rr["controller"] or {}
        check(rr["autoscale_armed"] and (
            ctl.get("min_replicas"), ctl.get("max_replicas"),
            ctl.get("interval_s")) == (2, 3, 0.05)
            and (ctl.get("scale_events") or {}).get("up") == 0
            and ctl["scale_events"]["down"] == 0
            and ctl.get("last_signals") is not None,
            f"http_router --autoscale controller {ctl}")
        check(rr["statuses"] == [200, 200] and rr["equal_to_single"],
              f"http_router replies {got}, single server {single}")
        check(sorted(rr["replicas"]) == ["0", "1"]
              and rr["policy"] == "cache-aware" and rr["one_weight_copy"],
              f"http_router {rr}")
        check(launches == expect and expect["flash_fwd"] == 2 * L,
              f"http_router launches {launches}, expected {expect}")

        # The same checkpoint served over a serving mesh of the two ranks
        # (ROADMAP A14 part 3).
        mesh_http, mesh_failures = drive_mesh_http(
            torch, ptl, fa, pa, smi, mesh_ranks, saved, shallow, auto)
        mesh_router, bad = drive_mesh_router(torch, ptl, fa, pa, smi,
                                             mesh_ranks, saved, shallow,
                                             auto)
        mesh_failures += bad
    row["runs"] = runs
    row["launches"] = {k: sum(r["launches"][k] for r in runs.values())
                       for k in NO_LAUNCHES}
    row["failures"] = failures
    emit(row)
    if failures or mesh_failures:
        raise AssertionError(f"checkpoint phases failed: {failures} "
                             f"{mesh_failures}")
    return row, mesh_http, mesh_router


# The prefix cache (ROADMAP A11): prefix_serving at llama3-8b's full width,
# prefix_invariant at DECODE_DEPTH layers in float32 activations.
PREFIX_SYSTEM = 1024     # the shared system prompt's tokens, BOS included
PREFIX_TURNS = 16        # wave 1: one warm request, then 15
PREFIX_SECOND = 8        # wave 2: second turns of the first 8
PREFIX_RESTORES = 4      # requests on a demoted system prompt
PREFIX_NEW = 32          # new tokens per request
PREFIX_TIER = 32         # host_kv_blocks
PREFIX_POLL_MIN = 4      # swap_poll_min: polls a ready swap-in is held
PREFIX_BUSY = (0, 2, 5, 9)  # serving prompts that keep rows decoding
PREFIX_BUSY_NEW = 400


def prefix_texts(np, seed=0):
    """The prefix phases' byte texts (numpy ``seed``): the system prompt
    (PREFIX_SYSTEM - 1 characters, so that with BOS it fills 8 blocks of
    128), wave 1's user turns (the first 8, which wave 2 extends, of
    129-159 characters: their prompts key 9 blocks, and a second turn's
    prompt keys the same 9; the rest of 64-128), wave 2's 64-character
    turns, and the restore wave's turns (64-128)."""
    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz      .,"))

    def text(n):
        return "".join(rng.choice(letters, size=int(n)))

    system = text(PREFIX_SYSTEM - 1)
    turns = [text(rng.integers(129, 160) if i < PREFIX_SECOND
                  else rng.integers(64, 129)) for i in range(PREFIX_TURNS)]
    second = [text(64) for _ in range(PREFIX_SECOND)]
    restore = [text(rng.integers(64, 129)) for _ in range(PREFIX_RESTORES)]
    return system, turns, second, restore


def predicted_hits(kvcache, groups, block_size):
    """Each prompt's hit depth in blocks as ``chain_keys`` predicts it on
    the host: the leading keys published by earlier admission groups (a
    group's own chains are published as it is admitted)."""
    published, depths = set(), []
    for group in groups:
        for p in group:
            keys = kvcache.chain_keys(p, block_size)
            d = 0
            while d < len(keys) and keys[d] in published:
                d += 1
            depths.append(d)
        for p in group:
            published.update(kvcache.chain_keys(p, block_size))
    return depths


def records(cb, kinds=None):
    recs = cb.obs.dispatches_json(1 << 16)["dispatches"]
    return [r for r in recs if kinds is None or r["kind"] in kinds]


def record_launches(recs, L, int8=False, n_draft=None):
    """The kernel launches a batcher's dispatch records imply: an insert
    runs the flash forward once per layer (twice under speculation: target
    and draft), a fused prefill chunk once per layer, a decode iteration
    (of a decode or a fused dispatch) the paged kernel once per layer, a
    speculative round it n_draft + 2 times per layer; a suffix insert and
    an adopt launch no kernel."""
    sfx = "_int8" if int8 else ""
    want = dict(NO_LAUNCHES)
    for r in recs:
        if r["kind"] == "insert":
            want["flash_fwd" + sfx] += L * (2 if n_draft else 1)
        if r["kind"] == "fused":
            want["flash_fwd" + sfx] += L
        if r["kind"] in ("decode", "fused"):
            want["paged_decode" + sfx] += L * r["k"]
        elif r["kind"] == "spec":
            want["paged_decode" + sfx] += (n_draft + 2) * L * r["k"]
    return want


def serve_wave(torch, cb, prompts, max_new, log, on_busy=None):
    """Submit ``prompts`` together and step until they are done.  ``log``
    collects tokens, each request's TTFT (host clock from submit to the
    step that emitted its first token, the device synchronised), and the
    wall ms and iterations of steady steps at 8 busy slots (no admission,
    nothing queued).  ``on_busy``, once, when all 8 slots are busy and
    the step owes nothing: a callable given a step function."""
    t_sub = time.perf_counter()
    rids = [cb.submit(p, max_new_tokens=max_new) for p in prompts]
    want = set(rids)

    def one_step():
        free = any(s is None for s in cb.slots.values())
        quiet = not cb._dirty_rows and not (cb.queue and free)
        ins0 = cb.stats()["insert_dispatches_total"]
        torch.cuda.synchronize()
        t = time.perf_counter()
        evs = cb.step()
        torch.cuda.synchronize()
        now = time.perf_counter()
        if (quiet and not free
                and cb.stats()["insert_dispatches_total"] == ins0):
            log["steady_ms"].append((now - t) * 1e3)
            log["steady_iters"] += cb.decode_chunk_last
        for rid, tok_id, done in evs:
            log["tokens"].setdefault(rid, []).append(tok_id)
            log["ttft_ms"].setdefault(rid, (now - t_sub) * 1e3)
            if done:
                want.discard(rid)
        return evs

    while want:
        if (on_busy is not None and not cb.queue and not cb._dirty_rows
                and all(s is not None for s in cb.slots.values())):
            on_busy(one_step)
            on_busy = None
            continue
        one_step()
    return [log["tokens"][r] for r in rids], rids


def drive_prefix_serving(torch, np, ptl, fa, pa, params, cfg, tok, smi,
                         serve_row):
    """Phase ``prefix_serving``: a chat with one shared 1024-token system
    prompt through the radix prefix cache and the host tier at
    llama3-8b's full width (32 layers, bf16, the phase-3 weights)."""
    from jax_llama_tpu_torch import kvcache

    L, BLK = cfg.n_layers, 128
    system, turns, second, restore = prefix_texts(np)
    sys_ids = tok.encode(system, bos=True)
    assert len(sys_ids) == PREFIX_SYSTEM

    def batcher(**kw):
        return ptl.ContinuousBatcher(
            params, cfg, n_slots=8, max_len=2048, block_size=BLK,
            decode_chunk=8, device="cuda", **kw)

    t_phase = time.perf_counter()
    cb = batcher(prefix_index="radix", host_kv_blocks=PREFIX_TIER)
    log = dict(tokens={}, ttft_ms={}, steady_ms=[], steady_iters=0)
    wave1 = [sys_ids + tok.encode(t) for t in turns]
    profile = {}

    def busy_profile(step):
        profile.update(device_profile(
            torch, lambda: [step() for _ in range(3)],
            categories=SERVE_CATEGORIES))

    zero_counts(fa, pa)
    t0 = time.perf_counter()
    toks, rids = serve_wave(torch, cb, wave1[:1], PREFIX_NEW, log)
    more, more_rids = serve_wave(torch, cb, wave1[1:], PREFIX_NEW, log)
    toks, rids = toks + more, rids + more_rids
    wave2 = [wave1[i] + toks[i] + tok.encode(second[i])
             for i in range(PREFIX_SECOND)]
    # Wave 2 fills the 8 slots: three of its steady steps are profiled.
    more, more_rids = serve_wave(torch, cb, wave2, PREFIX_NEW, log,
                                 on_busy=busy_profile)
    toks, rids = toks + more, rids + more_rids
    waves_s = time.perf_counter() - t0
    st_waves = cb.stats()

    # The restore wave: rows kept busy decoding unrelated prompts; each
    # request on the system prompt comes after a demotion sweep, parks in
    # ``restoring`` while its slabs copy on the side stream, and is held
    # PREFIX_POLL_MIN polls while decode chunks go on.
    busy = [cb.submit(serve_prompts(tok)[i], max_new_tokens=PREFIX_BUSY_NEW)
            for i in PREFIX_BUSY]
    cb.step()
    cb.step()
    cb.swap_poll_min = PREFIX_POLL_MIN
    restores, restore_prompts, restore_rids = [], [], []
    for j, text in enumerate(restore):
        idle = cb.stats()["prefix_cached_blocks"]
        torch.cuda.synchronize()
        t = time.perf_counter()
        demoted = cb.demote_idle(idle)
        demote_ms = (time.perf_counter() - t) * 1e3
        prompt = sys_ids + tok.encode(text)
        restore_prompts.append(prompt)
        s0 = cb.stats()
        rid = cb.submit(prompt, max_new_tokens=PREFIX_NEW)
        restore_rids.append(rid)
        inflight_steps, extra_syncs, pending_at_first = 0, 0, None
        out = []
        while len(out) < PREFIX_NEW:
            syncs = cb.host_syncs_total
            seq0 = max((r["seq"] for r in records(cb)), default=-1)
            evs = cb.step()
            if pending_at_first is None and cb._restoring:
                pending_at_first = not kvcache.restore_ready(
                    cb._restoring[0].staged)
            dec = [r for r in records(cb, ("decode",)) if r["seq"] > seq0]
            if dec and dec[-1]["swap_inflight"]:
                inflight_steps += 1
                extra_syncs += cb.host_syncs_total - syncs - 1
            out += [t for r, t, _ in evs if r == rid]
        log["tokens"][rid] = out
        s1 = cb.stats()
        adopt = records(cb, ("adopt",))[-1]
        restores.append(dict(
            demoted_blocks=demoted, idle_before=idle, demote_ms=demote_ms,
            demote_gb_per_s=demoted * cb.block_bytes / demote_ms / 1e6,
            swap_in_blocks=s1["swap_in_blocks_total"]
            - s0["swap_in_blocks_total"],
            decode_steps_during_swap_in=inflight_steps,
            extra_host_syncs_during_swap_in=extra_syncs,
            copy_pending_after_begin=pending_at_first,
            adopt_blocks=adopt["k"], adopt_device_ms=adopt["wall_ms"],
            swap_in_host_ms=s1["swap_in_ms_total"] - s0["swap_in_ms_total"]))
    for r in busy:
        cb.cancel(r)
    st = cb.stats()
    hit_tokens, prompt_tokens = (cb.prefix_hit_tokens_total,
                                 cb.prompt_tokens_total)
    launches = launch_counts(fa, pa)
    instances = instance_counts(fa, pa)
    want_launches = record_launches(records(cb), L)

    # The swap path's copies alone, on the batcher's own stream and arena:
    # 8 blocks (the system prompt's chain) D2H into pinned slabs on the
    # main stream, H2D into staging on the side stream, between CUDA
    # events.
    chain = cb._match_prefix(cb._chain_keys(restore_prompts[0], BLK)).blocks
    side = cb._side_stream()
    slabs = [cb._arena.take() for _ in chain]
    e = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    torch.cuda.synchronize()
    e[0].record()
    for blk, slab in zip(chain, slabs):
        kvcache.fetch_slab(cb.pool, blk, into=slab)
    e[1].record()
    torch.cuda.synchronize()
    e[2].record(side)
    staged = kvcache.stage_restore(slabs, cb.free_blocks[:len(chain)],
                                   cb.n_blocks, device="cuda", stream=side)
    e[3].record(side)
    e[3].synchronize()
    nbytes = len(chain) * kvcache.pool_block_bytes(cb.pool)
    copies = dict(blocks=len(chain), bytes=nbytes,
                  d2h_ms=e[0].elapsed_time(e[1]),
                  h2d_ms=e[2].elapsed_time(e[3]))
    copies.update(d2h_gb_per_s=nbytes / copies["d2h_ms"] / 1e6,
                  h2d_gb_per_s=nbytes / copies["h2d_ms"] / 1e6)
    del slabs, staged

    # A hit's suffix insert and a miss insert of the same prompt (k = 1),
    # device ms between CUDA events, each counted from zero.
    probe = wave1[PREFIX_TURNS - 1]
    nc = batcher(prefix_cache=False)

    def one_insert(b, kind):
        zero_counts(fa, pa)
        rid = b.submit(probe, max_new_tokens=2)
        b._admit()
        flash = launch_counts(fa, pa)["flash_fwd"]
        while b.pending():
            b.step()
        rec = records(b, (kind,))[-1]
        assert rec["rids"] == [rid], rec
        return dict(device_ms=rec["wall_ms"], flash_launches=flash,
                    prefill_tokens=rec["prefill_tokens"])

    hit_insert = one_insert(cb, "suffix_insert")
    miss_insert = one_insert(nc, "insert")

    # The same traffic on a batcher without the prefix cache (every
    # request a miss): the reference each completion is held to, and the
    # misses' TTFT.
    nlog = dict(tokens={}, ttft_ms={}, steady_ms=[], steady_iters=0)
    ntoks = []
    for group in (wave1[:1], wave1[1:], wave2):
        ntoks += serve_wave(torch, nc, group, PREFIX_NEW, nlog)[0]
    for p in restore_prompts:
        ntoks += serve_wave(torch, nc, [p], PREFIX_NEW, nlog)[0]
    del nc
    got = toks + [log["tokens"][r] for r in restore_rids]
    prompts_all = wave1 + wave2 + restore_prompts
    divergences = token_divergences(torch, ptl, params, cfg, prompts_all,
                                    got, ntoks, DECODE_REL)

    depths = predicted_hits(kvcache, [wave1[:1], wave1[1:], wave2]
                            + [[p] for p in restore_prompts], BLK)
    predicted = dict(
        prefix_requests_hit_total=sum(d > 0 for d in depths),
        prefix_blocks_reused_total=sum(depths),
        prefix_hit_tokens=BLK * sum(depths))
    measured = dict(
        prefix_requests_hit_total=st["prefix_requests_hit_total"],
        prefix_blocks_reused_total=st["prefix_blocks_reused_total"],
        prefix_hit_tokens=hit_tokens)
    hit_ttft = [log["ttft_ms"][r] for r, d in zip(rids, depths) if d]
    miss_ttft = list(nlog["ttft_ms"].values())
    wall = sum(log["steady_ms"])
    row = dict(
        phase="prefix_serving", card=smi, config="llama3-8b", n_layers=L,
        dtype="bfloat16", n_slots=8, max_len=2048, block_size=BLK,
        decode_chunk=8, prefix_index="radix", host_kv_blocks=PREFIX_TIER,
        swap_poll_min=PREFIX_POLL_MIN, block_bytes=cb.block_bytes,
        system_tokens=PREFIX_SYSTEM,
        prompt_tokens=[len(p) for p in prompts_all], max_new=PREFIX_NEW,
        requests=len(prompts_all), waves_s=waves_s,
        seconds=time.perf_counter() - t_phase,
        hit_depth_blocks=depths, predicted=predicted, measured=measured,
        hit_rate=st["prefix_requests_hit_total"] / len(prompts_all),
        prefill_tokens_saved=hit_tokens, prompt_tokens_total=prompt_tokens,
        hit_tokens_ratio=st["prefix_hit_tokens_ratio"],
        launches=launches, expected_launches=want_launches,
        flash_by_instance=instances["flash_fwd_by_instance"],
        decode_iterations=st["decode_steps_total"],
        insert_records=len(records(cb, ("insert",))),
        suffix_insert_records=len(records(cb, ("suffix_insert",))),
        suffix_insert_device_ms=[(r["k"], r["prefill_tokens"], r["wall_ms"])
                                 for r in records(cb, ("suffix_insert",))],
        hit_insert=hit_insert, miss_insert=miss_insert,
        ttft_ms_p50=dict(hits=float(np.median(hit_ttft)),
                         misses=float(np.median(miss_ttft))),
        ttft_is="host clock from submit to the step that emitted the first "
        "token (device synchronised), hits from this batcher, misses from "
        "the prefix_cache=False batcher on the same traffic",
        restores=restores, copies=copies,
        swap=dict(ins=st["swap_ins_total"],
                  in_blocks=st["swap_in_blocks_total"],
                  out_blocks=st["swap_out_blocks_total"],
                  failures=st["swap_failures_total"],
                  host_tier_blocks=st["host_tier_blocks"],
                  arena_overflow=cb._arena.overflow_total),
        decode_ms_per_iteration=wall / log["steady_iters"]
        if log["steady_iters"] else None,
        serving_decode_ms_per_iteration=serve_row["decode_ms_per_iteration"],
        busy_share=profile.get("device_busy_share"),
        serving_busy_share=serve_row["busy_share"], profile_3_steps=profile,
        divergences_from_no_cache=divergences,
        stats_after_waves={k: st_waves[k] for k in (
            "prefix_requests_hit_total", "prefix_blocks_reused_total",
            "radix_nodes_total", "prefix_cached_blocks")})
    emit(row)
    del cb
    torch.cuda.empty_cache()
    problems = []
    if measured != predicted:
        problems.append(f"hits {measured}, chain_keys predict {predicted}")
    if launches != want_launches:
        problems.append(f"launches {launches}, records imply {want_launches}")
    if (hit_insert["flash_launches"] != 0
            or miss_insert["flash_launches"] != L):
        problems.append(f"hit/miss flash launches {hit_insert} {miss_insert}")
    if instances["flash_fwd_by_instance"] != (
            {"wgmma": launches["flash_fwd"]}):
        problems.append(f"flash instances {instances}")
    if instances["paged_kernel_launches"] != 2 * launches["paged_decode"]:
        problems.append(f"paged kernels {instances}")
    demoted_total = sum(r["demoted_blocks"] for r in restores)
    if not (st["swap_ins_total"] == PREFIX_RESTORES
            and st["swap_in_blocks_total"] == PREFIX_RESTORES * 8
            and st["swap_out_blocks_total"] == demoted_total
            and st["swap_failures_total"] == 0):
        problems.append(f"swap ledger {row['swap']}, demoted {demoted_total}")
    if not all(r["decode_steps_during_swap_in"] >= 2
               and r["extra_host_syncs_during_swap_in"] == 0
               and r["swap_in_blocks"] == 8 for r in restores):
        problems.append(f"restores {restores}")
    if [len(t) for t in got] != [PREFIX_NEW] * len(prompts_all):
        problems.append("a request did not end with its max_new tokens")
    if problems:
        raise AssertionError(f"prefix_serving failed: {problems}")
    return row


def drive_prefix_invariant(torch, np, ptl, fa, pa, params, cfg, tok, smi):
    """Phase ``prefix_invariant``: DECODE_DEPTH layers in float32
    activations (bf16 weights), exact token identity through every path
    of the prefix cache and the host tier, and its two fault drills."""
    from jax_llama_tpu_torch import kvcache
    from jax_llama_tpu_torch.degrade import DegradeManager
    from jax_llama_tpu_torch.faults import (FaultInjector, FaultSpec,
                                            InjectedFault)
    from jax_llama_tpu_torch.server import LLMServer

    L, BLK = DECODE_DEPTH, 128
    shallow = dict(params, layers={k: w[:L]
                                   for k, w in params["layers"].items()})
    dcfg = cfg.replace(n_layers=L, dtype="float32")
    c8 = dcfg.replace(kv_cache_dtype="int8")
    system, turns, _, _ = prefix_texts(np)
    S = tok.encode(system[:383], bos=True)   # 3 blocks
    P = [S + tok.encode(t) for t in turns[:4]]
    other = serve_prompts(tok)[3]
    made = []

    def batcher(c=dcfg, **kw):
        kw = dict(dict(n_slots=4, max_len=1024, block_size=BLK,
                       decode_chunk=8, device="cuda"), **kw)
        cb = ptl.ContinuousBatcher(shallow, c, **kw)
        made.append((cb, c, kw.get("draft_params") is not None))
        return cb

    def run(cb, prompts, n=PREFIX_NEW):
        rids = [cb.submit(p, max_new_tokens=n) for p in prompts]
        res = cb.run_to_completion()
        return [res[r] for r in rids]

    def chain(cb, prompt):
        blocks = cb._match_prefix(cb._chain_keys(prompt, BLK)).blocks
        names = ("k", "v", "pos", "k_scale", "v_scale")
        return blocks, {n: (getattr(cb.pool, n)[blocks] if n == "pos" else
                            getattr(cb.pool, n)[:, :, blocks]).clone()
                        for n in names if getattr(cb.pool, n) is not None}

    def same_bytes(a, b):
        return sorted(a) == sorted(b) and all(
            torch.equal(a[n], b[n]) for n in a)

    zero_counts(fa, pa)
    t0 = time.perf_counter()
    cells, problems = {}, []
    cold = [run(batcher(prefix_cache=False), [p])[0] for p in P]

    # hit vs cold; then demote -> restore -> hit vs cold with a busy row
    # decoding, the adopted blocks bit-identical to the demoted ones.
    A = batcher(host_kv_blocks=8)
    run(A, [P[0]])
    hit = run(A, [P[1]])[0]
    blocks0, before = chain(A, P[2])
    demoted = A.demote_idle(A.stats()["prefix_cached_blocks"])
    busy = A.submit(other, max_new_tokens=200)
    A.step()
    A.swap_poll_min = 2
    rid = A.submit(P[2], max_new_tokens=PREFIX_NEW)
    restored = []
    while len(restored) < PREFIX_NEW:
        restored += [t for r, t, _ in A.step() if r == rid]
    A.cancel(busy)
    blocks1, after = chain(A, P[2])
    k = len(blocks0)
    cells["hit"] = dict(equal_cold=hit == cold[1])
    cells["restore"] = dict(
        equal_cold=restored == cold[2], demoted=demoted,
        blocks_before=blocks0, blocks_after=blocks1[:k],
        bit_identical=same_bytes(
            before, {n: (t[:k] if n == "pos" else t[:, :, :k])
                     for n, t in after.items()}),
        swap_ins=A.stats()["swap_ins_total"])

    # export from A, import into B: a hit at full depth.
    keys, slabs = A.export_prefix(P[3])
    B = batcher()
    landed = B.import_prefix(keys, slabs)
    imported = run(B, [P[3]])[0]
    cells["export_import"] = dict(
        keys=len(keys), landed=landed, equal_cold=imported == cold[3],
        reused=B.stats()["prefix_blocks_reused_total"])

    # pressure: 3 sessions of 3 keyed blocks, a pool of 10 blocks (each
    # reservation is 5), a tier of 12: revisits come back through it.
    sessions = [tok.encode((t * 8)[:399], bos=True) for t in turns[8:11]]
    C = batcher(n_slots=1, max_len=640, n_blocks=10, host_kv_blocks=12)
    Cc = batcher(n_slots=1, max_len=640, prefix_cache=False)
    pressure = [run(C, [s], 16)[0] == run(Cc, [s], 16)[0]
                for _ in range(2) for s in sessions]
    cst = C.stats()
    cells["pressure"] = dict(
        all_equal_cold=all(pressure), hits=cst["prefix_requests_hit_total"],
        swap_ins=cst["swap_ins_total"], swap_out=cst["swap_out_blocks_total"])

    # int8 pools: a hit over restored blocks against the same hit over
    # blocks never demoted, token- and bit-identical (scale planes too).
    E2 = batcher(c8)
    run(E2, [P[0]])
    hit8 = run(E2, [P[1]])[0]
    E = batcher(c8, host_kv_blocks=8)
    run(E, [P[0]])
    b8, before8 = chain(E, P[1])
    E.demote_idle(E.stats()["prefix_cached_blocks"])
    again8 = run(E, [P[1]])[0]
    b8b, after8 = chain(E, P[1])
    k8 = len(b8)
    cells["int8"] = dict(
        equal=hit8 == again8, swap_ins=E.stats()["swap_ins_total"],
        bit_identical=same_bytes(
            before8, {n: (t[:k8] if n == "pos" else t[:, :, :k8])
                      for n, t in after8.items()}))

    # a self-draft speculative batcher: the draft's twins ride in the
    # slabs; acceptance exactly 1.0, tokens the cold speculative ones.
    spec_kw = dict(draft_params=shallow, draft_config=dcfg, n_draft=3,
                   spec_rounds=4)
    F = batcher(host_kv_blocks=8, **spec_kw)
    run(F, [P[0]])
    F.demote_idle(F.stats()["prefix_cached_blocks"])
    twins = sorted(F._store.tier._slabs[next(iter(F._store.tier._slabs))])
    spec_hit = run(F, [P[1]])[0]
    spec_cold = run(batcher(prefix_cache=False, **spec_kw), [P[1]])[0]
    cells["spec"] = dict(equal_cold=spec_hit == spec_cold,
                         acceptance=F.acceptance_rate(),
                         swap_ins=F.stats()["swap_ins_total"],
                         slab_fields=twins)

    # kv_swap fault: only its request fails; the slabs stay and the next
    # try restores.
    G = batcher(host_kv_blocks=8,
                fault_injector=FaultInjector("kv_swap@0:error"))
    run(G, [P[0]])
    G.demote_idle(G.stats()["prefix_cached_blocks"])
    r1 = G.submit(P[1], max_new_tokens=PREFIX_NEW)
    r2 = G.submit(other, max_new_tokens=8)
    res = G.run_to_completion()
    failed = G.pop_failed()
    retry = run(G, [P[1]])[0]
    cells["kv_swap_fault"] = dict(
        failed=[f[0] for f in failed] == [r1], other_done=list(res) == [r2],
        swap_failures=G.stats()["swap_failures_total"],
        retry_equal_cold=retry == cold[1],
        swap_ins=G.stats()["swap_ins_total"])

    # suffix_insert faulted twice: prefix_cache quarantines onto the flash
    # insert (cache off), and every request completes with the cold
    # tokens; kv_swap never leaves the batcher.
    clock = DrillClock()
    degrade = DegradeManager(threshold=2, window_s=600.0,
                             cooldown_s=DRILL_COOLDOWN_S, clock=clock)
    inj = FaultInjector(FaultSpec.parse(
        "suffix_insert@0:error,suffix_insert@1:error"))
    srv = LLMServer(batcher(fault_injector=inj), tokenizer=tok,
                    degrade=degrade)
    attributed = {s: srv._attribute(InjectedFault("probe", site=s))
                  for s in ("suffix_insert", "kv_swap")}
    with srv:
        replies = [http_request(srv.address, "/generate", {
            "prompt": p, "max_new_tokens": PREFIX_NEW}) for p in P]
        _, health = http_json(srv.address, "/healthz")
        _, dec = http_json(srv.address, "/debug/decisions")
        _, kv = http_json(srv.address, "/debug/kv")
        recs = http_json(srv.address, "/debug/dispatches?n=4096")[1][
            "dispatches"]
    got = [http_tokens(r) for r in replies]
    cells["suffix_insert_fault"] = dict(
        statuses=[s for s, _ in got], attributed=attributed,
        quarantined=health["quarantined"],
        prefix_index_after=health["kv"]["prefix_index"],
        decisions=[d["kind"] for d in dec["decisions"]],
        injected=inj.injected_total, kv_nodes_after=len(kv["nodes"]),
        suffix_inserts=sum(r["kind"] == "suffix_insert" for r in recs),
        divergences=token_divergences(
            torch, ptl, shallow, dcfg, P, [t for _, t in got], cold,
            DRILL_TIE) if [s for s, _ in got] == [200] * 4 else None)
    launches = launch_counts(fa, pa)
    want = dict(NO_LAUNCHES)
    for cb, c, spec in made[:-1]:
        for key, n in record_launches(
                records(cb), L, int8=c.kv_cache_dtype == "int8",
                n_draft=3 if spec else None).items():
            want[key] += n
    for key, n in record_launches(recs, L).items():
        want[key] += n
    row = dict(phase="prefix_invariant", card=smi, config="llama3-8b",
               n_layers=L, dtype="float32 activations, bf16 weights",
               block_size=BLK, system_tokens=len(S), cells=cells,
               launches=launches, expected_launches=want,
               seconds=time.perf_counter() - t0)
    emit(row)
    q = cells["suffix_insert_fault"]
    checks = {
        "hit": cells["hit"]["equal_cold"],
        "restore": cells["restore"]["equal_cold"]
        and cells["restore"]["bit_identical"]
        and cells["restore"]["swap_ins"] == 1,
        "export_import": cells["export_import"]["equal_cold"]
        and cells["export_import"]["landed"] == len(keys) == 3
        and cells["export_import"]["reused"] == 3,
        "pressure": cells["pressure"]["all_equal_cold"]
        and cells["pressure"]["hits"] == 3
        and cells["pressure"]["swap_ins"] >= 1,
        "int8": cells["int8"]["equal"] and cells["int8"]["bit_identical"]
        and cells["int8"]["swap_ins"] == 1
        and launches["flash_fwd_int8"] > 0
        and launches["paged_decode_int8"] > 0,
        "spec": cells["spec"]["equal_cold"]
        and cells["spec"]["acceptance"] == 1.0
        and cells["spec"]["swap_ins"] == 1
        and "d_k" in cells["spec"]["slab_fields"],
        "kv_swap_fault": cells["kv_swap_fault"]["failed"]
        and cells["kv_swap_fault"]["other_done"]
        and cells["kv_swap_fault"]["swap_failures"] == 1
        and cells["kv_swap_fault"]["retry_equal_cold"],
        "suffix_insert_fault": q["statuses"] == [200] * 4
        and q["attributed"] == {"suffix_insert": "prefix_cache",
                                "kv_swap": None}
        and q["quarantined"] == ["prefix_cache"]
        and q["prefix_index_after"] == "off" and q["injected"] == 2
        and "quarantine" in q["decisions"],
        "launches": launches == want,
    }
    for name, ok in checks.items():
        if not ok:
            problems.append(name)
    del made
    torch.cuda.empty_cache()
    if problems:
        raise AssertionError(f"prefix_invariant failed: {problems}: {cells}")
    return row


# Fused prefill-decode scheduling (ROADMAP A9) with logprobs (A17):
# fused_serving at llama3-8b's full width, fused_invariant at DECODE_DEPTH
# layers in float32 activations.
FUSED_COLD = 4           # fused_serving: requests admitted into a cold pool
# Fused against classic logprobs in float32 activations: 1e-5 abs against
# the classic path at the same prefill chunking (the same GEMM shapes);
# against another chunking or attention path (the single-shot insert, a
# hit's xla suffix), and on int8 pools (JAX's oracle), the JAX package's
# own tolerance for its fused oracle (tests/test_serving_fused.py),
# relative: the chunks' KV sum in another order (|logprob| ~ 10).
FUSED_LP_ATOL = 1e-5
JAX_LP_TOL = dict(rtol=1e-5, atol=1e-6)
SCORE_ATOL = 1e-4        # score vs a plain forward's log-softmax, float32
# fused_invariant: budgets of one block, two blocks and "infinity"; a
# decoding row and a 2.3-block prompt submitted while it decodes (numpy
# seed 11), a 2-block shared prefix for the hit cell.
INV_BUDGETS = (128, 256, 4096)
INV_PROMPTS = dict(r0=40, r1=300, shared=256)
INV_SAMPLED = (dict(temperature=0.8, seed=7),
               dict(temperature=0.7, top_p=0.9, seed=12))


def quantiles(xs):
    """p50 and p95 of ``xs`` (None when empty)."""
    import numpy as np

    if not xs:
        return dict(p50=None, p95=None)
    return dict(p50=float(np.percentile(xs, 50)),
                p95=float(np.percentile(xs, 95)))


def fused_arrivals(torch, cb, prompts, max_new, profile=False):
    """The fused phases' traffic on ``cb``: requests 0 .. FUSED_COLD-1 into
    the cold pool, the rest submitted after the first step, while those
    rows decode.  Every step is timed on the host clock (the step ends in
    its fetch) and classed by what it dispatched: "fused" (it advanced a
    prefill chunk), "insert" (a classic admission) or "decode".  Each
    token's arrival gives TTFT (from submit) and ITL (the gap to the
    request's previous token; tokens of one chunk arrive together, as a
    client sees them).  The stall-free check: in every fused dispatch,
    each row that was decoding when its admission's first chunk ran, and
    has not finished, emits.  With ``profile``, the first fused dispatch
    with a decoding row and the first quiet decode dispatch at 4 or more
    busy rows run under torch.profiler.  Returns a dict."""
    rids, sub_t, last_t = {}, {}, {}
    toks, lps, ttft, itl = {}, {}, {}, []
    steps, misses = [], []
    current, finished = None, set()
    profiles = {}

    def submit(i):
        rid = cb.submit(prompts[i], max_new_tokens=max_new[i])
        rids[rid] = i
        sub_t[rid] = time.perf_counter()

    for i in range(FUSED_COLD):
        submit(i)
    n_steps = 0
    t0 = time.perf_counter()
    while cb.pending():
        if n_steps == 1:
            for i in range(FUSED_COLD, len(prompts)):
                submit(i)
        if cb._pf is None:
            current = None  # no admission in flight
        decoding = {s.request_id for b, s in cb.slots.items()
                    if s is not None and cb.active[b]}
        quiet = (cb._pf is None and not cb.queue and not cb._dirty_rows
                 and not cb._restoring)
        ins0, ch0 = cb._admit_dispatches, cb.prefill_chunks_total
        prof = None
        if (profile and decoding and cb._pf is not None
                and "fused" not in profiles):
            prof = "fused"
        elif (profile and quiet and len(decoding) >= 4
              and "decode" not in profiles and n_steps > 1):
            prof = "decode"
        torch.cuda.synchronize()
        t = time.perf_counter()
        if prof:
            box = {}
            profiles[prof] = device_profile(
                torch, lambda: box.setdefault("ev", cb.step()),
                categories=SERVE_CATEGORIES)
            profiles[prof]["k"] = cb.decode_chunk_last
            evs = box["ev"]
        else:
            evs = cb.step()
        now = time.perf_counter()
        n_steps += 1
        fused = cb.prefill_chunks_total > ch0
        kind = ("fused" if fused else
                "insert" if cb._admit_dispatches > ins0 else "decode")
        steps.append(dict(kind=kind, k=cb.decode_chunk_last,
                          wall_ms=(now - t) * 1e3, profiled=bool(prof)))
        emitted, done = set(), set()
        for ev in evs:
            rid, tok_id, is_done = ev[0], ev[1], ev[2]
            i = rids[rid]
            if i not in toks:
                ttft[i] = (now - sub_t[rid]) * 1e3
            else:
                itl.append((now - last_t[i]) * 1e3)
            last_t[i] = now
            toks.setdefault(i, []).append(tok_id)
            if len(ev) > 3:
                lps.setdefault(i, []).append(ev[3])
            emitted.add(rid)
            if is_done:
                done.add(rid)
        if fused:
            if current is None:
                current = decoding
            misses += [dict(step=n_steps, request=rids[r])
                       for r in sorted(current - finished - emitted)]
        finished |= done
    torch.cuda.synchronize()
    return dict(tokens=toks, logprobs=lps, ttft_ms=ttft, itl_ms=itl,
                steps=steps, stall_misses=misses, profiles=profiles,
                serve_s=time.perf_counter() - t0)


def step_means(steps):
    """Mean wall ms per dispatch and per decode iteration of each dispatch
    kind, the profiled steps left out."""
    out = {}
    for kind in ("fused", "decode", "insert"):
        sel = [s for s in steps if s["kind"] == kind and not s["profiled"]]
        if sel:
            wall = sum(s["wall_ms"] for s in sel)
            out[kind] = dict(dispatches=len(sel),
                             ms_per_dispatch=wall / len(sel),
                             ms_per_iteration=wall / sum(s["k"] for s in sel))
    return out


def drive_fused_serving(torch, ptl, engine, fa, pa, params, cfg, tok, smi):
    """Phase ``fused_serving``: the serving phase's 12 requests at
    llama3-8b's full width through a batcher of its geometry with
    ``prefill_budget=FUSED_BUDGET`` and ``logprobs=True`` (what a ``run.py
    --http`` user gets by default): FUSED_COLD admitted into the cold pool,
    the other 8 submitted while those rows decode, so the fused lane
    carries them one at a time.  The same arrivals through a classic
    batcher (budget 0), and through the fused batcher without logprobs,
    whose run is also the one profiled (the profiler changes neither its
    tokens nor its fetches, and stays out of the timed runs' walls)."""
    L = cfg.n_layers
    prompts = serve_prompts(tok)
    kw = dict(n_slots=8, max_len=2048, decode_chunk=8, device="cuda")
    cb = ptl.ContinuousBatcher(params, cfg, prefill_budget=FUSED_BUDGET,
                               logprobs=True, **kw)
    chunks = {i: -(-n // cb._pf_chunk(n, 0))
              for i, n in enumerate(SERVE_PROMPT_TOKENS) if i >= FUSED_COLD}
    zero_counts(fa, pa)
    fused = fused_arrivals(torch, cb, prompts, SERVE_MAX_NEW)
    stats = cb.stats()
    launches = launch_counts(fa, pa)
    instances = instance_counts(fa, pa)
    del cb
    runs = {}
    for name, budget, lp in (("classic", 0, True), ("fused_no_logprobs",
                                                   FUSED_BUDGET, False)):
        cb = ptl.ContinuousBatcher(params, cfg, prefill_budget=budget,
                                   logprobs=lp, **kw)
        runs[name] = fused_arrivals(torch, cb, prompts, SERVE_MAX_NEW,
                                    profile=not lp)
        runs[name]["stats"] = cb.stats()
        del cb
    classic, plain = runs["classic"], runs["fused_no_logprobs"]
    got = [fused["tokens"][i] for i in range(12)]
    want = [classic["tokens"][i] for i in range(12)]
    divergences = token_divergences(torch, ptl, params, cfg, prompts, got,
                                    want, DECODE_REL)
    # Each emitted token's logprob against engine.score of the finished
    # sequence (one flash forward of prompt + completion).
    score_err = []
    for i in range(12):
        seq = torch.tensor([prompts[i] + got[i]], dtype=torch.int32,
                           device="cuda")
        ref = engine.score(params, seq, config=cfg)[0, len(prompts[i]) - 1:]
        score_err.append((torch.tensor(fused["logprobs"][i], device="cuda")
                          - ref).abs().max().item())
    inserts = stats["insert_dispatches_total"]
    chunk_sum = sum(chunks.values())
    flash = L * (chunk_sum + inserts)
    want_launches = dict(NO_LAUNCHES, flash_fwd=flash,
                         paged_decode=L * stats["decode_steps_total"])
    paged = launches["paged_decode"]
    lens_ok = all(len(fused["tokens"][i]) == SERVE_MAX_NEW[i]
                  for i in range(12))
    in_vocab = all(0 <= t < cfg.vocab_size for ts in got for t in ts)
    syncs = {name: dict(host_syncs_total=r["host_syncs_total"],
                        decode_dispatches_total=r["decode_dispatches_total"],
                        host_syncs_per_token=r["host_syncs_per_token"])
             for name, r in (("fused", stats), ("classic", classic["stats"]),
                             ("fused_no_logprobs", plain["stats"]))}
    row = dict(
        phase="fused_serving", card=smi, config="llama3-8b", n_layers=L,
        dtype="bfloat16", n_slots=8, max_len=2048, block_size=128,
        decode_chunk=8, prefill_budget=FUSED_BUDGET, logprobs=True,
        cold_requests=FUSED_COLD, prompt_tokens=list(SERVE_PROMPT_TOKENS),
        max_new=list(SERVE_MAX_NEW),
        fused_admissions=stats["fused_admissions_total"],
        prefill_chunks=stats["prefill_chunks_total"],
        predicted_chunks=chunks, inserts=inserts,
        decode_iterations=stats["decode_steps_total"],
        launches=launches, expected_launches=want_launches,
        instances={k: instances[k] for k in (
            "flash_fwd_by_instance", "paged_by_instance",
            "paged_kernel_launches")},
        stall_free=not fused["stall_misses"],
        stall_misses=fused["stall_misses"][:8],
        decode_stall_ms_total=dict(
            fused=stats["decode_stall_ms_total"],
            classic=classic["stats"]["decode_stall_ms_total"]),
        dispatch_wall=dict(fused=step_means(fused["steps"]),
                           classic=step_means(classic["steps"])),
        dispatch_device={k: dict(device_ms=p["device_ms"], wall_ms=p[
            "wall_ms"], k=p["k"], busy=p["device_busy_share"],
            by_category_ms=p.get("by_category_ms"))
            for k, p in runs["fused_no_logprobs"]["profiles"].items()},
        ttft_ms=dict(fused=quantiles(list(fused["ttft_ms"].values())),
                     classic=quantiles(list(classic["ttft_ms"].values()))),
        itl_ms=dict(fused=dict(quantiles(fused["itl_ms"]),
                               max=max(fused["itl_ms"])),
                    classic=dict(quantiles(classic["itl_ms"]),
                                 max=max(classic["itl_ms"]))),
        serve_s=dict(fused=fused["serve_s"], classic=classic["serve_s"],
                     fused_no_logprobs=plain["serve_s"]),
        token_divergences=divergences,
        logprob_vs_score_worst_abs=max(score_err),
        logprob_vs_score_per_request=score_err,
        syncs=syncs, prefix_hits=stats["prefix_requests_hit_total"],
        tokens_exact=lens_ok, tokens_in_vocab=in_vocab)
    emit(row)
    fails = []
    if stats["fused_admissions_total"] != len(prompts) - FUSED_COLD:
        fails.append("fused admissions")
    if stats["prefill_chunks_total"] != chunk_sum:
        fails.append("prefill chunks")
    if launches != want_launches:
        fails.append("launches")
    if (instances["flash_fwd_by_instance"] != {"wgmma": flash}
            or instances["paged_kernel_launches"] != 2 * paged):
        fails.append("instances")
    if fused["stall_misses"] or stats["decode_stall_ms_total"] != 0.0:
        fails.append("stall-free")
    if classic["stats"]["fused_admissions_total"] != 0:
        fails.append("the classic run admitted fused")
    if plain["tokens"] != fused["tokens"] or (
            syncs["fused"]["host_syncs_per_token"]
            != syncs["fused_no_logprobs"]["host_syncs_per_token"]):
        fails.append("logprobs changed the tokens or the fetches")
    if any(s["host_syncs_total"] != s["decode_dispatches_total"]
           for s in syncs.values()):
        fails.append("a fetch beside the chunk's")
    if not (lens_ok and in_vocab and stats["prefix_requests_hit_total"] == 0
            and all(e == e for e in score_err)):
        fails.append("tokens")
    if fails:
        raise AssertionError(f"fused_serving: {fails}")
    return row


def drive_fused_invariant(torch, np, ptl, engine, fa, pa, params, cfg, tok,
                          smi):
    """Phase ``fused_invariant``: DECODE_DEPTH layers in float32
    activations (the phase-3 weights), exact checks of fused admission
    against classic admission, of logprobs, ``score`` and the forward's
    auxiliary outputs (whose launches are checked exactly); the phase's
    launches go to the ``kernels`` line."""
    import threading

    from jax_llama_tpu_torch.faults import FaultInjector
    from jax_llama_tpu_torch.server import LLMServer

    L = DECODE_DEPTH
    shallow = dict(params, layers={k: w[:L]
                                   for k, w in params["layers"].items()})
    dcfg = cfg.replace(n_layers=L, dtype="float32")
    rng = np.random.RandomState(11)
    ids = {k: rng.randint(10, cfg.vocab_size, n).tolist()
           for k, n in INV_PROMPTS.items()}
    r1_prompt = ids["shared"] + ids["r1"][:INV_PROMPTS["r1"]
                                          - INV_PROMPTS["shared"]]
    row = dict(phase="fused_invariant", card=smi, config="llama3-8b",
               n_layers=L, dtype="float32 activations", cells={})
    fails = []
    t_start = time.perf_counter()
    zero_counts(fa, pa)

    def batcher(c=dcfg, **kw):
        kw = dict(dict(n_slots=2, max_len=1024, block_size=128,
                       decode_chunk=8, logprobs=True, device="cuda"), **kw)
        return ptl.ContinuousBatcher(shallow, c, **kw)

    def scenario(cb, sampled=False, prefix=False):
        """r0 decodes (a cold pool admits it classically), then r1 is
        submitted mid-decode; ``prefix``: a sharer of the first 256
        tokens warms the cache first.  Returns (tokens, logprobs) of
        (r0, r1) and the batcher's stats."""
        toks, lps = {}, {}

        def pump(n=None):
            k = 0
            while cb.pending() and (n is None or k < n):
                k += 1
                for ev in cb.step():
                    toks.setdefault(ev[0], []).append(ev[1])
                    lps.setdefault(ev[0], []).append(ev[3])

        if prefix:
            cb.submit(ids["shared"] + [7], max_new_tokens=2)
            pump()
        p0, p1 = INV_SAMPLED if sampled else ({}, {})
        r0 = cb.submit(ids["r0"], max_new_tokens=40, **p0)
        pump(2)
        r1 = cb.submit(r1_prompt, max_new_tokens=24, **p1)
        pump()
        return (toks[r0], toks[r1]), (lps[r0], lps[r1]), cb.stats()

    def compare(got, want, tol):
        """(tokens equal, max |logprob diff|, within ``tol``: FUSED_LP_ATOL
        abs when None, else numpy's allclose arguments)."""
        (gt, gl, _), (wt, wl, _) = got[:3], want[:3]
        pairs = [(a, b) for x, y in zip(gl, wl) for a, b in zip(x, y)]
        err = max(abs(a - b) for a, b in pairs)
        close = (err <= FUSED_LP_ATOL if tol is None else all(
            abs(a - b) <= tol["atol"] + tol["rtol"] * abs(b)
            for a, b in pairs))
        return gt == wt, err, close

    def same(name, got, want, tol=None, single=None, **extra):
        """Tokens identical and logprobs within ``tol`` (``compare``);
        ``single``, a second oracle held to JAX_LP_TOL (the single-shot
        classic insert)."""
        equal, err, close = compare(got, want, tol)
        gs = got[2]
        cell = dict(tokens_equal=equal, logprob_max_abs_diff=err,
                    logprob_tolerance=tol or dict(atol=FUSED_LP_ATOL),
                    fused_admissions=gs["fused_admissions_total"],
                    prefill_chunks=gs["prefill_chunks_total"], **extra)
        if single is not None:
            s_equal, s_err, s_close = compare(got, single, JAX_LP_TOL)
            cell["vs_single_shot"] = dict(
                tokens_equal=s_equal, logprob_max_abs_diff=s_err,
                logprob_tolerance=JAX_LP_TOL)
            close = close and s_equal and s_close
        row["cells"][name] = cell
        if not (equal and close):
            fails.append(name)
        return cell

    # 1. fused vs classic, greedy and sampled, at each budget: against
    # the classic insert at the same chunking, and the single-shot one.
    for sampled in (False, True):
        single = scenario(batcher(), sampled=sampled)
        for budget in INV_BUDGETS:
            cb = batcher(prefill_budget=budget)
            chunk = cb._pf_chunk(len(r1_prompt), 0)
            want = scenario(batcher(prefill_chunk=chunk), sampled=sampled)
            cell = same(f"{'sampled' if sampled else 'greedy'}_{budget}",
                        scenario(cb, sampled=sampled), want, single=single,
                        chunk=chunk)
            if cell["fused_admissions"] != 1 or cell["prefill_chunks"] != (
                    -(-len(r1_prompt) // cell["chunk"])):
                fails.append(f"chunks at {budget}")
    # 2. a prefix hit: the fused walk starts at fill0 = 256.
    want = scenario(batcher(), prefix=True)
    cb = batcher(prefill_budget=128)
    cell = same("prefix_hit", scenario(cb, prefix=True), want,
                tol=JAX_LP_TOL, hits=cb.prefix_requests_hit,
                chunk=cb._pf_chunk(
                    len(r1_prompt) - INV_PROMPTS["shared"], 2))
    if cell["hits"] != 1 or cell["prefill_chunks"] != 1:
        fails.append("prefix_hit walk")
    # 3. a swap-in that lands in the fused lane.
    session = ids["shared"] + ids["r0"]
    cold = batcher(prefix_cache=False)
    rc = cold.submit(session, max_new_tokens=8)
    want_s = cold.run_to_completion()[rc]
    cb = batcher(prefill_budget=128, host_kv_blocks=8, n_blocks=12)
    cb.submit(session, max_new_tokens=8)
    cb.run_to_completion()
    demoted = cb.demote_idle(2)
    r0 = cb.submit(ids["r0"], max_new_tokens=60)
    cb.step()
    cb.step()
    cb.swap_poll_min = 2
    rid = cb.submit(session, max_new_tokens=8)
    got_s, kept_decoding = [], True
    while cb.pending():
        busy = bool(cb._restoring or cb._pf is not None)
        evs = cb.step()
        if busy and not any(ev[0] == r0 for ev in evs):
            kept_decoding = False
        got_s += [ev[1] for ev in evs if ev[0] == rid]
    st = cb.stats()
    row["cells"]["swap_in_fused"] = dict(
        tokens_equal=got_s == want_s, demoted=demoted,
        swap_ins=st["swap_ins_total"], fused=st["fused_admissions_total"],
        prefill_chunks=st["prefill_chunks_total"],
        decoding_row_emitted_throughout=kept_decoding)
    if not (got_s == want_s and demoted == 2 and st["swap_ins_total"] == 1
            and st["fused_admissions_total"] == 1 and kept_decoding):
        fails.append("swap_in_fused")
    # 4. int8 pools against the classic path at the same chunking (JAX's
    # oracle there: where the chunks fall decides where KV quantizes).
    qcfg = dcfg.replace(kv_cache_dtype="int8")
    same("int8_256", scenario(batcher(qcfg, prefill_budget=256), sampled=True),
         scenario(batcher(qcfg, prefill_chunk=256), sampled=True),
         tol=JAX_LP_TOL)
    # 5. speculation with logprobs: R rounds a dispatch against the
    # per-round loop; a budget leaves its admission classic.
    spec = {}
    for r in (4, 1):
        cb = batcher(draft_params=shallow, draft_config=dcfg, n_draft=3,
                     spec_rounds=r, prefill_budget=128)
        spec[r] = scenario(cb) + (cb.acceptance_rate(),)
    cell = same("spec_logprobs", spec[4][:3], spec[1][:3],
                acceptance=spec[4][3])
    if cell["fused_admissions"] != 0 or spec[4][3] != 1.0:
        fails.append("spec classic admission")
    # 6. cancel mid-prefill frees every block.
    cb = batcher(prefill_budget=128, prefix_cache=False)
    r0 = cb.submit(ids["r0"], max_new_tokens=24)
    cb.step()
    cb.step()
    r1 = cb.submit(r1_prompt, max_new_tokens=24)
    cb.step()
    mid = cb._pf is not None and cb._pf.req.rid == r1
    free0 = len(cb.free_blocks)
    cb.cancel(r1)
    freed = len(cb.free_blocks) - free0
    out = cb.run_to_completion()
    row["cells"]["cancel_mid_prefill"] = dict(
        was_mid_prefill=mid, blocks_freed=freed,
        free_at_end=len(cb.free_blocks), n_blocks=cb.n_blocks)
    if not (mid and cb._pf is None and freed > 0 and r1 not in out
            and len(cb.free_blocks) == cb.n_blocks):
        fails.append("cancel_mid_prefill")
    # 7. the brownout rung's budget shrink: the server's ladder at
    # brownout-2 (a quarter of the budget) adds chunks, same tokens.
    walks = {}
    for rung in ("normal", "brownout-2"):
        cb = batcher(prefill_budget=512, prefix_cache=False)
        srv = LLMServer(cb, tokenizer=tok)
        srv.overload.force_rung(rung)
        srv._apply_overload_knobs()
        walks[rung] = scenario(cb) + (cb.prefill_budget,)
        del srv
    cell = same("brownout_shrink", walks["brownout-2"][:3],
                walks["normal"][:3], tol=JAX_LP_TOL,
                budgets=[walks[r][3] for r in walks],
                chunks=[walks[r][2]["prefill_chunks_total"] for r in walks])
    if cell["chunks"] != [1, 3] or cell["budgets"] != [512, 128]:
        fails.append("brownout_shrink")
    # 8. a prefill_chunk fault mid-prefill: the server recovers and
    # replays the delivered tokens.
    want_f = []
    for p, n in ((ids["r0"], 48), (r1_prompt, 16)):
        cb = batcher(logprobs=False)
        r = cb.submit(p, max_new_tokens=n)
        want_f.append(cb.run_to_completion()[r])
    inj = FaultInjector("prefill_chunk@1:error")
    srv = LLMServer(batcher(prefill_budget=128, fault_injector=inj,
                            logprobs=False), tokenizer=tok)
    replies = [None, None]

    def call(i, prompt, n):
        replies[i] = http_request(srv.address, "/generate",
                                  {"prompt": prompt, "max_new_tokens": n})

    with srv:
        a = threading.Thread(target=call, args=(0, ids["r0"], 48))
        a.start()
        deadline = time.monotonic() + 300
        while (srv.batcher.decode_dispatches_total < 2
               and time.monotonic() < deadline):
            time.sleep(0.005)
        call(1, r1_prompt, 16)
        a.join(timeout=600)
        _, health = http_json(srv.address, "/healthz")
    got_f = [http_tokens(r) for r in replies]
    cell = dict(statuses=[s for s, _ in got_f],
                recoveries=health["recoveries_total"],
                injected=inj.injected["prefill_chunk"],
                prefill_chunk_calls=inj.calls["prefill_chunk"])
    row["cells"]["prefill_chunk_fault"] = cell
    if cell["statuses"] == [200, 200]:
        cell["divergences"] = token_divergences(
            torch, ptl, shallow, dcfg, [ids["r0"], r1_prompt],
            [t for _, t in got_f], want_f, DRILL_TIE)
    if not (cell["statuses"] == [200, 200] and cell["recoveries"] == 1
            and cell["injected"] == 1):
        fails.append("prefill_chunk_fault")
    launches = launch_counts(fa, pa)
    # 9. score against a plain forward's log-softmax, and the forward's
    # auxiliary outputs: hidden states on the flash path, attention
    # probabilities with no kernel launch.
    seq = torch.tensor([r1_prompt], dtype=torch.int32, device="cuda")
    pos = torch.arange(seq.shape[1], device="cuda", dtype=torch.int32)[None]
    before = fa.flash_attention.launches
    got_sc = engine.score(shallow, seq, config=dcfg.replace(attn_impl="auto"))
    score_flash = fa.flash_attention.launches - before
    with torch.inference_mode():
        lg = ptl.forward(shallow, seq, pos, dcfg.replace(attn_impl="xla"))[0]
        ref_sc = torch.log_softmax(lg[:, :-1].float(), -1).gather(
            -1, seq[:, 1:, None].long())[..., 0]
        before = dict(launch_counts(fa, pa))
        aux_h = ptl.forward(shallow, seq, pos, dcfg.replace(
            attn_impl="auto"), output_hidden_states=True)[2]
        mid_counts = launch_counts(fa, pa)
        aux_a = ptl.forward(shallow, seq, pos, dcfg.replace(
            attn_impl="auto"), output_attentions=True)[2]
        after = launch_counts(fa, pa)
    hs_flash = mid_counts["flash_fwd"] - before["flash_fwd"]
    attn_launches = {k: after[k] - mid_counts[k] for k in after
                     if after[k] != mid_counts[k]}
    sums = aux_a.attentions.float().sum(-1)
    row["cells"]["score"] = dict(
        max_abs_err=(got_sc - ref_sc).abs().max().item(), bound=SCORE_ATOL,
        flash_launches=score_flash)
    row["cells"]["aux_outputs"] = dict(
        hidden_states_shape=list(aux_h.hidden_states.shape),
        hidden_last_is_final=bool(torch.equal(aux_h.hidden_states[-1],
                                              aux_h.last_hidden_state)),
        hidden_flash_launches=hs_flash,
        attentions_shape=list(aux_a.attentions.shape),
        attentions_rows_sum_to_one=(sums - 1).abs().max().item(),
        attentions_kernel_launches=attn_launches)
    if not (row["cells"]["score"]["max_abs_err"] < SCORE_ATOL
            and score_flash == L and hs_flash == L and not attn_launches
            and row["cells"]["aux_outputs"]["hidden_last_is_final"]
            and row["cells"]["aux_outputs"][
                "attentions_rows_sum_to_one"] < 1e-4):
        fails.append("score / aux outputs")
    row["launches"] = launches
    row["seconds"] = time.perf_counter() - t_start
    row["failures"] = fails
    emit(row)
    if fails:
        raise AssertionError(f"fused_invariant failed: {fails}")
    return row


# The replica router (ROADMAP A12 part 1): router_serving at llama3-8b's
# full width, router_drill at DECODE_DEPTH layers in float32 activations.
ROUTER_SLOTS = 8         # slots of each replica
# router_serving's and fleet_serving's depth: full width, half the
# layers (their host-bound decode scales with the layers; 32 took
# 79-125 s in router_serving alone, on the run's time limit).
FLEET_LAYERS = 16
ROUTER_NEW = 32          # new tokens per tenant request
ROUTER_REVISITS = 3      # wave 2: concurrent revisits per tenant
ROUTER_LONG = 8          # long generations that fill the spilling holder
ROUTER_BUSY = 2          # long generations that keep the spill target busy
ROUTER_LONG_NEW = 256
ROUTER_TURN_CHARS = (20, 121)    # user turns: a prompt keys 8 blocks
ROUTER_LONG_CHARS = (160, 201)
ROUTER_WAIT_S = 300.0
DRILL_NEW = 16
DRILL_HANDOFF_TIMEOUT_S = 0.5


def router_texts(np):
    """The router phases' byte texts: the two tenants' system prompts
    (``prefix_texts`` at numpy seeds 0 and 1: 1024 tokens with BOS, 8
    blocks of 128), and from numpy seed 2 six user turns per tenant of
    20-120 characters (so that a tenant's prompt keys its 8 blocks and no
    more) and the long generations' prompts of 160-200 characters (no two
    prompts share a block)."""
    systems = [prefix_texts(np, seed)[0] for seed in (0, 1)]
    rng = np.random.default_rng(2)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz      .,"))

    def text(lo, hi):
        return "".join(rng.choice(letters, size=int(rng.integers(lo, hi))))

    turns = [[text(*ROUTER_TURN_CHARS) for _ in range(6)] for _ in systems]
    longs = [text(*ROUTER_LONG_CHARS)
             for _ in range(ROUTER_LONG + ROUTER_BUSY)]
    return systems, turns, longs


def router_stream(url, payload, rid, out):
    """POST /generate as an NDJSON stream under X-Request-Id ``rid``;
    ``out[rid]`` (filled as the stream arrives) gets the status, the
    serving replica, the tokens, the client's TTFT (send to the first
    token line) and the request's ms."""
    import urllib.request

    rec = out[rid] = dict(tokens=[], ttft_ms=None)
    req = urllib.request.Request(
        url + "/generate", data=json.dumps(dict(payload, stream=True)).encode(),
        headers={"Content-Type": "application/json", "X-Request-Id": rid})
    t = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=900) as r:
            rec["status"] = r.status
            rec["replica"] = int(r.headers["X-Replica-Id"])
            for line in r:
                obj = json.loads(line)
                if obj.get("done"):
                    rec["final"] = obj.get("tokens")
                elif "token" in obj:
                    if rec["ttft_ms"] is None:
                        rec["ttft_ms"] = (time.perf_counter() - t) * 1e3
                    rec["tokens"].append(obj["token"])
    except Exception as e:  # the phase's checks report it
        rec["error"] = repr(e)
    rec["ms"] = (time.perf_counter() - t) * 1e3


def wait_until(cond, what, timeout_s=ROUTER_WAIT_S):
    deadline = time.perf_counter() + timeout_s
    while not cond():
        if time.perf_counter() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.01)


def route_decision(router, rid):
    """The last route decision of request ``rid`` (``/debug/decisions``)."""
    _, doc = http_json(router.address, f"/debug/decisions?request_id={rid}")
    routes = [d for d in doc["decisions"] if d["kind"] == "route"]
    return routes[-1] if routes else None


def replica_times_ms(router, rid):
    """The serving replica's own TTFT and end-to-end ms of ``rid`` from its
    timeline (``/debug/requests/<id>`` through the routing record), from
    its first span's start: to the end of the dispatch that emitted its
    first token (a fused admission's last chunk, else the first dispatch
    of its decoding span; a record ends at its fetch), and to its last
    span's end."""
    _, tl = http_json(router.address, f"/debug/requests/{rid}")
    by_seq = {d["seq"]: d for d in tl["dispatch_spans"]}
    spans = {sp["state"]: sp for sp in tl["spans"]}
    fused = [q for q in spans["prefilling"]["dispatches"]
             if by_seq[q]["kind"] == "fused"]
    first = by_seq[fused[-1] if fused else spans["decoding"]["dispatches"][0]]
    t0 = tl["spans"][0]["start_ms"]
    return (first["start_ms"] + first["wall_ms"] - t0,
            tl["spans"][-1]["end_ms"] - t0)


def drive_router_serving(torch, np, ptl, fa, pa, params, cfg, tok, smi):
    """Phase ``router_serving``: two replicas of llama3-8b at full width
    (``cfg.n_layers`` deep, bf16, the phase-3 weights, one copy on the
    card) behind
    the cache-aware router, serving two tenants' chats (module
    docstring)."""
    import threading

    from jax_llama_tpu_torch import kvcache
    from jax_llama_tpu_torch.router import ReplicaRouter
    from jax_llama_tpu_torch.server import LLMServer

    L, BLK = cfg.n_layers, 128
    systems, turns, longs = router_texts(np)
    sys_ids = [tok.encode(t, bos=True) for t in systems]
    assert all(len(x) == PREFIX_SYSTEM for x in sys_ids)
    kw = dict(n_slots=ROUTER_SLOTS, max_len=2048, block_size=BLK,
              decode_chunk=8, prefill_budget=FUSED_BUDGET, device="cuda")
    param_bytes = sum(t.numel() * t.element_size()
                      for t in flat_tree(params).values())
    prompts, out, threads = {}, {}, []

    def add(rid, ids, max_new):
        prompts[rid] = (ids, max_new)
        return rid

    def send(rids, wait=True):
        ts = [threading.Thread(target=router_stream, args=(
            router.address, {"prompt": prompts[r][0],
                             "max_new_tokens": prompts[r][1]}, r, out))
              for r in rids]
        for t in ts:
            t.start()
        if wait:
            for t in ts:
                t.join(timeout=900)
        threads.extend(ts)

    torch.cuda.synchronize()
    base_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    servers = [LLMServer(ptl.ContinuousBatcher(params, cfg, seed=i, **kw),
                         tokenizer=tok, replica_id=i).start()
               for i in range(2)]
    router = ReplicaRouter(servers, policy="cache-aware",
                           health_interval_s=0, canary_interval_s=0,
                           tokenizer=tok, block_size=BLK).start()
    try:
        zero_counts(fa, pa)
        t_phase = time.perf_counter()
        # Wave 1: one cold request per tenant, one on each replica.
        cold = [add(f"t{t}-cold", sys_ids[t] + tok.encode(turns[t][0]),
                    ROUTER_NEW) for t in (0, 1)]
        send(cold)
        holder = [out[r].get("replica") for r in cold]
        router.check_health_now()
        # Wave 2: each tenant's revisits, together.
        revisits = [add(f"t{t}-rev{j}",
                        sys_ids[t] + tok.encode(turns[t][1 + j]), ROUTER_NEW)
                    for j in range(ROUTER_REVISITS) for t in (0, 1)]
        send(revisits)
        # Wave 3: tenant 0's holder filled with long generations (the other
        # replica retired from picks meanwhile), two more on the other
        # replica, which keep it decoding: the spilled revisit is then a
        # fused admission, whose chain is published after its last chunk,
        # so the handoff's import lands first.
        ha, hb = holder
        long_a = [add(f"long-a{j}", tok.encode(longs[j], bos=True),
                      ROUTER_LONG_NEW) for j in range(ROUTER_LONG)]
        long_b = [add(f"long-b{j}", tok.encode(longs[ROUTER_LONG + j],
                                               bos=True), ROUTER_LONG_NEW)
                  for j in range(ROUTER_BUSY)]
        for rids, on, off in ((long_a, ha, hb), (long_b, hb, ha)):
            router.set_retiring(off)
            send(rids, wait=False)
            wait_until(lambda: router.health()["replicas"][on]["inflight"]
                       >= len(rids), f"{len(rids)} long requests on {on}")
            router.set_retiring(off, False)
        wait_until(lambda: all(out[r]["ttft_ms"] is not None
                               for r in long_a + long_b),
                   "the long generations' first tokens")
        router.check_health_now()
        spill = add("t0-spill", sys_ids[0] + tok.encode(turns[0][4]),
                    ROUTER_NEW)
        send([spill])
        handoffs_idle = router.wait_handoffs(120.0)
        router.check_health_now()
        last = add("t0-last", sys_ids[0] + tok.encode(turns[0][5]),
                   ROUTER_NEW)
        send([last])
        _, fleet_kv = http_json(router.address, "/debug/kv/fleet")
        for t in threads:
            t.join(timeout=900)
        phase_s = time.perf_counter() - t_phase
        launches = launch_counts(fa, pa)
        instances = instance_counts(fa, pa)
        recs = [records(s.batcher) for s in servers]
        stats = [s.batcher.stats() for s in servers]
        health = router.health()
        samples = prometheus_samples(router.metrics_text())
        _, trace = http_json(router.address, "/debug/trace")
        decisions = {r: route_decision(router, r) for r in prompts}
        fwd_ms = {e["args"]["request_id"]: e["dur"] / 1e3
                  for e in trace["traceEvents"]
                  if e.get("pid") == 0 and e.get("name") == "forward"}
        own = {r: replica_times_ms(router, r)
               for r in cold + revisits + [spill, last]}
        relay = {r: out[r]["ttft_ms"] - own[r][0] for r in own}
        relay_e2e = {r: fwd_ms[r] - own[r][1] for r in own}
        embeds = [s.batcher.params["embed"]["embedding"].data_ptr()
                  for s in servers]
        torch.cuda.synchronize()
        peak_extra = torch.cuda.max_memory_allocated() - base_bytes
    finally:
        router.stop()
        for s in servers:
            s.stop()
    # The handoff's copies alone, on the stopped replicas' batchers: the
    # chain exported from its new home and imported back into its first,
    # synchronised (the handoff span also waits for each serving loop's
    # step to end).
    chain = kvcache.chain_keys(prompts[spill][0], BLK)
    torch.cuda.synchronize()
    t = time.perf_counter()
    keys_out, slabs = servers[hb].batcher.export_prefix(keys=chain)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    landed = servers[ha].batcher.import_prefix(keys_out, slabs)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    copies = dict(blocks=len(slabs), landed=landed,
                  bytes=len(slabs) * servers[hb].batcher.block_bytes,
                  export_ms=(t1 - t) * 1e3, import_ms=(t2 - t1) * 1e3)
    copies["gb_per_s"] = copies["bytes"] / ((t2 - t) * 1e3) / 1e6
    del servers, slabs
    torch.cuda.empty_cache()

    # The reference: one batcher of the same geometry, but with a slot for
    # each request of the largest wave, on the same waves.
    ref = ptl.ContinuousBatcher(params, cfg, **dict(
        kw, n_slots=2 * ROUTER_SLOTS))
    want = {}
    for group in (cold, revisits, long_a + long_b + [spill], [last]):
        rids = {ref.submit(prompts[r][0], max_new_tokens=prompts[r][1]): r
                for r in group}
        done = ref.run_to_completion()
        want.update({rids[x]: done[x] for x in rids})
    del ref
    torch.cuda.empty_cache()
    order = list(prompts)
    got = [out[r]["tokens"] for r in order]
    divergences = token_divergences(
        torch, ptl, params, cfg, [prompts[r][0] for r in order], got,
        [want[r] for r in order], DECODE_REL)

    router_x = [e for e in trace["traceEvents"]
                if e.get("pid") == 0 and e.get("ph") == "X"]
    route_ms = [e["dur"] / 1e3 for e in router_x if e["name"] == "route"]
    hand_ms = [e["dur"] / 1e3 for e in router_x
               if e["name"] == "handoff_exec"]
    hand_bytes = health["handoff"]["bytes_total"]
    tokens_total = sum(len(t) for t in got)
    all_recs = [r for rs in recs for r in rs]
    want_launches = record_launches(all_recs, L)
    row = dict(
        phase="router_serving", card=smi, config="llama3-8b", n_layers=L,
        dtype="bfloat16", replicas=2, n_slots=ROUTER_SLOTS, max_len=2048,
        block_size=BLK, decode_chunk=8, prefill_budget=FUSED_BUDGET,
        policy="cache-aware", system_tokens=PREFIX_SYSTEM,
        requests=len(order), max_new=dict(tenant=ROUTER_NEW,
                                          long=ROUTER_LONG_NEW),
        holders=holder,
        replica_of={r: out[r].get("replica") for r in order},
        statuses={r: out[r].get("status") for r in order},
        errors={r: out[r]["error"] for r in order if "error" in out[r]},
        hit_depth={r: (decisions[r] or {}).get("hit_depth") for r in order},
        policy_of={r: (decisions[r] or {}).get("policy") for r in order},
        spill_decision=decisions[spill],
        handoff=health["handoff"], handoffs_idle=handoffs_idle,
        handoffs_completed=samples["llm_router_handoffs_completed_total"],
        handoffs_aborted=samples["llm_router_handoffs_aborted_total"],
        handoff_bytes=hand_bytes, handoff_ms=hand_ms,
        handoff_gb_per_s=(hand_bytes / hand_ms[0] / 1e6
                          if hand_ms and hand_ms[0] else None),
        handoff_is="the router's handoff_exec span: export on the source's "
        "serving loop, import on the destination's, the residency probe "
        "and the source's demotion, each waiting for that loop's step to "
        "end",
        handoff_copies=copies,
        fleet_kv=fleet_kv["fleet"],
        route_decision_ms=dict(p50=float(np.median(route_ms)),
                               max=max(route_ms), n=len(route_ms)),
        relay_ttft_overhead_ms=dict(
            p50=float(np.median(list(relay.values()))),
            max=max(relay.values()), per_request=relay),
        relay_e2e_overhead_ms=dict(
            p50=float(np.median(list(relay_e2e.values()))),
            max=max(relay_e2e.values()), per_request=relay_e2e),
        relay_is="ttft: the client's TTFT through the router (send to the "
        "first NDJSON token line) minus the serving replica's own (its "
        "timeline: first span's start to the end of the dispatch that "
        "emitted the first token); e2e: the router's forward span minus the "
        "replica's timeline from its first span's start to its last's end; "
        "both include the replica server's wait from the request's arrival "
        "to its loop's next step (the timeline starts at the batcher's "
        "submit), nil for wave 1's requests into idle replicas",
        prefix_hits=[s["prefix_requests_hit_total"] for s in stats],
        fused_admissions=[s["fused_admissions_total"] for s in stats],
        launches=launches, expected_launches=want_launches,
        instances={k: instances[k] for k in (
            "flash_fwd_by_instance", "paged_by_instance",
            "paged_kernel_launches")},
        one_weight_copy=len(set(embeds)) == 1, param_bytes=param_bytes,
        peak_bytes_over_weights=peak_extra,
        wall_s=phase_s, tokens=tokens_total,
        tokens_per_s=tokens_total / phase_s,
        divergences_from_one_batcher=divergences)
    emit(row)
    fails = []
    if row["errors"] or set(row["statuses"].values()) != {200}:
        fails.append("statuses")
    if any(len(out[r]["tokens"]) != prompts[r][1]
           or out[r].get("final") != out[r]["tokens"] for r in order):
        fails.append("a stream did not end with its max_new tokens")
    if sorted(holder) != [0, 1]:
        fails.append("the two tenants' cold requests on one replica")
    for r in revisits:
        t = int(r[1])
        if (out[r]["replica"] != holder[t]
                or row["policy_of"][r] != "cache-aware"
                or row["hit_depth"][r] != 8):
            fails.append(f"{r} not an 8-block hit on its holder")
    if any(out[r]["replica"] != ha for r in long_a) or any(
            out[r]["replica"] != hb for r in long_b):
        fails.append("the long generations' replicas")
    sd = decisions[spill] or {}
    if not (out[spill]["replica"] == hb and sd.get("policy") == "spill"
            and sd.get("spill_from") == ha and sd.get("hit_depth") == 8):
        fails.append("the spill")
    if not (handoffs_idle and health["handoff"]["scheduled_total"] == 1
            and row["handoffs_completed"] == 1
            and row["handoffs_aborted"] == 0
            and health["handoff"]["blocks_total"] == 8):
        fails.append("one completed handoff of 8 blocks")
    if not (out[last]["replica"] == hb
            and row["policy_of"][last] == "cache-aware"
            and row["hit_depth"][last] == 8):
        fails.append("the last revisit is not a hit at the destination")
    if fleet_kv["fleet"]["duplicate_kv_blocks"] != 0:
        fails.append("duplicate fleet blocks")
    if launches != want_launches or instances["flash_fwd_by_instance"] != (
            {"wgmma": launches["flash_fwd"]}) or (
            instances["paged_kernel_launches"]
            != 2 * launches["paged_decode"]):
        fails.append("launches")
    if not row["one_weight_copy"] or peak_extra >= param_bytes:
        fails.append("a second weight copy")
    if copies["blocks"] != 8 or copies["landed"] != 8:
        fails.append(f"the handoff's copies {copies}")
    if fails:
        raise AssertionError(f"router_serving: {fails}")
    return row


def drive_router_drill(torch, np, ptl, fa, pa, params, cfg, tok, smi):
    """Phase ``router_drill``: two replicas at DECODE_DEPTH layers in
    float32 activations behind the cache-aware router, one fault injector
    for the router and both replicas (module docstring)."""
    from jax_llama_tpu_torch import kvcache, serving
    from jax_llama_tpu_torch.faults import FaultInjector, FaultSpec
    from jax_llama_tpu_torch.router import ReplicaRouter
    from jax_llama_tpu_torch.server import LLMServer

    L, BLK = DECODE_DEPTH, 128
    shallow = dict(params, layers={k: w[:L]
                                   for k, w in params["layers"].items()})
    dcfg = cfg.replace(n_layers=L, dtype="float32")
    kw = dict(n_slots=DRILL_SLOTS, max_len=2048, block_size=BLK,
              decode_chunk=8, prefill_budget=FUSED_BUDGET, device="cuda")
    systems, turns, _ = router_texts(np)
    sys_ids = tok.encode(systems[0], bos=True)
    prompts = {"drill-reroute": serve_prompts(tok)[INVARIANT_REQUESTS[0]],
               "drill-chain": sys_ids + tok.encode(turns[0][0]),
               "drill-revisit": sys_ids + tok.encode(turns[0][1])}
    ref = ptl.ContinuousBatcher(shallow, dcfg, **kw)
    want = {}
    for rid, p in prompts.items():  # one at a time, as the drill sends them
        x = ref.submit(p, max_new_tokens=DRILL_NEW)
        want[rid] = ref.run_to_completion()[x]
    del ref

    inj = FaultInjector(FaultSpec.parse("router_replica@0:error"))
    servers = [LLMServer(ptl.ContinuousBatcher(
        shallow, dcfg, seed=i, fault_injector=inj, **kw), tokenizer=tok,
        replica_id=i).start() for i in range(2)]
    router = ReplicaRouter(servers, policy="cache-aware",
                           health_interval_s=0, canary_interval_s=0,
                           fault_injector=inj, tokenizer=tok,
                           block_size=BLK).start()
    got, cells, fails = {}, {}, []

    def post(rid):
        st, hdrs, body = http_request(
            router.address, "/generate",
            {"prompt": prompts[rid], "max_new_tokens": DRILL_NEW},
            headers={"X-Request-Id": rid})
        got[rid] = json.loads(body)["tokens"] if st == 200 else None
        return st, int(hdrs.get("X-Replica-Id", -1))

    try:
        zero_counts(fa, pa)
        router.check_health_now()
        router.run_canaries_now()
        _, fleet0 = http_json(router.address, "/debug/fleet")
        oracle = fleet0["canary"]["oracle_tokens"]

        # 1. The router_replica fault on the first forward (replica 0):
        # replica 0 marked unhealthy, the request re-routed to replica 1.
        st, rep = post("drill-reroute")
        healthy = [r["healthy"] for r in router.health()["replicas"]]
        _, doc = http_json(router.address,
                           "/debug/decisions?request_id=drill-reroute")
        trail = [(d["kind"], d.get("replica", d.get("failed_replica")))
                 for d in doc["decisions"]]
        cells["reroute"] = dict(status=st, replica=rep,
                                healthy_after=healthy, trail=trail,
                                reroutes=router.reroutes_total)
        if not (st == 200 and rep == 1 and healthy == [False, True]
                and trail == [("route", 0), ("reroute", 0), ("route", 1)]
                and router.reroutes_total == 1):
            fails.append("reroute")
        router.check_health_now()

        # 2. A chain on one replica, then a handoff whose import outlasts
        # the timeout (its staged copies never report ready): aborted, the
        # destination unchanged, the source still serving the chain.
        st, src = post("drill-chain")
        dst = 1 - src
        router.check_health_now()
        keys_hex = [k.hex() for k in kvcache.chain_keys(
            prompts["drill-chain"], BLK)]
        dst_cb, src_cb = servers[dst].batcher, servers[src].batcher
        dst_version = dst_cb.kv_digest.summary()["version"]
        src_hbm = src_cb.kv_digest.summary()["hbm_blocks"]
        ready, timeout = serving.restore_ready, router.handoff_timeout_s
        serving.restore_ready = lambda staged: False
        router.handoff_timeout_s = DRILL_HANDOFF_TIMEOUT_S
        try:
            router.migrate_chain(keys_hex, src, dst, request_id="drill-abort")
            idle = router.wait_handoffs(60.0)
        finally:
            serving.restore_ready = ready
            router.handoff_timeout_s = timeout
        h = router.health()["handoff"]
        st2, rep2 = post("drill-revisit")
        dec = route_decision(router, "drill-revisit") or {}
        cells["handoff_abort"] = dict(
            chain_status=st, src=src, dst=dst, keys=len(keys_hex),
            idle=idle, handoff=h,
            dst_aborts=dst_cb.kv_handoff_aborted_total,
            dst_version=(dst_version, dst_cb.kv_digest.summary()["version"]),
            src_hbm=(src_hbm, src_cb.kv_digest.summary()["hbm_blocks"]),
            revisit=dict(status=st2, replica=rep2,
                         policy=dec.get("policy"),
                         hit_depth=dec.get("hit_depth")))
        if not (st == 200 and idle and len(keys_hex) == 8
                and h["aborted_total"] == 1 and h["completed_total"] == 0
                and dst_cb.kv_handoff_aborted_total == 1
                and cells["handoff_abort"]["dst_version"][0]
                == cells["handoff_abort"]["dst_version"][1]
                and src_hbm == cells["handoff_abort"]["src_hbm"][1]
                and st2 == 200 and rep2 == src
                and dec.get("policy") == "cache-aware"
                and dec.get("hit_depth") == 8):
            fails.append("handoff abort")

        # 3. The same chain's handoff completes; the fleet trace links the
        # router's handoff span and both replicas' export/import instants
        # by request id.
        router.migrate_chain(keys_hex, src, dst, request_id="drill-handoff")
        idle = router.wait_handoffs(60.0)
        _, trace = http_json(router.address, "/debug/trace")
        evs = trace["traceEvents"]
        procs = sorted(e["args"]["name"] for e in evs
                       if e.get("ph") == "M" and e.get("name")
                       == "process_name")
        hand = [e["args"] for e in evs if e.get("pid") == 0
                and e.get("name") == "handoff"]
        linked = {(e["name"], e["pid"]) for e in evs
                  if e.get("name") in ("prefix_export", "prefix_import")
                  and (e.get("args") or {}).get("request_id")
                  == "drill-handoff"}
        cells["handoff_trace"] = dict(
            idle=idle, completed=router.health()["handoff"][
                "completed_total"], processes=procs, handoff_span=hand,
            linked=sorted(linked))
        if not (idle and cells["handoff_trace"]["completed"] == 1
                and {"router", "replica-0", "replica-1"} <= set(procs)
                and any(a.get("request_id") == "drill-handoff"
                        and a.get("blocks") == 8 for a in hand)
                and linked == {("prefix_export", 1 + src),
                               ("prefix_import", 1 + dst)}):
            fails.append("handoff trace")

        # 4. The canary drill: replica 1's front door dies (its loop
        # lives on); its canaries fail, its verdict flips, the anomaly
        # counter fires; the postmortem bundle parses.
        servers[1].httpd.shutdown()
        servers[1].httpd.server_close()
        for _ in range(3):
            router.run_canaries_now()
        router.check_health_now()
        _, fleet = http_json(router.address, "/debug/fleet")
        by = {r["replica"]: r for r in fleet["replicas"]}
        samples = prometheus_samples(router.metrics_text())
        st_b, bundle = http_json(router.address, "/debug/bundle")
        cells["canary"] = dict(
            oracle=oracle, verdicts=[by[i]["verdict"] for i in (0, 1)],
            score_1=by[1]["score"], anomalies=fleet["anomalies_total"],
            failures=router.canary_failures_total,
            anomaly_counter=samples.get(
                'llm_router_anomalies_total{signal="canary"}'),
            bundle=dict(status=st_b, kind=bundle.get("kind"),
                        replicas=[b["replica"] for b in bundle.get(
                            "replicas", [])]))
        if not (oracle and by[0]["verdict"] == "healthy"
                and by[1]["verdict"] in ("suspect", "critical")
                and "canary" in by[1]["anomalous"]
                and (cells["canary"]["anomaly_counter"] or 0) >= 1
                and router.canary_failures_total >= 3):
            fails.append("canary")
        if not (st_b == 200 and bundle.get("kind") == "router_bundle"
                and cells["canary"]["bundle"]["replicas"] == [0]):
            fails.append("bundle")
        launches = launch_counts(fa, pa)
        recs = [r for s in servers for r in records(s.batcher)]
    finally:
        router.stop()
        for s in servers:
            s.stop()
    del servers
    torch.cuda.empty_cache()
    want_launches = record_launches(recs, L)
    order = list(prompts)
    divergences = token_divergences(
        torch, ptl, shallow, dcfg, [prompts[r] for r in order],
        [got[r] or [] for r in order], [want[r] for r in order], DRILL_TIE)
    row = dict(phase="router_drill", card=smi, config="llama3-8b",
               n_layers=L, dtype="float32", replicas=2,
               n_slots=DRILL_SLOTS, block_size=BLK, fault="router_replica@0",
               handoff_timeout_s=DRILL_HANDOFF_TIMEOUT_S, **cells,
               launches=launches, expected_launches=want_launches,
               divergences=divergences)
    emit(row)
    if launches != want_launches:
        fails.append("launches")
    if any(got[r] is None or len(got[r]) != DRILL_NEW for r in order):
        fails.append("tokens")
    if fails:
        raise AssertionError(f"router_drill: {fails}")
    return row


# The fleet controller (ROADMAP A12 part 2): fleet_serving at llama3-8b's
# full width, fleet_drill at DECODE_DEPTH layers in float32 activations.
FLEET_BURST = 12          # wave 1: requests per tenant, all together
FLEET_QUEUE_WAIT_HIGH_MS = 250.0  # a replica's queue-wait p90 above it
FLEET_SESSIONS = 2        # wave 2: sessions per new tenant, grown replica
FLEET_CALM_S = 60.0       # the longest wait for the burst's waits to age
FLEET_MEMORY_SLACK = 64 << 20
FLEET_TICK_S = 0.25       # the phase's control period during the burst
FLEET_PERTURB = 0.5       # the rollout drill's final-norm noise, relative


def fleet_send(router, prompts, out, rids, wait=True):
    """``router_stream`` each of ``rids`` together; wait for them, or
    return their threads."""
    import threading

    ts = [threading.Thread(target=router_stream, args=(
        router.address, {"prompt": prompts[r][0],
                         "max_new_tokens": prompts[r][1]}, r, out))
          for r in rids]
    for t in ts:
        t.start()
    if wait:
        for t in ts:
            t.join(timeout=900)
    return ts


def timed(fn):
    t = time.perf_counter()
    res = fn()
    return res, (time.perf_counter() - t) * 1e3


def drive_fleet_serving(torch, np, ptl, fa, pa, params, cfg, tok, smi):
    """Phase ``fleet_serving``: two replicas of llama3-8b at full width
    (``cfg.n_layers`` deep, the phase-3 weights, one copy on the card) at
    router_serving's
    geometry behind the cache-aware router, with a ``FleetController``
    driven by ``tick()`` (module docstring)."""
    import gc

    from jax_llama_tpu_torch import kvcache
    from jax_llama_tpu_torch.router import FleetController, ReplicaRouter
    from jax_llama_tpu_torch.server import LLMServer

    L, BLK = cfg.n_layers, 128
    systems, turns, _ = router_texts(np)
    systems += [prefix_texts(np, seed)[0] for seed in (2, 3)]
    sys_ids = [tok.encode(t, bos=True) for t in systems]
    assert all(len(x) == PREFIX_SYSTEM for x in sys_ids)
    kw = dict(n_slots=ROUTER_SLOTS, max_len=2048, block_size=BLK,
              decode_chunk=8, prefill_budget=FUSED_BUDGET, device="cuda")
    obs_of, embeds, built_ms, pool_bytes = {}, {}, {}, {}

    def make_replica(i):
        t = time.perf_counter()
        cb = ptl.ContinuousBatcher(params, cfg, seed=i, **kw)
        obs_of[i] = cb.obs
        embeds[i] = cb.params["embed"]["embedding"].data_ptr()
        pool_bytes[i] = cb.block_bytes * cb.n_blocks
        srv = LLMServer(cb, tokenizer=tok, replica_id=i).start()
        built_ms[i] = (time.perf_counter() - t) * 1e3
        return srv

    prompts, out = {}, {}

    def add(rid, ids):
        prompts[rid] = (ids, ROUTER_NEW)
        return rid

    servers = {i: make_replica(i) for i in range(2)}
    router = ReplicaRouter(list(servers.values()), policy="cache-aware",
                           health_interval_s=0, canary_interval_s=0,
                           tokenizer=tok, block_size=BLK).start()
    ctrl = FleetController(
        router, replica_factory=make_replica, min_replicas=2,
        max_replicas=3, interval_s=0, dwell_s=0.0, cooldown_s=0.0,
        queue_wait_high_ms=FLEET_QUEUE_WAIT_HIGH_MS)
    fails, cells = [], {}
    try:
        # One short request straight to each seed first: a serving loop's
        # first GEMM allocates its thread's cuBLAS workspace, which the
        # baseline must hold.
        for srv in servers.values():
            http_request(srv.address, "/generate",
                         {"prompt": [1, 2, 3], "max_new_tokens": 4})
        seq0 = {i: max(r["seq"] for r in obs_of[i].dispatches_json(
            1 << 16)["dispatches"]) for i in servers}
        torch.cuda.synchronize()
        gc.collect()
        mem_before_up = torch.cuda.memory_allocated()
        zero_counts(fa, pa)
        t_phase = time.perf_counter()
        # 1. Pressure: the two tenants' burst, more requests than slots,
        # with a health poll and a tick every FLEET_TICK_S until one
        # scales up (the waits of the burst's queued admissions are the
        # pressure; they age out of a replica's 10 s signal window).
        burst = [add(f"burst-{t}-{j}",
                     sys_ids[t] + tok.encode(turns[t][j % len(turns[t])]))
                 for j in range(FLEET_BURST) for t in (0, 1)]
        burst_threads = fleet_send(router, prompts, out, burst, wait=False)
        hold_ms, up = [], {}
        while True:
            router.check_health_now()
            up, up_ms = timed(ctrl.tick)
            if up.get("action") != "hold":
                break
            hold_ms.append(up_ms)
            if not any(t.is_alive() for t in burst_threads):
                break
            time.sleep(FLEET_TICK_S)
        grown = up.get("replica")
        if grown is not None:
            # The rest of the burst stays on the seeds (no late pick, no
            # spill's handoff onto the grown replica): its chains are the
            # sessions' below, so the drain moves each of them.
            router.set_retiring(grown)
        for t in burst_threads:
            t.join(timeout=900)
        if grown is not None:
            router.set_retiring(grown, False)
        cells["scale_up"] = dict(
            action=up.get("action"), reason=up.get("reason"),
            replica=grown, signals=up.get("signals"), tick_ms=up_ms,
            holds_before=len(hold_ms),
            factory_ms=built_ms.get(grown),
            shares_embedding=embeds.get(grown) == embeds[0],
            replicas=len(router.health()["replicas"]))
        if not (up.get("action") == "up" and grown == 2
                and cells["scale_up"]["shares_embedding"]
                and router.health()["replicas"][2]["healthy"]):
            raise AssertionError(f"fleet_serving: no scale-up {cells}")

        # 2. Live sessions on the grown replica (the seeds retired from
        # picks meanwhile): two new tenants' sessions, then one hit each
        # on the holder.
        for i in servers:
            router.set_retiring(i)
        sessions = [add(f"session-{t}-{j}", sys_ids[2 + t]
                        + tok.encode(turns[t][j]))
                    for t in (0, 1) for j in range(FLEET_SESSIONS)]
        fleet_send(router, prompts, out, sessions)
        router.check_health_now()
        holder = [add(f"holder-{t}", prompts[f"session-{t}-0"][0])
                  for t in (0, 1)]
        fleet_send(router, prompts, out, holder)
        for i in servers:
            router.set_retiring(i, False)
        torch.cuda.synchronize()
        gc.collect()
        mem_three = torch.cuda.memory_allocated()
        # Calm: the burst's queue waits age out of the replicas' signal
        # windows.
        t_calm = time.perf_counter()
        while True:
            router.check_health_now()
            sig = ctrl.signals()
            qw = sig["queue_wait_ms_p90_max"]
            if ((qw is None or qw <= ctrl.queue_wait_high_ms)
                    and sig["occupancy_max"] is not None
                    and sig["occupancy_max"] <= ctrl.occupancy_low):
                break
            if time.perf_counter() - t_calm > FLEET_CALM_S:
                raise AssertionError(f"fleet_serving: never calm {sig}")
            time.sleep(0.25)
        calm_wait_s = time.perf_counter() - t_calm
        chains = {rep.index: rep.server.call_on_loop(
            lambda b: b.resident_chain_keys())
            for rep in router._replicas if not rep.retired}
        down, down_ms = timed(ctrl.tick)
        victim = down.get("replica")
        drain = down.get("drain") or {}
        _, scale_decs = http_json(router.address,
                                  "/debug/decisions?kind=scale")
        verdicts = [d.get("sentinel") for d in scale_decs["decisions"]
                    if d.get("action") == "down"]
        cells["scale_down"] = dict(
            action=down.get("action"), reason=down.get("reason"),
            replica=victim, victim_verdict=verdicts[-1] if verdicts else None,
            verdicts={i: router.sentinel.verdict(i) for i in chains},
            signals=down.get("signals"), tick_ms=down_ms,
            calm_wait_s=calm_wait_s,
            chains={i: len(c) for i, c in chains.items()}, drain=drain)
        if not (down.get("action") == "down" and victim == grown
                and cells["scale_down"]["victim_verdict"] == "healthy"
                and drain.get("ok")
                and drain.get("migrated") == len(chains[victim])
                and drain.get("skipped") == 0):
            raise AssertionError(f"fleet_serving: scale-down {cells}")
        gc.collect()
        torch.cuda.synchronize()
        mem_after = torch.cuda.memory_allocated()
        # 3. Each session's revisit on its new home.
        router.check_health_now()
        revisits = [add(f"revisit-{t}", prompts[f"session-{t}-0"][0])
                    for t in (0, 1)]
        fleet_send(router, prompts, out, revisits)
        phase_s = time.perf_counter() - t_phase
        launches = launch_counts(fa, pa)
        instances = instance_counts(fa, pa)
        decisions = {r: route_decision(router, r) for r in holder + revisits}
        stats = {i: s.batcher.stats() for i, s in servers.items()}
        health = router.health()
        samples = prometheus_samples(router.metrics_text())
        recs = [r for i, o in obs_of.items()
                for r in o.dispatches_json(1 << 16)["dispatches"]
                if r["seq"] > seq0.get(i, -1)]
    finally:
        ctrl.close(stop_owned=True)
        router.stop()
        for s in servers.values():
            s.stop()
    # The migration's copies alone, on the stopped survivors: a migrated
    # chain exported from its new home and imported into the other.
    home = out["revisit-0"].get("replica")
    other = next(i for i in servers if i != home)
    chain = kvcache.chain_keys(prompts["revisit-0"][0], BLK)
    torch.cuda.synchronize()
    t = time.perf_counter()
    keys_out, slabs = servers[home].batcher.export_prefix(keys=chain)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    landed = servers[other].batcher.import_prefix(keys_out, slabs)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    block_bytes = servers[home].batcher.block_bytes
    copies = dict(blocks=len(slabs), landed=landed,
                  bytes=len(slabs) * block_bytes,
                  export_ms=(t1 - t) * 1e3, import_ms=(t2 - t1) * 1e3,
                  gb_per_s=len(slabs) * block_bytes / ((t2 - t) * 1e3) / 1e6)
    del servers, slabs
    torch.cuda.empty_cache()

    order = list(prompts)
    got = {r: out[r]["tokens"] for r in order}
    first = {f"holder-{t}": f"session-{t}-0" for t in (0, 1)}
    first.update({f"revisit-{t}": f"session-{t}-0" for t in (0, 1)})
    divergences = token_divergences(
        torch, ptl, params, cfg, [prompts[r][0] for r in first],
        [got[r] for r in first], [got[first[r]] for r in first], DECODE_REL)
    want_launches = record_launches(recs, L)
    migrated = drain.get("migrated") or 0
    row = dict(
        phase="fleet_serving", card=smi, config="llama3-8b", n_layers=L,
        dtype="bfloat16", replicas=dict(seed=2, min=2, max=3),
        n_slots=ROUTER_SLOTS, max_len=2048, block_size=BLK, decode_chunk=8,
        prefill_budget=FUSED_BUDGET, policy="cache-aware",
        queue_wait_high_ms=FLEET_QUEUE_WAIT_HIGH_MS, dwell_s=0.0,
        cooldown_s=0.0, burst=len(burst), sessions=len(sessions), **cells,
        hold_tick_ms=dict(p50=float(np.median(hold_ms)) if hold_ms
                          else None, max=max(hold_ms, default=None),
                          n=len(hold_ms)),
        factory_ms=built_ms.get(grown),
        drain_ms=drain.get("dur_ms"), sessions_migrated=migrated,
        blocks_migrated=drain.get("blocks"),
        bytes_migrated=(drain.get("blocks") or 0) * block_bytes,
        destinations=drain.get("destinations"),
        migration_copies=copies,
        replica_of={r: out[r].get("replica") for r in order},
        statuses={r: out[r].get("status") for r in order},
        errors={r: out[r]["error"] for r in order if "error" in out[r]},
        hit_depth={r: (decisions[r] or {}).get("hit_depth")
                   for r in decisions},
        revisit_ttft_ms={r: out[r]["ttft_ms"] for r in holder + revisits},
        revisit_ttft_is="the client's TTFT through the router: holder-* "
        "hit the grown replica before the drain, revisit-* the same "
        "prompts on their new homes after it",
        memory_bytes=dict(before_burst=mem_before_up,
                          three_replicas=mem_three, after_retire=mem_after,
                          difference=mem_after - mem_before_up,
                          freed=mem_three - mem_after,
                          grown_pool=pool_bytes.get(grown)),
        prefix_hits={i: s["prefix_requests_hit_total"]
                     for i, s in stats.items()},
        scale_events={k: samples.get(
            f'llm_fleet_scale_events_total{{action="{k}"}}')
            for k in ("up", "down", "deferred", "aborted")},
        sessions_migrated_metric=samples.get("llm_sessions_migrated_total"),
        launches=launches, expected_launches=want_launches,
        instances={k: instances[k] for k in (
            "flash_fwd_by_instance", "paged_by_instance",
            "paged_kernel_launches")},
        replicas_served=sorted(obs_of), wall_s=phase_s,
        divergences_from_first_turn=divergences)
    emit(row)
    if row["errors"] or set(row["statuses"].values()) != {200}:
        fails.append("statuses")
    if any(len(out[r]["tokens"]) != prompts[r][1]
           or out[r].get("final") != out[r]["tokens"] for r in order):
        fails.append("a stream did not end with its max_new tokens")
    if any(out[r]["replica"] != grown for r in sessions + holder):
        fails.append("the sessions did not reach the grown replica")
    dests = {int(k) for k in (drain.get("destinations") or {})}
    for r in holder + revisits:
        home_r = out[r]["replica"]
        if r in revisits and home_r not in dests:
            fails.append(f"{r} not on a migration destination")
        if row["hit_depth"][r] != len(chain):
            fails.append(f"{r} not a {len(chain)}-block hit")
    if abs(row["memory_bytes"]["difference"]) > FLEET_MEMORY_SLACK:
        fails.append("memory not back after the retire")
    if row["memory_bytes"]["freed"] < pool_bytes[grown]:
        fails.append("the retired replica's pool not freed")
    if launches != want_launches or instances["flash_fwd_by_instance"] != (
            {"wgmma": launches["flash_fwd"]}) or (
            instances["paged_kernel_launches"]
            != 2 * launches["paged_decode"]):
        fails.append("launches")
    if not any(r["kind"] in ("decode", "fused") for r in
               obs_of[grown].dispatches_json(1 << 16)["dispatches"]):
        fails.append("the grown replica launched no kernel")
    if copies["blocks"] != len(chain) or copies["landed"] != len(chain):
        fails.append(f"the migration's copies {copies}")
    if fails:
        raise AssertionError(f"fleet_serving: {fails}")
    return row


def drive_fleet_drill(torch, np, ptl, fa, pa, params, cfg, tok, smi):
    """Phase ``fleet_drill``: a fleet at DECODE_DEPTH layers in float32
    activations behind the cache-aware router with a ``FleetController``
    driven by hand (module docstring)."""
    from jax_llama_tpu_torch.faults import FaultInjector
    from jax_llama_tpu_torch.router import FleetController, ReplicaRouter
    from jax_llama_tpu_torch.server import LLMServer

    L, BLK = DECODE_DEPTH, 128
    shallow = dict(params, layers={k: w[:L]
                                   for k, w in params["layers"].items()})
    dcfg = cfg.replace(n_layers=L, dtype="float32")
    kw = dict(n_slots=DRILL_SLOTS, max_len=2048, block_size=BLK,
              decode_chunk=8, prefill_budget=FUSED_BUDGET, device="cuda")
    # New weights for the bad rollout: every tensor shared with the served
    # tree but the final norm's weight, under seeded relative noise (a
    # uniform scale would keep every argmax).
    g = torch.Generator(device="cuda").manual_seed(7)
    w = shallow["final_norm"]
    noise = torch.randn(w.shape, generator=g, device="cuda")
    perturbed = dict(shallow, final_norm=(w.float() * (
        1 + FLEET_PERTURB * noise)).to(w.dtype))
    systems, turns, _ = router_texts(np)
    sys_ids = [tok.encode(s, bos=True) for s in systems]
    prompts = {"session": sys_ids[0] + tok.encode(turns[0][0]),
               "other": sys_ids[1] + tok.encode(turns[1][0])}
    ref = ptl.ContinuousBatcher(shallow, dcfg, **kw)
    want = {}
    for name, p in prompts.items():
        x = ref.submit(p, max_new_tokens=DRILL_NEW)
        want[name] = ref.run_to_completion()[x]
    del ref
    made, obs_all = [], []

    def make(i, p=shallow):
        cb = ptl.ContinuousBatcher(p, dcfg, seed=i, **kw)
        obs_all.append(cb.obs)
        srv = LLMServer(cb, tokenizer=tok, replica_id=i).start()
        made.append(srv)
        return srv

    servers = [make(i) for i in range(2)]
    router = ReplicaRouter(servers, policy="cache-aware",
                           health_interval_s=0, canary_interval_s=0,
                           tokenizer=tok, block_size=BLK).start()
    ctrl = FleetController(router, replica_factory=make, min_replicas=1,
                           max_replicas=3, interval_s=0)
    got, sent, cells, fails = {}, [], {}, []

    def post(rid, name):
        st, hdrs, body = http_request(
            router.address, "/generate",
            {"prompt": prompts[name], "max_new_tokens": DRILL_NEW},
            headers={"X-Request-Id": rid})
        got[rid] = json.loads(body)["tokens"] if st == 200 else None
        sent.append((rid, name))
        dec = route_decision(router, rid) or {}
        return dict(status=st, replica=int(hdrs.get("X-Replica-Id", -1)),
                    hit_depth=dec.get("hit_depth"))

    def membership():
        return [(r.index, id(r.server) if r.server else None, r.retired,
                 r.retiring) for r in router._replicas]

    try:
        zero_counts(fa, pa)
        router.check_health_now()
        # 1. scale_event aborts a scale-up (call 0) and a scale-down (call
        # 1): membership unchanged, nothing built.
        before, n_made = membership(), len(made)
        ctrl.fault_injector = FaultInjector(
            "scale_event@0:error,scale_event@1:error")
        up, down = ctrl.scale_up(), ctrl.scale_down()
        ctrl.fault_injector = None
        cells["scale_event"] = dict(up=up, down=down,
                                    unchanged=membership() == before,
                                    built=len(made) - n_made)
        if not (up["ok"] is False and down["ok"] is False
                and "injected" in up["reason"]
                and "injected" in down["reason"]
                and membership() == before and len(made) == n_made):
            fails.append("scale_event")

        # 2. session_migrate fails the one session's move: the drain
        # reports it, the source resumes and the revisit hits there.
        first = post("migrate-first", "session")
        src = first["replica"]
        router.check_health_now()
        chains = servers[src].call_on_loop(lambda b: b.resident_chain_keys())
        ctrl.fault_injector = FaultInjector("session_migrate@0:error")
        rep = ctrl.drain_replica(src)
        ctrl.fault_injector = None
        snap = router.health()["replicas"][src]
        revisit = post("migrate-revisit", "session")
        cells["session_migrate"] = dict(
            first=first, chains=len(chains), drain=rep, revisit=revisit,
            resumed=not snap["retiring"] and not snap["retired"])
        if not (rep["ok"] is False and rep["reason"] == "migration-failures"
                and rep["failed"] == 1 and rep["migrated"] == 0
                and len(chains) == 1
                and cells["session_migrate"]["resumed"]
                and revisit["replica"] == src
                and revisit["hit_depth"] == len(chains[0])):
            fails.append("session_migrate")

        # 3. A rollout on the same weights: every rung passes its gate,
        # the final sweep is clean.
        router.run_canaries_now()
        _, fleet = http_json(router.address, "/debug/fleet")
        oracle = fleet["canary"]["oracle_tokens"]
        same, same_ms = timed(lambda: ctrl.rollout(make))
        _, rungs = http_json(router.address,
                             "/debug/decisions?kind=rollout_rung")
        gates = [d.get("gate") for d in rungs["decisions"]]
        after_same = post("after-rollout", "session")
        cells["rollout_same"] = dict(result=same, ms=same_ms, gates=gates,
                                     after=after_same)
        if not (same["ok"] and same["planned"] == 2
                and gates == ["oracle-pinned", "oracle-match"]
                and after_same["status"] == 200):
            fails.append("rollout_same")

        # 4. A rollout to the perturbed tree, gated on the old canary
        # tokens: rung 0 fails its gate and rolls back; the fleet then
        # serves the old weights' tokens.
        n_rungs = len(rungs["decisions"])
        bad, bad_ms = timed(lambda: ctrl.rollout(
            lambda i: make(i, perturbed), rollback_factory=make,
            expect_tokens=oracle))
        _, rungs = http_json(router.address,
                             "/debug/decisions?kind=rollout_rung")
        bad_rungs = rungs["decisions"][n_rungs:]
        sweep = dict(router.run_canaries_now())
        after_bad = [post(f"after-rollback-{j}", "session") for j in (0, 1)]
        cells["rollout_bad"] = dict(
            result=bad, ms=bad_ms, rungs=bad_rungs,
            canary_tokens={i: r.get("tokens") for i, r in sweep.items()},
            oracle=oracle, after=after_bad,
            rollbacks=ctrl.state_json()["rollbacks_total"])
        if not (bad["ok"] is False and len(bad["rungs"]) == 1
                and bad["rungs"][0].get("rollback") == "rolled-back"
                and "oracle-mismatch" in (bad_rungs[-1].get("reason") or "")
                and all(r.get("tokens") == oracle for r in sweep.values())
                and all(a["status"] == 200 for a in after_bad)):
            fails.append("rollout_bad")

        # 5. A replica made non-healthy (three failed canaries fed to the
        # sentinel) is not the victim of a scale-down.
        grow = ctrl.scale_up()
        for _ in range(3):
            router.sentinel.observe_canary(0, ok=False, error="fleet_drill")
        sick = router.sentinel.verdict(0)
        down = ctrl.scale_down()
        router.sentinel.forget(0)
        router.check_health_now()
        cells["victim"] = dict(grew=grow.get("replica"), sick_verdict=sick,
                               result={k: down.get(k) for k in (
                                   "ok", "replica", "reason")},
                               drain=down.get("drain"))
        if not (grow["ok"] and sick != "healthy" and down["ok"]
                and down["replica"] != 0):
            fails.append("victim")

        # 6. A drain with no survivor (the other replica retiring) fails
        # cleanly: the replica resumes and its session still hits there.
        router.set_retiring(1)
        held = post("no-survivor-first", "other")
        router.check_health_now()
        lone = ctrl.drain_replica(held["replica"])
        router.set_retiring(1, False)
        snap = router.health()["replicas"][held["replica"]]
        again = post("no-survivor-revisit", "other")
        cells["no_survivor"] = dict(first=held, drain=lone, revisit=again,
                                    resumed=not snap["retiring"])
        if not (lone["ok"] is False and lone["reason"] == "no-survivor"
                and cells["no_survivor"]["resumed"]
                and again["replica"] == held["replica"]
                and again["hit_depth"] == len(chains[0])):
            fails.append("no_survivor")
        launches = launch_counts(fa, pa)
        recs = [r for o in obs_all
                for r in o.dispatches_json(1 << 16)["dispatches"]]
        state = ctrl.state_json()
    finally:
        ctrl.close(stop_owned=True)
        router.stop()
        for s in made:
            s.stop()
    del made, servers
    torch.cuda.empty_cache()
    want_launches = record_launches(recs, L)
    order = [rid for rid, _ in sent]
    divergences = token_divergences(
        torch, ptl, shallow, dcfg, [prompts[n] for _, n in sent],
        [got[rid] or [] for rid in order], [want[n] for _, n in sent],
        DRILL_TIE)
    row = dict(phase="fleet_drill", card=smi, config="llama3-8b",
               n_layers=L, dtype="float32", replicas=2,
               n_slots=DRILL_SLOTS, block_size=BLK, **cells,
               controller=state, instances_built=len(obs_all),
               launches=launches, expected_launches=want_launches,
               divergences=divergences)
    emit(row)
    if launches != want_launches:
        fails.append("launches")
    if any(got[rid] is None or len(got[rid]) != DRILL_NEW for rid in order):
        fails.append("a session dropped")
    if fails:
        raise AssertionError(f"fleet_drill: {fails}")
    return row


# ---------------------------------------------------------------------------
# Tensor and data parallelism (ROADMAP A14 part 1)
# ---------------------------------------------------------------------------

# At tensor = 2 a llama3-8b rank's kernels see half the heads: H = 16 over
# KVH = 4 (G = 4 as unsharded).
SHARD_TP = 2
SHARD_H, SHARD_KVH = 32 // SHARD_TP, 8 // SHARD_TP
# The mesh phases: MESH_RANKS ranks spawned once on cuda:0 over gloo (NCCL
# refuses two ranks on one device); mesh_serving runs the serving phase's
# first MESH_SERVE requests at DECODE_DEPTH layers; its data cell serves
# two prompts in one insert, then a prompt on the second one's first
# MESH_HIT_BLOCKS blocks.
MESH_RANKS = 2
MESH_SERVE = 6
MESH_PREFIX_TOKENS = 300
MESH_HIT_BLOCKS = 2
MESH_NEW = 16
MESH_WAIT_S = 300


def shard_kernel_row(torch, kernel, shape, args_desc, out, ref, instance,
                     want, cold, plain, library, bound, device_ms, extra):
    """One ``kernel_check`` row at a tensor = 2 rank's shape (emitted);
    raises unless the worst row is within REL_BOUND and the instance is
    the expected one."""
    rel = row_rel_err(torch, out, ref)
    ms = time_ms(torch, cold, iters=4 * len(cold))
    plain_ms = time_ms(torch, plain, iters=len(plain), warmup=1)
    library_ms = time_ms(torch, library, iters=4 * len(library))
    bound_ms, bound_by = bound
    row = dict(phase="kernel_check", kernel=kernel, shape=shape,
               tensor=SHARD_TP, **args_desc, dtype="bfloat16",
               instance=instance, worst_row_rel=rel, rel_bound=REL_BOUND,
               ms=ms, device_ms=device_ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
               roofline_share=bound_ms / ms,
               device_roofline_share=(bound_ms / device_ms if device_ms
                                      else None), **extra)
    emit(row)
    if not (rel < REL_BOUND and instance == want
            and bool(torch.isfinite(out).all())):
        raise AssertionError(
            f"{kernel} at tensor={SHARD_TP} ({shape}): worst row {rel} of "
            f"its max |plain| (bound {REL_BOUND}), instance {instance} "
            f"(expected {want})")
    return row


def paged_library(torch, q, k, v, pos, table, q_pos, k_new=None, v_new=None):
    """SDPA over views of the attended slots gathered beforehand (the
    gather not timed; the step's own slot appended for stock-paged),
    enough layers that the views exceed L2 four times."""
    import torch.nn.functional as F

    L, KVH, NB, BLK, d = k.shape
    B = q.shape[0]
    if k_new is None:
        blk, allowed = paged_gathered_mask(torch, pos, table, q_pos)
        qt = q.reshape(B, -1, 1, d)
    else:
        blk = table.long().clamp(0, NB - 1)
        allowed = stock_attended(torch, table, q_pos, NB, BLK)
        allowed = torch.cat([allowed, torch.ones_like(allowed[:, :1])], 1)
        qt = q.transpose(1, 2)
    mask = allowed[:, None, None, :]
    view_bytes = 2 * KVH * (blk.numel() * BLK + B) * d * k.element_size()
    n_views = max(2, -(-4 * L2_BYTES // view_bytes))
    views = []
    for i in range(n_views):
        kv = []
        for t, new in ((k, k_new), (v, v_new)):
            g = t[i % L][:, blk].reshape(KVH, B, -1, d).transpose(0, 1)
            if new is not None:
                g = torch.cat([g, new.transpose(1, 2)], dim=2)
            kv.append(g.contiguous())
        views.append(tuple(kv))
    return [lambda kg=kg, vg=vg: F.scaled_dot_product_attention(
        qt, kg, vg, attn_mask=mask, enable_gqa=True) for kg, vg in views]


def check_shard_kernels(torch, fa, pa, kn, gen, paged_instance):
    """``kernel_check`` cells at a tensor = 2 rank's shapes (H = 16, KVH =
    4, d = 128, bf16), each held against its plain version: the flash
    forward at the serving insert (8 rows, T = S = 1024), the paged
    decode at the serving shape (8 rows, T = 1), stock-paged at the same
    shape with the step's own slot, splash at the insert (B = 8, T = S =
    1024, offset 0); each with its cold-L2 time, device time, plain and
    library times and bound.  The paged decode must run the instance the
    full-shape check ran (``paged_instance``: the same G and T)."""
    rows = {}
    bf16 = torch.bfloat16

    # Row 1: the flash forward.
    args = flash_inputs(torch, "insert", gen, H=SHARD_H, KVH=SHARD_KVH)
    q, k = args[0], args[1]
    want = fa.flash_instance(q.dtype, q.shape[3], q.shape[1], k.shape[1],
                             q.shape[2] // k.shape[2])
    before = dict(fa.flash_attention.launches_by_instance)
    out = fa.flash_attention(*args)
    torch.cuda.synchronize()
    inst = ran_instance(fa.flash_attention.launches_by_instance, before)
    copies = cold_copies(args)
    cold = [lambda a=a: fa.flash_attention(*a) for a in copies]
    rows["flash_fwd"] = shard_kernel_row(
        torch, "flash_fwd", "tp2_insert",
        dict(B=q.shape[0], T=q.shape[1], S=k.shape[1], H=q.shape[2],
             KVH=k.shape[2], d=q.shape[3]),
        out, fa.flash_attention_reference(*args), inst, want, cold,
        [lambda a=a: fa.flash_attention_reference(*a) for a in copies],
        [library_attention(torch, *a) for a in copies], flash_bound(*args),
        kernel_device_ms(torch, cold, ("flash_fwd",)), {})
    del copies, cold

    # Row 4: the paged decode.
    args = paged_inputs(torch, gen, KVH=SHARD_KVH)
    q, k, v, pos, table, q_pos = args
    L = k.shape[0]
    before = dict(pa.paged_pool_attention.launches_by_instance)
    out, lse = pa.paged_pool_attention(*args, layer=L - 1)
    torch.cuda.synchronize()
    inst = ran_instance(pa.paged_pool_attention.launches_by_instance, before)
    ref, ref_lse = pa.paged_pool_attention_reference(*args, layer=L - 1)
    live = (ref_lse > pa.MASK_VALUE / 2).all(dim=(1, 2))
    cold = [lambda i=i: pa.paged_pool_attention(*args, layer=i)
            for i in range(L)]
    rows["paged_decode"] = shard_kernel_row(
        torch, "paged_decode", "tp2_serving",
        dict(B=q.shape[0], KVH=q.shape[1], G=q.shape[2], d=q.shape[3],
             L=L, fills=list(PAGED_FILLS)),
        out[live], ref[live], inst, paged_instance,
        cold, [lambda i=i: pa.paged_pool_attention_reference(
            *args, layer=i) for i in range(L)],
        paged_library(torch, *args), paged_bound(torch, q, k, pos, table,
                                                  q_pos),
        kernel_device_ms(torch, cold, ("paged_decode",)),
        dict(lse_max_abs_err=(lse - ref_lse)[
            ref_lse > pa.MASK_VALUE / 2].abs().max().item()))
    del cold

    # Row 5: stock-paged, the step's own K/V merged in.
    B, KVH, G, d = q.shape
    qs = q.reshape(B, 1, KVH * G, d)
    k_new, v_new = (torch.randn(B, 1, KVH, d, device="cuda", generator=gen)
                    .to(bf16) for _ in range(2))
    sargs = (qs, k_new, v_new, k, v, table, q_pos)
    before = dict(kn.stock_paged_decode.launches_by_instance)
    out = kn.stock_paged_decode(*sargs, layer=L - 1)
    torch.cuda.synchronize()
    inst = ran_instance(kn.stock_paged_decode.launches_by_instance, before)
    ref = kn.stock_paged_decode_reference(*sargs, layer=L - 1)
    live = q_pos >= 0
    cold = [lambda i=i: kn.stock_paged_decode(*sargs, layer=i)
            for i in range(L)]
    rows["stock_paged"] = shard_kernel_row(
        torch, "stock_paged", "tp2_serving",
        dict(B=B, KVH=KVH, G=G, d=d, L=L), out[live], ref[live], inst,
        kn.stock_instance(bf16, bf16), cold,
        [lambda i=i: kn.stock_paged_decode_reference(*sargs, layer=i)
         for i in range(L)],
        paged_library(torch, qs, k, v, pos, table, q_pos, k_new, v_new),
        stock_bound(torch, qs, k, table, q_pos, PEAK_BF16_FLOPS),
        device_ms_per_launch(torch, cold, ("stock_split", "stock_combine"),
                             "stock_split")[0], {})
    del cold, args, sargs, k, v

    # Row 6: splash at the insert.
    import torch.nn.functional as F

    B, T, S, off = SPLASH_SHAPES["insert"]
    args = tuple(torch.randn(sh, device="cuda", generator=gen).to(bf16)
                 for sh in ((B, T, SHARD_H, 128), (B, S, SHARD_KVH, 128),
                            (B, S, SHARD_KVH, 128)))
    before = dict(kn.splash_prefill.launches_by_instance)
    out = kn.splash_prefill(*args, chunk_offset=off)
    torch.cuda.synchronize()
    inst = ran_instance(kn.splash_prefill.launches_by_instance, before)
    copies = cold_copies(args)
    cold = [lambda a=a: kn.splash_prefill(*a, chunk_offset=off)
            for a in copies]
    mask = (torch.arange(S, device="cuda")[None, :]
            <= torch.arange(T, device="cuda")[:, None] + off)
    rows["splash_prefill"] = shard_kernel_row(
        torch, "splash_prefill", "tp2_insert",
        dict(B=B, T=T, S=S, H=SHARD_H, KVH=SHARD_KVH, d=128,
             chunk_offset=off),
        out, kn.splash_prefill_reference(*args, chunk_offset=off), inst,
        kn.splash_instance(bf16), cold,
        [lambda a=a: kn.splash_prefill_reference(*a, chunk_offset=off)
         for a in copies],
        [lambda a=a: F.scaled_dot_product_attention(
            *(x.transpose(1, 2) for x in a), attn_mask=mask,
            enable_gqa=True) for a in copies],
        splash_bound(args[0], args[1], off, PEAK_BF16_FLOPS),
        device_ms_per_launch(torch, cold, ("splash_",), "splash_")[0], {})
    return rows


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def mesh_collectives(mesh):
    return {"/".join((kind,) + axes): n
            for (kind, axes), n in sorted(mesh.collectives.items())}


def mesh_serve(torch, ptl, fa, pa, params, cfg, mesh, prompts, max_new):
    """The serving phase's batcher (8 slots, max_len 2048, decode_chunk
    8) over ``mesh`` (None: unsharded), the first half of ``prompts``
    submitted at once and the rest after two steps; counted from zero."""
    cb = ptl.ContinuousBatcher(params, cfg, n_slots=8, max_len=2048,
                               decode_chunk=8, device="cuda", mesh=mesh)
    return mesh_traffic(torch, fa, pa, cb, mesh,
                        [list(zip(prompts, max_new))[:len(prompts) // 2],
                         list(zip(prompts, max_new))[len(prompts) // 2:]],
                        at_step=2)


def mesh_traffic(torch, fa, pa, cb, mesh, waves, at_step=None):
    """Serve ``waves`` of (prompt, max_new): the second wave after
    ``at_step`` steps, or once the first has drained.  Returns the tokens
    in submission order and the host state every rank must share."""
    zero_counts(fa, pa)
    if mesh is not None:
        mesh.collectives.clear()
    order, out = [], {}
    for p, n in waves[0]:
        order.append(cb.submit(p, max_new_tokens=n))
    pending = list(waves[1:])
    steps = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    while cb.pending() or pending:
        if pending and (steps == at_step if at_step is not None
                        else not cb.pending()):
            for p, n in pending.pop(0):
                order.append(cb.submit(p, max_new_tokens=n))
        for rid, tok_id, *_ in cb.step():
            out.setdefault(rid, []).append(tok_id)
        steps += 1
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t
    digest = cb.kv_digest.summary()
    digest.pop("epoch")  # a per-store random token
    st = cb.stats()
    return dict(tokens=[out.get(r, []) for r in order],
                launches=launch_counts(fa, pa),
                flash_by_instance=dict(
                    fa.flash_attention.launches_by_instance),
                table=cb.table.tolist(), free=sorted(cb.free_blocks),
                digest=digest, steps=steps, serve_s=serve_s,
                pool_k=list(cb.pool.k.shape),
                prefix_hits=st["prefix_requests_hit_total"],
                prefix_blocks_reused=cb.prefix_blocks_reused,
                inserts=st["insert_dispatches_total"],
                serve_mesh=cb.describe()["serve_mesh"],
                collectives=mesh_collectives(mesh) if mesh is not None
                else {})


def mesh_prefix_waves(tok):
    """The data cell's traffic: two MESH_PREFIX_TOKENS-token prompts in
    one insert (each data rank computes one row), then a prompt on the
    second one's first MESH_HIT_BLOCKS blocks."""
    texts = serve_texts()
    a = tok.encode(texts[2], bos=True)[:MESH_PREFIX_TOKENS]
    b = tok.encode(texts[6], bos=True)[:MESH_PREFIX_TOKENS]
    hit = b[:MESH_HIT_BLOCKS * 128] + a[1:41]
    return [[(a, MESH_NEW), (b, MESH_NEW)], [(hit, MESH_NEW)]]


def mesh_cell_generate(torch, state, tokens, mask, max_new):
    """mesh_generate on one rank: the seed-0 llama3-8b tree drawn as this
    rank's tensor = 2 shard, then ``engine.generate`` on the mesh."""
    import jax_llama_tpu_torch as ptl
    from jax_llama_tpu_torch import engine
    from jax_llama_tpu_torch.parallel import make_mesh

    fa, pa = state["fa"], state["pa"]
    mesh = make_mesh(tensor=MESH_RANKS, devices=["cuda:0"] * MESH_RANKS)
    cfg = ptl.get_config("llama3-8b", param_dtype="bfloat16",
                         dtype="bfloat16", attn_impl="auto")
    t = time.perf_counter()
    params = ptl.init_params(cfg, seed=0, device="cuda", mesh=mesh)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    state.update(mesh=mesh, params=params, cfg=cfg)
    gc = engine.GenerationConfig(max_new_tokens=max_new, temperature=0.0)
    zero_counts(fa, pa)
    mesh.collectives.clear()
    t = time.perf_counter()
    out = engine.generate(params, tokens.cuda(), mask.cuda(), config=cfg,
                          gen_config=gc, device="cuda", mesh=mesh)
    torch.cuda.synchronize()
    return dict(tokens=out.cpu().tolist(), init_s=init_s,
                generate_s=time.perf_counter() - t,
                launches=launch_counts(fa, pa),
                flash_by_instance=dict(
                    fa.flash_attention.launches_by_instance),
                collectives=mesh_collectives(mesh),
                weight_bytes=tree_bytes(params),
                qkv=list(params["layers"]["qkv"].shape),
                device=str(mesh.device), rank=mesh.rank)


def mesh_cell_serve_tp(torch, state, prompts, max_new, dtype):
    """mesh_serving's tensor = 2 cells on one rank: the first DECODE_DEPTH
    layers of this rank's shard, in ``dtype`` activations."""
    import jax_llama_tpu_torch as ptl

    p = state["params"]
    p8 = dict(p, layers={k: w[:DECODE_DEPTH] for k, w in p["layers"].items()})
    return mesh_serve(torch, ptl, state["fa"], state["pa"], p8,
                      state["cfg"].replace(n_layers=DECODE_DEPTH,
                                          dtype=dtype),
                      state["mesh"], prompts, max_new)


def mesh_cell_serve_dp(torch, state, waves):
    """mesh_serving's data = 2 cell on one rank: the DECODE_DEPTH-layer
    seed-0 tree whole on each rank (tensor = 1), rows split over data."""
    import gc

    import jax_llama_tpu_torch as ptl
    from jax_llama_tpu_torch.parallel import make_mesh

    state.pop("params", None)
    gc.collect()
    torch.cuda.empty_cache()
    mesh = make_mesh(data=MESH_RANKS, devices=["cuda:0"] * MESH_RANKS)
    cfg8 = ptl.get_config("llama3-8b", param_dtype="bfloat16",
                          dtype="bfloat16", attn_impl="auto",
                          n_layers=DECODE_DEPTH)
    params = ptl.init_params(cfg8, seed=0, device="cuda", mesh=mesh)
    cb = ptl.ContinuousBatcher(params, cfg8, n_slots=2, max_len=2048,
                               decode_chunk=8, device="cuda", mesh=mesh)
    return dict(mesh_traffic(torch, state["fa"], state["pa"], cb, mesh,
                             waves), rank=mesh.rank,
                data_index=mesh.axis_index("data"))


def mesh_cell_release(torch, state):
    """Between phases: drop what the earlier cells kept and give the
    allocator's cached blocks back to the card, which the main process
    shares with the ranks."""
    import gc

    for key in ("params", "mesh", "cfg"):
        state.pop(key, None)
    gc.collect()
    torch.cuda.empty_cache()
    return dict(reserved=torch.cuda.memory_reserved())


def http_session(srv, requests, got):
    """mesh_http's traffic on one server (run.py's ``_serve_http`` test
    hook): ``requests`` one after another, each reply kept, and after each
    the batcher's host state taken on the serving loop (over a mesh, a
    record of the lockstep log: every rank computes its own there and
    the ranks compare them); then /healthz and /debug/dispatches, and the
    log's counts over a mesh."""
    got["replies"], got["states"] = [], []
    for path, payload in requests:
        got["replies"].append(http_request(srv.address, path, payload))
        got["states"].append(srv.call_on_loop(lambda b: b.host_state()))
    got["health"] = http_json(srv.address, "/healthz")[1]
    got["dispatches"] = http_json(
        srv.address, "/debug/dispatches?n=4096")[1]["dispatches"]
    leader = getattr(srv.batcher, "_leader", None)
    if leader is not None:
        got["lockstep"] = leader.stats()


def router_session(router, servers, got):
    """mesh_router's traffic (run.py's ``_serve_router`` test hook): a
    session's cold serve through the router and its revisit (a routed
    prefix hit); the session's chain moved by the router's handoff path to
    the other replica and served there (a hit, the cold serve's tokens);
    a FleetController scale-up, a prompt on the grown replica, its
    scale-down (a drain by migration) and the prompt's revisit through
    the router.  Host states are taken through the log, /healthz and each
    replica's dispatch records kept."""
    from jax_llama_tpu_torch.kvcache import chain_keys
    from jax_llama_tpu_torch.tokenizers import ByteTokenizer

    texts = serve_texts()
    tok_ids = ByteTokenizer().encode(texts[5], bos=True)
    session = {"text": texts[5], "max_new_tokens": MESH_HTTP_NEW}
    revisit = {"text": texts[5] + " and then some", "max_new_tokens":
               MESH_HTTP_NEW}
    grown_prompt = {"text": texts[9], "max_new_tokens": MESH_HTTP_NEW}
    ctl = router.controller
    got["cold"] = http_request(router.address, "/generate", session)
    router.check_health_now()
    got["routed_hit"] = http_request(router.address, "/generate", revisit)
    src = int(got["cold"][1]["X-Replica-Id"])
    dst = 1 - src
    keys = chain_keys(tok_ids, servers[0].batcher.block_size)
    router.migrate_chain([k.hex() for k in keys], src, dst)
    got["handoffs_idle"] = router.wait_handoffs(ROUTER_WAIT_S)
    got["handoff_hit"] = http_request(servers[dst].address, "/generate",
                                      session)
    got["up"] = ctl.scale_up()
    grown = router._replicas[got["up"]["replica"]].server
    got["grown_serve"] = http_request(grown.address, "/generate",
                                      grown_prompt)
    got["states_grown"] = [s.call_on_loop(lambda b: b.host_state())
                           for s in servers + [grown]]
    got["down"] = ctl.scale_down(victim=got["up"]["replica"])
    got["grown_revisit"] = http_request(router.address, "/generate",
                                        grown_prompt)
    got["states"] = [s.call_on_loop(lambda b: b.host_state())
                     for s in servers]
    got["records"] = [records(s.batcher) for s in servers + [grown]]
    got["health"] = router.health()
    got["replica_stats"] = [s.call_on_loop(lambda b: b.stats())
                            for s in servers]
    got["handoffs_completed"] = router.handoffs_completed_total
    leader = getattr(servers[0].batcher, "_leader", None)
    if leader is not None:
        got["lockstep"] = leader.stats()


def mesh_cell_http(torch, state, argv, requests=None):
    """mesh_http's and mesh_router's cells on one rank: ``run.main()``
    with ``argv`` (an HTTP server over a serving mesh of the two ranks),
    as torchrun would start it, counted from zero.  On rank 0 run.py's
    test hook drives the traffic (``http_session`` with ``requests``;
    ``router_session`` under ``--replicas``); the other rank follows the
    log until rank 0 stops it.  Returns the rank's launches, what its
    hook or its follower loop saw, and its wall seconds."""
    import contextlib
    import gc
    import io

    from jax_llama_tpu_torch import run as prun
    from jax_llama_tpu_torch.parallel import distributed, lockstep

    fa, pa = state["fa"], state["pa"]
    got, followed = {}, {}
    orig = (prun._serve_http, prun._serve_router, lockstep.follow)

    def follow(*a, **kw):
        followed.update(orig[2](*a, **kw))
        return followed

    lockstep.follow = follow
    prun._serve_http = lambda *a, **kw: orig[0](*a, **dict(
        kw, _test_hook=lambda srv: http_session(srv, requests, got)))
    prun._serve_router = lambda *a, **kw: orig[1](*a, **dict(
        kw, _test_hook=lambda router, servers: router_session(
            router, servers, got)))
    saved = sys.argv, os.environ.get("WORLD_SIZE")
    sys.argv = ["run", *argv]
    os.environ["WORLD_SIZE"] = str(MESH_RANKS)
    zero_counts(fa, pa)
    out = io.StringIO()
    t = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            prun.main()
        torch.cuda.synchronize()
    finally:
        prun._serve_http, prun._serve_router, lockstep.follow = orig
        sys.argv = saved[0]
        if saved[1] is None:
            os.environ.pop("WORLD_SIZE", None)
        else:
            os.environ["WORLD_SIZE"] = saved[1]
    wall = time.perf_counter() - t
    # The card is shared with the main process: its later phases need the
    # memory this rank's servers cached.
    gc.collect()
    torch.cuda.empty_cache()
    return dict(got, followed=followed, launches=launch_counts(fa, pa),
                instances=instance_counts(fa, pa), wall_s=wall,
                rank=distributed.process_index(), out=out.getvalue())


MESH_CELLS = {"generate": mesh_cell_generate, "serve_tp": mesh_cell_serve_tp,
              "serve_dp": mesh_cell_serve_dp, "release": mesh_cell_release,
              "http": mesh_cell_http}


def mesh_rank(rank, port, cmd, res):
    """One rank of the mesh phases (spawned): it brings up the gloo group
    on cuda:0 and runs the ``MESH_CELLS`` the parent sends, each on its
    own shard, until the parent sends None."""
    import faulthandler
    import traceback

    import torch

    sys.path.insert(0, HERE)
    from jax_llama_tpu_torch.parallel import distributed

    torch.cuda.set_device(0)
    distributed.initialize(f"localhost:{port}", MESH_RANKS, rank,
                           backend="gloo")
    state = dict(
        fa=importlib.import_module("jax_llama_tpu_torch.ops.flash_attention"),
        pa=importlib.import_module("jax_llama_tpu_torch.ops.paged_attention"))
    try:
        while True:
            item = cmd.get()
            if item is None:
                break
            name, kw = item
            # A cell that hangs (a collective some rank never joins)
            # leaves each rank's stacks on stderr before the parent
            # gives up on it.
            faulthandler.dump_traceback_later(MESH_WAIT_S - 30)
            try:
                res.put((rank, True, MESH_CELLS[name](torch, state, **kw)))
            except BaseException:
                res.put((rank, False, traceback.format_exc()))
            faulthandler.cancel_dump_traceback_later()
    finally:
        distributed.shutdown()


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class MeshRanks:
    """MESH_RANKS spawned ranks (``mesh_rank``), asked cell by cell."""

    def __init__(self):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        port = free_port()
        self.cmd = [ctx.Queue() for _ in range(MESH_RANKS)]
        self.res = ctx.Queue()
        self.procs = [ctx.Process(target=mesh_rank, daemon=True,
                                  args=(r, port, self.cmd[r], self.res))
                      for r in range(MESH_RANKS)]
        for p in self.procs:
            p.start()

    def ask(self, name, **kw):
        import queue

        for q in self.cmd:
            q.put((name, kw))
        out, errors = [None] * MESH_RANKS, []
        deadline = time.monotonic() + MESH_WAIT_S
        got = 0
        while got < MESH_RANKS:
            try:
                rank, ok, value = self.res.get(timeout=5)
            except queue.Empty:
                dead = [p.exitcode for p in self.procs if not p.is_alive()]
                if dead or time.monotonic() > deadline:
                    raise AssertionError(
                        f"mesh cell {name}: ranks exited {dead} or timed "
                        f"out; errors so far: {errors}")
                continue
            got += 1
            if ok:
                out[rank] = value
            else:
                errors.append(f"rank {rank}: {value}")
                # The other ranks now wait in a collective this one left.
                deadline = min(deadline, time.monotonic() + 30)
        if errors:
            raise AssertionError(f"mesh cell {name} failed:\n" +
                                 "\n".join(errors))
        return out

    def close(self):
        for q in self.cmd:
            q.put(None)
        for p in self.procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)


def mesh_matches_reference(check, cell, r, ref):
    """A rank's flash and paged launches, block tables and radix digest
    against the unsharded batcher's on the same traffic."""
    for key in ("flash_fwd", "paged_decode"):
        check(r["launches"][key] == ref["launches"][key],
              f"mesh_serving {cell} {key} {r['launches'][key]}, "
              f"unsharded {ref['launches'][key]}")
    check(r["table"] == ref["table"] and r["digest"] == ref["digest"],
          f"mesh_serving {cell}: host state differs from the unsharded "
          f"batcher's")


def same_across_ranks(rows, keys):
    """The keys whose values differ between ranks."""
    return [k for k in keys if any(r[k] != rows[0][k] for r in rows[1:])]


def drive_mesh(torch, ptl, fa, pa, params, cfg, tok, smi, gen_tokens,
               gen_mask, gen_out, prompt_ids, ranks):
    """Phases ``mesh_generate`` and ``mesh_serving`` (ROADMAP A14 part 1):
    two ranks (``ranks``, spawned once on cuda:0 over gloo).

    mesh_generate: each rank draws the seed-0 llama3-8b tree (full width,
    32 layers, bf16) as its tensor = 2 shard and runs ``engine.generate``
    on the generate phase's 4 prompts (padded to 512) for 32 new tokens:
    tokens equal to the unsharded generate phase's, or the first
    divergence a bf16 near-tie below DECODE_REL; each rank launches the
    flash kernel once per layer of the one prefill, on "wgmma", at H = 16.

    mesh_serving: the serving phase's first MESH_SERVE requests at
    DECODE_DEPTH layers on the tensor = 2 mesh (``--serve-mesh 1,2``) and
    on the unsharded batcher over the same weights: tokens equal (or a
    near-tie), block tables, free list and radix digest identical on both
    ranks, each rank's flash and paged launches the unsharded batcher's;
    then the same in float32 activations, tokens identical.  Then the
    data = 2 cell (``--serve-mesh 2,1``): two prompts in one
    insert, each data rank computing one row, then a prompt that hits
    MESH_HIT_BLOCKS blocks of the second, which data rank 1 computed and
    data rank 0 landed from the gather."""
    import gc

    failures = []

    def check(ok, what):
        if not ok:
            failures.append(what)

    t0 = time.perf_counter()
    g = ranks.ask("generate", tokens=gen_tokens.cpu(),
                  mask=gen_mask.cpu(), max_new=32)
    P = gen_tokens.shape[1]
    want = [row[P:] for row in gen_out.cpu().tolist()]
    got = [row[P:] for row in g[0]["tokens"]]
    check(not same_across_ranks(g, ["tokens"]), "ranks' tokens differ")
    divergences = []
    try:
        divergences = token_divergences(torch, ptl, params, cfg,
                                        prompt_ids, got, want,
                                        DECODE_REL)
    except AssertionError as e:
        failures.append(f"mesh_generate: {e}")
    L = cfg.n_layers
    for r in g:
        check(r["launches"]["flash_fwd"] == L
              and r["flash_by_instance"] == {"wgmma": L}
              and r["launches"]["paged_decode"] == 0,
              f"rank {r['rank']} launches {r['launches']} "
              f"{r['flash_by_instance']}")
        check(r["qkv"][1] == SHARD_KVH, f"rank shard {r['qkv']}")
    new_tokens = len(want[0])
    gen_row = dict(
        phase="mesh_generate", card=smi, ranks=MESH_RANKS,
        backend="gloo", devices=[r["device"] for r in g],
        config="llama3-8b", n_layers=L, dim=cfg.dim, dtype="bfloat16",
        tensor=MESH_RANKS, heads_per_rank=(
            g[0]["qkv"][1] * (cfg.n_heads // cfg.kv_heads)),
        kv_heads_per_rank=g[0]["qkv"][1], batch=len(want),
        padded_len=P, max_gen_len=new_tokens,
        tokens_equal=got == want, divergences=divergences,
        weight_bytes_per_rank=[r["weight_bytes"] for r in g],
        init_params_s=[r["init_s"] for r in g],
        generate_s=[r["generate_s"] for r in g],
        launches_per_rank=[r["launches"] for r in g],
        flash_by_instance_per_rank=[r["flash_by_instance"] for r in g],
        collectives_per_rank=g[0]["collectives"],
        collectives_per_token={k: v / new_tokens for k, v in
                               g[0]["collectives"].items()},
        spawn_to_result_s=time.perf_counter() - t0)
    emit(gen_row)

    # mesh_serving, tensor = 2: the unsharded reference first.
    L8 = DECODE_DEPTH
    cfg8 = cfg.replace(n_layers=L8)
    shallow = dict(params, layers={k: w[:L8]
                                   for k, w in params["layers"].items()})
    prompts = serve_prompts(tok)[:MESH_SERVE]
    max_new = list(SERVE_MAX_NEW[:MESH_SERVE])
    ref = mesh_serve(torch, ptl, fa, pa, shallow, cfg8, None, prompts,
                     max_new)
    tp = ranks.ask("serve_tp", prompts=prompts, max_new=max_new,
                   dtype="bfloat16")
    differ = same_across_ranks(tp, ["tokens", "table", "free",
                                    "digest"])
    check(not differ, f"mesh_serving tp ranks differ in {differ}")
    tp_div = []
    try:
        tp_div = token_divergences(torch, ptl, shallow, cfg8, prompts,
                                   tp[0]["tokens"], ref["tokens"],
                                   DECODE_REL)
    except AssertionError as e:
        failures.append(f"mesh_serving tp: {e}")
    # No request stops early (no stop tokens), so a near-tie changes
    # neither the iterations nor the prompt chains: launches, tables
    # and the digest must be the unsharded batcher's whatever it is.
    for r in tp:
        check(r["pool_k"][1] == SHARD_KVH, f"pool {r['pool_k']}")
        mesh_matches_reference(check, "tp", r, ref)

    # The same traffic in float32 activations (bf16 weights), where
    # the sharded sums' rounding is far below any logit gap: tokens
    # identical to the unsharded batcher's, no near-tie allowed.
    cfg8_f32 = cfg8.replace(dtype="float32")
    ref32 = mesh_serve(torch, ptl, fa, pa, shallow, cfg8_f32, None,
                       prompts, max_new)
    tp32 = ranks.ask("serve_tp", prompts=prompts, max_new=max_new,
                     dtype="float32")
    differ = same_across_ranks(tp32, ["tokens", "table", "free",
                                      "digest"])
    check(not differ, f"mesh_serving tp f32 ranks differ in {differ}")
    check(tp32[0]["tokens"] == ref32["tokens"],
          "mesh_serving tp f32: tokens differ from the unsharded "
          "batcher's")
    for r in tp32:
        mesh_matches_reference(check, "tp f32", r, ref32)
    del shallow

    # The data = 2 cell: the unsharded reference on the same tree.
    waves = mesh_prefix_waves(tok)
    p8 = ptl.init_params(cfg8, seed=0, device="cuda")
    cb = ptl.ContinuousBatcher(p8, cfg8, n_slots=2, max_len=2048,
                               decode_chunk=8, device="cuda")
    dref = mesh_traffic(torch, fa, pa, cb, None, waves)
    del cb
    dp = ranks.ask("serve_dp", waves=waves)
    differ = same_across_ranks(dp, ["tokens", "table", "free",
                                    "digest"])
    check(not differ, f"mesh_serving dp ranks differ in {differ}")
    dp_div = []
    try:
        dp_div = token_divergences(
            torch, ptl, p8, cfg8, [p for w in waves for p, _ in w],
            dp[0]["tokens"], dref["tokens"], DECODE_REL)
    except AssertionError as e:
        failures.append(f"mesh_serving dp: {e}")
    for r in dp + [dref]:
        check(r["prefix_hits"] == 1
              and r["prefix_blocks_reused"] == MESH_HIT_BLOCKS,
              f"dp prefix hits {r['prefix_hits']} reused "
              f"{r['prefix_blocks_reused']}")
    for r in dp:
        mesh_matches_reference(check, "dp", r, dref)
    del p8
    gc.collect()
    torch.cuda.empty_cache()
    serve_row = dict(
        phase="mesh_serving", card=smi, ranks=MESH_RANKS,
        backend="gloo", n_layers=L8, config="llama3-8b",
        dtype="bfloat16",
        tensor2=dict(
            serve_mesh=tp[0]["serve_mesh"], requests=MESH_SERVE,
            max_new=max_new, tokens_equal=tp[0]["tokens"]
            == ref["tokens"], divergences=tp_div,
            host_state_identical=not same_across_ranks(
                tp, ["table", "free", "digest"]),
            digest=tp[0]["digest"], pool_k_per_rank=tp[0]["pool_k"],
            launches_per_rank=[r["launches"] for r in tp],
            unsharded_launches=ref["launches"],
            flash_by_instance_per_rank=[r["flash_by_instance"]
                                        for r in tp],
            steps=tp[0]["steps"], unsharded_steps=ref["steps"],
            serve_s=[r["serve_s"] for r in tp],
            unsharded_serve_s=ref["serve_s"],
            collectives_per_rank=tp[0]["collectives"]),
        tensor2_f32=dict(
            dtype="float32 activations, bf16 weights",
            tokens_equal=tp32[0]["tokens"] == ref32["tokens"],
            host_state_identical=not same_across_ranks(
                tp32, ["table", "free", "digest"]),
            launches_per_rank=[r["launches"] for r in tp32],
            unsharded_launches=ref32["launches"],
            serve_s=[r["serve_s"] for r in tp32],
            unsharded_serve_s=ref32["serve_s"]),
        data2=dict(
            serve_mesh=dp[0]["serve_mesh"],
            prompt_tokens=[len(p) for w in waves for p, _ in w],
            tokens_equal=dp[0]["tokens"] == dref["tokens"],
            divergences=dp_div,
            host_state_identical=not same_across_ranks(
                dp, ["table", "free", "digest"]),
            prefix_hits=[r["prefix_hits"] for r in dp],
            prefix_blocks_reused=[r["prefix_blocks_reused"]
                                  for r in dp],
            hit_blocks_computed_by_data_rank=1,
            data_index_per_rank=[r["data_index"] for r in dp],
            inserts=dp[0]["inserts"],
            launches_per_rank=[r["launches"] for r in dp],
            unsharded_launches=dref["launches"],
            serve_s=[r["serve_s"] for r in dp],
            collectives_per_rank=dp[0]["collectives"]),
        seconds=time.perf_counter() - t0, failures=failures)
    emit(serve_row)
    # The ranks stay up for phase 9b: hand their cached memory back.
    ranks.ask("release")
    if failures:
        raise AssertionError(f"mesh phases failed: {failures}")
    return gen_row, serve_row


# ---------------------------------------------------------------------------
# The HTTP server and the router over a serving mesh (ROADMAP A14 part 3)
# ---------------------------------------------------------------------------

# mesh_http's traffic: MESH_HTTP_NEW new tokens a request; the first one
# times out (MESH_HTTP_TIMEOUT_S) in its first decode dispatch, which the
# drill delays, and the second one's first decode dispatch fails and
# replays (MESH_HTTP_FAULTS counts decode dispatches from the first).
MESH_HTTP_NEW = 16
MESH_HTTP_TIMEOUT_S = 1.0
MESH_HTTP_FAULTS = "step@0:delay=2,step@1:error"
MESH_SPEC = ["--serve-mesh", f"1,{MESH_RANKS}"]


def mesh_http_requests():
    """mesh_http's requests, in the order they are sent: the timeout, the
    replayed one, a blocking /generate, an NDJSON stream, a /chat (the
    byte tokenizer has no chat format: every server answers 400) and the
    blocking prompt's revisit (a prefix hit)."""
    t = serve_texts()
    new = MESH_HTTP_NEW
    return [
        ("/generate", {"text": t[1], "max_new_tokens": 64,
                       "timeout_s": MESH_HTTP_TIMEOUT_S}),
        ("/generate", {"text": t[4], "max_new_tokens": new}),
        ("/generate", {"text": t[5], "max_new_tokens": new}),
        ("/generate", {"text": t[3], "max_new_tokens": new,
                       "stream": True}),
        ("/chat", {"messages": [{"role": "user", "content": t[1]}],
                   "max_new_tokens": new}),
        ("/generate", {"text": t[5] + " and then some",
                       "max_new_tokens": new}),
    ]


def http_cli_session(torch, argv, requests):
    """The unsharded reference of a mesh_http cell: ``run.main()`` with
    ``argv`` in this process, ``http_session`` as its test hook."""
    from jax_llama_tpu_torch import run as prun

    got = {}
    orig = prun._serve_http
    prun._serve_http = lambda *a, **kw: orig(*a, **dict(
        kw, _test_hook=lambda srv: http_session(srv, requests, got)))
    try:
        out, _, wall = run_cli(torch, argv)
    finally:
        prun._serve_http = orig
    return dict(got, out=out, wall_s=wall)


def router_cli_session(torch, argv):
    """The unsharded reference of mesh_router: ``run.main()`` with
    ``argv`` in this process, ``router_session`` as its test hook."""
    from jax_llama_tpu_torch import run as prun

    got = {}
    orig = prun._serve_router
    prun._serve_router = lambda *a, **kw: orig(*a, **dict(
        kw, _test_hook=lambda router, servers: router_session(
            router, servers, got)))
    try:
        out, _, wall = run_cli(torch, argv)
    finally:
        prun._serve_router = orig
    return dict(got, out=out, wall_s=wall)


def batcher_session(torch, ptl, params, cfg, kernels, requests):
    """What a server run.py builds at the checkpoint phase's flags
    (``cli_batcher``) answers to ``requests`` sent one at a time, each
    (path, payload) a /generate of a text: its tokens, and its host state
    after each, counted from zero."""
    tok = ptl.ByteTokenizer()
    cb = cli_batcher(ptl, params, cfg, kernels)
    tokens, states = [], []
    t = time.perf_counter()
    for _, payload in requests:
        rid = cb.submit(tok.encode(payload["text"], bos=True),
                        max_new_tokens=payload["max_new_tokens"])
        tokens.append(cb.run_to_completion()[rid])
        states.append(cb.host_state())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    del cb
    torch.cuda.empty_cache()
    return dict(tokens=tokens, states=states, wall_s=wall)


def float32_checkpoint(saved, path):
    """``saved`` with float32 activations: its params hard-linked, its
    config's dtype float32, the manifest's config entry re-hashed."""
    import hashlib

    from jax_llama_tpu_torch.convert.checkpoint import (
        MANIFEST_NAME,
        PARAMS_NAME,
    )

    path.mkdir()
    os.link(saved / PARAMS_NAME, path / PARAMS_NAME)
    conf = json.loads((saved / "config.json").read_text())
    conf["dtype"] = "float32"
    data = json.dumps(conf).encode()
    (path / "config.json").write_bytes(data)
    manifest = json.loads((saved / MANIFEST_NAME).read_text())
    manifest["files"]["config.json"] = {
        "sha256": hashlib.sha256(data).hexdigest(), "bytes": len(data)}
    (path / MANIFEST_NAME).write_text(json.dumps(manifest))
    return path


def lockstep_figures(stats):
    """The leader's log counts: records by kind, records per serving
    iteration (a step record each) and the ms each record took to
    publish and to agree on."""
    n = max(1, stats["records_total"])
    steps = stats["records"].get("step", 0)
    return dict(records=stats["records"], records_total=stats[
        "records_total"], records_per_iteration=(
            stats["records_total"] / steps if steps else None),
        publish_ms_per_record=stats["publish_ms_total"] / n,
        agree_ms_per_record=stats["agree_ms_total"] / n)


def drive_mesh_http(torch, ptl, fa, pa, smi, ranks, saved, shallow, cfg):
    """Phase ``mesh_http`` (ROADMAP A14 part 3): ``run.main()`` with
    ``--http 0 --serve-mesh 1,2`` on the two ranks, through run.py's test
    hook, over the checkpoint phase's DECODE_DEPTH-layer llama3-8b
    checkpoint; rank 0 leads (HTTP, the server's loop), rank 1 follows
    the lockstep log.  Two cells, each beside the unsharded server
    (``run.main()`` without the mesh in this process, the same argv and
    requests):

    - bf16: ``mesh_http_requests`` under MESH_HTTP_FAULTS (a request
      that times out mid-generation, one whose failed dispatch replays):
      the same statuses, tokens equal or a near-tie below DECODE_REL;
    - float32 activations (the same bf16 weights) on the selected kernels
      (``--prefill-kernel splash --decode-kernel stock-paged``, rows 6
      and 5): a blocking request and a stream, tokens identical to those
      of the batcher such a server builds (``batcher_session``: the
      server adds no kernel launch, and loading the checkpoint once
      more would cost the phase seconds).

    In each: both ranks' host state (block tables, free list, radix
    digest, queue, slots) taken through the log after every request and
    equal; each rank's launches and kernel instances the unsharded
    server's (bf16 inserts on flash "wgmma"); /healthz reports the 1 x 2
    mesh.  The log's records
    per iteration and ms per record are reported."""
    t0 = time.perf_counter()
    failures = []

    def check(ok, what):
        if not ok:
            failures.append(what)

    L = cfg.n_layers
    tok = ptl.ByteTokenizer()
    base = ["--byte-tokenizer", "--http", "0", "--slots", str(CKPT_SLOTS),
            "--temperature", "0", "--attn", "auto"]
    f32 = float32_checkpoint(saved, saved.parent / "saved_f32")
    reqs = mesh_http_requests()
    cells = {}
    selected = [a for k, v in SELECTED.items()
                for a in ("--" + k.replace("_", "-"), v)]
    for name, ckpt, cell_reqs, extra in (
            ("bf16", saved, reqs, ["--inject-faults", MESH_HTTP_FAULTS]),
            ("float32", f32, reqs[2:4], selected)):
        argv = ["--ckpt-dir", str(ckpt), *base, *extra]
        zero_counts(fa, pa)
        if name == "bf16":
            ref = http_cli_session(torch, argv, cell_reqs)
            want = [http_tokens(r) for r in ref["replies"]]
            ref["recoveries"] = ref["health"]["recoveries_total"]
        else:
            ref = batcher_session(torch, ptl, shallow,
                                  cfg.replace(dtype="float32"), SELECTED,
                                  cell_reqs)
            want = [(200, t) for t in ref["tokens"]]
            ref["recoveries"] = 0
        ref_launches = launch_counts(fa, pa)
        ref_inst = instance_counts(fa, pa)
        t = time.perf_counter()
        rows = ranks.ask("http", argv=argv + MESH_SPEC, requests=cell_reqs)
        mesh_s = time.perf_counter() - t
        lead, follow = rows
        got = [http_tokens(r) for r in lead["replies"]]
        statuses = [st for st, _ in got]
        check(statuses == [st for st, _ in want],
              f"mesh_http {name} statuses {statuses}, unsharded "
              f"{[st for st, _ in want]}")
        ok = [i for i, (st, _) in enumerate(got) if st == 200]
        prompts = [tok.encode(cell_reqs[i][1]["text"], bos=True) for i in ok]
        divergences = []
        if name == "float32":
            check([got[i] for i in ok] == [want[i] for i in ok],
                  f"mesh_http float32 tokens {got}, unsharded {want}")
        else:
            try:
                divergences = token_divergences(
                    torch, ptl, shallow, cfg, prompts,
                    [got[i][1] for i in ok], [want[i][1] for i in ok],
                    DECODE_REL)
            except AssertionError as e:
                failures.append(f"mesh_http bf16: {e}")
        same_states = lead["states"] == follow["followed"].get("states")
        check(same_states and len(lead["states"]) == len(cell_reqs),
              f"mesh_http {name}: the ranks' host states differ")
        check(lead["launches"] == follow["launches"] == ref_launches,
              f"mesh_http {name} launches per rank "
              f"{[r['launches'] for r in rows]}, unsharded {ref_launches}")
        path = (("flash_fwd", "paged_decode") if name == "bf16"
                else ("splash_prefill", "stock_paged"))
        check(all(ref_launches[k] > 0 for k in path),
              f"mesh_http {name}: a kernel of the path did not launch: "
              f"{ref_launches}")
        # Each rank runs the unsharded server's instances (bf16 inserts
        # the Hopper flash instance).
        inst_keys = ("flash_fwd_by_instance", "splash_by_instance",
                     "stock_by_instance")
        for r in rows:
            inst = {k: r["instances"][k] for k in inst_keys}
            check(inst == {k: ref_inst[k] for k in inst_keys} and (
                name != "bf16"
                or set(inst["flash_fwd_by_instance"]) == {"wgmma"}),
                f"mesh_http {name} rank {r['rank']} instances {inst}, "
                f"unsharded {ref_inst}")
        check(lead["health"]["replica"]["serve_mesh"] == {
            "data": 1, "tensor": MESH_RANKS, "devices": MESH_RANKS},
            f"mesh_http {name} /healthz {lead['health']['replica']}")
        cells[name] = dict(
            requests=[p for p, _ in cell_reqs], statuses=statuses,
            unsharded_statuses=[st for st, _ in want],
            tokens_equal=[got[i] for i in ok] == [want[i] for i in ok],
            divergences=divergences,
            host_state_identical_after_each_request=same_states,
            host_state_equal_to_unsharded=lead["states"] == ref["states"],
            launches_per_rank=[r["launches"] for r in rows],
            unsharded_launches=ref_launches,
            kernels=SELECTED if name == "float32" else "checkpoint's",
            instances_per_rank=[{k: r["instances"][k] for k in inst_keys}
                                for r in rows],
            paged_by_instance_per_rank=[
                r["instances"]["paged_by_instance"] for r in rows],
            recoveries=[lead["health"]["recoveries_total"],
                        ref["recoveries"]],
            lockstep=lockstep_figures(lead["lockstep"]),
            follower_records=follow["followed"].get("records"),
            mesh_s=mesh_s, rank_wall_s=[r["wall_s"] for r in rows],
            unsharded_s=ref["wall_s"],
            unsharded_is=("run.main()" if name == "bf16"
                          else "batcher_session"))
    bf = cells["bf16"]
    check(bf["statuses"] == [504, 200, 200, 200, 400, 200],
          f"mesh_http bf16 statuses {bf['statuses']}")
    check(bf["recoveries"] == [1, 1], f"mesh_http recoveries "
          f"{bf['recoveries']}")
    check(cells["float32"]["host_state_equal_to_unsharded"],
          "mesh_http float32: host state differs from the unsharded "
          "server's")
    row = dict(phase="mesh_http", card=smi, ranks=MESH_RANKS,
               backend="gloo", config="llama3-8b", n_layers=L,
               argv_mesh=MESH_SPEC, faults=MESH_HTTP_FAULTS, cells=cells,
               launches=cells["bf16"]["launches_per_rank"][0],
               seconds=time.perf_counter() - t0, failures=failures)
    emit(row)
    return row, failures


def drive_mesh_router(torch, ptl, fa, pa, smi, ranks, saved, shallow, cfg):
    """Phase ``mesh_router`` (ROADMAP A14 part 3): ``run.main()`` with
    ``--http 0 --replicas 2 --route cache-aware --autoscale --serve-mesh
    1,2`` on the two ranks (JAX's time-shared geometry: both replicas on
    the one mesh), over the checkpoint phase's DECODE_DEPTH-layer
    checkpoint, the controller's own loop idle (``--autoscale-interval-s``
    3600) so that the hook's actions are the only ones.  It runs the
    checkpoint's kernels (flash, paged): the stock-paged slot rounds K/V
    to bf16 in the kernel (JAX's semantics), so under it a hit and a cold
    serve part at a non-tie even in float32, unsharded as on the mesh
    (mesh_http's float32 cell holds the selected kernels instead).  Checks
    (``router_session``): the session's revisit routed to its holder (a
    hit in the router's index); the router's handoff moves the chain and
    its serve on the other replica is a prefix hit with the cold serve's
    tokens; a FleetController scale-up builds a third replica on both
    ranks and a scale-down drains it by migration, its prompt's revisit
    the served tokens (a hit and a cold insert round differently in
    bf16: a differing token must be a near-tie below DECODE_REL, as in
    mesh_serving); every live replica's /healthz reports the 1 x 2
    mesh; the ranks' host states agree through the log; each rank's
    launches are the unsharded router's on the same traffic
    (``run.main()`` without the mesh in this process, counted from zero
    just before it), and the ones the replicas' dispatch records
    imply."""
    t0 = time.perf_counter()
    failures = []

    def check(ok, what):
        if not ok:
            failures.append(what)

    L = cfg.n_layers
    argv = ["--ckpt-dir", str(saved), "--byte-tokenizer", "--http", "0",
            "--slots", str(CKPT_SLOTS), "--temperature", "0", "--attn",
            "auto", "--replicas", "2", "--route", "cache-aware",
            "--canary-interval-s", "0", "--autoscale", "--autoscale-min",
            "2", "--autoscale-max", "3", "--autoscale-interval-s", "3600"]
    zero_counts(fa, pa)
    ref = router_cli_session(torch, argv)
    ref_launches = launch_counts(fa, pa)
    t = time.perf_counter()
    rows = ranks.ask("http", argv=argv + MESH_SPEC)
    mesh_s = time.perf_counter() - t
    lead, follow = rows
    toks = {k: http_tokens(lead[k]) for k in (
        "cold", "routed_hit", "handoff_hit", "grown_serve",
        "grown_revisit")}
    check(all(st == 200 for st, _ in toks.values()),
          f"mesh_router statuses { {k: v[0] for k, v in toks.items()} }")
    holder = lead["cold"][1].get("X-Replica-Id")
    check(lead["routed_hit"][1].get("X-Replica-Id") == holder
          and lead["health"]["cache_index"]["hit_depth_blocks_total"] >= 1,
          f"mesh_router: the revisit was not a routed hit "
          f"({lead['routed_hit'][1].get('X-Replica-Id')} vs {holder})")
    dst = 1 - int(holder)
    check(lead["handoffs_idle"] and lead["handoffs_completed"] == 1
          and lead["replica_stats"][dst]["prefix_requests_hit_total"] >= 1,
          f"mesh_router handoff: completed {lead['handoffs_completed']}, "
          f"replica {dst} {lead['replica_stats'][dst]}")
    up, down = lead["up"], lead["down"]
    check(up.get("ok") and up.get("replica") == 2 and down.get("ok")
          and down["drain"]["migrated"] >= 1,
          f"mesh_router scale: up {up}, down {down}")
    texts = serve_texts()
    tok = ptl.ByteTokenizer()
    divergences = {}
    for name, (hit, cold, text) in dict(
            handoff=("handoff_hit", "cold", texts[5]),
            drain=("grown_revisit", "grown_serve", texts[9])).items():
        try:
            divergences[name] = token_divergences(
                torch, ptl, shallow, cfg, [tok.encode(text, bos=True)],
                [toks[hit][1]], [toks[cold][1]], DECODE_REL)
        except AssertionError as e:
            failures.append(f"mesh_router {name}: {e}")
    meshes = [r["replica"]["serve_mesh"]
              for r in lead["health"]["replicas"] if not r.get("retired")]
    check(len(meshes) == 2 and all(m == {
        "data": 1, "tensor": MESH_RANKS, "devices": MESH_RANKS}
        for m in meshes), f"mesh_router /healthz meshes {meshes}")
    states = lead["states_grown"] + lead["states"]
    check(states == follow["followed"].get("states"),
          "mesh_router: the ranks' host states differ")
    recs = [r for rs in lead["records"] for r in rs]
    expect = record_launches(recs, L)
    check(lead["launches"] == follow["launches"] == ref_launches == expect
          and expect["flash_fwd"] > 0 and expect["paged_decode"] > 0,
          f"mesh_router launches per rank {[r['launches'] for r in rows]}, "
          f"unsharded {ref_launches}, the records imply {expect}")
    ref_toks = {k: http_tokens(ref[k]) for k in toks}
    # C3: a request whose tokens differ from the unsharded router's must
    # part at a near-tie below DECODE_REL, as mesh_http's bf16 cell.
    prompt_of = dict(cold=texts[5], routed_hit=texts[5] + " and then some",
                     handoff_hit=texts[5], grown_serve=texts[9],
                     grown_revisit=texts[9])
    divergences_unsharded = {}
    for k in toks:
        if toks[k] == ref_toks[k]:
            continue
        try:
            divergences_unsharded[k] = token_divergences(
                torch, ptl, shallow, cfg,
                [tok.encode(prompt_of[k], bos=True)], [toks[k][1]],
                [ref_toks[k][1]], DECODE_REL)
        except AssertionError as e:
            failures.append(f"mesh_router {k} against the unsharded "
                            f"router: {e}")
    row = dict(
        phase="mesh_router", card=smi, ranks=MESH_RANKS, backend="gloo",
        config="llama3-8b", n_layers=L, argv_mesh=MESH_SPEC,
        replicas=2, holder=holder,
        statuses={k: v[0] for k, v in toks.items()},
        handoff_tokens_equal_cold=toks["handoff_hit"] == toks["cold"],
        drain_revisit_tokens_equal=toks["grown_revisit"]
        == toks["grown_serve"], divergences=divergences,
        routed_hit_depth_blocks=lead["health"]["cache_index"][
            "hit_depth_blocks_total"],
        handoffs_completed=lead["handoffs_completed"],
        scale_up=up, drain={k: down["drain"].get(k) for k in (
            "ok", "sessions", "migrated", "blocks", "dur_ms")},
        serve_meshes=meshes, host_states_identical=states == follow[
            "followed"].get("states"),
        launches_per_rank=[r["launches"] for r in rows],
        unsharded_launches=ref_launches, expected_launches=expect,
        tokens_equal_unsharded={k: toks[k] == ref_toks[k] for k in toks},
        divergences_unsharded=divergences_unsharded,
        instances_per_rank=[{k: r["instances"][k] for k in (
            "flash_fwd_by_instance", "paged_by_instance")} for r in rows],
        lockstep=lockstep_figures(lead["lockstep"]),
        follower_records=follow["followed"].get("records"),
        mesh_s=mesh_s, rank_wall_s=[r["wall_s"] for r in rows],
        unsharded_s=ref["wall_s"],
        launches=lead["launches"], seconds=time.perf_counter() - t0,
        failures=failures)
    emit(row)
    return row, failures


# ---------------------------------------------------------------------------
# Sharded training, ring attention and pipeline stages (ROADMAP A14 part 2)
# ---------------------------------------------------------------------------

TP2_TRAIN_SHAPE = dict(B=4, T=2048, H=16, KVH=4, d=128)
# The rows and KV heads of the rank at data 1, tensor 1 of a data 2 x
# tensor 2 mesh over 8 rows: the kernel_check cell whose dropout hash is
# keyed on global offsets (C5).
TP2_DROPOUT_OFFSETS = (4, 4)
MT_LAYERS, MT_STEPS, MT_B, MT_T = 2, 3, 4, 2048
PIPE_LAYERS, PIPE_STEPS, PIPE_MICRO = 4, 2, 4
MT_LOSS_REL = 1e-2
MT_BOUND_IS = ("per leaf, max |sharded - unsharded| over every element, "
               "bound 2 x steps x lr (Adam moves an entry at most lr a step "
               "either way) + 2**-7 x the leaf's max |value| (one bf16 ulp "
               "at its largest value)")
RING_SHAPE = dict(B=1, T=8192, H=32, KVH=8, d=128)
RING_SEED_WORDS = (0x2545F491, 0x9E3779B9)
RING_PROMPT, RING_NEW, RING_PREFILL_CHUNK = 4096, 16, 1024


def mesh_train_config(ptl, n_layers, **kw):
    """The mesh training cells' model: llama3-8b width, ``n_layers``
    deep, bf16, remat "dots", the flash kernels."""
    return ptl.get_config("llama3-8b", param_dtype="bfloat16",
                          dtype="bfloat16", n_layers=n_layers, remat=True,
                          remat_policy="dots", attn_impl="flash", **kw)


def mesh_train_batch(np, data, vocab):
    """The train phase's first B = 4 x 2048 batch (``data.batches``)."""
    return next(data.batches(train_documents(np, vocab), MT_B, MT_T))


def leaf_diffs(torch, got, ref, steps, lr):
    """Per leaf: max |got - ref| and its bound (``MT_BOUND_IS``); ``ref``
    maps names to (memory-mapped) host tensors."""
    out = {}
    for name, t in flat_tree(got).items():
        r = ref[name].to(t.device)
        diff = (t.float() - r.float()).abs().max().item()
        bound = 2 * steps * lr + 2.0 ** -7 * r.float().abs().max().item()
        out[name] = dict(max_abs=diff, bound=bound)
    return out


def mesh_cell_train(torch, state, axes, fsdp, n_layers, steps, ref_path,
                    micro=None):
    """One rank of mesh_train / pipeline_train: the seed-0 tree of
    ``n_layers`` drawn whole and sharded (``fsdp``: ZeRO-3), the train
    phase's batch split by ``shard_batch``, ``steps`` train_steps on the
    mesh, counted from zero; then the params gathered and held (rank 0)
    against the unsharded run's at ``ref_path``."""
    import numpy as np

    import jax_llama_tpu_torch as ptl
    from jax_llama_tpu_torch import data, train
    from jax_llama_tpu_torch.parallel import make_mesh
    from jax_llama_tpu_torch.parallel.partition import (gather_params,
                                                        shard_params)

    fa, pa = state["fa"], state["pa"]
    mesh = make_mesh(**axes, devices=["cuda:0"] * MESH_RANKS)
    cfg = mesh_train_config(ptl, n_layers, pp_microbatches=micro)
    full = ptl.init_params(cfg, seed=0, device="cuda")
    params = shard_params(full, mesh, cfg, fsdp=fsdp)
    del full
    batch = data.shard_batch(mesh_train_batch(np, data, cfg.vocab_size),
                             mesh)
    opt = train.make_optimizer()
    st = train.init_train_state(params, opt)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(fa, pa)
    mesh.collectives.clear()
    losses, step_ms, per_step = [], [], []
    for _ in range(steps):
        before = bwd_counts(fa)
        torch.cuda.synchronize()
        t = time.perf_counter()
        st, loss = train.train_step(st, batch.tokens, cfg, opt,
                                    loss_mask=batch.loss_mask, mesh=mesh)
        losses.append(loss.item())
        step_ms.append((time.perf_counter() - t) * 1e3)
        after = bwd_counts(fa)
        per_step.append({k: after[k] - before[k] for k in after})
    inst = instance_counts(fa, pa)
    out = dict(rank=mesh.rank, losses=losses, step_ms=step_ms,
               launches=launch_counts(fa, pa), launches_per_step=per_step,
               instances={k: inst[k] for k in (
                   "flash_fwd_by_instance", "flash_bwd_dq_by_instance",
                   "flash_bwd_dkv_by_instance")},
               peak_memory_bytes=torch.cuda.max_memory_allocated(),
               collectives=mesh_collectives(mesh),
               routes=dict(mesh.routes), backend=mesh.backend,
               local_rows=int(batch.tokens.shape[0]),
               local_qkv=list(st.params["layers"]["qkv"].shape))
    gathered = gather_params(st.params, mesh, cfg, fsdp=fsdp)
    del st, params
    if mesh.rank == 0:
        ref = torch.load(ref_path, map_location="cpu", mmap=True,
                         weights_only=True)
        out["diffs"] = leaf_diffs(torch, gathered, ref, steps,
                                  opt.learning_rate)
    del gathered
    torch.cuda.empty_cache()
    return out


def ring_inputs(torch, sl=slice(None)):
    """q, k, v and a cotangent g at RING_SHAPE (bf16, from a seed, the
    same in every process on the card), positions 0..T-1, sliced to
    ``sl`` along T."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    B, T, H, KVH, d = (RING_SHAPE[k] for k in ("B", "T", "H", "KVH", "d"))
    shapes = ((B, T, H, d), (B, T, KVH, d), (B, T, KVH, d), (B, T, H, d))
    q, k, v, g = (torch.randn(sh, device="cuda", generator=gen)
                  .to(torch.bfloat16)[:, sl].contiguous() for sh in shapes)
    pos = torch.arange(T, device="cuda", dtype=torch.int32)[None][:, sl]
    return q, k, v, g, pos.contiguous()


def mesh_cell_ring(torch, state, rate):
    """One rank of the ring phase: ``ring_sdpa`` forward and backward on
    its 4096 of RING_SHAPE's 8192 tokens over a seq = 2 mesh; its out, dq,
    dk, dv on the host, and the ms of one more forward + backward."""
    from jax_llama_tpu_torch.parallel import make_mesh, ring, use_mesh

    mesh = make_mesh(seq=MESH_RANKS, devices=["cuda:0"] * MESH_RANKS)
    n = RING_SHAPE["T"] // MESH_RANKS
    i = mesh.axis_index("seq")
    q, k, v, g, pos = ring_inputs(torch, slice(i * n, (i + 1) * n))

    def run():
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        with use_mesh(mesh):
            out = ring.ring_sdpa(*leaves, pos, pos,
                                 dropout_rng=RING_SEED_WORDS if rate
                                 else None, dropout_rate=rate)
            out.backward(g)
        return out.detach(), [x.grad for x in leaves]

    mesh.collectives.clear()
    out, grads = run()
    collectives = mesh_collectives(mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    run()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    return dict(rank=mesh.rank, seq_index=i, out=out.cpu(),
                dq=grads[0].cpu(), dk=grads[1].cpu(), dv=grads[2].cpu(),
                ms=ms, peak_memory_bytes=torch.cuda.max_memory_allocated(),
                collectives=collectives, routes=dict(mesh.routes))


def mesh_cell_ring_generate(torch, state, tokens, max_new):
    """One rank of the ring phase's cached generate: the MT_LAYERS-deep
    seed-0 tree whole on each rank, ``attn_impl="ring"`` on a seq = 2
    mesh, so the lockstep cache holds this rank's half of the slots and
    every step runs ``ring_decode``."""
    import jax_llama_tpu_torch as ptl
    from jax_llama_tpu_torch import engine
    from jax_llama_tpu_torch.parallel import make_mesh

    fa, pa = state["fa"], state["pa"]
    mesh = make_mesh(seq=MESH_RANKS, devices=["cuda:0"] * MESH_RANKS)
    cfg = mesh_train_config(ptl, MT_LAYERS).replace(attn_impl="ring",
                                                   remat=False)
    params = ptl.init_params(cfg, seed=0, device="cuda")
    gc = engine.GenerationConfig(max_new_tokens=max_new, temperature=0.0,
                                 prefill_chunk=RING_PREFILL_CHUNK)
    zero_counts(fa, pa)
    mesh.collectives.clear()
    t = time.perf_counter()
    out = engine.generate(params, tokens.cuda(), torch.ones_like(
        tokens, dtype=torch.bool).cuda(), config=cfg, gen_config=gc,
        device="cuda", mesh=mesh)
    torch.cuda.synchronize()
    return dict(rank=mesh.rank, tokens=out.cpu().tolist(),
                generate_s=time.perf_counter() - t,
                launches=launch_counts(fa, pa),
                collectives=mesh_collectives(mesh))


def mesh_cell_checkpoint(torch, state, path):
    """One rank of the checkpoint phase's mesh part: the saved tree
    loaded as a tensor = 2 shard and saved from that mesh (gathered, rank
    0 writes); then loaded with fsdp = 2 and held against
    ``shard_params(fsdp=True)`` of the whole file."""
    import json

    from jax_llama_tpu_torch.convert import load_checkpoint, save_checkpoint
    from jax_llama_tpu_torch.parallel import make_mesh, use_mesh
    from jax_llama_tpu_torch.parallel.partition import shard_params

    tp = make_mesh(tensor=MESH_RANKS, devices=["cuda:0"] * MESH_RANKS)
    t = time.perf_counter()
    shard, cfg = load_checkpoint(path, mesh=tp, verify=False)
    with use_mesh(tp):
        save_checkpoint(path + "_tensor2", shard, cfg)
    save_s = time.perf_counter() - t
    del shard
    fs = make_mesh(fsdp=MESH_RANKS, devices=["cuda:0"] * MESH_RANKS)
    got, _ = load_checkpoint(path, mesh=fs, fsdp=True, verify=False)
    full, _ = load_checkpoint(path, device="cpu", verify=False)
    want = shard_params(full, fs, cfg, fsdp=True)
    same = all(torch.equal(a, b) for a, b in zip(
        flat_tree(got).values(), flat_tree(want).values()))
    out = dict(rank=fs.rank, fsdp_same=same,
               fsdp_qkv=list(got["layers"]["qkv"].shape), save_s=save_s)
    if tp.rank == 0:
        out["manifests"] = [json.load(open(f"{p}/manifest.json"))
                            for p in (path, path + "_tensor2")]
    del got, full, want
    torch.cuda.empty_cache()
    return out


MESH_CELLS.update(train=mesh_cell_train, ring=mesh_cell_ring,
                  ring_generate=mesh_cell_ring_generate,
                  checkpoint=mesh_cell_checkpoint)


def plain_attention_grads(torch, fa, q, k, v, g, pos, rate):
    """The unsharded plain attention's out, dq, dk, dv (float32, through
    autograd), one KV head's query group at a time so that no [H, T, T]
    score tensor exists at once; with ``rate`` the probabilities dropped
    under the ring's hash mask (``ring.dropout_keep``)."""
    from jax_llama_tpu_torch.parallel import ring

    B, T, H, d = q.shape
    KVH = k.shape[2]
    G = H // KVH
    outs, dqs, dks, dvs = [], [], [], []
    allowed = (pos[:, None, :] <= pos[:, :, None])[:, None]
    base = (ring.dropout_base(RING_SEED_WORDS, B, H, device=q.device)
            if rate else None)
    for h in range(KVH):
        hs = slice(h * G, (h + 1) * G)
        qq = q[:, :, hs].float().requires_grad_()
        kk = k[:, :, h:h + 1].float().requires_grad_()
        vv = v[:, :, h:h + 1].float().requires_grad_()
        s = torch.einsum("bthd,bskd->bhts", qq, kk) / d ** 0.5
        p = torch.softmax(s.masked_fill(~allowed, float("-inf")), -1)
        if rate:
            keep = ring.dropout_keep(base[:, :, hs], pos, pos, rate)
            p = torch.where(keep, p / (1.0 - rate), 0.0)
        o = torch.einsum("bhts,bskd->bthd", p, vv)
        dq, dk, dv = torch.autograd.grad(o, (qq, kk, vv), g[:, :, hs].float())
        outs.append(o.detach())
        dqs.append(dq)
        dks.append(dk)
        dvs.append(dv)
        del s, p, o
    return (torch.cat(outs, 2), torch.cat(dqs, 2), torch.cat(dks, 2),
            torch.cat(dvs, 2))


def unsharded_train(torch, np, ptl, fa, pa, n_layers, steps, ref_path,
                    micro=None):
    """The mesh cells' unsharded run in this process: the same seed-0
    tree and batch, ``steps`` train_steps; the updated params written to
    ``ref_path`` for the ranks to hold theirs against."""
    from jax_llama_tpu_torch import data, train

    cfg = mesh_train_config(ptl, n_layers, pp_microbatches=micro)
    params = ptl.init_params(cfg, seed=0, device="cuda")
    batch = data.to_device(mesh_train_batch(np, data, cfg.vocab_size),
                           "cuda")
    opt = train.make_optimizer()
    st = train.init_train_state(params, opt)
    losses, step_ms = [], []
    zero_counts(fa, pa)
    for _ in range(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        st, loss = train.train_step(st, batch.tokens, cfg, opt,
                                    loss_mask=batch.loss_mask)
        losses.append(loss.item())
        step_ms.append((time.perf_counter() - t) * 1e3)
    launches = bwd_counts(fa)
    torch.save({n: t.detach().cpu() for n, t in
                flat_tree(st.params).items()}, ref_path)
    del st, params
    torch.cuda.empty_cache()
    return dict(losses=losses, step_ms=step_ms, launches=launches)


def check_mesh_train_cell(check, name, rows, ref, L, steps, per_mb=1):
    """A mesh training cell's rows against the unsharded run: losses,
    every gathered leaf within its bound, and per rank and step the
    flash launches a layer owes (times ``per_mb`` microbatches), all on
    the Hopper instance."""
    want_step = {"flash_fwd": 2 * L * per_mb, "flash_bwd_dq": L * per_mb,
                 "flash_bwd_dkv": L * per_mb}
    for r in rows:
        check(all(abs(a - b) <= MT_LOSS_REL * abs(b)
                  for a, b in zip(r["losses"], ref["losses"])),
              f"{name} rank {r['rank']} losses {r['losses']}, unsharded "
              f"{ref['losses']}")
        check(all(c == want_step for c in r["launches_per_step"]),
              f"{name} rank {r['rank']} launches per step "
              f"{r['launches_per_step']}, expected {want_step}")
        check(r["instances"] == {
            f"{k}_by_instance": {"wgmma": n * steps}
            for k, n in want_step.items()},
            f"{name} rank {r['rank']} instances {r['instances']}")
    over = {n: d for n, d in rows[0]["diffs"].items()
            if not d["max_abs"] <= d["bound"]}
    check(not over, f"{name}: leaves past their bound {over}")


def drive_mesh_training(torch, np, ptl, fa, pa, smi, ranks):
    """Phases ``mesh_train``, ``ring``, ``pipeline_train`` and
    ``checkpoint_mesh`` (ROADMAP A14 part 2): the two ranks of
    ``drive_mesh`` on cuda:0 over gloo, so every number is the ranks'
    time-shared run (correctness and per-rank kernel shapes, never a
    parallel speed).

    mesh_train: MT_LAYERS layers at llama3-8b width, B = 4 x 2048, remat
    "dots", flash, bf16; MT_STEPS steps on tensor = 2 and on fsdp = 2
    (ZeRO-3) against the same steps unsharded in this process.
    ring: ``ring_sdpa`` forward and backward at RING_SHAPE on seq = 2,
    without and with dropout 0.1, against the unsharded plain attention;
    then a ``ring_decode`` generate of RING_NEW greedy tokens over a
    seq-sharded cache holding a RING_PROMPT-token prompt.
    pipeline_train: stage = 2, PIPE_LAYERS layers, PIPE_MICRO
    microbatches of one row, PIPE_STEPS steps.
    checkpoint_mesh: a save from the tensor = 2 ranks whose manifest is
    the unsharded save's, and a load with fsdp = 2."""
    import shutil
    import tempfile

    from jax_llama_tpu_torch.convert import save_checkpoint

    failures = []

    def check(ok, what):
        if not ok:
            failures.append(what)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        rows = {}
        # mesh_train
        t0 = time.perf_counter()
        ref_path = os.path.join(tmp, "ref.pt")
        ref = unsharded_train(torch, np, ptl, fa, pa, MT_LAYERS, MT_STEPS,
                              ref_path)
        cells = {}
        for cell, axes, fsdp in (("tensor2", dict(tensor=2), False),
                                 ("fsdp2", dict(fsdp=2), True)):
            got = ranks.ask("train", axes=axes, fsdp=fsdp,
                            n_layers=MT_LAYERS, steps=MT_STEPS,
                            ref_path=ref_path)
            check_mesh_train_cell(check, f"mesh_train {cell}", got, ref,
                                  MT_LAYERS, MT_STEPS)
            cells[cell] = dict(
                axes=axes, fsdp=fsdp, losses=got[0]["losses"],
                step_ms_per_rank=[r["step_ms"] for r in got],
                launches_per_rank=[r["launches"] for r in got],
                launches_per_step=got[0]["launches_per_step"][0],
                instances_per_rank=[r["instances"] for r in got],
                peak_memory_bytes_per_rank=[r["peak_memory_bytes"]
                                            for r in got],
                collectives=got[0]["collectives"], routes=got[0]["routes"],
                backend=got[0]["backend"],
                local_rows=got[0]["local_rows"],
                local_qkv=got[0]["local_qkv"],
                max_leaf_diff=max(d["max_abs"]
                                  for d in got[0]["diffs"].values()),
                leaf_diffs=got[0]["diffs"])
        rows["mesh_train"] = dict(
            phase="mesh_train", card=smi, ranks=MESH_RANKS,
            devices="cuda:0 x 2 (gloo)", config="llama3-8b",
            n_layers=MT_LAYERS, reduced=f"depth 32 -> {MT_LAYERS} layers",
            dim=4096, dtype="bfloat16", remat="dots", attn_impl="flash",
            batch=MT_B, seq_len=MT_T, steps=MT_STEPS,
            step_ms_is="host clock around each train_step (its loss read "
            "syncs), two ranks time-sharing one card: not a parallel speed",
            unsharded=ref, loss_rel_bound=MT_LOSS_REL,
            leaf_bound_is=MT_BOUND_IS, cells=cells,
            seconds=time.perf_counter() - t0)
        emit(rows["mesh_train"])

        # ring
        t0 = time.perf_counter()
        q, k, v, g, pos = ring_inputs(torch)
        ring_cells = {}
        for rate in (0.0, TRAIN_DROPOUT):
            got = ranks.ask("ring", rate=rate)
            got.sort(key=lambda r: r["seq_index"])
            want = plain_attention_grads(torch, fa, q, k, v, g, pos, rate)
            errs = {}
            for name, w in zip(("out", "dq", "dk", "dv"), want):
                full = torch.cat([r[name] for r in got], 1).cuda()
                errs[name] = row_rel_err(
                    torch, full, w,
                    short_rows(pos, pos, RING_SHAPE["H"])
                    if name == "dq" else None)
            del want
            label = "dropout" if rate else "no_dropout"
            ring_cells[label] = dict(
                dropout=rate, err=errs, bound={n: TRAIN_BOUNDS[n]
                                               for n in errs},
                ms_per_rank=[r["ms"] for r in got],
                peak_memory_bytes_per_rank=[r["peak_memory_bytes"]
                                            for r in got],
                collectives=got[0]["collectives"], routes=got[0]["routes"])
            check(all(e < TRAIN_BOUNDS[n] for n, e in errs.items()),
                  f"ring ({label}): {errs} against {TRAIN_BOUNDS}")
        del q, k, v, g, pos
        # the seq-sharded cached generate, against the unsharded run
        from jax_llama_tpu_torch import engine

        gen = torch.Generator(device="cuda").manual_seed(11)
        prompt = torch.randint(0, 128000, (1, RING_PROMPT), device="cuda",
                               generator=gen, dtype=torch.int32)
        rcfg = mesh_train_config(ptl, MT_LAYERS).replace(attn_impl="ring",
                                                        remat=False)
        rparams = ptl.init_params(rcfg, seed=0, device="cuda")
        gc = engine.GenerationConfig(max_new_tokens=RING_NEW,
                                     temperature=0.0,
                                     prefill_chunk=RING_PREFILL_CHUNK)
        want = engine.generate(rparams, prompt, torch.ones_like(
            prompt, dtype=torch.bool), config=rcfg, gen_config=gc,
            device="cuda")[0, RING_PROMPT:].tolist()
        got = ranks.ask("ring_generate", tokens=prompt.cpu(),
                        max_new=RING_NEW)
        check(not same_across_ranks(got, ["tokens"]), "ring ranks differ")
        divergences = []
        try:
            divergences = token_divergences(
                torch, ptl, rparams, rcfg, [prompt[0].tolist()],
                [got[0]["tokens"][0][RING_PROMPT:]], [want], DECODE_REL)
        except AssertionError as e:
            failures.append(f"ring generate: {e}")
        del rparams
        torch.cuda.empty_cache()
        L = MT_LAYERS
        n_steps = RING_NEW  # the prefill's chunks and the decode steps
        rows["ring"] = dict(
            phase="ring", card=smi, ranks=MESH_RANKS, seq=MESH_RANKS,
            shape=RING_SHAPE, tokens_per_rank=RING_SHAPE["T"] // MESH_RANKS,
            dtype="bfloat16", cells=ring_cells,
            err_is=TRAIN_ERR_IS, ms_is="host clock around one forward + "
            "backward (synchronized), two ranks time-sharing one card",
            generate=dict(
                config="llama3-8b", n_layers=L, dtype="bfloat16",
                attn_impl="ring", prompt_tokens=RING_PROMPT,
                prefill_chunk=RING_PREFILL_CHUNK, new_tokens=RING_NEW,
                slots_per_rank=(RING_PROMPT + RING_NEW) // MESH_RANKS,
                tokens_equal=got[0]["tokens"][0][RING_PROMPT:] == want,
                divergences=divergences, tie_bound=DECODE_REL,
                generate_s_per_rank=[r["generate_s"] for r in got],
                launches=got[0]["launches"],
                collectives=got[0]["collectives"], decode_steps=n_steps),
            seconds=time.perf_counter() - t0)
        emit(rows["ring"])

        # pipeline_train
        t0 = time.perf_counter()
        pref = unsharded_train(torch, np, ptl, fa, pa, PIPE_LAYERS,
                               PIPE_STEPS, ref_path, micro=PIPE_MICRO)
        got = ranks.ask("train", axes=dict(stage=2), fsdp=False,
                        n_layers=PIPE_LAYERS, steps=PIPE_STEPS,
                        ref_path=ref_path, micro=PIPE_MICRO)
        check_mesh_train_cell(check, "pipeline_train", got, pref,
                              PIPE_LAYERS // 2, PIPE_STEPS, PIPE_MICRO)
        rows["pipeline_train"] = dict(
            phase="pipeline_train", card=smi, ranks=MESH_RANKS, stage=2,
            config="llama3-8b", n_layers=PIPE_LAYERS,
            layers_per_stage=PIPE_LAYERS // 2,
            reduced=f"depth 32 -> {PIPE_LAYERS} layers", dtype="bfloat16",
            remat="dots", attn_impl="flash", batch=MT_B, seq_len=MT_T,
            microbatches=PIPE_MICRO, microbatch_rows=MT_B // PIPE_MICRO,
            steps=PIPE_STEPS, unsharded=pref, losses=got[0]["losses"],
            step_ms_per_rank=[r["step_ms"] for r in got],
            launches_per_rank=[r["launches"] for r in got],
            launches_per_step=got[0]["launches_per_step"][0],
            instances_per_rank=[r["instances"] for r in got],
            peak_memory_bytes_per_rank=[r["peak_memory_bytes"] for r in got],
            collectives=got[0]["collectives"],
            max_leaf_diff=max(d["max_abs"]
                              for d in got[0]["diffs"].values()),
            leaf_diffs=got[0]["diffs"], leaf_bound_is=MT_BOUND_IS,
            seconds=time.perf_counter() - t0)
        emit(rows["pipeline_train"])

        # checkpoint_mesh
        t0 = time.perf_counter()
        from jax_llama_tpu_torch.convert import load_checkpoint

        cfg = mesh_train_config(ptl, MT_LAYERS)
        path = os.path.join(tmp, "ckpt")
        full = ptl.init_params(cfg, seed=0, device="cuda")
        save_checkpoint(path, full, cfg)
        del full
        got = ranks.ask("checkpoint", path=path)
        manifests = got[0]["manifests"]
        same_manifest = (manifests[0]["files"] == manifests[1]["files"])
        check(same_manifest, "checkpoint_mesh: the tensor = 2 save's "
              "manifest differs from the unsharded save's")
        check(all(r["fsdp_same"] for r in got),
              "checkpoint_mesh: an fsdp = 2 load differs from "
              "shard_params(fsdp=True)")
        rows["checkpoint_mesh"] = dict(
            phase="checkpoint_mesh", card=smi, ranks=MESH_RANKS,
            config="llama3-8b", n_layers=MT_LAYERS, dtype="bfloat16",
            manifest_digests_equal=same_manifest,
            files={f: m["sha256"][:16] for f, m in
                   manifests[1]["files"].items()},
            fsdp_load_equal=[r["fsdp_same"] for r in got],
            fsdp_qkv=got[0]["fsdp_qkv"],
            tensor2_load_and_save_s=[r["save_s"] for r in got],
            seconds=time.perf_counter() - t0)
        emit(rows["checkpoint_mesh"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if failures:
        raise AssertionError("mesh training phases failed:\n"
                             + "\n".join(failures))
    return rows


RANK_FLAG = "--torchrun-rank"


def torchrun_rank(out_dir, argv):
    """One rank of ``torchrun_one_shot``: ``jax_llama_tpu_torch.run``'s
    ``main`` on ``argv``, as ``python -m jax_llama_tpu_torch.run`` runs
    it, with the kernels' counts zeroed just before it; then this rank's
    launches and flash instances go to ``out_dir/rank<RANK>.json``."""
    sys.path.insert(0, HERE)
    from jax_llama_tpu_torch import run

    fa = importlib.import_module("jax_llama_tpu_torch.ops.flash_attention")
    pa = importlib.import_module("jax_llama_tpu_torch.ops.paged_attention")
    sys.argv = ["jax_llama_tpu_torch.run", *argv]
    zero_counts(fa, pa)
    run.main()
    counts = dict(launches=launch_counts(fa, pa), flash_by_instance=dict(
        fa.flash_attention.launches_by_instance))
    with open(os.path.join(out_dir, f"rank{os.environ['RANK']}.json"),
              "w") as f:
        json.dump(counts, f)


def torchrun_one_shot(argv, timeout_s=300):
    """``python -m torch.distributed.run --nproc-per-node MESH_RANKS``
    over ``torchrun_rank`` (``jax_llama_tpu_torch.run`` on ``argv``) from
    the checkout: (rc, stdout, stderr's tail, wall s, each rank's counts
    or None where a rank wrote none)."""
    import shutil
    import tempfile

    env = dict(os.environ)
    env["PYTHONPATH"] = HERE + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
    t = time.perf_counter()
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run",
             "--nproc-per-node", str(MESH_RANKS), "--master-port",
             str(free_port()), os.path.abspath(__file__), RANK_FLAG,
             out_dir, "--", *argv],
            cwd=HERE, env=env, capture_output=True, text=True,
            timeout=timeout_s)
        wall = time.perf_counter() - t
        counts = []
        for r in range(MESH_RANKS):
            path = os.path.join(out_dir, f"rank{r}.json")
            counts.append(json.load(open(path)) if os.path.exists(path)
                          else None)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    return proc.returncode, proc.stdout, proc.stderr[-2000:], wall, counts


def rel_err(a, b) -> float:
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()


# The rehearsal phase's synthetic geometry: head_dim 64, which the flash
# kernels take (JAX's default, dim 64 over 4 heads, is head_dim 16).
REHEARSAL_GEOMETRY = dict(dim=256, n_heads=4, n_kv_heads=2)
REHEARSAL_PARITY = 1e-3
# The runtime host-sync audit: depth, rows, prompt and new tokens, and
# the steady steps watched.
HOSTSYNC_LAYERS, HOSTSYNC_ROWS = 8, 4
HOSTSYNC_PROMPT, HOSTSYNC_NEW, HOSTSYNC_STEPS = 64, 96, 4


def drive_rehearsal(torch, fa, pa, smi):
    """Phase ``rehearsal`` (module docstring)."""
    import numpy as np

    from jax_llama_tpu_torch import rehearsal

    t0 = time.perf_counter()
    L = 2                      # _write_synthetic_meta_checkpoint's depth
    zero_counts(fa, pa)
    res = rehearsal.rehearse_synthetic(device="cuda", **REHEARSAL_GEOMETRY)
    torch.cuda.synchronize()
    launches = launch_counts(fa, pa)
    by_instance = dict(fa.flash_attention.launches_by_instance)
    synthetic_s = time.perf_counter() - t0
    zero_counts(fa, pa)
    try:
        rehearsal.rehearse_synthetic(device="cuda")
        refused = None
    except ValueError as e:
        refused = str(e)
    refused_launches = launch_counts(fa, pa)
    t = time.perf_counter()
    shapes = rehearsal.rehearse_8b_shapes()
    shapes_s = time.perf_counter() - t
    want = dict(NO_LAUNCHES, flash_fwd=2 * L)
    row = dict(phase="rehearsal", card=smi, geometry=REHEARSAL_GEOMETRY,
               n_layers=L, dtype="float32",
               tokens=res["tokens"].tolist(), parity=res["parity"],
               parity_bound=REHEARSAL_PARITY,
               last_logits_finite=bool(np.isfinite(
                   res["last_logits"]).all()),
               launches=launches, expected_launches=want,
               flash_by_instance=by_instance,
               default_geometry_refused=refused,
               default_geometry_launches=refused_launches,
               shapes_8b=shapes, synthetic_s=synthetic_s,
               shapes_8b_s=shapes_s, seconds=time.perf_counter() - t0)
    emit(row)
    if not (res["parity"] is not None
            and res["parity"] < REHEARSAL_PARITY
            and row["last_logits_finite"]):
        raise AssertionError(f"rehearsal parity {res['parity']}")
    if launches != want or by_instance != {"float32": 2 * L}:
        raise AssertionError(f"rehearsal launches {launches} "
                             f"{by_instance}, expected {want} on float32")
    if refused is None or "head_dim 16" not in refused or any(
            refused_launches.values()):
        raise AssertionError(f"rehearsal at JAX's default geometry on the "
                             f"card: {refused}, {refused_launches}")
    if not (shapes["leaves"] == 9 and 7.9e9 < shapes["params"] < 8.4e9
            and shapes["largest_shard_bytes"] > 0):
        raise AssertionError(f"rehearse_8b_shapes: {shapes}")
    return row


def sync_site_sanctioned(path, line):
    """Does the statement of ``path`` holding ``line`` carry an
    ``# audit: host-fetch`` pragma (the static lint's grammar: on the
    statement, the line above it, or its function's ``def`` line)?"""
    import ast

    from jax_llama_tpu_torch.analysis.common import Pragmas

    with open(path) as f:
        source = f.read()
    tree = ast.parse(source)
    spans = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and (
                node.lineno <= line <= node.end_lineno):
            spans.append((node.lineno, node.lineno))
        elif isinstance(node, ast.stmt) and not isinstance(node, (
                ast.If, ast.For, ast.While, ast.With, ast.Try,
                ast.ClassDef)) and node.lineno <= line <= node.end_lineno:
            spans.append((node.lineno, node.end_lineno))
    return Pragmas.scan(source).allows("host-fetch", *spans)


def drive_hostsync_runtime(torch, ptl, fa, pa, params, cfg, tok, smi):
    """Phase ``hostsync_runtime`` (module docstring)."""
    import traceback
    import warnings

    t0 = time.perf_counter()
    L = HOSTSYNC_LAYERS
    shallow = dict(params, layers={k: w[:L] for k, w in
                                   params["layers"].items()})
    c = cfg.replace(n_layers=L)
    text = serve_texts()[0]
    prompts = [tok.encode(text[17 * i:17 * i + HOSTSYNC_PROMPT - 1],
                          bos=True) for i in range(HOSTSYNC_ROWS)]
    zero_counts(fa, pa)
    cb = ptl.ContinuousBatcher(shallow, c, n_slots=8, max_len=2048,
                               decode_chunk=8, device="cuda")
    for p in prompts:
        cb.submit(p, max_new_tokens=HOSTSYNC_NEW)
    for _ in range(2):                 # admission, then a settled step
        cb.step()
    torch.cuda.synchronize()
    pkg = os.path.join(HERE, "jax_llama_tpu_torch") + os.sep
    sites, steps, stepping = [], [], [False]

    def hook(message, category, filename, lineno, file=None, line=None):
        # Only what a step raises: setting the mode warns once that the
        # feature is a prototype, which is no sync.
        if not stepping[0]:
            return
        port = [f for f in traceback.extract_stack()
                if f.filename.startswith(pkg)]
        where = port[-1] if port else None
        sites.append(dict(
            path=os.path.relpath(where.filename, HERE) if where
            else filename, line=where.lineno if where else lineno,
            message=str(message)[:120]))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(HOSTSYNC_STEPS):
                if not cb.pending():
                    break
                n0, h0 = len(sites), cb.host_syncs_total
                d0, u0 = cb.steps_total, cb.state_uploads_total
                stepping[0] = True
                try:
                    cb.step()
                finally:
                    stepping[0] = False
                steps.append(dict(syncs=len(sites) - n0,
                                  host_syncs=cb.host_syncs_total - h0,
                                  iterations=cb.steps_total - d0,
                                  uploads=cb.state_uploads_total - u0))
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    launches = launch_counts(fa, pa)
    stats = cb.stats()
    del cb
    by_site = {}
    for st in sites:
        key = f"{st['path']}:{st['line']}"
        by_site.setdefault(key, dict(count=0, message=st["message"],
                                     sanctioned=sync_site_sanctioned(
                                         os.path.join(HERE, st["path"]),
                                         st["line"])))
        by_site[key]["count"] += 1
    want = dict(NO_LAUNCHES, flash_fwd=L * stats["insert_dispatches_total"],
                paged_decode=L * stats["decode_steps_total"])
    row = dict(phase="hostsync_runtime", card=smi, config="llama3-8b",
               n_layers=L, dtype="bfloat16", rows=HOSTSYNC_ROWS,
               steady_steps=steps, sync_sites=by_site, launches=launches,
               expected_launches=want,
               host_syncs_total=stats["host_syncs_total"],
               seconds=time.perf_counter() - t0)
    emit(row)
    if len(steps) != HOSTSYNC_STEPS or any(
            s["syncs"] != s["host_syncs"] or s["host_syncs"] != 1
            or s["uploads"] or not s["iterations"] for s in steps):
        raise AssertionError(f"hostsync_runtime: steady steps {steps}, "
                             f"sites {by_site}")
    unsanctioned = [k for k, v in by_site.items() if not v["sanctioned"]]
    if not by_site or unsanctioned:
        raise AssertionError(f"hostsync_runtime: sync sites without a "
                             f"host-fetch pragma: {unsanctioned} "
                             f"({by_site})")
    if launches != want or not want["flash_fwd"]:
        raise AssertionError(f"hostsync_runtime launches {launches}, "
                             f"expected {want}")
    return row


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
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
    tp2_train_rows = check_train_kernels(torch, fa, gen, "tp2_train",
                                         TP2_TRAIN_SHAPE, f32=False,
                                         offsets=TP2_DROPOUT_OFFSETS)
    shard_rows = check_shard_kernels(torch, fa, pa, kn, gen,
                                     paged_row["instance"])

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

    # Phase 3b: tensor and data parallelism (ROADMAP A14 part 1): two
    # ranks on the one card, the generate phase's prompts at full width
    # on a tensor = 2 mesh, then the serving mesh at 8 layers.
    # The ranks serve phase 9b too; they are stopped at the end.
    ranks = MeshRanks()
    mesh_gen, mesh_serve_row = drive_mesh(
        torch, ptl, fa, pa, params, cfg, tok, smi, tokens, mask, out,
        [tok.encode(p, bos=True) for p in prompts], ranks)

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
    ckpt_row, mesh_http_row, mesh_router_row = drive_checkpoint(
        torch, ptl, fa, pa, shallow, cfg, smi, ranks)
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

    # Phase 5d: the prefix cache and the host tier (ROADMAP A11): a shared
    # system prompt at full width, then the exact invariants at 8 layers.
    prefix_row = drive_prefix_serving(torch, np, ptl, fa, pa, params, cfg,
                                      tok, smi, serve_row)
    prefix_inv = drive_prefix_invariant(torch, np, ptl, fa, pa, params, cfg,
                                        tok, smi)

    # Phase 5e: fused prefill-decode scheduling with logprobs (ROADMAP A9,
    # A17): the serving traffic at full width, then the exact invariants,
    # score and the forward's auxiliary outputs at 8 layers.
    fused_row = drive_fused_serving(torch, ptl, engine, fa, pa, params, cfg,
                                    tok, smi)
    fused_inv = drive_fused_invariant(torch, np, ptl, engine, fa, pa, params,
                                      cfg, tok, smi)

    # Phase 5f: the replica router (ROADMAP A12 part 1): two replicas on
    # the one weight copy at full width and FLEET_LAYERS deep, then the
    # control-plane drill at 8 layers.
    fleet_params = dict(params, layers={k: w[:FLEET_LAYERS] for k, w in
                                        params["layers"].items()})
    fleet_cfg = cfg.replace(n_layers=FLEET_LAYERS)
    router_row = drive_router_serving(torch, np, ptl, fa, pa, fleet_params,
                                      fleet_cfg, tok, smi)
    router_drill = drive_router_drill(torch, np, ptl, fa, pa, params, cfg,
                                      tok, smi)

    # Phase 5g: the fleet controller (ROADMAP A12 part 2): a scale-up and a
    # drain by migration at full width and FLEET_LAYERS deep, then the
    # controller's drills at 8 layers.
    fleet_row = drive_fleet_serving(torch, np, ptl, fa, pa, fleet_params,
                                    fleet_cfg, tok, smi)
    del fleet_params
    fleet_drill = drive_fleet_drill(torch, np, ptl, fa, pa, params, cfg,
                                    tok, smi)

    # Phase 5h: the dress rehearsal and the runtime host-sync audit
    # (ROADMAP A16 part 2).
    rehearsal_row = drive_rehearsal(torch, fa, pa, smi)
    hostsync_row = drive_hostsync_runtime(torch, ptl, fa, pa, params, cfg,
                                          tok, smi)

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

    # Phase 9b: sharded training, ring attention, pipeline stages and
    # checkpoints from a mesh (ROADMAP A14 part 2), two ranks on the card.
    try:
        a14 = drive_mesh_training(torch, np, ptl, fa, pa, smi, ranks)
    finally:
        ranks.close()
    mt_cells = a14["mesh_train"]["cells"]

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
             "http_drill": drill_row["launches"],
             "prefix_serving": prefix_row["launches"],
             "prefix_invariant": prefix_inv["launches"],
             "fused_serving": fused_row["launches"],
             "fused_invariant": fused_inv["launches"],
             "router_serving": router_row["launches"],
             "router_drill": router_drill["launches"],
             "fleet_serving": fleet_row["launches"],
             "fleet_drill": fleet_drill["launches"],
             "rehearsal": rehearsal_row["launches"],
             "hostsync_runtime": hostsync_row["launches"],
             "mesh_generate": mesh_gen["launches_per_rank"][0],
             "mesh_serving": mesh_serve_row["tensor2"][
                 "launches_per_rank"][0],
             "mesh_http": mesh_http_row["launches"],
             "mesh_http_float32": mesh_http_row["cells"]["float32"][
                 "launches_per_rank"][0],
             "mesh_router": mesh_router_row["launches"],
             "mesh_train_tensor2": mt_cells["tensor2"][
                 "launches_per_rank"][0],
             "mesh_train_fsdp2": mt_cells["fsdp2"]["launches_per_rank"][0],
             "pipeline_train": a14["pipeline_train"][
                 "launches_per_rank"][0]}
    # Each rank's launches on the mesh paths (every rank launches the
    # same kernels on its own heads and rows).
    mesh_paths = {
        "mesh_generate": mesh_gen["launches_per_rank"],
        "mesh_serving": mesh_serve_row["tensor2"]["launches_per_rank"],
        "mesh_serving_data2": mesh_serve_row["data2"]["launches_per_rank"],
        "checkpoint_tensor2": ckpt_row["runs"]["one_shot_tensor2"][
            "launches_per_rank"],
        "mesh_http": mesh_http_row["cells"]["bf16"]["launches_per_rank"],
        "mesh_http_float32": mesh_http_row["cells"]["float32"][
            "launches_per_rank"],
        "mesh_router": mesh_router_row["launches_per_rank"],
        "mesh_train_tensor2": mt_cells["tensor2"]["launches_per_rank"],
        "mesh_train_fsdp2": mt_cells["fsdp2"]["launches_per_rank"],
        "pipeline_train": a14["pipeline_train"]["launches_per_rank"]}

    def shard_sub(name):
        """The kernel at a tensor = 2 rank's shape (its kernel_check
        cell) and its launches per rank on the mesh paths."""
        row = shard_rows[name]
        return dict({k: row[k] for k in (
            "shape", "B", "T", "S", "H", "KVH", "G", "instance",
            "worst_row_rel", "ms", "device_ms", "plain_ms", "library_ms",
            "bound_ms", "bound_by") if k in row},
            launches_per_rank={path: [r[name] for r in rows]
                               for path, rows in mesh_paths.items()})

    paths_instances = {"generate": instances,
                       "serving": serve_row["instances"],
                       "http_serving": http_row["instances"],
                       "fused_serving": fused_row["instances"],
                       "router_serving": router_row["instances"],
                       "fleet_serving": fleet_row["instances"],
                       "train": train_row["instances"]}

    def by_path(name):
        return {path: counts[name] for path, counts in paths.items()}

    def tp2_train_sub(name):
        """The kernel at a tensor = 2 rank's training shape (its
        kernel_check cells) and its launches per rank on the mesh
        training paths."""
        row = tp2_train_rows[(name, "no_dropout")]
        drop = tp2_train_rows[(name, "dropout")]
        return dict(
            {k: row[k] for k in ("B", "T", "H", "KVH", "d", "instance",
                                 "ms", "device_ms", "plain_ms",
                                 "library_ms", "bound_ms", "bound_by")},
            max_abs_err=max(row["worst_row_rel"], drop["worst_row_rel"]),
            dropout_ms=drop["ms"], dropout_device_ms=drop["device_ms"],
            dropout_plain_ms=drop["plain_ms"],
            dropout_library_ms=drop["library_ms"],
            dropout_bound_ms=drop["bound_ms"],
            launches_per_rank={path: [r[name] for r in mesh_paths[path]]
                               for path in ("mesh_train_tensor2",
                                            "mesh_train_fsdp2",
                                            "pipeline_train")})

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
                for path, inst in paths_instances.items()
                if f"{name}_by_instance" in inst},
            plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row["library_ms"], tp2_train=tp2_train_sub(name))

    def flash_sub(name, extra=()):
        row = flash_rows[name]
        return {k: row[k] for k in (
            "B", "T", "S", "dtype", "instance", "ms", "device_ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms",
            "worst_row_rel", *extra)}

    pre = flash_rows["insert"]
    fwd = train_kernel("flash_fwd", "jax_llama_tpu/ops/flash_attention.py:868")
    fwd.update(insert_ms=pre["ms"], insert_bound_ms=pre["bound_ms"],
               insert_plain_ms=pre["plain_ms"],
               insert_library_ms=pre["library_ms"],
               insert_instance=pre["instance"],
               decode=dict(flash_sub("decode"), replaced_device_ms=flash_rows[
                   "decode"]["replaced_device_ms"]),
               cached_decode=flash_sub("cached_decode"),
               fused_chunk=flash_sub("fused_chunk", ("base",
                                                     "lse_max_abs_err")),
               tp2=shard_sub("flash_fwd"))
    fi8 = flash_int8_rows["bfloat16"]
    pi8 = paged_int8_rows["serving"]

    def int8_sub(row, **extra):
        return dict(extra, max_abs_err=row["worst_row_rel"], ms=row["ms"],
                    device_ms=row["device_ms"], warm_ms=row["warm_ms"],
                    plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                    bound_by=row["bound_by"], library_ms=row["library_ms"],
                    instance=row["instance"])

    emit(dict(phase="total", seconds=time.perf_counter() - t_start,
              card=smi))
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
             float32_device_ms=flash_int8_rows["float32"]["device_ms"],
             fused_chunk=int8_sub(flash_int8_rows["fused_chunk"],
                                  T=FUSED_CHUNK["T"], S=FUSED_CHUNK["S"],
                                  base=FUSED_CHUNK["base"])),
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
                 float32_ms=verify_rows["float32"]["ms"]),
             tp2=shard_sub("paged_decode")),
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
             float32_instance=stock_rows["float32"]["instance"],
             tp2=shard_sub("stock_paged")),
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
                 "instance")},
             tp2=shard_sub("splash_prefill")),
    ]})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == [RANK_FLAG]:
        torchrun_rank(sys.argv[2], sys.argv[4:])
        sys.exit(0)
    sys.exit(main())
