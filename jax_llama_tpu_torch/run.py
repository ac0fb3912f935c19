"""Completion CLI: load a checkpoint onto the card and complete prompts
(port of ``jax_llama_tpu/run.py``).

    python -m jax_llama_tpu_torch.run \
        --ckpt-dir /path/to/llama3-8b-torch \
        --tokenizer /path/to/tokenizer.model \
        [--llama2] [--prompt "..." --prompt "..."] \
        [--max-gen-len 256] [--temperature 0.8] [--top-p 0.95] \
        [--attn auto] [--quantize] [--device cuda]

    python -m jax_llama_tpu_torch.run --ckpt-dir ... --serve [--slots 4] \
        [--decode-chunk 8] [--prefill-kernel splash] \
        [--decode-kernel stock-paged] [--draft-ckpt-dir ...] < prompts.txt

    python -m jax_llama_tpu_torch.run --ckpt-dir ... --http 8000 \
        [--slots 4] [--slo-ttft-ms 500] [--inject-faults SPEC] ...

The checkpoint is the port's (``python -m jax_llama_tpu_torch.convert``
writes one from Meta's files).  The argument parser is the JAX package's,
so an argv that one accepts the other does too, plus ``--device`` (default
"cuda"); the defaults differ only in ``--peak-tflops`` and
``--peak-hbm-gbps``, which name the H100's peaks.  The one-shot mode,
``--serve`` (prompts on stdin, one per line) and ``--http PORT``
(``server.LLMServer``: POST /generate and /chat, GET /metrics, /healthz,
/debug/*) run on the card, or on the CPU with ``--device cpu``; ``--http``
never falls back to the CPU.  A flag whose feature is not ported exits
with a message that names its ROADMAP item: ``--logprobs`` (A17),
``--replicas`` > 1, ``--autoscale``, ``--replica-roles`` (A12),
``--serve-mesh`` and a ``--data``/``--fsdp``/``--tensor`` mesh of more
than one device (A14), ``--host-kv-blocks`` > 0 (A11).  ``--serve`` and
``--http`` run without the prefix cache (A11) and with classic
whole-prompt admission (A9), and say so in one log line when the flags
ask for either (their defaults do).  ``--log-json`` formats the log lines.
The flags that only configure the replica fleet (routing, canaries,
autoscale bounds: A12) are parsed from one table, ``_FLEET_FLAGS``, and
have nothing to configure until their item.
"""

from __future__ import annotations

import argparse
import os

DEFAULT_PROMPTS = [
    "I believe the meaning of life is",
    "Simply put, the theory of relativity states that",
]


# Flags that only configure the replica fleet (ROADMAP A12), as (flag,
# type (None: a string), default, choices): registered with the JAX CLI's
# names, types and defaults so that one argv parses in both packages.
# Until A12 they have nothing to configure.
_FLEET_FLAGS = (
    ("--route", None, "least-loaded",
     ("least-loaded", "affinity", "cache-aware")),
    ("--canary-interval-s", float, 10.0, None),
    ("--autoscale-min", int, 1, None),
    ("--autoscale-max", int, 8, None),
    ("--autoscale-interval-s", float, 5.0, None),
)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ckpt-dir", required=True,
                    help="checkpoint dir written by save_checkpoint or "
                         "python -m jax_llama_tpu_torch.convert")
    ap.add_argument("--tokenizer", default=None)
    ap.add_argument("--llama2", action="store_true",
                    help="sentencepiece (llama2) tokenizer")
    ap.add_argument("--byte-tokenizer", action="store_true",
                    help="vocab-file-free byte tokenizer (smoke tests)")
    ap.add_argument("--tensor", type=int, default=0,
                    help="tensor-parallel degree (0 = every local device, "
                         "here the one card; > 1 is ROADMAP A14)")
    ap.add_argument("--data", type=int, default=1,
                    help="data-parallel degree (> 1 is ROADMAP A14)")
    ap.add_argument("--fsdp", type=int, default=1,
                    help="FSDP degree (> 1 is ROADMAP A14)")
    ap.add_argument("--prompt", action="append", default=None)
    ap.add_argument("--max-gen-len", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--top-p", type=float, default=0.95)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--attn", default=None,
                    choices=["xla", "flash", "auto"],
                    help="override attn_impl from the checkpoint config, "
                         "which the converter writes as 'xla' (plain "
                         "attention, no kernel); 'flash' runs the flash "
                         "kernel in every forward, 'auto' in forwards of "
                         "more than 8 tokens (the prefill)")
    ap.add_argument("--prefill-kernel", default=None,
                    choices=["flash", "splash", "auto"],
                    help="attention kernel for --serve inserts "
                         "(default: the checkpoint config's, which the "
                         "converter writes as flash; ops/kernels.py; "
                         "auto = splash when head_dim is "
                         "a multiple of 128 and the cache is not int8, "
                         "else flash; a chunk splash cannot take runs "
                         "flash; a failed build or launch raises)")
    ap.add_argument("--decode-kernel", default=None,
                    choices=["paged", "stock-paged", "gathered", "auto"],
                    help="attention kernel for --serve decode steps "
                         "(default: the checkpoint config's, which the "
                         "converter writes as paged; auto = paged; "
                         "stock-paged takes T = 1 steps "
                         "over a full-precision pool and leaves the rest "
                         "to paged; gathered = the gathered view, no "
                         "kernel; a failed build or launch raises)")
    ap.add_argument("--quantize", action="store_true",
                    help="int8-quantize weights after load (weight-only, "
                         "per-channel)")
    ap.add_argument("--serve", action="store_true",
                    help="continuous-batching mode: read prompts (one per "
                         "line) from stdin, print completions as they "
                         "finish; requests share a slot pool")
    ap.add_argument("--slots", type=int, default=4,
                    help="slot-pool size for --serve")
    ap.add_argument("--serve-mesh", default=None, metavar="DP,TP",
                    help="serving-mesh geometry (ROADMAP A14; refused)")
    ap.add_argument("--replicas", type=int, default=1, metavar="N",
                    help="serving replicas behind one HTTP door (> 1 is "
                         "ROADMAP A12; refused)")
    ap.add_argument("--autoscale", action="store_true",
                    help="elastic replica fleet (ROADMAP A12; refused)")
    ap.add_argument("--replica-roles", default=None, metavar="R,R,...",
                    help="prefill/decode disaggregation (ROADMAP A12; "
                         "refused)")
    ap.add_argument("--decode-chunk", type=int, default=8,
                    help="fuse up to this many decode iterations per "
                         "step() in --serve (token-identical to 1; 1 "
                         "restores the per-token loop; speculative "
                         "serving chunks by --spec-rounds instead)")
    ap.add_argument("--prefill-budget", type=int, default=512,
                    help="fused prefill-decode scheduling (ROADMAP A9): "
                         "--serve admits whole prompts (budget 0) and "
                         "logs one line when this asks for more")
    ap.add_argument("--draft-ckpt-dir", default=None,
                    help="checkpoint dir of a draft model for speculative "
                         "--serve (must share the target's vocabulary; "
                         "the draft only changes speed, never content)")
    ap.add_argument("--n-draft", type=int, default=4,
                    help="draft tokens proposed per speculative round "
                         "(with --draft-ckpt-dir)")
    ap.add_argument("--spec-rounds", type=int, default=8,
                    help="fuse up to this many speculative draft+verify "
                         "rounds per step() (token-identical to 1)")
    ap.add_argument("--http", type=int, default=None, metavar="PORT",
                    help="serve over HTTP on this port (POST /generate "
                         "with blocking or NDJSON-streaming responses, "
                         "POST /chat for llama-3 tokenizers, "
                         "GET /metrics, /healthz, /debug/*) instead of "
                         "the stdin loop; 0 picks a free port")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="the prefix cache is ROADMAP A11: --serve always "
                         "runs without it, so this flag changes nothing "
                         "but the log line")
    ap.add_argument("--prefix-index", default="radix",
                    choices=["radix", "exact", "off"],
                    help="prefix-cache index (ROADMAP A11): --serve runs "
                         "with 'off' whatever this says, and logs one "
                         "line when it asks for another")
    ap.add_argument("--host-kv-blocks", type=int, default=0,
                    help="host-DRAM KV block tier (> 0 is ROADMAP A11; "
                         "refused)")
    ap.add_argument("--logprobs", action="store_true",
                    help="per-token logprobs (ROADMAP A17; refused)")
    _add_http_flags(ap)
    for flag, kind, default, choices in _FLEET_FLAGS:
        ap.add_argument(flag, type=kind, default=default, choices=choices,
                        help="replica fleet flag, ROADMAP A12; parsed for "
                             "argv compatibility")
    ap.add_argument("--log-json", action="store_true",
                    help="one JSON object per operational log line "
                         "instead of 'event k=v' text")
    ap.add_argument("--device", default="cuda",
                    help="where the model runs: 'cuda' (default; raises "
                         "without a GPU) or 'cpu'")
    args = ap.parse_args()
    # One formatter for every operational log line (obs.StructuredLogger;
    # --log-json flips it to JSON objects).  The completions themselves
    # are plain prints: they are the program's product, not its log.
    from .obs import StructuredLogger

    log = StructuredLogger(json_mode=args.log_json)
    _refuse_unported(args)

    from .convert.checkpoint import load_checkpoint
    from .generation import LLaMA
    from .models.llama import resolve_device
    from .utils.profiling import DecodeStats, Timer

    device = resolve_device(args.device)
    if args.byte_tokenizer:
        from .tokenizers import ByteTokenizer

        tokenizer = ByteTokenizer()
    elif args.tokenizer is None:
        raise SystemExit("--tokenizer is required (or pass --byte-tokenizer)")
    elif args.llama2:
        from .tokenizers import LLaMA2Tokenizer

        tokenizer = LLaMA2Tokenizer(args.tokenizer)
    else:
        from .tokenizers import LLaMA3Tokenizer

        tokenizer = LLaMA3Tokenizer(args.tokenizer)

    with Timer() as load_t:
        params, config = load_checkpoint(args.ckpt_dir, device=device)
    if args.attn:
        config = config.replace(attn_impl=args.attn)
    if args.quantize:
        from .ops.quant import is_quantized, quantize_params

        if not is_quantized(params):
            params = quantize_params(params)
    log.log(
        "checkpoint_restored", ckpt_dir=args.ckpt_dir, device=str(device),
        seconds=round(load_t.elapsed_s, 1),
    )

    if args.http is not None:
        _serve_http(params, config, tokenizer, device, args, logger=log)
        return
    if args.serve:
        _serve(params, config, tokenizer, device, args, log)
        return

    model = LLaMA(params=params, config=config, tokenizer=tokenizer,
                  device=device)
    prompts = args.prompt or DEFAULT_PROMPTS

    with Timer() as gen_t:
        outs = model.generate_from_str(
            prompts, args.max_gen_len, args.temperature, args.top_p, args.seed
        )
    stats = DecodeStats(
        batch=len(prompts),
        prompt_len=max(len(tokenizer.encode(p, bos=True, eos=False))
                       for p in prompts),
        new_tokens=args.max_gen_len,
        prefill_s=0.0,
        decode_s=gen_t.elapsed_s,
    )
    for p, o in zip(prompts, outs):
        print(f"\n=== {p!r}\n{o}")
    print(f"\n[{stats.summary()}] (incl. compile)")


def _add_http_flags(ap) -> None:
    """The HTTP server's flags (``--http``), with the JAX CLI's names,
    types, defaults and help, except the two peaks, which default to the
    H100's."""
    ap.add_argument("--host", default="127.0.0.1",
                    help="bind address for --http")
    ap.add_argument("--inject-faults", default=None, metavar="SPEC",
                    help="deterministic fault injection for chaos runs "
                         "(--http only): comma-separated "
                         "site[@N|~P]:kind[=v] rules — sites step, "
                         "insert, alloc, flash_kernel, paged_kernel, "
                         "splash_kernel, stock_paged_kernel, spec_decode "
                         "(faults.SITES); kinds error, oom, "
                         "delay=SECONDS, nan; e.g. 'step@5:error' or "
                         "'paged_kernel~0.01:error'.  Also read from the "
                         "JLT_FAULTS env var")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed for probabilistic (site~P) fault rules")
    ap.add_argument("--max-recoveries", type=int, default=3,
                    help="crash recoveries (batcher rebuild + request "
                         "replay) allowed per --recovery-window-s "
                         "before the server hard-drains with 503s")
    ap.add_argument("--recovery-window-s", type=float, default=60.0)
    ap.add_argument("--watchdog-s", type=float, default=60.0,
                    help="flip /healthz degraded when the serving loop "
                         "heartbeat stalls past this many seconds "
                         "(0 disables the watchdog thread)")
    ap.add_argument("--quarantine-threshold", type=int, default=3,
                    help="failures attributable to one feature (splash, "
                         "stock-paged, flash or paged kernel, speculative "
                         "decode) inside --quarantine-window-s before it "
                         "is quarantined onto its fallback (the server "
                         "stays up, degraded)")
    ap.add_argument("--quarantine-window-s", type=float, default=60.0)
    ap.add_argument("--quarantine-cooldown-s", type=float, default=30.0,
                    help="how long a quarantined feature stays on its "
                         "fallback before one probe re-trial")
    ap.add_argument("--drain-timeout-s", type=float, default=30.0,
                    help="SIGTERM/SIGINT drain budget: in-flight "
                         "requests run to completion (new POSTs get "
                         "503 + Retry-After); stragglers past this "
                         "many seconds are failed with 503")
    ap.add_argument("--slo-ttft-ms", type=float, default=0.0,
                    help="time-to-first-token SLO deadline in ms for "
                         "--http: finished requests are scored against "
                         "it and /metrics exposes attainment gauges "
                         "(llm_slo_ttft_attainment, window 256) plus "
                         "llm_goodput_tokens_total — tokens from "
                         "requests that met EVERY configured deadline.  "
                         "0 (default) leaves the dimension unset "
                         "(always passes)")
    ap.add_argument("--slo-itl-ms", type=float, default=0.0,
                    help="inter-token-latency SLO deadline in ms for "
                         "--http: a request passes when its WORST "
                         "token gap stays under it.  0 (default) "
                         "leaves the dimension unset")
    ap.add_argument("--priority-classes", default="on",
                    choices=["on", "off"],
                    help="overload control for --http (overload.py): "
                         "'on' (default) enables the optional "
                         "per-request \"priority\" field (interactive "
                         "| batch) with strict interactive-first "
                         "admission, cost-based deadline refusals "
                         "(503 + load-derived Retry-After when a "
                         "request's timeout_s provably cannot be "
                         "met), and the SLO-driven brownout ladder; "
                         "'off' keeps plain FIFO admission with only "
                         "the --max-queue depth backstop")
    ap.add_argument("--max-queue", type=int, default=256,
                    help="pre-admission queue depth backstop for "
                         "--http: past it new POSTs are refused 503 + "
                         "Retry-After (each blocked POST holds an OS "
                         "thread, so this bounds handler-thread "
                         "memory under flood)")
    ap.add_argument("--brownout-attainment", type=float, default=0.85,
                    help="brownout ladder escalation bar: escalate "
                         "one rung when windowed interactive-class "
                         "SLO attainment drops below this (needs "
                         "--slo-ttft-ms / --slo-itl-ms to be scored)")
    ap.add_argument("--brownout-recover-attainment", type=float,
                    default=0.95,
                    help="brownout ladder recovery bar: step DOWN one "
                         "rung only once attainment is back at/above "
                         "this (must be >= --brownout-attainment — "
                         "the gap is the hysteresis band)")
    ap.add_argument("--brownout-queue-wait-ms", type=float, default=0.0,
                    help="queue-wait pressure bar for the ladder "
                         "(recent pre-admission wait p90 above it = "
                         "pressure); 0 derives 2x --slo-ttft-ms, or "
                         "2000 ms when no TTFT SLO is set")
    ap.add_argument("--brownout-dwell-s", type=float, default=2.0,
                    help="pressure must persist this long before each "
                         "one-rung escalation")
    ap.add_argument("--brownout-cooldown-s", type=float, default=10.0,
                    help="calm must persist this long before each "
                         "one-rung recovery step")
    ap.add_argument("--brownout-batch-max-new", type=int, default=64,
                    help="batch-class max_new_tokens cap applied at "
                         "brownout-1 (halves again at deeper rungs)")
    ap.add_argument("--brownout-demote-blocks", type=int, default=32,
                    help="idle KV blocks demoted to the host tier on "
                         "entering brownout-1 and deeper (the host tier "
                         "is ROADMAP A11: no-op until then)")
    ap.add_argument("--peak-tflops", type=float, default=989.4,
                    help="peak TFLOP/s for the /metrics "
                         "llm_mxu_utilization and "
                         "llm_host_overhead_ratio gauges (default: the "
                         "H100 SXM's dense bf16 peak); 0 disables the "
                         "FLOPs-side gauges")
    ap.add_argument("--peak-hbm-gbps", type=float, default=3350.0,
                    help="HBM bandwidth in GB/s for the /metrics "
                         "llm_hbm_utilization gauge (default: the H100 "
                         "SXM's HBM3 peak); 0 disables it")
    ap.add_argument("--no-cost-models", action="store_true",
                    help="skip the per-dispatch analytic cost models "
                         "(obs.CostModel): the utilization / "
                         "host-overhead gauges go dark; live serving "
                         "keeps them ON (host arithmetic per dispatch, "
                         "no device work)")


def _refuse_unported(args) -> None:
    """Exit, naming the ROADMAP item, on a mode or flag value whose feature
    the port does not have yet; validate the rest as the JAX CLI does."""
    if args.replicas < 1:
        raise SystemExit("--replicas must be >= 1")
    tensor = args.tensor or 1  # 0 = every local device: the one card
    mesh = args.data * args.fsdp * tensor
    unported = (
        (args.logprobs, "--logprobs (per-token logprobs)", "A17"),
        (args.replicas > 1, "--replicas > 1 (the replica router)", "A12"),
        (args.autoscale, "--autoscale (the fleet controller)", "A12"),
        (args.replica_roles is not None,
         "--replica-roles (prefill/decode disaggregation)", "A12"),
        (args.serve_mesh is not None, "--serve-mesh (the serving mesh)",
         "A14"),
        (mesh > 1, f"a device mesh of {mesh} (--data {args.data} --fsdp "
         f"{args.fsdp} --tensor {args.tensor})", "A14"),
        (args.host_kv_blocks > 0, "--host-kv-blocks > 0 (the host KV tier)",
         "A11"),
    )
    for bad, what, item in unported:
        if bad:
            raise SystemExit(f"{what} is not ported (ROADMAP {item})")
    # The env var is checked too: a JLT_FAULTS drill that the chosen mode
    # cannot honor must refuse, not run fault-free while the operator
    # believes injection was armed.
    fault_spec = args.inject_faults or os.environ.get("JLT_FAULTS")
    if fault_spec:
        if args.http is None:
            raise SystemExit(
                "--inject-faults / JLT_FAULTS only apply to the HTTP "
                "server (--http PORT) — the stdin/--serve and one-shot "
                "modes have no crash recovery, so a fault drill there "
                "would just crash the run"
            )
        from .faults import FaultSpec

        try:  # before the weight load
            FaultSpec.parse(fault_spec)
        except ValueError as e:
            raise SystemExit(f"bad fault spec: {e}")


def _chat_format_for(tokenizer):
    """The one 'is this a llama-3 chat tokenizer' test: a tokenizer with
    special tokens and an end-of-turn id gets the Llama-3 ``ChatFormat``,
    any other none."""
    if hasattr(tokenizer, "special_tokens") and hasattr(
        tokenizer, "eot_id"
    ):
        from .tokenizers.llama3 import ChatFormat

        return ChatFormat(tokenizer)
    return None


def _load_draft(args, device):
    """Optional speculative-serving draft model (--draft-ckpt-dir):
    (draft_params, draft_config) or (None, None); attn_impl follows the
    --attn override, so both models resolve the same attention paths."""
    ckpt = getattr(args, "draft_ckpt_dir", None)
    if not ckpt:
        return None, None
    from .convert.checkpoint import load_checkpoint

    draft_params, draft_config = load_checkpoint(ckpt, device=device)
    if args.attn:
        draft_config = draft_config.replace(attn_impl=args.attn)
    return draft_params, draft_config


def _stops(tokenizer):
    return tuple(
        int(s) for s in getattr(tokenizer, "stop_tokens", [tokenizer.eos_id])
    )


def _batcher_kwargs(args, draft_params, log) -> dict:
    """The batcher arguments that ``--serve`` and ``--http`` take from the
    flags.  The prefix cache (A11) and fused prefill (A9) are not ported:
    the batcher runs without them, and one log line says so when the
    flags ask for either (the JAX CLI's defaults do)."""
    prefix_cache = not args.no_prefix_cache and args.prefix_index != "off"
    fused = args.prefill_budget > 0 and draft_params is None
    if prefix_cache or fused:
        log.log(
            "serve_options_not_ported",
            "serving with prefix_cache=False, prefix_index='off', "
            "prefill_budget=0: the prefix cache is ROADMAP A11, fused "
            "prefill-decode ROADMAP A9",
            prefix_index=args.prefix_index if prefix_cache else None,
            prefill_budget=args.prefill_budget if fused else None,
        )
    return dict(
        n_slots=args.slots, max_len=None, temperature=args.temperature,
        top_p=args.top_p, seed=args.seed, prefix_cache=False,
        decode_chunk=args.decode_chunk, n_draft=args.n_draft,
        spec_rounds=args.spec_rounds, prefill_budget=0, prefix_index="off",
        prefill_kernel=args.prefill_kernel,
        decode_kernel=args.decode_kernel,
    )


def _serve(params, config, tokenizer, device, args, log) -> None:
    """Continuous-batching loop over stdin prompts (one per line)."""
    import sys

    from .serving import ContinuousBatcher

    stops = _stops(tokenizer)
    draft_params, draft_config = _load_draft(args, device)
    cb = ContinuousBatcher(
        params, config, **_batcher_kwargs(args, draft_params, log),
        stop_tokens=stops, draft_params=draft_params,
        draft_config=draft_config, device=device,
    )
    rid_prompt: dict = {}
    emitted: dict = {}
    lines = [ln.rstrip("\n") for ln in sys.stdin if ln.strip()]
    for line in lines:
        try:
            rid = cb.submit(
                tokenizer.encode(line, bos=True, eos=False),
                max_new_tokens=args.max_gen_len,
            )
        except ValueError as e:
            # One over-long prompt must not take down the whole serve loop.
            print(f"\n=== {line!r}\n[rejected: {e}]", flush=True)
            continue
        rid_prompt[rid] = line
    while cb.pending():
        for rid, tok, done in cb.step():
            emitted.setdefault(rid, []).append(tok)
            if done:
                toks = emitted[rid]
                # The batcher finishes a request at its first stop token,
                # so a stop id can only be the terminal element.
                if toks and toks[-1] in stops:
                    toks = toks[:-1]
                print(f"\n=== {rid_prompt[rid]!r}\n{tokenizer.decode(toks)}",
                      flush=True)
    print(f"\nserved {len(rid_prompt)} request(s) on {args.slots} slot(s)")


def _serve_http(params, config, tokenizer, device, args, _test_hook=None,
                logger=None) -> None:
    """HTTP front-end: ``LLMServer`` over the batcher until interrupted
    (JAX ``run._serve_http``).  ``_test_hook(srv)``, when given, runs once
    the server is up, and then the function returns instead of
    blocking."""
    import signal
    import time

    from .faults import FaultInjector, install_trace_hook
    from .obs import Observability, StructuredLogger
    from .server import LLMServer
    from .serving import ContinuousBatcher

    if logger is None:
        logger = StructuredLogger(json_mode=args.log_json)
    # --inject-faults wins over the JLT_FAULTS env var; with neither, no
    # injector is built.
    fault_spec = args.inject_faults or os.environ.get("JLT_FAULTS")
    injector = None
    if fault_spec:
        injector = FaultInjector(fault_spec, seed=args.fault_seed)
        # The first load of each kernel's library fires its site too
        # (ops._build.load), so a drill can fail a kernel's build.
        install_trace_hook(injector.fire)
        logger.log("faults_armed", spec=fault_spec)
    draft_params, draft_config = _load_draft(args, device)
    # The observability sink gets the CLI's SLO deadlines and peaks; the
    # batcher hands it to every rebuild, so the trace stays one.
    obs = Observability(
        slo_ttft_ms=args.slo_ttft_ms or None,
        slo_itl_ms=args.slo_itl_ms or None,
        peak_flops=args.peak_tflops * 1e12,
        peak_bytes_per_s=args.peak_hbm_gbps * 1e9,
    )
    cb = ContinuousBatcher(
        params, config, **_batcher_kwargs(args, draft_params, logger),
        stop_tokens=_stops(tokenizer), draft_params=draft_params,
        draft_config=draft_config, fault_injector=injector, obs=obs,
        cost_models=not args.no_cost_models, device=device,
    )
    chat_format = _chat_format_for(tokenizer)
    try:
        with LLMServer(
            cb, tokenizer=tokenizer, host=args.host, port=args.http,
            chat_format=chat_format,
            max_recoveries=args.max_recoveries,
            recovery_window_s=args.recovery_window_s,
            watchdog_deadline_s=(args.watchdog_s if args.watchdog_s > 0
                                 else None),
            quarantine_threshold=args.quarantine_threshold,
            quarantine_window_s=args.quarantine_window_s,
            quarantine_cooldown_s=args.quarantine_cooldown_s,
            drain_timeout_s=args.drain_timeout_s,
            logger=logger,
            max_queue=args.max_queue,
            priority_classes=args.priority_classes == "on",
            brownout_enter_attainment=args.brownout_attainment,
            brownout_exit_attainment=args.brownout_recover_attainment,
            brownout_queue_wait_ms=args.brownout_queue_wait_ms or None,
            brownout_dwell_s=args.brownout_dwell_s,
            brownout_cooldown_s=args.brownout_cooldown_s,
            brownout_batch_max_new=args.brownout_batch_max_new,
            brownout_demote_blocks=args.brownout_demote_blocks,
        ) as srv:
            endpoints = "POST /generate" + (
                ", /chat" if chat_format is not None else "")
            logger.log("serving", address=srv.address,
                       endpoints=f"{endpoints}, GET /metrics, /healthz, "
                                 "/debug/*")
            if _test_hook is not None:
                _test_hook(srv)
                return
            # SIGTERM and the first Ctrl-C flip a flag (the handler does
            # nothing else: a store is async-signal-safe) and restore
            # SIGINT's default, so a second Ctrl-C hard-stops; the loop
            # below drains.
            state = {"signaled": False}

            def _on_signal(signum, frame):
                state["signaled"] = True
                signal.signal(signal.SIGINT, signal.default_int_handler)

            previous = []
            try:
                for sig in (signal.SIGTERM, signal.SIGINT):
                    previous.append((sig, signal.signal(sig, _on_signal)))
            except ValueError:
                previous = []  # not the main thread; no signal wiring
            try:
                while not state["signaled"]:
                    time.sleep(0.2)
                srv.begin_drain()
                logger.log(
                    "drain_begin",
                    "in-flight requests finish, new requests 503",
                    timeout_s=args.drain_timeout_s,
                )
                if srv.wait_drained(args.drain_timeout_s + 10):
                    logger.log("drained", "shutting down")
                else:
                    logger.log("drain_timeout", "shutting down")
            except KeyboardInterrupt:
                srv.begin_drain(timeout_s=0.0)
                logger.log("hard_shutdown", "second interrupt")
            finally:
                for sig, old in previous:
                    try:
                        signal.signal(sig, old)
                    except (ValueError, TypeError):
                        pass
    finally:
        if injector is not None:
            # The hook is a module global: clear it so an embedding
            # process does not keep firing a dead drill's injector.
            install_trace_hook(None)


if __name__ == "__main__":
    main()
