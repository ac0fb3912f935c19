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

The checkpoint is the port's (``python -m jax_llama_tpu_torch.convert``
writes one from Meta's files).  The argument parser is the JAX package's,
so an argv that one accepts the other does too, plus ``--device`` (default
"cuda").  The one-shot mode and ``--serve`` (prompts on stdin, one per
line) run; a flag whose feature is not ported exits with a message that
names its ROADMAP item: ``--http``, ``--inject-faults``/``JLT_FAULTS``
(A7), ``--logprobs`` (A17), ``--replicas`` > 1, ``--autoscale``,
``--replica-roles`` (A12), ``--serve-mesh`` and a ``--data``/``--fsdp``/
``--tensor`` mesh of more than one device (A14), ``--host-kv-blocks`` > 0
(A11).  ``--serve`` runs without the prefix cache (A11) and with classic
whole-prompt admission (A9), and says so in one log line when the flags
ask for either (their defaults do).  ``--log-json`` formats the log lines.
The flags that only configure the HTTP server (SLOs, brownout, cost
models, recovery: A7) or the replica fleet (routing, canaries, autoscale
bounds: A12) are parsed from one table, ``_SERVER_ONLY_FLAGS``, and have
nothing to configure until their item.
"""

from __future__ import annotations

import argparse
import os

DEFAULT_PROMPTS = [
    "I believe the meaning of life is",
    "Simply put, the theory of relativity states that",
]


# Flags that only configure the HTTP server (ROADMAP A7) or the replica
# fleet (A12), as (flag, type (None: a string), default, item, choices):
# registered with the JAX CLI's names, types and defaults so that one argv
# parses in both packages.  Until their item is ported they have nothing
# to configure.
_SERVER_ONLY_FLAGS = (
    ("--route", None, "least-loaded", "A12",
     ("least-loaded", "affinity", "cache-aware")),
    ("--canary-interval-s", float, 10.0, "A12", None),
    ("--autoscale-min", int, 1, "A12", None),
    ("--autoscale-max", int, 8, "A12", None),
    ("--autoscale-interval-s", float, 5.0, "A12", None),
    ("--host", None, "127.0.0.1", "A7", None),
    ("--fault-seed", int, 0, "A7", None),
    ("--max-recoveries", int, 3, "A7", None),
    ("--recovery-window-s", float, 60.0, "A7", None),
    ("--watchdog-s", float, 60.0, "A7", None),
    ("--quarantine-threshold", int, 3, "A7", None),
    ("--quarantine-window-s", float, 60.0, "A7", None),
    ("--quarantine-cooldown-s", float, 30.0, "A7", None),
    ("--drain-timeout-s", float, 30.0, "A7", None),
    ("--slo-ttft-ms", float, 0.0, "A7", None),
    ("--slo-itl-ms", float, 0.0, "A7", None),
    ("--priority-classes", None, "on", "A7", ("on", "off")),
    ("--max-queue", int, 256, "A7", None),
    ("--brownout-attainment", float, 0.85, "A7", None),
    ("--brownout-recover-attainment", float, 0.95, "A7", None),
    ("--brownout-queue-wait-ms", float, 0.0, "A7", None),
    ("--brownout-dwell-s", float, 2.0, "A7", None),
    ("--brownout-cooldown-s", float, 10.0, "A7", None),
    ("--brownout-batch-max-new", int, 64, "A7", None),
    ("--brownout-demote-blocks", int, 32, "A7", None),
    ("--peak-tflops", float, 197.0, "A7", None),
    ("--peak-hbm-gbps", float, 819.0, "A7", None),
    ("--no-cost-models", bool, False, "A7", None),
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
                    help="serve over HTTP (ROADMAP A7; refused)")
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
    ap.add_argument("--inject-faults", default=None, metavar="SPEC",
                    help="fault injection, also read from JLT_FAULTS "
                         "(ROADMAP A7; refused)")
    for flag, kind, default, item, choices in _SERVER_ONLY_FLAGS:
        help_ = (f"{'HTTP server' if item == 'A7' else 'replica fleet'} "
                 f"flag, ROADMAP {item}; parsed for argv compatibility")
        if kind is bool:
            ap.add_argument(flag, action="store_true", help=help_)
        else:
            ap.add_argument(flag, type=kind, default=default,
                            choices=choices, help=help_)
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


def _refuse_unported(args) -> None:
    """Exit, naming the ROADMAP item, on a mode or flag value whose feature
    the port does not have yet; validate the rest as the JAX CLI does."""
    if args.replicas < 1:
        raise SystemExit("--replicas must be >= 1")
    tensor = args.tensor or 1  # 0 = every local device: the one card
    mesh = args.data * args.fsdp * tensor
    fault_spec = args.inject_faults or os.environ.get("JLT_FAULTS")
    unported = (
        (args.http is not None, "--http (the HTTP server)", "A7"),
        (bool(fault_spec), "--inject-faults / JLT_FAULTS (fault injection)",
         "A7"),
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


def _serve(params, config, tokenizer, device, args, log) -> None:
    """Continuous-batching loop over stdin prompts (one per line)."""
    import sys

    from .serving import ContinuousBatcher

    stops = tuple(
        int(s) for s in getattr(tokenizer, "stop_tokens", [tokenizer.eos_id])
    )
    draft_params, draft_config = _load_draft(args, device)
    prefix_cache = not args.no_prefix_cache and args.prefix_index != "off"
    fused = args.prefill_budget > 0 and draft_params is None
    if prefix_cache or fused:
        # The JAX CLI's defaults; the port's batcher has neither yet.
        log.log(
            "serve_options_not_ported",
            "serving with prefix_cache=False, prefix_index='off', "
            "prefill_budget=0: the prefix cache is ROADMAP A11, fused "
            "prefill-decode ROADMAP A9",
            prefix_index=args.prefix_index if prefix_cache else None,
            prefill_budget=args.prefill_budget if fused else None,
        )
    cb = ContinuousBatcher(
        params, config, n_slots=args.slots,
        max_len=config.max_seq_len, stop_tokens=stops,
        temperature=args.temperature, top_p=args.top_p,
        seed=args.seed,
        prefix_cache=False,
        decode_chunk=args.decode_chunk,
        draft_params=draft_params, draft_config=draft_config,
        n_draft=args.n_draft,
        spec_rounds=args.spec_rounds,
        prefill_budget=0,
        prefix_index="off",
        prefill_kernel=args.prefill_kernel,
        decode_kernel=args.decode_kernel,
        device=device,
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


if __name__ == "__main__":
    main()
