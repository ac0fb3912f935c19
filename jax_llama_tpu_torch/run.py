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

    python -m jax_llama_tpu_torch.run --ckpt-dir ... --http 8000 \
        --replicas 2 [--route cache-aware] [--replica-roles prefill,decode] \
        [--canary-interval-s 10] [--autoscale --autoscale-max 4] ...

    torchrun --nproc-per-node 2 -m jax_llama_tpu_torch.run \
        --ckpt-dir ... --tensor 2 [--data 1] ...
    torchrun --nproc-per-node 2 -m jax_llama_tpu_torch.run \
        --ckpt-dir ... --serve --serve-mesh 1,2 < prompts.txt
    torchrun --nproc-per-node 2 -m jax_llama_tpu_torch.run \
        --ckpt-dir ... --http 8000 --serve-mesh 1,2 [--replicas 2 ...]
    torchrun --nproc-per-node 4 -m jax_llama_tpu_torch.run \
        --ckpt-dir ... --http 8000 --serve-mesh 1,2 --replicas 2 ...

The checkpoint is the port's (``python -m jax_llama_tpu_torch.convert``
writes one from Meta's files).  The argument parser is the JAX package's,
so an argv that one accepts the other does too, plus ``--device`` (default
"cuda"); the defaults differ only in ``--peak-tflops`` and
``--peak-hbm-gbps``, which name the H100's peaks.  The one-shot mode,
``--serve`` (prompts on stdin, one per line) and ``--http PORT``
(``server.LLMServer``: POST /generate and /chat, GET /metrics, /healthz,
/debug/*) run on the card, or on the CPU with ``--device cpu``; ``--http``
never falls back to the CPU.

Tensor, data and fsdp parallelism run one process per rank, as
``torchrun`` starts them (``parallel.distributed.initialize`` reads its
environment): ``--tensor N`` / ``--data N`` / ``--fsdp N`` shard the
one-shot completion and ``--serve`` over a ``data x fsdp x tensor`` mesh
(``--fsdp`` > 1 loads the ZeRO-3 layout, each layer gathered before
use), and
``--serve --serve-mesh dp,tp`` the batcher, over ``dp * tp`` ranks
(``--tensor 0``, the default, is every rank the data axis leaves).  Each
rank loads only its shard of the checkpoint.  Rank 0 reads stdin and
broadcasts the prompts; only rank 0 prints.  The process group's backend
is nccl with one rank per GPU and gloo with ``--device cpu``, and gloo
where the ranks share the one GPU of a single-GPU host (NCCL refuses two
ranks on one device); more ranks than GPUs on a host with several exit.
``checkpoint_restored`` logs the backend and each rank's device.
``--http`` over a mesh of more than one rank (``--serve-mesh`` or the
``--tensor``/``--data`` axes) serves from rank 0, the leader, which runs
the HTTP front end, the server's loop and, with ``--replicas``, the router
and the fleet controller; every other rank is a follower that builds the
same batchers over its own shard and applies, in order, the batcher calls
the leader publishes (``parallel.lockstep``).  Every replica time-shares
the one mesh.  SIGTERM or SIGINT on rank 0 drains, then stops the
followers, which ignore signals.  ``--http --replicas N --serve-mesh
dp,tp`` under ``k x dp x tp`` ranks (k > 1) slices the job as JAX slices
its devices (``parallel.slices``): replica i runs on ranks ``[i x dp x
tp, (i + 1) x dp x tp)``, a serving mesh with its own log and its own
shard of the weights, while the job has them, and time-shares the first
slice after (autoscaled replicas too); rank 0 runs the router and
reaches each other slice's replica, whose server runs on that slice's
first rank, through a control channel, and a handoff or a drain between
slices carries the KV of every head.  A world that is not a whole
number of slices exits naming the flags.
``--http`` with ``--replicas`` > 1 serves N replicas on the one device
behind ``router.ReplicaRouter`` (``--route``, ``--replica-roles``,
``--canary-interval-s``), as the JAX CLI does; ``--autoscale`` adds a
``router.FleetController`` over them (``--autoscale-min``,
``--autoscale-max``, ``--autoscale-interval-s``), whose grown replicas
share the one weight copy.
``--serve`` and ``--http`` run as the JAX CLI does: the prefix cache
(``--prefix-index radix`` by default, ``exact``, ``off``;
``--no-prefix-cache``; ``--host-kv-blocks`` > 0 attaches the host tier,
radix only) and fused prefill-decode scheduling
(``--prefill-budget 512`` by default: a prompt that arrives while rows
decode is prefilled in chunks of at most that many tokens inside the
decode dispatches; 0 admits whole prompts).  ``--logprobs`` (``--http``
only, as in the JAX CLI) lets a request ask for each token's logprob
(``"logprobs": true``).  ``--log-json`` formats the log lines.
The router's flags and the fleet controller's (its autoscale bounds)
are parsed from one table, ``_FLEET_FLAGS``.
"""

from __future__ import annotations

import argparse
import contextlib
import os

DEFAULT_PROMPTS = [
    "I believe the meaning of life is",
    "Simply put, the theory of relativity states that",
]


# Flags that configure the replica fleet, as (flag, type (None: a
# string), default, choices): registered with the JAX CLI's names, types
# and defaults so that one argv parses in both packages.  The router reads
# --route and --canary-interval-s, the fleet controller (--autoscale) the
# autoscale bounds and period.
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
                    help="tensor-parallel degree (0 = every rank the "
                         "data axis leaves; one rank per process, e.g. "
                         "under torchrun)")
    ap.add_argument("--data", type=int, default=1,
                    help="data-parallel degree (ranks splitting the rows)")
    ap.add_argument("--fsdp", type=int, default=1,
                    help="FSDP degree: ranks holding a ZeRO-3 shard of "
                         "the weights and splitting the rows")
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
                    help="serving-mesh geometry for --serve: dp x tp "
                         "ranks (a bare TP is 1,TP); one process per rank")
    ap.add_argument("--replicas", type=int, default=1, metavar="N",
                    help="serving replicas behind one HTTP door "
                         "(router.ReplicaRouter; needs --http)")
    ap.add_argument("--autoscale", action="store_true",
                    help="elastic fleet for --replicas N: a "
                         "FleetController scales up under sustained "
                         "interactive-attainment / queue-wait pressure "
                         "and scales down (sentinel-gated, live "
                         "sessions migrated) when calm; every action "
                         "is a recorded decision (GET "
                         "/debug/decisions?kind=scale).  Grown replicas "
                         "share the seed replicas' weight copy")
    ap.add_argument("--replica-roles", default=None, metavar="R,R,...",
                    help="prefill/decode disaggregation: one role "
                         "per replica (needs --route cache-aware)")
    ap.add_argument("--decode-chunk", type=int, default=8,
                    help="fuse up to this many decode iterations per "
                         "step() in --serve (token-identical to 1; 1 "
                         "restores the per-token loop; speculative "
                         "serving chunks by --spec-rounds instead)")
    ap.add_argument("--prefill-budget", type=int, default=512,
                    help="fused prefill-decode scheduling for --serve / "
                         "--http: a prompt that arrives while rows "
                         "decode is prefilled in chunks of at most this "
                         "many tokens inside the decode dispatches, so "
                         "no decoding row stalls; 0 admits whole "
                         "prompts at step boundaries (speculative "
                         "serving always does)")
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
                    help="disable prompt prefix caching in the serving "
                         "pool (on by default; equivalent to "
                         "--prefix-index off)")
    ap.add_argument("--prefix-index", default="radix",
                    choices=["radix", "exact", "off"],
                    help="prefix-cache index for --serve / --http: "
                         "'radix' (default) shares partial prompt "
                         "prefixes across all cached chains through a "
                         "block-granular radix tree; 'exact' keeps the "
                         "flat exact-chain map (the behavioural oracle, "
                         "no host tier); 'off' disables matching and "
                         "retention")
    ap.add_argument("--host-kv-blocks", type=int, default=0,
                    help="host KV block tier capacity for --serve / "
                         "--http (requires --prefix-index radix): cold "
                         "prefix-cache blocks demote into pinned host "
                         "memory instead of being freed, and sessions "
                         "whose cached prefix was demoted swap it back "
                         "in on a side stream while rows decode; 0 "
                         "(default) disables the tier")
    ap.add_argument("--logprobs", action="store_true",
                    help="compute per-token model logprobs so HTTP "
                         "requests may ask for them (\"logprobs\": true)")
    _add_http_flags(ap)
    for flag, kind, default, choices in _FLEET_FLAGS:
        ap.add_argument(flag, type=kind, default=default, choices=choices,
                        help="replica fleet flag (--replicas > 1)")
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

    from .models.llama import resolve_device

    from .parallel import distributed

    ranks, slices = _mesh_ranks(args)
    device = resolve_device(args.device)
    owned = not distributed.is_initialized()
    mesh = _mesh_for(args, device, ranks, slices)
    if mesh is not None:
        device = mesh.device
    try:
        _run(args, log, device, mesh)
    finally:
        if mesh is not None and owned:
            distributed.shutdown()


def _run(args, log, device, mesh) -> None:
    """Everything after the mesh: load, then one-shot, ``--serve`` or
    ``--http``; under a mesh only rank 0 prints."""
    from .convert.checkpoint import load_checkpoint
    from .generation import LLaMA
    from .utils.profiling import DecodeStats, Timer

    rank0 = mesh is None or mesh.global_rank == 0
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
        params, config = load_checkpoint(args.ckpt_dir, device=device,
                                         mesh=mesh,
                                         fsdp=mesh is not None
                                         and args.fsdp > 1)
    if args.attn:
        config = config.replace(attn_impl=args.attn)
    if args.serve_mesh is not None and mesh is not None:
        # A clear refusal at startup beats a silently unplaced mesh.
        from .parallel.serve_mesh import validate_serve_mesh

        try:
            validate_serve_mesh(config, mesh, args.slots)
        except ValueError as e:
            raise SystemExit(str(e))
    if args.quantize:
        from .ops.quant import is_quantized, quantize_params

        if not is_quantized(params):
            params = quantize_params(params)
    if rank0:
        log.log(
            "checkpoint_restored", ckpt_dir=args.ckpt_dir,
            device=str(device), seconds=round(load_t.elapsed_s, 1),
            mesh=str(dict(mesh.shape)) if mesh is not None else None,
            **(_mesh_placement(mesh) if mesh is not None else {}),
        )

    if args.http is not None:
        _serve_http(params, config, tokenizer, device, args, logger=log,
                    mesh=mesh)
        return
    if args.serve:
        _serve(params, config, tokenizer, device, args, mesh=mesh)
        return

    model = LLaMA(params=params, config=config, tokenizer=tokenizer,
                  device=device, mesh=mesh)
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
    if not rank0:
        return
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
                    help="idle KV blocks proactively demoted to the "
                         "host tier on entering brownout-1 and deeper "
                         "(no-op without --host-kv-blocks)")
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
    the port does not have yet; validate the rest as the JAX CLI does
    (JAX :414-470)."""
    if args.replicas < 1:
        raise SystemExit("--replicas must be >= 1")
    if args.replicas > 1 and args.http is None:
        raise SystemExit(
            "--replicas > 1 needs the HTTP front-end (--http PORT): "
            "the ReplicaRouter speaks HTTP to its replicas"
        )
    if args.autoscale:
        if args.replicas < 2 or args.http is None:
            raise SystemExit(
                "--autoscale needs router mode (--replicas >= 2 with "
                "--http PORT): the FleetController scales the "
                "ReplicaRouter's fleet"
            )
        if args.replica_roles is not None:
            raise SystemExit(
                "--autoscale does not compose with --replica-roles: "
                "role disaggregation pins fleet membership (at least "
                "one replica of each role)"
            )
        if not (1 <= args.autoscale_min <= args.replicas
                <= args.autoscale_max):
            raise SystemExit(
                "--autoscale needs 1 <= --autoscale-min <= --replicas "
                "<= --autoscale-max"
            )
    if args.serve_mesh is not None and args.http is None and not args.serve:
        raise SystemExit(
            "--serve-mesh applies to the serving modes "
            "(--serve / --http PORT)"
        )
    if args.replica_roles is not None:
        roles = tuple(
            r.strip() for r in args.replica_roles.split(",") if r.strip()
        )
        if args.replicas < 2:
            raise SystemExit(
                "--replica-roles needs --replicas >= 2 (one prefill "
                "and one decode replica at minimum)"
            )
        if len(roles) != args.replicas:
            raise SystemExit(
                f"--replica-roles names {len(roles)} roles for "
                f"--replicas {args.replicas}; give one role per replica"
            )
        bad = sorted(set(roles) - {"prefill", "decode"})
        if bad:
            raise SystemExit(
                f"--replica-roles: unknown role(s) {bad}; valid roles "
                "are 'prefill' and 'decode'"
            )
        if not ("prefill" in roles and "decode" in roles):
            raise SystemExit(
                "--replica-roles needs at least one replica of EACH "
                "role (prefill and decode)"
            )
        if args.route != "cache-aware":
            raise SystemExit(
                "--replica-roles requires --route cache-aware (the "
                "disaggregation scheduler routes off the router's "
                "global radix index)"
            )
        args.replica_roles = roles
    if args.host_kv_blocks > 0 and (
            args.prefix_index != "radix" or args.no_prefix_cache):
        # The tier hangs off radix-node residency: refused here rather
        # than left silently inert (the batcher tolerates the pair only
        # for the prefix-cache quarantine's rebuild).
        raise SystemExit(
            "--host-kv-blocks requires --prefix-index radix with the "
            "prefix cache enabled (the host tier hangs off radix-node "
            "residency)")
    if args.logprobs and args.http is None:
        raise SystemExit(
            "--logprobs only applies to the HTTP server (--http PORT); "
            "the stdin/--serve and one-shot modes have no logprobs output")
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


def _serve_spec(args):
    from .parallel.serve_mesh import parse_serve_mesh

    try:
        return parse_serve_mesh(args.serve_mesh)
    except ValueError as e:
        raise SystemExit(str(e))


def _mesh_ranks(args):
    """``(ranks, slices)``: the ranks of one mesh the flags ask for, and
    how many such meshes this run's processes (torchrun's
    ``WORLD_SIZE``) hold, checked before anything is loaded.  Over
    ``--serve-mesh`` with ``--http`` and ``--replicas`` > 1 a world wider
    than one mesh is sliced (``parallel.slices``), one slice per replica
    while they last (JAX :856); it must be a whole number of slices."""
    world = int(os.environ.get("WORLD_SIZE",
                               os.environ.get("JAX_NUM_PROCESSES", "1")))
    spec = _serve_spec(args) if args.serve_mesh is not None else None
    rows = args.data * args.fsdp
    want = (spec.n_devices if spec is not None
            else rows * (args.tensor or max(1, world // rows)))
    if (spec is not None and args.replicas > 1 and args.http is not None
            and world > want):
        from .parallel.slices import slice_count

        try:
            return want, slice_count(world, want)
        except ValueError:
            raise SystemExit(
                f"--replicas {args.replicas} over --serve-mesh "
                f"{args.serve_mesh} with {world} processes: sliced replicas "
                f"take a whole number of slices of dp x tp = {want} ranks "
                f"each; start a multiple of {want} processes (torchrun "
                f"--nproc-per-node k x {want}), or {want} for replicas that "
                "time-share one mesh")
    if want != world:
        raise SystemExit(
            f"a mesh of {want} ranks needs {want} processes, this run has "
            f"{world} (start one per rank, e.g. torchrun "
            f"--nproc-per-node {want})")
    return want, 1


def _mesh_for(args, device, ranks: int, slices: int = 1):
    """The run's mesh (JAX :402-411, :472-500): ``--serve-mesh`` or the
    ``--data`` x ``--fsdp`` x ``--tensor`` axes over the ``ranks``
    processes, whose
    group is brought up here; None for a single rank.  With ``slices`` >
    1 the job's ``ranks x slices`` processes hold that many serving
    meshes, and this is this rank's (``make_mesh(slices=)``).  The backend
    is nccl with one rank per GPU, and gloo on the CPU and where every
    rank of this host shares its one GPU (NCCL refuses two ranks on one
    device); more ranks than GPUs on a host with several is refused."""
    if ranks * slices == 1:
        return None
    import torch

    from .parallel import distributed
    from .parallel.mesh import make_mesh
    from .parallel.serve_mesh import build_serve_mesh

    world = ranks * slices
    devices = None
    if device.type == "cpu":
        devices = ["cpu"] * world
    else:
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        n_gpu = torch.cuda.device_count()
        if local > n_gpu > 1:
            raise SystemExit(
                f"{local} ranks on a host with {n_gpu} GPUs: run one rank "
                "per GPU, or every rank on the one GPU of a single-GPU host")
        if local > n_gpu:
            devices = ["cuda:0"] * world
    distributed.initialize(backend="gloo" if devices else None,
                           device=str(device))
    # An HTTP server's ranks wait on one another only so long: a rank
    # that is lost or diverges stops every rank (parallel.lockstep).
    bounds = {}
    if args.http is not None:
        from .parallel.lockstep import CONTROL_TIMEOUT_S, MESH_TIMEOUT_S

        bounds = dict(timeout_s=MESH_TIMEOUT_S,
                      control_timeout_s=CONTROL_TIMEOUT_S)
    if args.serve_mesh is not None:
        return build_serve_mesh(_serve_spec(args), devices=devices,
                                slices=slices, **bounds)
    return make_mesh(data=args.data, fsdp=args.fsdp,
                     tensor=ranks // (args.data * args.fsdp),
                     devices=devices, **bounds)


def _mesh_placement(mesh) -> dict:
    """The process group's backend and each rank's device, for the log."""
    import torch.distributed as dist

    return dict(backend=dist.get_backend(),
                rank_devices=[str(d) for d in mesh.devices])


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


def _load_draft(args, device, mesh=None):
    """Optional speculative-serving draft model (--draft-ckpt-dir):
    (draft_params, draft_config) or (None, None), sharded over ``mesh``
    like the target; attn_impl follows the --attn override, so both
    models resolve the same attention paths."""
    ckpt = getattr(args, "draft_ckpt_dir", None)
    if not ckpt:
        return None, None
    from .convert.checkpoint import load_checkpoint

    draft_params, draft_config = load_checkpoint(
        ckpt, device=device, mesh=mesh,
        fsdp=mesh is not None and args.fsdp > 1)
    if args.attn:
        draft_config = draft_config.replace(attn_impl=args.attn)
    return draft_params, draft_config


def _stops(tokenizer):
    return tuple(
        int(s) for s in getattr(tokenizer, "stop_tokens", [tokenizer.eos_id])
    )


def _batcher_kwargs(args) -> dict:
    """The batcher arguments that ``--serve`` and ``--http`` take from the
    flags, as the JAX CLI passes them (JAX :664-671)."""
    return dict(
        n_slots=args.slots, max_len=None, temperature=args.temperature,
        top_p=args.top_p, seed=args.seed, logprobs=args.logprobs,
        prefix_cache=not args.no_prefix_cache,
        decode_chunk=args.decode_chunk, n_draft=args.n_draft,
        spec_rounds=args.spec_rounds, prefill_budget=args.prefill_budget,
        prefix_index=args.prefix_index,
        host_kv_blocks=args.host_kv_blocks,
        prefill_kernel=args.prefill_kernel,
        decode_kernel=args.decode_kernel,
    )


def _serve(params, config, tokenizer, device, args, mesh=None) -> None:
    """Continuous-batching loop over stdin prompts (one per line).  Under
    a serving mesh every rank runs the same batcher: rank 0 reads stdin
    and broadcasts the prompts, and only rank 0 prints."""
    import sys

    from .serving import ContinuousBatcher

    rank0 = mesh is None or mesh.rank == 0
    stops = _stops(tokenizer)
    draft_params, draft_config = _load_draft(args, device, mesh)
    cb = ContinuousBatcher(
        params, config, **_batcher_kwargs(args),
        stop_tokens=stops, draft_params=draft_params,
        draft_config=draft_config, device=device, mesh=mesh,
    )
    rid_prompt: dict = {}
    emitted: dict = {}
    lines = ([ln.rstrip("\n") for ln in sys.stdin if ln.strip()]
             if rank0 else None)
    if mesh is not None:
        lines = mesh.broadcast_object(lines, src=0)
    for line in lines:
        try:
            rid = cb.submit(
                tokenizer.encode(line, bos=True, eos=False),
                max_new_tokens=args.max_gen_len,
            )
        except ValueError as e:
            # One over-long prompt must not take down the whole serve loop.
            if rank0:
                print(f"\n=== {line!r}\n[rejected: {e}]", flush=True)
            continue
        rid_prompt[rid] = line
    while cb.pending():
        for rid, tok, done in cb.step():
            emitted.setdefault(rid, []).append(tok)
            if done and rank0:
                toks = emitted[rid]
                # The batcher finishes a request at its first stop token,
                # so a stop id can only be the terminal element.
                if toks and toks[-1] in stops:
                    toks = toks[:-1]
                print(f"\n=== {rid_prompt[rid]!r}\n{tokenizer.decode(toks)}",
                      flush=True)
    if rank0:
        print(f"\nserved {len(rid_prompt)} request(s) on {args.slots} "
              f"slot(s)")


def _arm_faults(args, logger):
    """The fault injector of ``--inject-faults`` (over the JLT_FAULTS env
    var), its build-time hook installed; None with neither.  Every rank
    of a mesh arms the same spec and seed, so a batcher site fires at the
    same call on every rank."""
    from .faults import FaultInjector, install_trace_hook

    fault_spec = args.inject_faults or os.environ.get("JLT_FAULTS")
    if not fault_spec:
        return None
    injector = FaultInjector(fault_spec, seed=args.fault_seed)
    # The first load of each kernel's library fires its site too
    # (ops._build.load), so a drill can fail a kernel's build.
    install_trace_hook(injector.fire)
    logger.log("faults_armed", spec=fault_spec)
    return injector


def _replica_batchers(params, config, tokenizer, device, args, injector,
                      mesh):
    """``make(i)``: replica ``i``'s batcher, the flags' with its own
    sampling seed and observability sink, over ``mesh`` (time-shared by
    every replica).  The draft model is loaded here, sharded like the
    target, and a serving mesh is validated against it too (JAX)."""
    from .obs import Observability
    from .serving import ContinuousBatcher

    draft_params, draft_config = _load_draft(args, device, mesh)
    if args.serve_mesh is not None and mesh is not None \
            and draft_config is not None:
        # _run validated the target before the draft existed.
        from .parallel.serve_mesh import validate_serve_mesh

        try:
            validate_serve_mesh(config, mesh, args.slots,
                                draft_config=draft_config)
        except ValueError as e:
            raise SystemExit(str(e))

    def make(i):
        # The observability sink gets the CLI's SLO deadlines and peaks;
        # the batcher hands it to every rebuild, so the trace stays one.
        obs = Observability(
            slo_ttft_ms=args.slo_ttft_ms or None,
            slo_itl_ms=args.slo_itl_ms or None,
            peak_flops=args.peak_tflops * 1e12,
            peak_bytes_per_s=args.peak_hbm_gbps * 1e9,
        )
        return ContinuousBatcher(
            params, config, **dict(_batcher_kwargs(args), seed=args.seed + i),
            stop_tokens=_stops(tokenizer), draft_params=draft_params,
            draft_config=draft_config, fault_injector=injector, obs=obs,
            cost_models=not args.no_cost_models, device=device, mesh=mesh,
        )

    return make


@contextlib.contextmanager
def _signals_ignored():
    """SIGTERM and SIGINT ignored meanwhile (a follower's or a slice
    head's: rank 0 drains on them, then stops this rank)."""
    import signal

    previous = []
    try:
        for sig in (signal.SIGTERM, signal.SIGINT):
            previous.append((sig, signal.signal(sig, signal.SIG_IGN)))
    except ValueError:
        previous = []  # not the main thread; no signal wiring
    try:
        yield
    finally:
        for sig, old in previous:
            signal.signal(sig, old)


def _follow(mesh, make) -> None:
    """A follower rank of an HTTP server over ``mesh``: build the
    replicas the leader makes (``make``) and apply its records until its
    stop record (``parallel.lockstep.follow``).  Signals are ignored
    meanwhile: rank 0 drains on them, then stops this rank."""
    from .parallel import lockstep

    with _signals_ignored():
        lockstep.follow(mesh, make)


def _until_signal(on_drain, on_hard, leader=None) -> None:
    """Block until SIGTERM or the first Ctrl-C, then ``on_drain()``; a
    second Ctrl-C during it calls ``on_hard()``.  The handler only flips
    a flag (a store is async-signal-safe) and restores SIGINT's default,
    so a second Ctrl-C raises KeyboardInterrupt here.  When ``leader``'s
    lockstep log breaks (a rank diverged or was lost) the wait ends and
    its error raises: no rank of the mesh can serve any more."""
    import signal
    import time

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
            if leader is not None and leader.broken is not None:
                raise leader.broken
            time.sleep(0.2)
        on_drain()
    except KeyboardInterrupt:
        on_hard()
    finally:
        for sig, old in previous:
            try:
                signal.signal(sig, old)
            except (ValueError, TypeError):
                pass


def _serve_http(params, config, tokenizer, device, args, _test_hook=None,
                logger=None, mesh=None) -> None:
    """HTTP front-end: ``LLMServer`` over the batcher until interrupted
    (JAX ``run._serve_http``); ``--replicas`` > 1 serves through
    ``_serve_router``.  Over a mesh of more than one rank, rank 0 is the
    leader: it serves HTTP and publishes each batcher call to the other
    ranks, the followers, which apply them on their own shards until the
    leader stops them (``parallel.lockstep``).  ``_test_hook(srv)``, when
    given, runs on the leader once the server is up, and then the
    function returns instead of blocking."""
    from .faults import install_trace_hook
    from .obs import StructuredLogger
    from .parallel import lockstep
    from .server import LLMServer

    if logger is None:
        logger = StructuredLogger(json_mode=args.log_json)
    if args.replicas > 1:
        _serve_router(params, config, tokenizer, device, args,
                      _test_hook=_test_hook, logger=logger, mesh=mesh)
        return
    injector = _arm_faults(args, logger)
    leader = None
    try:
        make = _replica_batchers(params, config, tokenizer, device, args,
                                 injector, mesh)
        if mesh is not None and mesh.size > 1:
            if mesh.rank != 0:
                _follow(mesh, make)
                return
            leader = lockstep.leader_for(mesh)
            cb = leader.make(0, lambda: make(0))
        else:
            cb = make(0)
        chat_format = _chat_format_for(tokenizer)
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
                                 "/debug/*",
                       **({"mesh": str(dict(mesh.shape))}
                          if leader is not None else {}))
            if _test_hook is not None:
                _test_hook(srv)
                return

            def drain():
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

            def hard():
                srv.begin_drain(timeout_s=0.0)
                logger.log("hard_shutdown", "second interrupt")

            _until_signal(drain, hard, leader)
    finally:
        if leader is not None:
            # The server has stopped: the followers return.
            leader.stop()
        if injector is not None:
            # The hook is a module global: clear it so an embedding
            # process does not keep firing a dead drill's injector.
            install_trace_hook(None)


def _serve_router(params, config, tokenizer, device, args, _test_hook=None,
                  logger=None, mesh=None) -> None:
    """``--replicas N`` mode (JAX ``run._serve_router``): N independent
    batcher + server replicas behind one ``router.ReplicaRouter`` speaking
    the standard protocol on the ``--http`` port.  The replicas of one
    mesh share its one copy of the weights, as the JAX package's share
    ``params``; each owns its pool, queue, prefix index and serving-loop
    thread.  A job of several serving meshes' worth of ranks is sliced
    (``parallel.slices``, JAX's geometry): replica i runs on slice i, its
    ranks holding their own shard of the target and the draft, while the
    job has that slice, and time-shares slice 0 after, the fleet
    controller's grown replicas alike; one mesh's worth of ranks is
    time-shared by every replica.  One fault injector serves the router
    site and every replica's sites, so ``site@N`` counts the process's
    dispatches; over a mesh the router and the controller draw from an
    injector of their own (the same spec and seed), so that a ``site~P``
    draw on the leader alone never moves the random stream every rank's
    batchers share, and a slice's ranks count their own replicas'
    dispatches only.  With ``--autoscale`` a ``router.FleetController``
    grows the fleet through ``make_replica`` and, when the router shuts
    down, stops the replicas it grew.  Over a mesh of more than one rank,
    global rank 0 is the leader: it runs the router, the controller and
    the server of every replica on slice 0, and builds each such
    replica's batcher on every rank of the slice through the lockstep
    log; the other ranks of the slice follow it (``parallel.lockstep``).
    The head of another slice runs its replica's server and leads its
    slice's log at rank 0's word (``slices.serve_slice``), and rank 0's
    router reaches it through a ``slices.RemoteReplica``.
    ``_test_hook(router, servers)``, when given, runs on the leader once
    everything is up, and then the function returns instead of
    blocking."""
    from .obs import StructuredLogger
    from .parallel import lockstep
    from .parallel import slices as slicing

    if logger is None:
        logger = StructuredLogger(json_mode=args.log_json)
    n_slices = 1 if mesh is None else mesh.slices
    channels = {}
    if n_slices > 1:
        channels = slicing.open_channels(
            mesh, timeout_s=lockstep.CONTROL_TIMEOUT_S)
    try:
        _serve_replicas(params, config, tokenizer, device, args, _test_hook,
                        logger, mesh, channels)
    finally:
        if mesh is not None and mesh.global_rank == 0:
            for ch in channels.values():
                # Each other slice's head stops its servers and its log.
                ch.close()


def _serve_replicas(params, config, tokenizer, device, args, _test_hook,
                    logger, mesh, channels) -> None:
    """``_serve_router`` past the slices' channels (``channels``: rank 0's
    to every other slice's head, a head's to rank 0)."""
    from .faults import FaultInjector, install_trace_hook
    from .parallel import lockstep
    from .parallel import slices as slicing
    from .router import FleetController, ReplicaRouter
    from .server import LLMServer

    n_slices = 1 if mesh is None else mesh.slices
    injector = _arm_faults(args, logger)
    make = _replica_batchers(params, config, tokenizer, device, args,
                             injector, mesh)

    def serve(cb, i):
        """Replica ``i``'s server over its batcher, as the JAX CLI builds
        one per replica, started."""
        return LLMServer(
            cb, tokenizer=tokenizer, host=args.host, port=0, replica_id=i,
            max_recoveries=args.max_recoveries,
            recovery_window_s=args.recovery_window_s,
            watchdog_deadline_s=(args.watchdog_s if args.watchdog_s > 0
                                 else None),
            drain_timeout_s=args.drain_timeout_s,
            logger=logger,
            max_queue=args.max_queue,
            priority_classes=args.priority_classes == "on",
        ).start()

    leader, router_faults = None, injector
    if mesh is not None and mesh.global_rank != 0:
        try:
            with _signals_ignored():
                if mesh.rank == 0:
                    slicing.serve_slice(mesh, channels[mesh.slice], make,
                                        serve)
                else:
                    lockstep.follow(mesh, make)
        finally:
            if injector is not None:
                install_trace_hook(None)
        return
    if mesh is not None and mesh.size > 1:
        leader = lockstep.leader_for(mesh)
    if mesh is not None and (mesh.size > 1 or n_slices > 1):
        if injector is not None:
            router_faults = FaultInjector(injector.specs,
                                          seed=args.fault_seed)
        if n_slices < args.replicas:
            logger.log("serve_mesh_shared",
                       f"{args.replicas} replicas on {n_slices} slice(s) of "
                       f"{mesh.size} ranks: replicas past the last slice "
                       "time-share slice 0", mesh=str(dict(mesh.shape)))
        if n_slices > 1:
            logger.log("serve_mesh_sliced", slices=n_slices,
                       ranks_per_slice=mesh.size,
                       replica_slices=[slicing.replica_slice(i, n_slices)
                                       for i in range(args.replicas)])

    def make_replica(i):
        """Build and start replica ``i``: on slice 0, its batcher (on
        every rank of a mesh) and its server here; on another slice, the
        same on that slice, reached through a RemoteReplica."""
        s = slicing.replica_slice(i, n_slices)
        if s != 0:
            return slicing.RemoteReplica(channels[s], i).start()
        cb = (leader.make(i, lambda: make(i)) if leader is not None
              else make(i))
        return serve(cb, i)

    servers = []
    try:
        for i in range(args.replicas):
            servers.append(make_replica(i))
        # Cache-aware routing speaks the replicas' chain-key schema: the
        # tokenizer and chat format mirror each replica's own encoding,
        # block_size is the key granularity (one config, so one size;
        # replica 0 is always on slice 0, in this process).
        router = ReplicaRouter(
            servers, host=args.host, port=args.http, policy=args.route,
            fault_injector=router_faults, logger=logger,
            tokenizer=tokenizer,
            block_size=servers[0].batcher.block_size,
            chat_format=_chat_format_for(tokenizer),
            roles=args.replica_roles,
            canary_interval_s=args.canary_interval_s,
        ).start()
        controller = None
        if args.autoscale:
            # Grown replicas come from make_replica (a fresh slice while
            # the job has one, else slice 0's weight copy); the
            # controller stops them on close.
            controller = FleetController(
                router, replica_factory=make_replica,
                min_replicas=args.autoscale_min,
                max_replicas=args.autoscale_max,
                interval_s=args.autoscale_interval_s,
                drain_timeout_s=args.drain_timeout_s,
            )
            logger.log("autoscale_armed", min=args.autoscale_min,
                       max=args.autoscale_max,
                       interval_s=args.autoscale_interval_s)
        try:
            logger.log("serving_replicas", address=router.address,
                       replicas=args.replicas, policy=args.route,
                       device=str(device),
                       **({"mesh": str(dict(mesh.shape))}
                          if mesh is not None else {}))
            if _test_hook is not None:
                _test_hook(router, servers)
                return

            def drain():
                logger.log("drain_begin", "all replicas draining",
                           timeout_s=args.drain_timeout_s)
                for srv in servers:
                    srv.begin_drain()
                for srv in servers:
                    srv.wait_drained(args.drain_timeout_s + 10)
                logger.log("drained", "shutting down")

            def hard():
                for srv in servers:
                    srv.begin_drain(timeout_s=0.0)
                logger.log("hard_shutdown", "second interrupt")

            _until_signal(drain, hard, leader)
        finally:
            if controller is not None:
                controller.close(stop_owned=True)
            router.stop()
    finally:
        for srv in servers:
            srv.stop()
        if leader is not None:
            # Every replica has stopped: the followers return.
            leader.stop()
        if injector is not None:
            install_trace_hook(None)


if __name__ == "__main__":
    main()
