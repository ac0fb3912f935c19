"""The port's CLIs held against the JAX package's: one tiny Meta checkpoint
(float32) is converted by JAX's ``convert`` CLI to Orbax and by the port's
to its own format, and the two ``run.main()`` print identical greedy
completions, one-shot (byte tokenizer, and a Llama-3 tokenizer on a rank
table trained here) and under ``--serve`` over the same stdin lines.  The
byte tokenizer drops ids past 255 when it decodes, so the ids each CLI
handed to ``decode`` are compared too.  Under ``--http 0`` both CLIs serve
one request from the same checkpoint with the same greedy tokens, and shut
down, and with ``--logprobs`` both return the same per-token logprobs;
``--serve`` passes ``--prefill-budget`` (default 512) to its batcher.
``--http 0 --replicas 2 --route cache-aware`` serves through the replica
router with the single server's replies, and with ``--autoscale`` a fleet
controller whose ``/debug/fleet`` block has the JAX CLI's keys.  Flags
whose feature is not ported exit naming their ROADMAP item; the router's
flags are refused as the JAX CLI refuses them, with its messages, and a
sliced job that is not a whole number of serving meshes exits naming
the flags."""

import io
import json
import sys
import urllib.request

import pytest
import torch

import jax_llama_tpu.convert.__main__ as jconvert_cli
import jax_llama_tpu.run as jrun
from jax_llama_tpu.tokenizers.bytes import ByteTokenizer as JByteTokenizer

import jax_llama_tpu_torch.convert.__main__ as pconvert_cli
import jax_llama_tpu_torch.run as prun
from jax_llama_tpu_torch.convert import convert_meta_checkpoint, load_checkpoint
from jax_llama_tpu_torch.tokenizers.bytes import ByteTokenizer

from test_torch_convert import _assert_trees_equal, _make_meta_ckpt
from test_tokenizers import _CORPUS, _train_bpe_ranks
from test_torch_tokenizers import write_rank_file

PROMPTS = ["the quick brown fox", "hello world", "pack my box"]
GREEDY = ["--max-gen-len", "8", "--temperature", "0", "--tensor", "1"]


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """(JAX's Orbax dir, the port's dir, the rank file, the Meta dir, the
    vocabulary size)."""
    root = tmp_path_factory.mktemp("cli")
    ranks = _train_bpe_ranks(_CORPUS, n_merges=200)
    rank_file = write_rank_file(root / "trained.model", ranks)
    meta = root / "meta"
    meta.mkdir()
    _make_meta_ckpt(meta, n_shards=1, vocab=len(ranks) + 256)
    common = ["--ckpt-dir", str(meta), "--tokenizer", str(rank_file),
              "--max-seq-len", "64", "--dtype", "float32"]
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(sys, "argv", ["convert", *common, "--out-dir",
                                 str(root / "jax")])
        jconvert_cli.main()
        mp.setattr(sys, "argv", ["convert", *common, "--out-dir",
                                 str(root / "port"), "--device", "cpu"])
        pconvert_cli.main()
    finally:
        mp.undo()
    return root / "jax", root / "port", rank_file, meta, len(ranks) + 256


def _run(main, argv, monkeypatch, capsys, stdin=None):
    monkeypatch.setattr(sys, "argv", ["run", *argv])
    if stdin is not None:
        monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
    capsys.readouterr()
    main()
    return capsys.readouterr().out


def _completions(out, end):
    """The '=== prompt' blocks, from the first to the line that starts with
    ``end``, in the order printed."""
    body = out[out.index("\n=== "):out.rindex("\n" + end)]
    return body.split("\n=== ")[1:]


def _recording_decode(monkeypatch, cls):
    """Record the ids every ``cls.decode`` call receives."""
    seen, orig = [], cls.decode

    def decode(self, ids):
        seen.append(list(ids))
        return orig(self, ids)

    monkeypatch.setattr(cls, "decode", decode)
    return seen


def test_port_convert_cli_writes_the_in_memory_conversion(ckpts):
    _, port, _, meta, vocab = ckpts
    want, want_cfg = convert_meta_checkpoint(
        meta, vocab_size=vocab, max_seq_len=64, dtype="float32",
        device="cpu")
    got, cfg = load_checkpoint(port, device="cpu")
    assert cfg == want_cfg
    _assert_trees_equal(got, want)


@pytest.mark.parametrize("tokenizer", ["byte", "llama3"])
def test_one_shot_matches_jax(ckpts, monkeypatch, capsys, tokenizer):
    jdir, pdir, rank_file, _, _ = ckpts
    tok = (["--byte-tokenizer"] if tokenizer == "byte"
           else ["--tokenizer", str(rank_file)])
    prompts = [a for p in PROMPTS for a in ("--prompt", p)]
    jseen = _recording_decode(monkeypatch, JByteTokenizer)
    pseen = _recording_decode(monkeypatch, ByteTokenizer)
    want = _run(jrun.main, ["--ckpt-dir", str(jdir), *tok, *prompts,
                            *GREEDY], monkeypatch, capsys)
    got = _run(prun.main, ["--ckpt-dir", str(pdir), *tok, *prompts, *GREEDY,
                           "--device", "cpu"], monkeypatch, capsys)
    assert "checkpoint_restored" in got and "device=cpu" in got
    blocks = _completions(got, "[")
    assert len(blocks) == len(PROMPTS)
    assert blocks == _completions(want, "[")
    assert pseen == jseen
    if tokenizer == "byte":
        assert len(pseen) == len(PROMPTS) and any(pseen)
    else:  # every id decodes: the completions carry text
        assert any(b.split("\n", 1)[1] for b in blocks)
    assert "tok/s/chip" in got.splitlines()[-1]


def test_serve_matches_jax(ckpts, monkeypatch, capsys):
    jdir, pdir, _, _, _ = ckpts
    stdin = "".join(p + "\n" for p in PROMPTS)
    argv = ["--byte-tokenizer", "--serve", "--slots", "2", *GREEDY]
    jseen = _recording_decode(monkeypatch, JByteTokenizer)
    pseen = _recording_decode(monkeypatch, ByteTokenizer)
    want = _run(jrun.main, ["--ckpt-dir", str(jdir), *argv], monkeypatch,
                capsys, stdin)
    got = _run(prun.main, ["--ckpt-dir", str(pdir), *argv, "--device",
                           "cpu"], monkeypatch, capsys, stdin)
    # JAX's defaults (the prefix cache, fused prefill at budget 512) are
    # the port's: no line says an option is not served.
    assert not [ln for ln in got.splitlines()
                if ln.startswith("serve_options_not_ported")]
    assert sorted(_completions(got, "served")) == sorted(
        _completions(want, "served"))
    assert sorted(pseen) == sorted(jseen) and len(pseen) == len(PROMPTS)
    assert got.splitlines()[-1] == want.splitlines()[-1] == (
        "served 3 request(s) on 2 slot(s)")


def test_serve_without_the_unported_defaults_logs_nothing(
        ckpts, monkeypatch, capsys):
    _, pdir, _, _, _ = ckpts
    got = _run(prun.main, ["--ckpt-dir", str(pdir), "--byte-tokenizer",
                           "--serve", "--no-prefix-cache", "--prefill-budget",
                           "0", *GREEDY, "--device", "cpu"],
               monkeypatch, capsys, "hello\n")
    assert "serve_options_not_ported" not in got
    assert got.splitlines()[-1] == "served 1 request(s) on 4 slot(s)"


def test_missing_tokenizer_exits(tmp_path, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["run", "--ckpt-dir", str(tmp_path),
                                      "--device", "cpu"])
    with pytest.raises(SystemExit, match="--tokenizer is required"):
        prun.main()


def _http_generate(main, module, argv, monkeypatch, capsys, payload):
    """Run ``main`` with ``--http 0``; once its server is up, POST
    ``payload`` to /generate and read /healthz, then let it shut down.
    Returns (the reply, /healthz, the CLI's output)."""
    got = {}

    def hook(srv):
        req = urllib.request.Request(srv.address + "/generate",
                                     data=json.dumps(payload).encode())
        with urllib.request.urlopen(req, timeout=120) as r:
            got["reply"] = (r.status, json.loads(r.read()))
        with urllib.request.urlopen(srv.address + "/healthz",
                                    timeout=60) as r:
            got["health"] = json.loads(r.read())

    orig = module._serve_http
    monkeypatch.setattr(module, "_serve_http",
                        lambda *a, **kw: orig(*a, **kw, _test_hook=hook))
    try:
        out = _run(main, argv, monkeypatch, capsys)
    finally:
        monkeypatch.setattr(module, "_serve_http", orig)
    return got["reply"], got["health"], out


def test_http_serves_one_request_like_jax(ckpts, monkeypatch, capsys):
    jdir, pdir, _, _, _ = ckpts
    argv = ["--byte-tokenizer", "--http", "0", "--slots", "2", *GREEDY]
    payload = {"text": "hello world", "max_new_tokens": 8,
               "temperature": 0}
    want, _, _ = _http_generate(jrun.main, jrun, ["--ckpt-dir", str(jdir),
                                                  *argv],
                                monkeypatch, capsys, payload)
    got, health, out = _http_generate(
        prun.main, prun, ["--ckpt-dir", str(pdir), *argv, "--device", "cpu"],
        monkeypatch, capsys, payload)
    assert got[0] == want[0] == 200
    assert got[1]["tokens"] == want[1]["tokens"]
    assert len(got[1]["tokens"]) == 8 and got[1]["text"] == want[1]["text"]
    assert health["ok"] is True and health["quarantined"] == []
    assert "serving address=http://127.0.0.1:" in out


def test_http_logprobs_like_jax(ckpts, monkeypatch, capsys):
    """--logprobs builds the batcher with logprobs (ROADMAP A17): a
    request that asks for them gets JAX's per-token logprobs."""
    jdir, pdir, _, _, _ = ckpts
    argv = ["--byte-tokenizer", "--http", "0", "--slots", "2", "--logprobs",
            *GREEDY]
    payload = {"text": "hello world", "max_new_tokens": 8,
               "temperature": 0, "logprobs": True}
    want, _, _ = _http_generate(jrun.main, jrun, ["--ckpt-dir", str(jdir),
                                                  *argv],
                                monkeypatch, capsys, payload)
    got, _, _ = _http_generate(
        prun.main, prun, ["--ckpt-dir", str(pdir), *argv, "--device", "cpu"],
        monkeypatch, capsys, payload)
    assert got[0] == want[0] == 200
    assert got[1]["tokens"] == want[1]["tokens"]
    assert len(got[1]["logprobs"]) == 8
    assert all(abs(a - b) < 1e-5
               for a, b in zip(got[1]["logprobs"], want[1]["logprobs"]))


def test_serve_passes_the_prefill_budget(ckpts, monkeypatch, capsys):
    """--serve builds its batcher with --prefill-budget, JAX's default
    512 when the flag is absent, and without logprobs."""
    from jax_llama_tpu_torch import serving as pserving

    _, pdir, _, _, _ = ckpts
    built = []

    class Recording(pserving.ContinuousBatcher):
        def __init__(self, *a, **kw):
            built.append(kw)
            super().__init__(*a, **kw)

    monkeypatch.setattr(pserving, "ContinuousBatcher", Recording)
    base = ["--ckpt-dir", str(pdir), "--byte-tokenizer", "--serve",
            *GREEDY, "--device", "cpu"]
    for extra, budget in (([], 512), (["--prefill-budget", "32"], 32)):
        out = _run(prun.main, base + extra, monkeypatch, capsys, "hello\n")
        assert out.splitlines()[-1] == "served 1 request(s) on 4 slot(s)"
        assert built[-1]["prefill_budget"] == budget
        assert built[-1]["logprobs"] is False


def test_http_fault_flag_reaches_the_server(ckpts, monkeypatch, capsys):
    """--inject-faults arms the server's injector: the first decode step
    dies, the server recovers and the reply is the fault-free one."""
    _, pdir, _, _, _ = ckpts
    argv = ["--ckpt-dir", str(pdir), "--byte-tokenizer", "--http", "0",
            "--slots", "2", *GREEDY, "--device", "cpu"]
    payload = {"prompt": [1, 7, 9], "max_new_tokens": 6}
    clean, _, _ = _http_generate(prun.main, prun, argv, monkeypatch, capsys,
                                 payload)
    got, health, out = _http_generate(
        prun.main, prun, argv + ["--inject-faults", "step@0:error",
                                 "--log-json"],
        monkeypatch, capsys, payload)
    assert got == (200, dict(clean[1], request_id=got[1]["request_id"]))
    assert health["recoveries_total"] == 1
    events = [json.loads(ln)["event"] for ln in out.splitlines()
              if ln.startswith("{")]
    assert "faults_armed" in events and "crash_recovery" in events


def test_http_replicas_route_like_one_server(ckpts, monkeypatch, capsys):
    """``--replicas 2 --http 0 --route cache-aware`` serves through the
    router (JAX tests/test_run_cli.py drives its CLI the same way): the
    routed replies are the single server's, a session's revisit routes
    to the replica holding its chain, and both replicas served."""
    _, pdir, _, _, _ = ckpts
    session = "the quick brown fox jumps over the lazy d"
    payloads = [{"text": session, "max_new_tokens": 4, "temperature": 0},
                {"text": "pack my box", "max_new_tokens": 4,
                 "temperature": 0},
                {"text": session + " next!",
                 "max_new_tokens": 4, "temperature": 0}]

    def post(url, payload):
        req = urllib.request.Request(url + "/generate",
                                     data=json.dumps(payload).encode())
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())["tokens"], r.headers["X-Replica-Id"]

    single = []
    orig_http = prun._serve_http
    monkeypatch.setattr(prun, "_serve_http", lambda *a, **kw: orig_http(
        *a, **kw, _test_hook=lambda srv: single.extend(
            post(srv.address, p)[0] for p in payloads)))
    argv = ["--ckpt-dir", str(pdir), "--byte-tokenizer", "--http", "0",
            "--slots", "2", *GREEDY, "--device", "cpu"]
    _run(prun.main, argv, monkeypatch, capsys)
    monkeypatch.setattr(prun, "_serve_http", orig_http)

    routed = {}

    def hook(router, servers):
        routed["replies"] = [post(router.address, payloads[0])]
        router.check_health_now()
        routed["replies"] += [post(router.address, p) for p in payloads[1:]]
        routed["health"] = router.health()
        routed["seeds"] = [s.batcher.seed for s in servers]

    orig = prun._serve_router
    monkeypatch.setattr(prun, "_serve_router", lambda *a, **kw: orig(
        *a, **dict(kw, _test_hook=hook)))
    out = _run(prun.main, argv + ["--replicas", "2", "--route",
                                  "cache-aware"], monkeypatch, capsys)
    tokens = [t for t, _ in routed["replies"]]
    reps = [r for _, r in routed["replies"]]
    assert tokens == single and all(len(t) == 4 for t in tokens)
    assert reps[2] == reps[0] != reps[1]  # the revisit hit, the other spread
    h = routed["health"]
    assert h["policy"] == "cache-aware" and len(h["replicas"]) == 2
    assert h["cache_index"]["hit_depth_blocks_total"] >= 2
    assert routed["seeds"] == [0, 1]
    assert "serving_replicas address=http://127.0.0.1:" in out


def _fleet_view(main, module, argv, monkeypatch, capsys):
    """Run ``main`` in router mode to its test hook: the router's
    ``/debug/fleet`` once the controller's loop has judged a scraped
    fleet (or after 30 s), and the number of replicas."""
    seen = {}

    def hook(router, servers):
        import time

        deadline = time.monotonic() + 30.0
        while True:
            with urllib.request.urlopen(router.address + "/debug/fleet",
                                        timeout=60) as r:
                seen["fleet"] = json.loads(r.read())
            sig = (seen["fleet"].get("controller") or {}).get(
                "last_signals") or {}
            if (sig.get("reason") == "at-min-replicas"
                    or time.monotonic() > deadline):
                break
            time.sleep(0.05)
        seen["replicas"] = len(router.health()["replicas"])

    orig = module._serve_router
    monkeypatch.setattr(module, "_serve_router", lambda *a, **kw: orig(
        *a, **dict(kw, _test_hook=hook)))
    seen["out"] = _run(main, argv, monkeypatch, capsys)
    return seen


def test_http_replicas_autoscale_arms_the_controller(ckpts, monkeypatch,
                                                     capsys):
    """``--http 0 --replicas 2 --autoscale`` starts a FleetController as
    the JAX CLI does: /debug/fleet carries its block with the flag bounds
    and period, with the JAX CLI's keys on the same argv, and the log says
    ``autoscale_armed``.  The idle fleet is calm at its floor, so the
    background loop defers (at-min-replicas) and grows nothing."""
    jdir, pdir, _, _, _ = ckpts
    flags = ["--byte-tokenizer", "--http", "0", "--slots", "2",
             "--replicas", "2", "--autoscale", "--autoscale-min", "2",
             "--autoscale-max", "3", "--autoscale-interval-s", "0.05",
             "--canary-interval-s", "0", *GREEDY]
    port = _fleet_view(prun.main, prun, ["--ckpt-dir", str(pdir), *flags,
                                         "--device", "cpu"],
                       monkeypatch, capsys)
    jax_view = _fleet_view(jrun.main, jrun, ["--ckpt-dir", str(jdir),
                                             *flags], monkeypatch, capsys)
    ctrl = port["fleet"]["controller"]
    assert (ctrl["min_replicas"], ctrl["max_replicas"],
            ctrl["interval_s"]) == (2, 3, 0.05)
    assert ctrl["last_signals"]["reason"] == "at-min-replicas"
    assert ctrl["scale_events"]["up"] == 0 and port["replicas"] == 2
    assert set(ctrl) == set(jax_view["fleet"]["controller"])
    assert set(port["fleet"]) == set(jax_view["fleet"])
    assert "autoscale_armed" in port["out"]


@pytest.mark.parametrize("argv,item", [
    # Ported (ROADMAP A17): refused outside --http with the JAX CLI's
    # message.
    (["--logprobs"], "--http"),
    # The router is ported (ROADMAP A12 part 1): --replicas > 1 is
    # refused without --http, and --replica-roles with one replica, each
    # with the JAX CLI's message.
    (["--replicas", "2"], "--replicas > 1 needs the HTTP front-end"),
    # The fleet controller is ported (ROADMAP A12 part 2): --autoscale
    # outside router mode is refused with the JAX CLI's message.
    (["--autoscale"], "--autoscale needs router mode"),
    (["--replica-roles", "prefill,decode"],
     "--replica-roles needs --replicas >= 2"),
    # The serving mesh is ported (ROADMAP A14 part 1): --serve-mesh
    # outside the serving modes is refused with the JAX CLI's message, and
    # a mesh wider than this run's processes (one per rank, e.g. under
    # torchrun) is refused before any load ("=" marks a port-only message:
    # the JAX CLI builds such a mesh over its 8 virtual devices).
    (["--serve-mesh", "1,2"], "--serve-mesh applies to the serving modes"),
    (["--tensor", "2"], "=a mesh of 2 ranks needs 2 processes"),
    (["--data", "2", "--tensor", "1"], "=a mesh of 2 ranks needs 2 processes"),
    # --fsdp is ported (ROADMAP A14 part 2): a data x fsdp x tensor mesh,
    # one process per rank.  So is --http over a mesh (A14 part 3): one
    # process is refused a mesh of two ranks (run_cli's ranks2 serves it).
    (["--fsdp", "2"], "=a mesh of 2 ranks needs 2 processes"),
    (["--serve-mesh", "1,2", "--http", "0"],
     "=a mesh of 2 ranks needs 2 processes"),
    # The host tier is ported (ROADMAP A11): the flag is refused only
    # off the radix index, with the JAX CLI's message.
    (["--host-kv-blocks", "1", "--prefix-index", "exact"], None),
], ids=["logprobs", "replicas", "autoscale", "roles",
        "serve_mesh", "tensor", "data", "fsdp", "http_mesh", "host_kv"])
def test_unported_flags_exit_naming_their_item(tmp_path, monkeypatch, argv,
                                               item):
    monkeypatch.setattr(sys, "argv", ["run", "--ckpt-dir", str(tmp_path),
                                      "--byte-tokenizer", *argv])
    ported = item is None or item.startswith("--")
    match = ("--host-kv-blocks requires --prefix-index radix"
             if item is None else
             "--logprobs only applies to the HTTP server" if item == "--http"
             else item if ported
             else item[1:] if item.startswith("=")
             else f"not ported \\(ROADMAP {item}\\)")
    with pytest.raises(SystemExit, match=match):
        prun.main()
    if ported:  # JAX's CLI refuses the same argv so
        with pytest.raises(SystemExit, match=match):
            jrun.main()


def test_world_not_a_whole_number_of_slices_exits(tmp_path, monkeypatch):
    """``--replicas 2`` over a serving mesh in a job wider than one mesh
    is sliced (one mesh's worth of ranks per replica, JAX's geometry;
    ``test_torch_sliced_replicas`` serves it); a job that is not a whole
    number of meshes is refused before the process group comes up,
    naming the flags."""
    monkeypatch.setenv("WORLD_SIZE", "3")
    monkeypatch.setattr(sys, "argv", [
        "run", "--ckpt-dir", str(tmp_path), "--byte-tokenizer", "--http",
        "0", "--replicas", "2", "--serve-mesh", "1,2"])
    with pytest.raises(SystemExit, match=(
            r"--replicas 2 over --serve-mesh 1,2 with 3 processes: sliced "
            r"replicas take a whole number of slices")):
        prun.main()


@pytest.fixture(scope="module")
def ranks2():
    from torch_mesh_worker import MeshPool

    pool = MeshPool(2)
    yield pool
    pool.close()


MESH_GREEDY = ["--max-gen-len", "8", "--temperature", "0",
               "--byte-tokenizer", "--device", "cpu"]


@pytest.mark.parametrize("mesh", [["--tensor", "2"],
                                  ["--data", "2", "--tensor", "1"],
                                  ["--fsdp", "2", "--tensor", "1"]],
                         ids=["tensor", "data", "fsdp"])
def test_one_shot_on_a_mesh_matches_jax_and_one_rank(
        ckpts, monkeypatch, capsys, ranks2, mesh):
    """run.py one-shot over two ranks (one process each, as torchrun
    starts them): rank 0 prints the completions of the single-rank run
    and of JAX's CLI on the same mesh over its virtual devices; rank 1
    prints nothing."""
    jdir, pdir, _, _, _ = ckpts
    prompts = [a for p in PROMPTS for a in ("--prompt", p)]
    argv = ["--ckpt-dir", str(pdir), *prompts, *MESH_GREEDY[:-2]]
    want = _run(jrun.main, ["--ckpt-dir", str(jdir), *prompts,
                            *MESH_GREEDY[:-2], *mesh], monkeypatch, capsys)
    single = _run(prun.main, argv + ["--device", "cpu", "--tensor", "1"],
                  monkeypatch, capsys)
    out = ranks2.run("run_cli", argv=argv + ["--device", "cpu", *mesh])
    assert out[1] == ""
    assert "checkpoint_restored" in out[0] and "mesh=" in out[0]
    assert ("backend=gloo rank_devices=['cpu', 'cpu']" in out[0])
    assert _completions(out[0], "[") == _completions(single, "[") == (
        _completions(want, "["))


def test_serve_on_a_serving_mesh_matches_one_rank(ckpts, monkeypatch,
                                                  capsys, ranks2):
    """``--serve --serve-mesh 1,2``: rank 0 reads stdin and broadcasts the
    prompts, both ranks serve them on their shards, only rank 0 prints;
    the completions are the single-rank batcher's."""
    _, pdir, _, _, _ = ckpts
    stdin = "".join(p + "\n" for p in PROMPTS)
    argv = ["--ckpt-dir", str(pdir), "--serve", "--slots", "2",
            *MESH_GREEDY]
    single = _run(prun.main, argv, monkeypatch, capsys, stdin)
    out = ranks2.run("run_cli", argv=argv + ["--serve-mesh", "1,2"],
                     stdin=stdin)
    assert out[1] == ""
    assert sorted(_completions(out[0], "served")) == sorted(
        _completions(single, "served"))
    assert out[0].splitlines()[-1] == "served 3 request(s) on 2 slot(s)"


def test_http_on_a_serving_mesh_matches_one_rank(ckpts, monkeypatch,
                                                 capsys, ranks2):
    """``--http 0 --serve-mesh 1,2`` under two ranks: rank 0 serves HTTP
    and leads, rank 1 follows and prints nothing; the reply is the
    single-rank server's, and /healthz reports the mesh."""
    _, pdir, _, _, _ = ckpts
    argv = ["--ckpt-dir", str(pdir), "--http", "0", "--slots", "2",
            *MESH_GREEDY]
    payload = {"text": "hello world", "max_new_tokens": 8, "temperature": 0}
    single, _, _ = _http_generate(prun.main, prun, argv, monkeypatch,
                                  capsys, payload)
    out = ranks2.run("run_http_cli", argv=argv + ["--serve-mesh", "1,2"],
                     requests=[("/generate", payload)])
    lead, follow = out
    assert follow["out"] == "" and "replies" not in follow
    (st, body), = lead["replies"]
    assert st == single[0] == 200
    assert body["tokens"] == single[1]["tokens"] and len(body["tokens"]) == 8
    assert body["text"] == single[1]["text"]
    assert lead["health"][1]["replica"]["serve_mesh"] == {
        "data": 1, "tensor": 2, "devices": 2}
    assert "serving address=http://127.0.0.1:" in lead["out"]


def test_http_replicas_on_a_serving_mesh_keep_probabilistic_faults_equal(
        ckpts, ranks2):
    """``--replicas 2 --serve-mesh 1,2`` with ``router_replica~P`` and
    ``step~P`` armed on both ranks: the router (rank 0 only) draws from an
    injector of its own, so the step draws fire at the same record on
    both ranks; the failed steps replay and every request is answered,
    and the ranks' host states end equal."""
    _, pdir, _, _, _ = ckpts
    argv = ["--ckpt-dir", str(pdir), "--http", "0", "--slots", "2",
            "--replicas", "2", "--inject-faults",
            "router_replica~0.5:delay=0.001,step~0.3:error",
            "--fault-seed", "3", "--max-recoveries", "100", *MESH_GREEDY,
            "--serve-mesh", "1,2"]
    requests = [("/generate", {"text": t, "max_new_tokens": 8,
                               "temperature": 0}) for t in PROMPTS * 2]
    lead, follow = ranks2.run("run_router_cli", argv=argv,
                              requests=requests)
    assert [st for st, _ in lead["replies"]] == [200] * len(requests)
    router, batchers = lead["router_faults"], lead["batcher_faults"]
    assert not router["same"]
    assert router["calls"]["router_replica"] == len(requests)
    assert router["delays"] >= 1
    assert batchers["injected"]["step"] >= 1
    assert sum(lead["recoveries"]) == batchers["injected"]["step"]
    assert lead["states"] == follow["states"] and len(lead["states"]) == 2
    assert follow["records"]["rebuild"] == batchers["injected"]["step"]


def test_serve_mesh_that_does_not_fit_exits(ckpts, ranks2):
    """``--serve-mesh 2,1`` over an odd slot count exits with the
    validation's message on every rank."""
    _, pdir, _, _, _ = ckpts
    with pytest.raises(AssertionError, match="must divide n_slots=3"):
        ranks2.run("run_cli", argv=["--ckpt-dir", str(pdir), "--serve",
                                    "--slots", "3", "--serve-mesh", "2,1",
                                    *MESH_GREEDY])


def test_more_ranks_than_the_gpus_of_a_multi_gpu_host_exit(monkeypatch):
    """Ranks that outnumber a host's several GPUs are refused before the
    process group comes up, not stacked two to a GPU; only a single-GPU
    host shares its GPU between ranks (over gloo)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    with pytest.raises(SystemExit, match="4 ranks on a host with 2 GPUs"):
        prun._mesh_for(None, torch.device("cuda"), 4)


@pytest.mark.parametrize("roles,route,match", [
    ("prefill", "least-loaded", "one role per replica"),
    ("prefill,cook", "least-loaded", "unknown role"),
    ("prefill,prefill", "cache-aware", "EACH role"),
    ("prefill,decode", "least-loaded", "requires --route cache-aware"),
], ids=["count", "unknown", "each_role", "route"])
def test_replica_roles_refused_as_jax_refuses_them(tmp_path, monkeypatch,
                                                   roles, route, match):
    """``--replica-roles`` with two replicas is validated before any load,
    with the JAX CLI's messages, and the JAX CLI refuses the same argv."""
    monkeypatch.setattr(sys, "argv", [
        "run", "--ckpt-dir", str(tmp_path), "--byte-tokenizer", "--http",
        "0", "--replicas", "2", "--replica-roles", roles, "--route", route,
        "--tensor", "1"])
    for main in (prun.main, jrun.main):
        with pytest.raises(SystemExit, match=match):
            main()


def test_fault_env_var_exits_naming_a7(tmp_path, monkeypatch):
    """JLT_FAULTS (the A7 fault drill) applies to --http only: without it
    the CLI refuses, as JAX's does, and a bad spec is refused before any
    load."""
    monkeypatch.setenv("JLT_FAULTS", "step@1:error")
    monkeypatch.setattr(sys, "argv", ["run", "--ckpt-dir", str(tmp_path),
                                      "--byte-tokenizer"])
    with pytest.raises(SystemExit, match="only apply to the HTTP server"):
        prun.main()
    monkeypatch.setenv("JLT_FAULTS", "nowhere@1:error")
    monkeypatch.setattr(sys, "argv", ["run", "--ckpt-dir", str(tmp_path),
                                      "--byte-tokenizer", "--http", "0"])
    with pytest.raises(SystemExit, match="bad fault spec"):
        prun.main()


def test_run_defaults_to_the_card(ckpts, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    monkeypatch.setattr(sys, "argv", ["run", "--ckpt-dir", str(ckpts[1]),
                                      "--byte-tokenizer"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prun.main()


def test_argument_surfaces_match():
    """Every flag of JAX's CLI parses in the port's, with the same
    option strings, default, type, choices and action; the port adds only
    --device.  The two deliberate differences: --peak-tflops and
    --peak-hbm-gbps default to the H100 SXM's peaks (989.4 TFLOP/s dense
    bf16, 3350 GB/s HBM3) where JAX's name a TPU's."""
    import argparse

    def parser_of(main):
        captured = {}

        def fake_parse(self, *a, **kw):
            captured["parser"] = self
            raise SystemExit(0)

        orig = argparse.ArgumentParser.parse_args
        argparse.ArgumentParser.parse_args = fake_parse
        try:
            with pytest.raises(SystemExit):
                main()
        finally:
            argparse.ArgumentParser.parse_args = orig
        return {a.dest: (tuple(a.option_strings), a.default, a.type,
                         None if a.choices is None else tuple(a.choices),
                         type(a).__name__)
                for a in captured["parser"]._actions if a.dest != "help"}

    jflags, pflags = parser_of(jrun.main), parser_of(prun.main)
    assert set(pflags) - set(jflags) == {"device"}
    peaks = {"peak_tflops": 989.4, "peak_hbm_gbps": 3350.0}
    for dest, default in peaks.items():
        assert pflags[dest][1] == default
        pflags[dest] = pflags[dest][:1] + jflags[dest][1:2] + pflags[dest][2:]
    assert {k: pflags[k] for k in jflags} == jflags
