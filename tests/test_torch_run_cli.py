"""The port's CLIs held against the JAX package's: one tiny Meta checkpoint
(float32) is converted by JAX's ``convert`` CLI to Orbax and by the port's
to its own format, and the two ``run.main()`` print identical greedy
completions, one-shot (byte tokenizer, and a Llama-3 tokenizer on a rank
table trained here) and under ``--serve`` over the same stdin lines.  The
byte tokenizer drops ids past 255 when it decodes, so the ids each CLI
handed to ``decode`` are compared too.  Under ``--http 0`` both CLIs serve
one request from the same checkpoint with the same greedy tokens, and shut
down.  Flags whose feature is not ported exit naming their ROADMAP item."""

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
    # JAX's defaults ask for the prefix cache and fused prefill: one line
    # says the port serves without them.
    notes = [ln for ln in got.splitlines()
             if ln.startswith("serve_options_not_ported")]
    assert len(notes) == 1 and "A11" in notes[0] and "A9" in notes[0]
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


@pytest.mark.parametrize("argv,item", [
    (["--logprobs"], "A17"),
    (["--replicas", "2"], "A12"),
    (["--autoscale"], "A12"),
    (["--replica-roles", "prefill,decode"], "A12"),
    (["--serve-mesh", "1,2"], "A14"),
    (["--tensor", "2"], "A14"),
    (["--data", "2", "--tensor", "1"], "A14"),
    (["--host-kv-blocks", "1"], "A11"),
], ids=["logprobs", "replicas", "autoscale", "roles",
        "serve_mesh", "tensor", "data", "host_kv"])
def test_unported_flags_exit_naming_their_item(tmp_path, monkeypatch, argv,
                                               item):
    monkeypatch.setattr(sys, "argv", ["run", "--ckpt-dir", str(tmp_path),
                                      "--byte-tokenizer", *argv])
    with pytest.raises(SystemExit, match=f"not ported \\(ROADMAP {item}\\)"):
        prun.main()


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
