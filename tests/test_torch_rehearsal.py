"""The port's dress rehearsal (``jax_llama_tpu_torch.rehearsal``) held
against the JAX package's (``jax_llama_tpu.rehearsal``) on the CPU.

One synthetic Meta checkpoint is written from a numpy seed at JAX's
default geometry; both ``_pipeline``s convert, save, load and generate
from the same files.  The greedy tokens must be equal and the float32
logits of each prompt's last token within 2e-4 (PERF.md section 2's
float32 bound between the two packages).  ``--shapes-8b`` must give the
JAX package's leaf count, parameter total and largest shard bytes; the
CLI's argument errors are JAX's.
"""

import ast
import importlib
import re
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from jax_llama_tpu import rehearsal as jreh
from jax_llama_tpu.models import forward as jforward

from jax_llama_tpu_torch import rehearsal as preh

LOGIT_ATOL = 2e-4
PIPELINE = dict(tokenizer=None, dtype="float32", max_seq_len=128,
                prompts=["hello tpu", "paged kv"], max_gen_len=8,
                parity_atol=1e-3)


@pytest.fixture(scope="module")
def meta_ckpt(tmp_path_factory):
    root = tmp_path_factory.mktemp("rehearsal")
    ck = root / "meta"
    ck.mkdir()
    vocab = preh._write_synthetic_meta_checkpoint(ck)
    return root, ck, vocab


def test_synthetic_checkpoint_is_jaxs(meta_ckpt, tmp_path):
    """The port's writer and JAX's write the same tensors and params.json
    from the same seed and geometry."""
    _, ck, vocab = meta_ckpt
    assert jreh._write_synthetic_meta_checkpoint(tmp_path) == vocab
    assert (ck / "params.json").read_text() == (
        tmp_path / "params.json").read_text()
    for f in sorted(ck.glob("*.pth")):
        a = torch.load(f, weights_only=True)
        b = torch.load(tmp_path / f.name, weights_only=True)
        assert sorted(a) == sorted(b)
        for k in a:
            assert torch.equal(a[k], b[k]), (f.name, k)


def test_pipeline_matches_jax(meta_ckpt, monkeypatch, capsys):
    """Convert -> save -> load -> greedy generate -> oracle parity on the
    same Meta files: the port's tokens are JAX's, its last-token float32
    logits within LOGIT_ATOL of JAX's forward on JAX's restored weights,
    and both pass their own oracle parity."""
    root, ck, vocab = meta_ckpt
    seen = {}
    oracle = jreh._oracle_module()

    class Spy:
        @staticmethod
        def oracle_forward(params, toks, positions, cfg):
            seen.update(params=params, toks=toks, positions=positions,
                        cfg=cfg)
            return oracle.oracle_forward(params, toks, positions, cfg)

    monkeypatch.setattr(jreh, "_oracle_module", lambda: Spy)
    jdiff = jreh._pipeline(str(ck), str(root / "jax_out"),
                           vocab_size=vocab, **PIPELINE)
    log = capsys.readouterr().out
    want_tokens = [ast.literal_eval(ast.literal_eval(m)) for m in re.findall(
        r"prompt \d+: '[^']*' -> (.*)$", log, re.M)]
    jcfg = seen["cfg"]
    jlogits = np.asarray(jax.jit(
        lambda p, t, q: jforward(p, t, q, jcfg)[0])(
            seen["params"], jnp.asarray(seen["toks"]),
            jnp.asarray(seen["positions"])))[:, -1]

    got = preh._pipeline(str(ck), str(root / "port_out"), vocab_size=vocab,
                         device="cpu", **PIPELINE)
    assert got["tokens"].tolist() == want_tokens
    np.testing.assert_allclose(got["last_logits"], jlogits, rtol=0,
                               atol=LOGIT_ATOL)
    assert jdiff < 1e-3 and got["parity"] < 1e-3
    assert got["n_params"] == sum(
        int(np.prod(a.shape)) for a in jax.tree.leaves(seen["params"]))


def test_shapes_8b_matches_jax():
    """The meta-device 8B check and JAX's eval_shape agree on the leaf
    count, the parameter total and the largest bf16 shard at tensor = 4 x
    data = 2."""
    from jax_llama_tpu import get_config, init_params
    from jax_llama_tpu.parallel.partition import param_partition_specs

    got = preh.rehearse_8b_shapes()
    cfg = get_config("llama3-8b")
    shapes = jax.eval_shape(lambda: init_params(jax.random.PRNGKey(0), cfg))
    leaves = jax.tree.leaves(shapes)
    axes = {"tensor": 4, "data": 2}
    shard = []

    def take(leaf, spec):
        shape = list(leaf.shape)
        for dim, ax in enumerate(tuple(spec)):
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                if a is not None:
                    shape[dim] //= axes.get(a, 1)
        shard.append(int(np.prod(shape)) * 2)

    jax.tree.map(take, shapes, param_partition_specs(cfg))
    assert got == dict(leaves=len(leaves),
                       params=sum(int(np.prod(a.shape)) for a in leaves),
                       largest_shard_bytes=max(shard))


def test_cli_arguments(monkeypatch, capsys):
    """No mode is a usage error (exit 2) in both CLIs; --ckpt-dir without
    --tokenizer names the missing flag; the port's CLI runs --synthetic
    and --shapes-8b on the CPU, and its default device raises on a host
    without a GPU instead of falling back."""
    for main in (lambda: jreh.main(), lambda: preh.main([])):
        monkeypatch.setattr("sys.argv", ["rehearsal"])
        with pytest.raises(SystemExit) as e:
            main()
        assert e.value.code == 2
    assert "pick at least one of" in capsys.readouterr().err
    monkeypatch.setattr("sys.argv", ["rehearsal", "--ckpt-dir", "x"])
    with pytest.raises(SystemExit, match="--ckpt-dir needs --tokenizer"):
        jreh.main()
    with pytest.raises(SystemExit, match="--ckpt-dir needs --tokenizer"):
        preh.main(["--ckpt-dir", "x"])
    preh.main(["--synthetic", "--shapes-8b", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "synthetic rehearsal PASSED" in out
    assert "8B shape rehearsal PASSED" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            preh.main(["--synthetic"])


def test_default_geometry_head_dim_is_refused_by_the_kernel():
    """JAX's default synthetic geometry has head_dim 16; the flash
    wrapper's card path refuses it (it never runs the plain version on a
    CUDA tensor), which is why the card rehearsal passes a head_dim-64
    geometry."""
    fa = importlib.import_module("jax_llama_tpu_torch.ops.flash_attention")
    q = torch.zeros(1, 16, 4, 16)
    k = torch.zeros(1, 16, 2, 16)
    pos = torch.zeros(1, 16, dtype=torch.int32)
    with pytest.raises(ValueError, match="head_dim 16 not supported"):
        fa._check(q, k, k, pos, pos)
    assert 16 not in fa._HEAD_DIMS and 64 in fa._HEAD_DIMS
    src = Path(preh.__file__).read_text()
    assert "import jax" not in src and "jax_llama_tpu." not in src
