"""The port's checkpoint path held against the JAX package: the Meta
converter, the layout helpers, save/load with the integrity manifest and
the training checkpoint (CPU, tiny synthetic Meta checkpoints).

Tolerances: converted trees, configs and layout helpers are compared
exactly (bf16 through a uint16 view); logits from a converted float32
checkpoint against JAX's ``forward`` and ``tests/torch_oracle.py`` within
atol 2e-4, rtol 1e-4; a resumed training step exactly.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_llama_tpu import config as jcfg_lib
from jax_llama_tpu import convert as jconvert
from jax_llama_tpu.convert import checkpoint as jckpt
from jax_llama_tpu.models import forward as jforward
from jax_llama_tpu.models import init_params as jinit_params
from jax_llama_tpu.models import llama as jllama
from jax_llama_tpu.ops import quant as jquant
import torch_oracle as oracle

import jax_llama_tpu_torch as ptl
from jax_llama_tpu_torch.convert import checkpoint as pckpt
from jax_llama_tpu_torch.convert import (
    convert_meta_checkpoint,
    load_checkpoint,
    load_config,
    load_train_state,
    save_checkpoint,
    save_train_state,
    verify_manifest,
)
from jax_llama_tpu_torch.models import llama as pllama
from jax_llama_tpu_torch.ops.quant import QuantizedTensor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Synthetic model geometry (full, unsharded), as tests/test_convert.py.
DIM, LAYERS, HEADS, KVH, VOCAB, MULT = 16, 2, 4, 2, 64, 16
HD = DIM // HEADS


def _make_meta_ckpt(path, n_shards=2, with_output=True, emb_axis=1,
                    vocab=VOCAB):
    """Random Meta-layout tensors split Megatron-style across shards and
    torch.save'd, as ``tests/test_convert.py:_make_meta_ckpt``; the
    embedding is split on the model dim (``emb_axis`` 1, Llama-2's
    ParallelEmbedding) or on the vocabulary (0, Llama-3's
    VocabParallelEmbedding)."""
    rng = np.random.RandomState(0)
    ffn = jcfg_lib.swiglu_hidden_size(DIM, MULT)
    full = {"tok_embeddings.weight": rng.randn(vocab, DIM).astype(np.float32),
            "norm.weight": rng.randn(DIM).astype(np.float32)}
    if with_output:
        full["output.weight"] = rng.randn(vocab, DIM).astype(np.float32)
    for l in range(LAYERS):
        p = f"layers.{l}."
        full[p + "attention.wq.weight"] = rng.randn(HEADS * HD, DIM).astype(np.float32)
        full[p + "attention.wk.weight"] = rng.randn(KVH * HD, DIM).astype(np.float32)
        full[p + "attention.wv.weight"] = rng.randn(KVH * HD, DIM).astype(np.float32)
        full[p + "attention.wo.weight"] = rng.randn(DIM, HEADS * HD).astype(np.float32)
        full[p + "feed_forward.w1.weight"] = rng.randn(ffn, DIM).astype(np.float32)
        full[p + "feed_forward.w2.weight"] = rng.randn(DIM, ffn).astype(np.float32)
        full[p + "feed_forward.w3.weight"] = rng.randn(ffn, DIM).astype(np.float32)
        full[p + "attention_norm.weight"] = rng.randn(DIM).astype(np.float32)
        full[p + "ffn_norm.weight"] = rng.randn(DIM).astype(np.float32)

    col_keys = ("wq", "wk", "wv", "w1", "w3", "output")
    row_keys = ("wo", "w2")
    for s in range(n_shards):
        shard = {}
        for key, arr in full.items():
            if key == "tok_embeddings.weight":
                part = np.split(arr, n_shards, axis=emb_axis)[s]
            elif any(k in key for k in col_keys):
                part = np.split(arr, n_shards, axis=0)[s]
            elif any(k in key for k in row_keys):
                part = np.split(arr, n_shards, axis=1)[s]
            else:  # norms replicated
                part = arr
            shard[key] = torch.from_numpy(part.copy())
        torch.save(shard, path / f"consolidated.{s:02d}.pth")

    (path / "params.json").write_text(json.dumps({
        "dim": DIM, "n_layers": LAYERS, "n_heads": HEADS, "n_kv_heads": KVH,
        "multiple_of": MULT, "norm_eps": 1e-5, "rope_theta": 10000.0,
        "vocab_size": -1,
    }))
    return full


# (shards, untied lm_head, embedding split axis): 1 and 2 shards, tied and
# untied heads, Llama-2 (model dim) and Llama-3 (vocabulary) embeddings.
CASES = [(1, True, 1), (1, False, 1), (2, True, 1), (2, False, 1),
         (2, True, 0), (2, False, 0)]
CASE_IDS = [f"{n}shard-{'untied' if out else 'tied'}-"
            f"{'llama2' if ax == 1 else 'llama3'}" for n, out, ax in CASES]


def _np(t):
    """A port tensor as numpy; bf16 as its uint16 bits."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _jnp(a):
    """A JAX-side array as numpy; bf16 as its uint16 bits."""
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        elif isinstance(v, QuantizedTensor) or hasattr(v, "scale"):
            out[f"{prefix}{k}/q"] = v.q
            out[f"{prefix}{k}/scale"] = v.scale
        else:
            out[prefix + k] = v
    return out


def _assert_port_tree_equals_jax(ptree, jtree):
    pf, jf = _flat(ptree), _flat(jtree)
    assert sorted(pf) == sorted(jf)
    for name in jf:
        want, got = _jnp(jf[name]), _np(pf[name])
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def _assert_trees_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert sorted(fa) == sorted(fb)
    for name in fa:
        assert fa[name].dtype == fb[name].dtype, name
        assert torch.equal(fa[name], fb[name]), name


@pytest.fixture(scope="module", params=CASES, ids=CASE_IDS)
def meta_ckpt(request, tmp_path_factory):
    n, out, ax = request.param
    path = tmp_path_factory.mktemp("meta")
    full = _make_meta_ckpt(path, n_shards=n, with_output=out, emb_axis=ax)
    return path, full, out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_matches_jax_exactly(meta_ckpt, dtype):
    path, _, with_output = meta_ckpt
    jp, jc = jconvert.convert_meta_checkpoint(
        path, vocab_size=VOCAB, max_seq_len=64, dtype=dtype)
    pp, pc = convert_meta_checkpoint(
        path, vocab_size=VOCAB, max_seq_len=64, dtype=dtype, device="cpu")
    assert dataclasses.asdict(pc) == dataclasses.asdict(jc)
    assert pc.tie_word_embeddings == (not with_output)
    _assert_port_tree_equals_jax(pp, jp)
    for t in _flat(pp).values():
        assert t.device.type == "cpu" and t.is_contiguous()


def test_convert_logits_match_jax_and_oracle(meta_ckpt):
    path = meta_ckpt[0]
    jp, jc = jconvert.convert_meta_checkpoint(
        path, vocab_size=VOCAB, max_seq_len=64, dtype="float32")
    pp, pc = convert_meta_checkpoint(
        path, vocab_size=VOCAB, max_seq_len=64, dtype="float32", device="cpu")
    tokens = np.random.RandomState(1).randint(0, VOCAB, (2, 8))
    positions = np.tile(np.arange(8), (2, 1))
    got = ptl.forward(pp, torch.from_numpy(tokens),
                      torch.from_numpy(positions), pc)[0].numpy()
    want_jax, _ = jforward(jp, jnp.asarray(tokens), jnp.asarray(positions), jc)
    want_oracle = oracle.oracle_forward(jp, tokens, positions, jc)
    np.testing.assert_allclose(got, np.asarray(want_jax), atol=2e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(got, want_oracle, atol=2e-4, rtol=1e-4)


def test_convert_shard_reassembly_exact(tmp_path):
    """split_qkv inverts the converter's packing and feature permutation
    back to Meta's tensors."""
    full = _make_meta_ckpt(tmp_path, n_shards=2)
    params, _ = convert_meta_checkpoint(tmp_path, vocab_size=VOCAB,
                                        dtype="float32", device="cpu")
    q, k, v = pllama.split_qkv(params["layers"]["qkv"][0])
    for got, key, heads in ((q, "wq", HEADS), (k, "wk", KVH), (v, "wv", KVH)):
        want = full[f"layers.0.attention.{key}.weight"].T.reshape(
            DIM, heads, HD)
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(params["lm_head"].numpy(),
                                  full["output.weight"].T)


def test_convert_rejects_unknown_arch_keys(tmp_path):
    _make_meta_ckpt(tmp_path)
    pj = json.loads((tmp_path / "params.json").read_text())
    pj["quantization_scheme"] = "fp8"
    (tmp_path / "params.json").write_text(json.dumps(pj))
    with pytest.raises(ValueError, match="quantization_scheme"):
        convert_meta_checkpoint(tmp_path, vocab_size=VOCAB, device="cpu")


def test_convert_consumes_use_scaled_rope(tmp_path):
    _make_meta_ckpt(tmp_path)
    pj = json.loads((tmp_path / "params.json").read_text())
    pj["use_scaled_rope"] = True
    (tmp_path / "params.json").write_text(json.dumps(pj))
    _, config = convert_meta_checkpoint(tmp_path, vocab_size=VOCAB,
                                        device="cpu")
    assert config.use_scaled_rope


@pytest.mark.parametrize("dtype,compute", [("float32", "float32"),
                                           ("bfloat16", "bfloat16"),
                                           ("float16", "bfloat16")])
def test_convert_dtype_sets_compute(tmp_path, dtype, compute):
    _make_meta_ckpt(tmp_path)
    params, config = convert_meta_checkpoint(
        tmp_path, vocab_size=VOCAB, dtype=dtype, device="cpu")
    assert config.dtype == compute and config.param_dtype == dtype
    assert params["layers"]["qkv"].dtype == getattr(torch, dtype)


def test_convert_needs_a_vocab_size_and_defaults_to_the_card(tmp_path):
    _make_meta_ckpt(tmp_path)
    with pytest.raises(ValueError, match="vocab_size"):
        convert_meta_checkpoint(tmp_path, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            convert_meta_checkpoint(tmp_path, vocab_size=VOCAB)


# ---------------------------------------------------------------------------
# Layout helpers
# ---------------------------------------------------------------------------

def _qkv_inputs(lead=(2,)):
    rng = np.random.default_rng(0)
    shape = lambda h: (*lead, DIM, h, HD)
    return [rng.standard_normal(shape(h)).astype(np.float32)
            for h in (HEADS, KVH, KVH)]


@pytest.mark.parametrize("inverse", [False, True])
def test_rope_permute_matches_jax(inverse):
    w = _qkv_inputs()[0]
    got = pllama.rope_permute(torch.from_numpy(w), inverse=inverse).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jllama.rope_permute(w, inverse=inverse)))
    back = pllama.rope_permute(torch.from_numpy(got), inverse=not inverse)
    np.testing.assert_array_equal(back.numpy(), w)


@pytest.mark.parametrize("lead", [(), (2,)], ids=["layer", "stacked"])
def test_fuse_and_split_qkv_match_jax(lead):
    q, k, v = _qkv_inputs(lead)
    fused = pllama.fuse_qkv(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_array_equal(fused.numpy(),
                                  np.asarray(jllama.fuse_qkv(q, k, v)))
    for got, want in zip(pllama.split_qkv(fused), (q, k, v)):
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def jax_tiny():
    cfg = jcfg_lib.tiny()
    return jax.tree.map(np.asarray, jinit_params(jax.random.PRNGKey(0), cfg))


def test_permute_d_axis_quantized_matches_jax(jax_tiny):
    """Payload and scale move together, exactly as JAX moves them."""
    jq = jax.tree.map(np.asarray, jquant.quantize_params(jax_tiny))
    pq = ptl.from_jax_params(jq, device="cpu")
    for to_d_first in (True, False):
        src_j = jq["layers"] if to_d_first else jllama.permute_d_axis(
            jq["layers"], to_d_first=True)
        src_p = pq["layers"] if to_d_first else pllama.permute_d_axis(
            pq["layers"], to_d_first=True)
        want = jllama.permute_d_axis(src_j, to_d_first=to_d_first)
        got = pllama.permute_d_axis(src_p, to_d_first=to_d_first)
        assert isinstance(got["qkv"], QuantizedTensor)
        _assert_port_tree_equals_jax(got, jax.tree.map(np.asarray, want))


def _old_separate(tree):
    """The separate q/k/v + gate/up layer tree, built as the JAX test of
    the old-layout migration builds it."""
    lp = dict(tree["layers"])
    q, k, v = jllama.split_qkv(lp.pop("qkv"))
    gate_up = lp.pop("gate_up")
    lp.update(q=np.asarray(q), k=np.asarray(k), v=np.asarray(v),
              gate=gate_up[:, 0], up=gate_up[:, 1])
    return dict(tree, layers=lp)


def test_from_jax_params_fuses_older_layer_trees(jax_tiny):
    want = ptl.from_jax_params(jax_tiny, device="cpu")
    separate = ptl.from_jax_params(_old_separate(jax_tiny), device="cpu")
    d_first = ptl.from_jax_params(
        dict(jax_tiny, layers=jax.tree.map(np.asarray, jckpt._to_d_first(
            jax_tiny["layers"]))), device="cpu")
    _assert_trees_equal(separate, want)
    _assert_trees_equal(d_first, want)
    # JAX's fuse_params of the same trees gives the same fused weights.
    _assert_port_tree_equals_jax(
        separate, jax.tree.map(np.asarray,
                               jllama.fuse_params(_old_separate(jax_tiny))))


def test_from_jax_params_quantized_layouts(jax_tiny):
    """A D-first int8 tree migrates exactly; a separate-layout int8 tree is
    refused, as JAX's checkpoint migration refuses it."""
    jq = jax.tree.map(np.asarray, jquant.quantize_params(jax_tiny))
    want = ptl.from_jax_params(jq, device="cpu")
    d_first = dict(jq, layers=jax.tree.map(
        np.asarray, jllama.permute_d_axis(jq["layers"], to_d_first=True)))
    _assert_trees_equal(ptl.from_jax_params(d_first, device="cpu"), want)
    lp = dict(jq["layers"])
    qkv = lp.pop("qkv")
    lp.update(q=qkv, k=qkv, v=qkv, gate=lp["gate_up"], up=lp.pop("gate_up"))
    with pytest.raises(NotImplementedError, match="quantize_params"):
        ptl.from_jax_params(dict(jq, layers=lp), device="cpu")


def test_forward_aux_outputs_name_their_item(jax_tiny):
    """The auxiliary outputs (ROADMAP A17, once refused naming it) on the
    converted tree: JAX's hidden states and attention probabilities."""
    jcfg = jcfg_lib.tiny()
    cfg = ptl.get_config("tiny")
    params = ptl.from_jax_params(jax_tiny, device="cpu")
    tokens = np.arange(4, dtype=np.int32)[None] + 3
    pos = np.arange(4, dtype=np.int32)[None]
    for kw in (dict(output_hidden_states=True),
               dict(output_attentions=True)):
        _, _, got = ptl.forward(params, torch.from_numpy(tokens),
                                torch.from_numpy(pos), cfg, **kw)
        _, _, want = jllama.forward(jax_tiny, tokens, pos, jcfg, **kw)
        name = "hidden_states" if "output_hidden_states" in kw else (
            "attentions")
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def _tiny_params(seed=0, dtype="float32"):
    cfg = ptl.get_config("tiny", param_dtype=dtype, dtype=dtype)
    return ptl.init_params(cfg, seed=seed, device="cpu"), cfg


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "quantized"])
def test_checkpoint_roundtrip(tmp_path, kind):
    params, cfg = _tiny_params(dtype="float32" if kind == "float32"
                               else "bfloat16")
    if kind == "quantized":
        params = ptl.quantize_params(params)
    save_checkpoint(tmp_path / "ckpt", params, cfg)
    assert sorted(os.listdir(tmp_path / "ckpt")) == [
        "config.json", "manifest.json", "params.pt"]
    restored, rcfg = load_checkpoint(tmp_path / "ckpt", device="cpu")
    assert rcfg == cfg
    assert load_config(tmp_path / "ckpt") == (cfg, kind == "quantized")
    assert isinstance(restored["layers"]["qkv"],
                      QuantizedTensor if kind == "quantized" else torch.Tensor)
    _assert_trees_equal(restored, params)


def test_checkpoint_saves_views_compactly(tmp_path):
    """A tree of views (the first layers of a stack) is saved as those
    layers alone, not as the storage beneath them."""
    params, cfg = _tiny_params()
    shallow = dict(params, layers={k: w[:1] for k, w in
                                   params["layers"].items()})
    save_checkpoint(tmp_path / "full", params, cfg)
    save_checkpoint(tmp_path / "shallow", shallow, cfg.replace(n_layers=1))
    full = os.path.getsize(tmp_path / "full" / "params.pt")
    small = os.path.getsize(tmp_path / "shallow" / "params.pt")
    assert small < 0.6 * full
    restored, _ = load_checkpoint(tmp_path / "shallow", device="cpu")
    _assert_trees_equal(restored, shallow)


def test_checkpoint_manifest_rejects_corrupt_shard(tmp_path):
    """A flipped byte, a truncated file and a deleted file each fail the
    load before any weight is used, naming the file."""
    params, cfg = _tiny_params()
    ckpt = tmp_path / "ckpt"
    save_checkpoint(ckpt, params, cfg)
    manifest = json.loads((ckpt / pckpt.MANIFEST_NAME).read_text())
    assert set(manifest["files"]) == {"config.json", "params.pt"}
    assert manifest["version"] == 1
    assert verify_manifest(ckpt) is True

    shard = ckpt / "params.pt"
    blob = bytearray(shard.read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    shard.write_bytes(bytes(blob))
    with pytest.raises(ValueError, match="params.pt: sha256 mismatch"):
        load_checkpoint(ckpt, device="cpu")
    shard.write_bytes(bytes(blob[: len(blob) // 2]))
    with pytest.raises(ValueError, match="params.pt: truncated"):
        load_checkpoint(ckpt, device="cpu")
    shard.unlink()
    with pytest.raises(ValueError, match="params.pt: missing"):
        load_checkpoint(ckpt, device="cpu")


def test_checkpoint_verify_false_skips_the_hash(tmp_path):
    params, cfg = _tiny_params()
    save_checkpoint(tmp_path / "ckpt", params, cfg)
    mf = tmp_path / "ckpt" / pckpt.MANIFEST_NAME
    manifest = json.loads(mf.read_text())
    manifest["files"]["params.pt"]["sha256"] = "0" * 64
    mf.write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="sha256 mismatch"):
        load_checkpoint(tmp_path / "ckpt", device="cpu")
    restored, _ = load_checkpoint(tmp_path / "ckpt", device="cpu",
                                  verify=False)
    _assert_trees_equal(restored, params)


def test_checkpoint_atomic_overwrite_keeps_manifest_consistent(tmp_path):
    cfg = ptl.get_config("tiny")
    ckpt = tmp_path / "ckpt"
    save_checkpoint(ckpt, _tiny_params(seed=0)[0], cfg)
    save_checkpoint(ckpt, _tiny_params(seed=1)[0], cfg)
    restored, _ = load_checkpoint(ckpt, device="cpu")
    _assert_trees_equal(restored, _tiny_params(seed=1)[0])
    assert verify_manifest(ckpt) is True
    leftovers = [n for n in os.listdir(tmp_path)
                 if ".tmp-" in n or ".trash-" in n]
    assert leftovers == []


def test_checkpoint_failed_save_leaves_no_temp_dir(tmp_path, monkeypatch):
    """A write that fails (here: a full disk) leaves neither a checkpoint
    nor its temp directory behind."""
    params, cfg = _tiny_params()

    def full_disk(*args, **kwargs):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(pckpt.torch, "save", full_disk)
    with pytest.raises(OSError, match="No space"):
        save_checkpoint(tmp_path / "ckpt", params, cfg)
    assert os.listdir(tmp_path) == []


def test_checkpoint_kind_mismatch_errors(tmp_path):
    params, cfg = _tiny_params()
    opt = ptl.make_optimizer(1e-3)
    save_train_state(tmp_path / "t", ptl.init_train_state(params, opt), cfg)
    with pytest.raises(ValueError, match="training checkpoint"):
        load_checkpoint(tmp_path / "t", device="cpu")
    save_checkpoint(tmp_path / "s", _tiny_params()[0], cfg)
    with pytest.raises(ValueError, match="serving checkpoint"):
        load_train_state(tmp_path / "s", device="cpu")


def test_train_state_resume_roundtrip(tmp_path):
    """2 steps, save, load, 1 step: the same losses and params as 3 steps
    straight through (exactly: the same float32 work in the same order)."""
    cfg = ptl.get_config("tiny", vocab_size=64, dim=32, n_layers=2,
                         n_heads=4, n_kv_heads=2, multiple_of=32,
                         max_seq_len=16)
    tokens = torch.from_numpy(
        np.random.RandomState(0).randint(0, 64, (4, 16)).astype(np.int32))
    opt = ptl.make_optimizer(1e-3)

    straight = ptl.init_train_state(ptl.init_params(cfg, seed=0,
                                                    device="cpu"), opt)
    losses = []
    for _ in range(3):
        straight, loss = ptl.train_step(straight, tokens, cfg, opt)
        losses.append(float(loss))

    state = ptl.init_train_state(ptl.init_params(cfg, seed=0, device="cpu"),
                                 opt)
    for _ in range(2):
        state, _ = ptl.train_step(state, tokens, cfg, opt)
    save_train_state(tmp_path / "tstate", state, cfg)
    restored, rcfg = load_train_state(tmp_path / "tstate", device="cpu")
    assert rcfg == cfg
    assert restored.step == 2 and restored.opt_state.count == 2
    _assert_trees_equal(restored.opt_state.mu, state.opt_state.mu)
    resumed, loss = ptl.train_step(restored, tokens, cfg, opt)
    assert float(loss) == losses[2]
    assert resumed.step == 3
    _assert_trees_equal(resumed.params, straight.params)
    _assert_trees_equal(resumed.opt_state.nu, straight.opt_state.nu)


# ---------------------------------------------------------------------------
# Across the two packages: one manifest and config format
# ---------------------------------------------------------------------------

def _flip_a_byte(path):
    blob = bytearray(path.read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    path.write_bytes(bytes(blob))


def test_port_reads_a_jax_checkpoint_directory(tmp_path):
    """The port's verify_manifest and load_config accept a directory that
    JAX's save_checkpoint wrote, refuse it after one flipped byte, and its
    load_checkpoint refuses the Orbax tree with a pointer to the
    converter."""
    jc = jcfg_lib.tiny()
    ckpt = tmp_path / "jax"
    jckpt.save_checkpoint(ckpt, jinit_params(jax.random.PRNGKey(0), jc), jc)
    assert verify_manifest(ckpt) is True
    cfg, quantized = load_config(ckpt)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jc)
    assert quantized is False
    with pytest.raises(ValueError, match="reads no Orbax checkpoint"):
        load_checkpoint(ckpt, device="cpu")
    manifest = json.loads((ckpt / "manifest.json").read_text())
    rel = max(manifest["files"], key=lambda r: manifest["files"][r]["bytes"])
    _flip_a_byte(ckpt / rel)
    with pytest.raises(ValueError, match="sha256 mismatch"):
        verify_manifest(ckpt)


def test_jax_reads_a_port_checkpoint_directory(tmp_path):
    """JAX's verify_manifest and load_config accept the port's directory
    (same manifest and config.json) and refuse it after one flipped
    byte."""
    params, cfg = _tiny_params()
    ckpt = tmp_path / "port"
    save_checkpoint(ckpt, ptl.quantize_params(params), cfg)
    assert jckpt.verify_manifest(ckpt) is True
    jc, quantized = jckpt.load_config(ckpt)
    assert dataclasses.asdict(jc) == dataclasses.asdict(cfg)
    assert quantized is True
    _flip_a_byte(ckpt / "params.pt")
    with pytest.raises(ValueError, match="sha256 mismatch"):
        jckpt.verify_manifest(ckpt)


# ---------------------------------------------------------------------------
# The slice's modules import with jax blocked
# ---------------------------------------------------------------------------

_SLICE_MODULES = (
    "convert", "convert.meta", "convert.checkpoint", "convert.__main__",
    "tokenizers.llama3", "tokenizers.llama2", "run", "download", "obs",
    "utils.profiling",
)

_BLOCKED = """
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        for banned in ("jax", "jaxlib", "jax_llama_tpu"):
            if name == banned or name.startswith(banned + "."):
                raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
import jax_llama_tpu_torch as pkg
walked = {m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                 pkg.__name__ + ".")}
want = [f"jax_llama_tpu_torch.{m}" for m in sys.argv[1:]]
missing = [m for m in want if m not in walked]
assert not missing, missing
for name in want:
    importlib.import_module(name)
bad = [m for m in sys.modules if m in ("jax", "jaxlib", "jax_llama_tpu")
       or m.startswith(("jax.", "jaxlib.", "jax_llama_tpu."))]
assert not bad, bad
print("ok")
"""


def test_slice_modules_import_with_jax_blocked():
    """The walk of tests/test_torch_generate.py reaches every module of this
    slice, and each imports with jax and the JAX package blocked."""
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED, *_SLICE_MODULES], cwd=REPO,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
