"""The port's packed-data pipeline held against ``jax_llama_tpu.data``:
the same documents give the same rows, masks and batches, shuffle
included; ``to_device`` places a batch and refuses a mesh."""

import numpy as np
import pytest
import torch

from jax_llama_tpu import data as jdata

from jax_llama_tpu_torch import data as pdata


def _docs(n=23, seed=0, eos=2):
    rng = np.random.default_rng(seed)
    return [list(rng.integers(3, 100, rng.integers(1, 40))) + [eos]
            for _ in range(n)]


def _same(a, b):
    np.testing.assert_array_equal(a.tokens, b.tokens)
    np.testing.assert_array_equal(a.loss_mask, b.loss_mask)
    assert a.tokens.dtype == b.tokens.dtype == np.int32
    assert a.loss_mask.dtype == b.loss_mask.dtype == np.bool_


@pytest.mark.parametrize("seq_len", [2, 16, 37])
def test_pack_documents_matches_jax(seq_len):
    want = list(jdata.pack_documents(_docs(), seq_len, pad_id=1))
    got = list(pdata.pack_documents(_docs(), seq_len, pad_id=1))
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        _same(a, b)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(drop_remainder=False),
    dict(shuffle_buffer=4, seed=3),
    dict(shuffle_buffer=64, seed=None, drop_remainder=False),
])
def test_batches_match_jax(kw):
    want = list(jdata.batches(_docs(41, seed=1), 3, 24, pad_id=0, **kw))
    got = list(pdata.batches(_docs(41, seed=1), 3, 24, pad_id=0, **kw))
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a.tokens.shape == (3, 24)
        _same(a, b)


def test_pack_documents_rejects_short_rows():
    with pytest.raises(ValueError, match="seq_len"):
        list(pdata.pack_documents(_docs(), 1))


def test_to_device_and_mesh_refusal():
    batch = next(pdata.batches(_docs(), 2, 16))
    placed = pdata.to_device(batch, "cpu")
    assert placed.tokens.dtype == torch.int32
    assert placed.loss_mask.dtype == torch.bool
    np.testing.assert_array_equal(placed.tokens.numpy(), batch.tokens)
    with pytest.raises(NotImplementedError, match="A14"):
        pdata.to_device(batch, "cpu", mesh=object())
