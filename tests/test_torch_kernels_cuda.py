"""The selection layer's two kernels on the card: the stock-paged decode
(``csrc/stock_paged.cu``) and the splash prefill (``csrc/splash_prefill.cu``)
against their plain versions.  Marked ``cuda``: each test skips on a host
without a GPU (the kernels have no CPU mode).  Like
tests/test_torch_cuda.py, this file imports neither jax nor the JAX
package, so it runs on a GPU host without them:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest -q

Tolerances against the plain version, per row (the row's max abs error
over its own max |plain|): 1e-2 in bf16 (output rounding; the splash
kernel's P rounded to bf16 at a running max), 1e-4 in float32 (summation
order).
"""

import importlib

import numpy as np
import pytest
import torch

from paged_inputs import pool_state

kn = importlib.import_module("jax_llama_tpu_torch.ops.kernels")

BOUND = {torch.bfloat16: 1e-2, torch.float32: 1e-4}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


def _row_rel(got, want):
    """The worst row's max abs error over its own max |plain| (rows: all
    but the last axis)."""
    err = (got.float() - want.float()).abs().amax(-1)
    scale = want.float().abs().amax(-1)
    return (err / torch.where(scale == 0, scale.max(), scale)).max().item()


# (B, KVH, G, d, BLK, MB, L, fills, inactive): empty rows, one slot, a
# block edge, 2047 slots; block sizes 128, 16, 20.
STOCK_CASES = {
    "d128_g4_blk128": (6, 8, 4, 128, 128, 16, 2, (2047, 0, 1, 128, 700, 5),
                       (5,)),
    "d64_g8_blk16": (4, 2, 8, 64, 16, 8, 2, (0, 1, 16, 100), ()),
    "d64_g1_blk20": (3, 4, 1, 64, 20, 6, 1, (20, 119, 0), (2,)),
    "d128_g8_blk20": (3, 2, 8, 128, 20, 104, 2, (2047, 40, 21), ()),
}
STOCK_DTYPES = {
    "bf16": (torch.bfloat16, torch.bfloat16),
    "f32": (torch.float32, torch.float32),
    "bf16q_f32pool": (torch.bfloat16, torch.float32),
}


def _stock_inputs(name, q_dtype, pool_dtype):
    B, KVH, G, d, BLK, MB, L, fills, inactive = STOCK_CASES[name]
    k, v, _, table, q_pos = pool_state(11, B, KVH, d, BLK, MB, L, fills,
                                       inactive)
    rng = np.random.default_rng(12)
    q, k_new, v_new = (rng.standard_normal(s).astype(np.float32)
                       for s in ((B, 1, KVH * G, d), (B, 1, KVH, d),
                                 (B, 1, KVH, d)))
    qs = [torch.from_numpy(a).cuda().to(q_dtype) for a in (q, k_new, v_new)]
    pools = [torch.from_numpy(a).cuda().to(pool_dtype) for a in (k, v)]
    return qs + pools + [torch.from_numpy(a).cuda() for a in (table, q_pos)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", sorted(STOCK_DTYPES))
@pytest.mark.parametrize("name", sorted(STOCK_CASES))
def test_stock_kernel_matches_plain_on_card(name, dtypes):
    _need_card()
    q_dtype, pool_dtype = STOCK_DTYPES[dtypes]
    args = _stock_inputs(name, q_dtype, pool_dtype)
    layer = args[3].shape[0] - 1
    before = kn.stock_paged_decode.launches
    out = kn.stock_paged_decode(*args, layer=layer)
    torch.cuda.synchronize()
    assert kn.stock_paged_decode.launches == \
        before + kn.STOCK_KERNELS_PER_CALL
    ref = kn.stock_paged_decode_reference(*[a.cpu() for a in args],
                                          layer=layer)
    assert out.dtype == q_dtype and bool(torch.isfinite(out).all())
    assert _row_rel(out.cpu(), ref) < BOUND[q_dtype]


@pytest.mark.cuda
def test_stock_kernel_layer_select_on_card():
    """The 5-D pool at its last layer gives exactly what the 4-D plane
    gives; the refusals hold on CUDA tensors too."""
    _need_card()
    args = _stock_inputs("d128_g4_blk128", torch.bfloat16, torch.bfloat16)
    q, k_new, v_new, k, v, table, q_pos = args
    five_d = kn.stock_paged_decode(*args, layer=1)
    four_d = kn.stock_paged_decode(q, k_new, v_new, k[1].contiguous(),
                                   v[1].contiguous(), table, q_pos)
    torch.cuda.synchronize()
    torch.testing.assert_close(five_d, four_d, atol=0, rtol=0)
    with pytest.raises(ValueError, match="multi-layer pool"):
        kn.stock_paged_decode(*args)
    with pytest.raises(NotImplementedError, match="T == 1 only"):
        kn.stock_paged_decode(q.repeat(1, 2, 1, 1), *args[1:], layer=1)
    with pytest.raises(TypeError, match="int8"):
        kn.stock_paged_decode(q, k_new, v_new, k.to(torch.int8),
                              v.to(torch.int8), table, q_pos, layer=1)


# (B, T, S, H, KVH, offset): offsets 0, 128, 512; T = S and T < S; G 1, 4.
SPLASH_CASES = {
    "g4_t256_s256_off0": (2, 256, 256, 8, 2, 0),
    "g1_t128_s512_off128": (2, 128, 512, 2, 2, 128),
    "g4_t256_s1024_off512": (1, 256, 1024, 8, 2, 512),
    "g4_t512_s1024_off0": (1, 512, 1024, 4, 1, 0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("name", sorted(SPLASH_CASES))
def test_splash_kernel_matches_plain_on_card(name, dtype):
    _need_card()
    B, T, S, H, KVH, off = SPLASH_CASES[name]
    gen = torch.Generator(device="cuda").manual_seed(3)
    q = torch.randn(B, T, H, 128, device="cuda", generator=gen).to(dtype)
    k = torch.randn(B, S, KVH, 128, device="cuda", generator=gen).to(dtype)
    v = torch.randn(B, S, KVH, 128, device="cuda", generator=gen).to(dtype)
    before = kn.splash_prefill.launches
    out = kn.splash_prefill(q, k, v, chunk_offset=off)
    torch.cuda.synchronize()
    assert kn.splash_prefill.launches == before + 1
    ref = kn.splash_prefill_reference(q, k, v, chunk_offset=off)
    assert out.dtype == dtype and bool(torch.isfinite(out).all())
    assert _row_rel(out, ref) < BOUND[dtype]


@pytest.mark.cuda
def test_splash_kernel_refuses_off_128_shapes_on_card():
    _need_card()
    z = dict(device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 128"):
        kn.splash_prefill(torch.zeros(1, 192, 2, 128, **z),
                          torch.zeros(1, 256, 1, 128, **z),
                          torch.zeros(1, 256, 1, 128, **z), chunk_offset=0)
    with pytest.raises(ValueError, match="head_dim 128"):
        kn.splash_prefill(torch.zeros(1, 128, 2, 256, **z),
                          torch.zeros(1, 128, 1, 256, **z),
                          torch.zeros(1, 128, 1, 256, **z), chunk_offset=0)
