"""The selection layer's two kernels on the card: the stock-paged decode
(``csrc/stock_paged.cu``: split-KV, every product on the tensor cores) and
the splash prefill (``csrc/splash_prefill.cu``: the TMA + wgmma instance
in bf16, CUDA cores in float32) against their plain versions.  Marked
``cuda``: each test skips on a host without a GPU (the kernels have no
CPU mode).  Like
tests/test_torch_cuda.py, this file imports neither jax nor the JAX
package, so it runs on a GPU host without them:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest -q

Tolerances against the plain version, per row (the row's max abs error
over its own max |plain|): 1e-2 in bf16 (output rounding; the splash
kernel's P rounded to bf16 at a running max), 1e-4 in float32 (summation
order).  Two calls on the same inputs give bit-identical outputs (no
atomics).
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
    # Fills that end inside a 16-slot chunk and inside a page of 16 or 20;
    # row 0 spans four 512-slot splits (1541 = 3*512 + 5) and three
    # (1109 = 2*512 + 85), its last split ending mid-chunk and mid-page.
    "d128_g4_blk16_mid": (4, 4, 4, 128, 16, 100, 2, (1541, 37, 401, 0),
                          ()),
    "d64_g2_blk20_mid": (3, 2, 2, 64, 20, 60, 1, (1109, 47, 7), ()),
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
@pytest.mark.parametrize("dtypes", sorted(STOCK_DTYPES))
@pytest.mark.parametrize("name", ["d128_g4_blk128", "d128_g4_blk16_mid",
                                  "d64_g2_blk20_mid"])
def test_stock_kernel_never_reads_unreached_blocks_on_card(name, dtypes):
    """Pool blocks no row's table names (spread among the live ones: the
    blocks are shuffled) hold NaN: the output is finite and equals the
    plain version run with those blocks zeroed; a second call is
    bit-identical."""
    _need_card()
    q_dtype, pool_dtype = STOCK_DTYPES[dtypes]
    args = _stock_inputs(name, q_dtype, pool_dtype)
    q, k_new, v_new, k, v, table, q_pos = args
    NB = k.shape[2]
    reached = torch.zeros(NB, dtype=torch.bool, device="cuda")
    named = table[(table >= 0) & (table < NB)].long()
    reached[named] = True
    assert 0 < int(reached.sum()) < NB
    k_nan, v_nan = k.clone(), v.clone()
    k_nan[:, :, ~reached] = float("nan")
    v_nan[:, :, ~reached] = float("nan")
    k_zero, v_zero = k.clone(), v.clone()
    k_zero[:, :, ~reached] = 0
    v_zero[:, :, ~reached] = 0
    layer = k.shape[0] - 1
    out = kn.stock_paged_decode(q, k_new, v_new, k_nan, v_nan, table, q_pos,
                                layer=layer)
    again = kn.stock_paged_decode(q, k_new, v_new, k_nan, v_nan, table,
                                  q_pos, layer=layer)
    torch.cuda.synchronize()
    ref = kn.stock_paged_decode_reference(
        *[a.cpu() for a in (q, k_new, v_new, k_zero, v_zero, table, q_pos)],
        layer=layer)
    assert bool(torch.isfinite(out).all())
    assert torch.equal(out, again)
    assert _row_rel(out.cpu(), ref) < BOUND[q_dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("split", [128, 256])
@pytest.mark.parametrize("dtypes", sorted(STOCK_DTYPES))
@pytest.mark.parametrize("name", ["d128_g8_blk20", "d128_g4_blk16_mid",
                                  "d64_g2_blk20_mid"])
def test_stock_kernel_smaller_splits_on_card(name, dtypes, split):
    """Splits of 128 and 256 slots put split and chunk boundaries inside
    pages of 16 and 20 and rows across up to 16 splits; the output is the
    plain version's, and the same instance runs."""
    _need_card()
    q_dtype, pool_dtype = STOCK_DTYPES[dtypes]
    args = _stock_inputs(name, q_dtype, pool_dtype)
    layer = args[3].shape[0] - 1
    before = dict(kn.stock_paged_decode.launches_by_instance)
    out = kn.stock_paged_launch(*args, layer=layer, split=split)
    torch.cuda.synchronize()
    want = kn.stock_instance(q_dtype, pool_dtype)
    assert kn.stock_paged_decode.launches_by_instance[want] == \
        before.get(want, 0) + 1
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
    # The 70b head layout (G = 8); long inserts and chunks of more work
    # items (128 query rows of a head) than the card has SMs, so a block
    # of the persistent grid walks several; a short chunk far in.
    "g8_t256_s512_off256": (1, 256, 512, 16, 2, 256),
    "g4_t2048_s2048_off0": (2, 2048, 2048, 8, 2, 0),
    "g8_t512_s1024_off512": (4, 512, 1024, 16, 2, 512),
    "g4_t128_s1024_off384": (2, 128, 1024, 8, 2, 384),
    # An offset off the 128 grid: the last tile of a block lies past all
    # of its first 64 rows.
    "g4_t256_s512_off192": (2, 256, 512, 8, 2, 192),
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("name", ["g4_t256_s1024_off512",
                                  "g8_t256_s512_off256",
                                  "g4_t128_s1024_off384",
                                  "g4_t256_s512_off192"])
def test_splash_kernel_one_hot_v_on_card(name, dtype):
    """v of slot j is the unit vector e_(j mod d): each output feature is
    the probability mass on the columns of that residue, so a column
    attended in error, or one missed, shows at full size.  Two calls give
    bit-identical outputs."""
    _need_card()
    B, T, S, H, KVH, off = SPLASH_CASES[name]
    d = 128
    gen = torch.Generator(device="cuda").manual_seed(5)
    q = torch.randn(B, T, H, d, device="cuda", generator=gen).to(dtype)
    k = torch.randn(B, S, KVH, d, device="cuda", generator=gen).to(dtype)
    eye = torch.eye(d, device="cuda", dtype=dtype)
    v = eye[torch.arange(S, device="cuda") % d][None, :, None, :].expand(
        B, S, KVH, d).contiguous()
    out = kn.splash_prefill(q, k, v, chunk_offset=off)
    again = kn.splash_prefill(q, k, v, chunk_offset=off)
    torch.cuda.synchronize()
    ref = kn.splash_prefill_reference(q, k, v, chunk_offset=off)
    assert torch.equal(out, again)
    assert _row_rel(out, ref) < BOUND[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", sorted(STOCK_DTYPES))
def test_stock_kernel_bit_identical_on_card(dtypes):
    _need_card()
    q_dtype, pool_dtype = STOCK_DTYPES[dtypes]
    args = _stock_inputs("d128_g8_blk20", q_dtype, pool_dtype)
    layer = args[3].shape[0] - 1
    first = kn.stock_paged_decode(*args, layer=layer)
    second = kn.stock_paged_decode(*args, layer=layer)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_splash_kernel_bit_identical_on_card():
    _need_card()
    B, T, S, H, KVH, off = SPLASH_CASES["g4_t2048_s2048_off0"]
    gen = torch.Generator(device="cuda").manual_seed(7)
    q, k, v = (torch.randn(B, n, h, 128, device="cuda", generator=gen)
               .to(torch.bfloat16) for n, h in ((T, H), (S, KVH), (S, KVH)))
    first = kn.splash_prefill(q, k, v, chunk_offset=off)
    second = kn.splash_prefill(q, k, v, chunk_offset=off)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
