"""The kernel-selection layer and the two kernels it selects: the splash
prefill and the stock-paged decode.

Port of ``jax_llama_tpu/ops/kernels.py``.  A config names one kernel per
role (``prefill_kernel``, ``decode_kernel``); the batcher resolves "auto"
once, when it is built, and bakes the concrete names into its config.

Roles and their kernels:

* prefill: ``flash`` (``ops.flash_attention``, the default) or ``splash``
  (``splash_prefill``): causal attention of one insert chunk whose first
  query sits at a static offset.  It runs only where ``splash_eligible``
  holds (head_dim and both lengths multiples of 128, a static offset, a
  full-precision cache); any other chunk runs the flash kernel, decided
  per call before any launch.
* decode: ``paged`` (``ops.paged_attention``, the default),
  ``stock-paged`` (``stock_paged_decode``: T == 1 steps over a
  full-precision pool; a T > 1 step or an int8 pool runs the paged
  kernel, decided per call), or ``gathered`` (not a kernel: the batcher's
  gathered view, ``use_pallas_kernel=False``).

``KernelSpec.fallback``, ``feature`` and ``fault_site`` own the
quarantine ladder between kernels (splash -> flash, stock-paged -> paged)
and each kernel's degrade feature and fault site; ``KERNEL_SOURCES`` names
the ``csrc/`` source each kernel is built from.  The server
(``server.LLMServer``) and the batcher's dispatch records read them from
here.  A kernel that fails to build or launch raises.  On the card only
the server's degrade layer acts on that error, and only by rebuilding onto
another hand-written kernel (the ``fallback`` above); a failure of the
baseline kernels (flash, paged) goes to the crash-recovery budget and its
breaker, never to plain PyTorch.

Each kernel has a plain PyTorch version beside its wrapper
(``splash_prefill_reference``, ``stock_paged_decode_reference``).  A CPU
tensor runs the plain version; a CUDA tensor launches the hand-written
kernel (``csrc/splash_prefill.cu``: TMA + wgmma in bf16;
``csrc/stock_paged.cu``: split-KV on the tensor cores) or raises.  Each
wrapper counts its kernel launches (``fn.launches``) and its calls by
instance, as the C entry point reports it (``fn.launches_by_instance``:
``splash_instance_name``, ``stock_instance_name``).

Not ported: the mesh branches (ROADMAP A14) and the TPU tilings
``_splash_block_sizes`` and ``_pages_per_compute_block``.  The JAX
package's trace-time fault hooks fire here at a library's first load
(``ops._build.load``) and at each dispatch (the batcher's ``_fault``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional, Tuple

import torch

from . import _build

# ---------------------------------------------------------------------------
# Selection registry (JAX :65-101)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """One selectable attention kernel.

    ``fallback`` is the kernel a quarantine rebuild selects (None: this is
    the baseline of its role, and has no kernel to fall back to);
    ``feature`` / ``fault_site`` are its degrade.py and faults.py names.
    """

    name: str
    role: str                      # "prefill" | "decode"
    fallback: Optional[str] = None
    feature: Optional[str] = None
    fault_site: Optional[str] = None


PREFILL_KERNELS = {
    "flash": KernelSpec(
        "flash", "prefill",
        feature="flash_attention", fault_site="flash_kernel",
    ),
    "splash": KernelSpec(
        "splash", "prefill", fallback="flash",
        feature="splash_prefill", fault_site="splash_kernel",
    ),
}

DECODE_KERNELS = {
    "paged": KernelSpec(
        "paged", "decode",
        feature="paged_kernel", fault_site="paged_kernel",
    ),
    "stock-paged": KernelSpec(
        "stock-paged", "decode", fallback="paged",
        feature="stock_paged", fault_site="stock_paged_kernel",
    ),
    # Not a kernel: the batcher's gathered view (use_pallas_kernel=False).
    "gathered": KernelSpec("gathered", "decode"),
}

# The csrc/ source each selectable kernel is built from (ops/_build.py).
KERNEL_SOURCES = {
    "flash": "flash_fwd", "splash": "splash_prefill",
    "paged": "paged_decode", "stock-paged": "stock_paged",
}


def kernel_specs() -> Tuple[KernelSpec, ...]:
    """Every selectable kernel with a degrade feature, the opt-in kernels
    (those with a kernel ``fallback``) first: the order a failure that
    names several features is attributed in, one rung at a time."""
    specs = [s for t in (PREFILL_KERNELS, DECODE_KERNELS)
             for s in t.values() if s.feature]
    return tuple(sorted(specs, key=lambda s: s.fallback is None))


def fault_site_of_source(source: str) -> Optional[str]:
    """The fault site of the kernel built from ``csrc/<source>.cu``."""
    for name, src in KERNEL_SOURCES.items():
        if src == source:
            spec = PREFILL_KERNELS.get(name) or DECODE_KERNELS[name]
            return spec.fault_site
    return None


def resolve_prefill_kernel(name: Optional[str], config) -> str:
    """A prefill-kernel name ("auto" or None included) as a concrete one:
    "auto" is splash where it can ever run (head_dim a multiple of 128, a
    full-precision cache), else flash.  Each chunk is still checked by
    ``splash_eligible``."""
    name = name or "auto"
    if name == "auto":
        return (
            "splash"
            if config.head_dim % 128 == 0
            and config.kv_cache_dtype != "int8"
            else "flash"
        )
    if name not in PREFILL_KERNELS:
        raise ValueError(
            f"unknown prefill kernel {name!r}; "
            f"have {sorted(PREFILL_KERNELS)} or 'auto'"
        )
    return name


def resolve_decode_kernel(name: Optional[str], config) -> str:
    """A decode-kernel name ("auto" or None included) as a concrete one:
    "auto" is the paged kernel, which also takes int8 pools and T > 1."""
    name = name or "auto"
    if name == "auto":
        return "paged"
    if name not in DECODE_KERNELS:
        raise ValueError(
            f"unknown decode kernel {name!r}; "
            f"have {sorted(DECODE_KERNELS)} or 'auto'"
        )
    return name


def splash_eligible(
    config,
    *,
    batch: int,
    q_len: int,
    kv_len: int,
    chunk_offset: Optional[int],
    quantized: bool = False,
    mesh=None,
) -> bool:
    """Can this prefill chunk run the splash kernel?  A static decision
    from the config, the shapes and the chunk's Python-int offset: the
    config selects splash, the offset is known, the cache is full
    precision, and head_dim, q_len and kv_len are multiples of 128.
    ``batch`` is the JAX signature's (its mesh clauses use it).  The port
    has no mesh yet: a mesh raises."""
    if mesh is not None:
        raise NotImplementedError(
            "splash_eligible under a mesh is not ported (ROADMAP A14)")
    if config.prefill_kernel != "splash":
        return False
    if chunk_offset is None or quantized:
        return False
    d = config.head_dim
    return d % 128 == 0 and q_len % 128 == 0 and kv_len % 128 == 0


_FNS = {}


def _lib_fn(name: str, symbol: str, argtypes):
    """The C entry point ``symbol`` of ``csrc/<name>.cu`` (built at first
    use), typed once per process."""
    if symbol not in _FNS:
        fn = getattr(_build.load(name), symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        _FNS[symbol] = fn
    return _FNS[symbol]


def _launch(device: torch.device, fn, *args) -> Tuple[int, int]:
    """Call the C entry point ``fn(*args, stream, &instance)`` on
    ``device``'s current stream, with ``device`` the current CUDA device
    for the call; returns its cudaError_t and the instance code it
    reported (0 when nothing launched)."""
    stream = torch.cuda.current_stream(device).cuda_stream
    code = ctypes.c_int(0)
    if device.index == torch.cuda.current_device():
        return fn(*args, stream, ctypes.byref(code)), code.value
    with torch.cuda.device(device):
        return fn(*args, stream, ctypes.byref(code)), code.value


def _count(wrapper, instance: str, launches: int) -> None:
    """``launches`` kernel launches of one ``wrapper`` call, of
    ``instance``."""
    wrapper.launches += launches
    by = wrapper.launches_by_instance
    by[instance] = by.get(instance, 0) + 1


def _on_card(name: str, tensors) -> None:
    """Device, contiguity and alignment of a kernel's tensor arguments."""
    dev = tensors[0][1].device
    for what, t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: {what} is on {t.device}, "
                             f"{tensors[0][0]} on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} must be 16-byte aligned")


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# ---------------------------------------------------------------------------
# Splash prefill (JAX :224-315)
# ---------------------------------------------------------------------------

SPLASH_KERNEL = "splash_prefill"
SPLASH_MULTIPLE = 128   # head_dim, q_len and kv_len (the eligibility rule)
SPLASH_HEAD_DIM = 128   # the head_dim the card kernel is built for


def _splash_check(q, k, v, chunk_offset) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("splash_prefill: q must be [B, T, H, d] and k, v "
                         "[B, S, KVH, d]")
    B, T, H, d = q.shape
    Bk, S, KVH, dk = k.shape
    if Bk != B or dk != d or KVH == 0 or H % KVH:
        raise ValueError(f"splash_prefill: shape mismatch q {tuple(q.shape)}"
                         f", k {tuple(k.shape)}")
    if d % SPLASH_MULTIPLE or T % SPLASH_MULTIPLE or S % SPLASH_MULTIPLE:
        raise ValueError(
            f"splash_prefill needs head_dim, q_len and kv_len multiples of "
            f"{SPLASH_MULTIPLE}; got d={d}, T={T}, S={S} (splash_eligible "
            f"keeps such chunks on the flash kernel)")
    if not isinstance(chunk_offset, int) or chunk_offset < 0:
        raise ValueError(f"splash_prefill: chunk_offset must be a static "
                         f"int >= 0, got {chunk_offset!r}")


def splash_prefill_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    chunk_offset: int,
) -> torch.Tensor:
    """The kernel's function in plain torch: q and k scaled by d**-0.25,
    each rounded to its dtype (JAX :269-270); float32 scores; query row t
    attends cache column j iff j <= t + chunk_offset; float32 softmax;
    the probabilities rounded to v's dtype for the P.V product (as the
    tensor-core kernel rounds them; a no-op in float32) and the float32
    row sum of the unrounded ones as denominator.  Returns [B, T, H, d]
    in q's dtype."""
    _splash_check(q, k, v, chunk_offset)
    B, T, H, d = q.shape
    S, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    scale = d ** -0.25
    qs = (q * scale).to(q.dtype).reshape(B, T, KVH, G, d)
    ks = (k * scale).to(k.dtype)
    s = torch.einsum("btkgd,bskd->bkgts", qs.float(), ks.float())
    cols = torch.arange(S, device=q.device)[None, :]
    rows = torch.arange(T, device=q.device)[:, None]
    s = s.masked_fill(cols > rows + chunk_offset, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)   # column 0 is always attended
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgts,bskd->bkgtd", p.to(v.dtype).float(), v.float())
    o = (o / l).permute(0, 3, 1, 2, 4)
    return o.reshape(B, T, H, d).to(q.dtype)


def splash_prefill(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    chunk_offset: int,
) -> torch.Tensor:
    """Causal attention of one prefill chunk at a static offset.

    q [B, T, H, d] holds the chunk's queries; k, v [B, S, KVH, d] the whole
    cache after this chunk's write.  Query row t sits at position
    ``chunk_offset + t`` and attends cache column j iff
    ``j <= t + chunk_offset`` (the insert path's slot index == position).
    GQA: query head h reads KV head h // (H // KVH).  d, T and S must be
    multiples of 128.  Returns [B, T, H, d] in q's dtype.

    A CPU tensor runs ``splash_prefill_reference``; a CUDA tensor launches
    ``csrc/splash_prefill.cu`` (bf16 or float32, head_dim 128) or raises.
    """
    _splash_check(q, k, v, chunk_offset)
    if q.device.type == "cpu":
        return splash_prefill_reference(q, k, v, chunk_offset=chunk_offset)
    if q.device.type != "cuda":
        raise ValueError(f"splash_prefill: unsupported device {q.device}")
    B, T, H, d = q.shape
    S, KVH = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"splash_prefill: q, k, v must share one of "
                        f"{list(_DTYPE_CODE)}; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if d != SPLASH_HEAD_DIM:
        raise ValueError(f"splash_prefill: the card kernel takes head_dim "
                         f"{SPLASH_HEAD_DIM}, got {d}")
    _on_card("splash_prefill", [("q", q), ("k", k), ("v", v)])
    fn = _lib_fn(SPLASH_KERNEL, "splash_prefill",
                 [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                 + [ctypes.c_float, ctypes.c_void_p,
                    ctypes.POINTER(ctypes.c_int)])
    out = torch.empty_like(q)
    rc, code = _launch(q.device, fn, q.data_ptr(), k.data_ptr(),
                       v.data_ptr(), out.data_ptr(), B, T, S, H, KVH, d,
                       chunk_offset, _DTYPE_CODE[q.dtype], d ** -0.25)
    if rc != 0:
        raise RuntimeError(f"splash_prefill launch failed: cudaError_t {rc}")
    _count(splash_prefill, splash_instance_name(code), 1)
    return out


# Launches of the CUDA kernel in this process (the plain version never
# counts), in all and by the instance the C entry point reports it
# launched (``splash_instance_name``); callers reset them by assigning 0
# and {}.
splash_prefill.launches = 0
splash_prefill.launches_by_instance = {}

_SPLASH_INSTANCES = {1: "wgmma", 2: "float32"}


def splash_instance_name(code: int) -> str:
    """The instance ``csrc/splash_prefill.cu``'s entry point reports it
    launched: 1 "wgmma" (bf16: a persistent grid, a producer warpgroup's
    TMA ring and two consumer warpgroups on wgmma), 2 "float32" (CUDA
    cores)."""
    if code not in _SPLASH_INSTANCES:
        raise RuntimeError(f"splash_prefill: no instance has code {code}")
    return _SPLASH_INSTANCES[code]


def splash_instance(dtype: torch.dtype) -> str:
    """The instance a card call in ``dtype`` is expected to run (what
    ``splash_instance_name`` of the reported code should say)."""
    if dtype == torch.bfloat16:
        return "wgmma"
    if dtype == torch.float32:
        return "float32"
    raise TypeError(f"splash_prefill: no instance for {dtype}")


def splash_prefill_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    chunk_offset: int,
) -> torch.Tensor:
    """The model's entry point for the splash slot (JAX :277): the kernel
    on one device.  The JAX package's per-shard branch under a mesh
    comes with ROADMAP A14."""
    return splash_prefill(q, k, v, chunk_offset=chunk_offset)


# ---------------------------------------------------------------------------
# Stock-paged decode (JAX :361-669)
# ---------------------------------------------------------------------------

STOCK_KERNEL = "stock_paged"
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
STOCK_MAX_GROUP = 8      # query heads per KV head the kernel holds
# Slots of a row per block of the split pass: 512 measured fastest of 128,
# 256 and 512 at the serving shape (chip_smoke.py kernel_check's
# split_sweep, through stock_paged_launch), bf16 and float32 pools.
STOCK_SPLIT = 512
STOCK_KERNELS_PER_CALL = 2   # the split pass and the combine pass
_STOCK_HEAD_DIMS = (64, 128)


def _stock_args(q, k_pool, v_pool, layer) -> Tuple[torch.Tensor,
                                                   torch.Tensor, int]:
    """JAX :520-527's refusals, before any launch: a 4-D pool is one
    layer; a 5-D pool of more than one layer needs ``layer``; T must be
    1; an int8 pool belongs to the paged kernel.  Returns the 5-D pools
    and the layer index."""
    if k_pool.dim() == 4:
        k_pool, v_pool, layer = k_pool[None], v_pool[None], None
    if k_pool.shape[0] != 1 and layer is None:
        raise ValueError(
            "multi-layer pool requires the `layer` index (a 5-D pool "
            "with layer=None would attend layer 0 for every layer)"
        )
    if q.dim() != 4 or q.shape[1] != 1:
        raise NotImplementedError(
            "stock-paged decode is T == 1 only; multi-token (speculative "
            "verify) dispatches use the custom paged kernel"
        )
    if k_pool.dtype == torch.int8 or v_pool.dtype == torch.int8:
        raise TypeError("stock-paged decode takes full-precision pools; "
                        "int8 pools use the custom paged kernel")
    layer = 0 if layer is None else int(layer)
    if not 0 <= layer < k_pool.shape[0]:
        raise ValueError(f"layer {layer} outside the pool's "
                         f"{k_pool.shape[0]} layers")
    return k_pool, v_pool, layer


def _merge_new_slot(q, k_new, v_new, out_pool, m, l) -> torch.Tensor:
    """The step's own K/V joins the pool result at the softmax level, with
    JAX :560-579's arithmetic: lse = m + log(l) (-inf for an empty row),
    the new slot's score q.k_new / sqrt(d) from the unscaled q, weights
    relative to their max.  out_pool, m, l: [B, KVH, G, (d)] float32."""
    B, _, H, d = q.shape
    KVH = k_new.shape[2]
    G = H // KVH
    scale = 1.0 / math.sqrt(d)
    lse = torch.where(l > 0.0,
                      m + torch.log(torch.where(l > 0.0, l, 1.0)),
                      float("-inf"))
    q4 = q[:, 0].reshape(B, KVH, G, d).float()
    s_new = torch.einsum("bkgd,bkd->bkg", q4, k_new[:, 0].float()) * scale
    m_tot = torch.maximum(lse, s_new)
    w_pool = torch.exp(lse - m_tot)
    p_new = torch.exp(s_new - m_tot)
    out = (out_pool * w_pool[..., None]
           + p_new[..., None] * v_new[:, 0].float()[:, :, None, :]
           ) / (w_pool + p_new)[..., None]
    return out.reshape(B, 1, H, d).to(q.dtype)


def stock_paged_pool_reference(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    table: torch.Tensor,
    q_pos: torch.Tensor,
    layer: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The pool pass in plain torch: the stock kernel's (out, m, l) per
    (row, KV head, query head of the group).

    q [B, 1, H, d]; k_pool, v_pool [L, KVH, NB, BLK, d].  The query is
    scaled by 1/sqrt(d) and rounded to q's dtype (JAX :528), K and V are
    rounded to bf16 whatever the pool dtype (the stock body's in-kernel
    cast), scores and softmax are float32 and P stays float32.  Row b
    attends the slots j < max(q_pos[b], 0) of its table in table order
    (slot j is offset j % BLK of block table[b, j // BLK]); a sentinel
    entry's slots take MASK_VALUE and zero values and are never read.  A
    row with no slot keeps m = -inf, l = 0, out = 0.  out is normalised,
    float32, rounded once to q's dtype when G % 8 == 0 (JAX :363-371).
    Returns (out [B, KVH, G, d], m [B, KVH, G], l [B, KVH, G])."""
    B, _, H, d = q.shape
    L, KVH, NB, BLK, _ = k_pool.shape
    MB = table.shape[1]
    G = H // KVH
    q3 = (q[:, 0] * (1.0 / math.sqrt(d))).to(q.dtype).float()
    q3 = q3.reshape(B, KVH, G, d)
    blk = table.long().clamp(0, NB - 1)
    real = (table >= 0) & (table < NB)                       # [B, MB]

    def gather(pool):   # -> [B, KVH, MB*BLK, d] float32 of bf16 values
        x = pool[layer][:, blk].to(torch.bfloat16).float()   # [KVH,B,MB,..]
        x = x * real[None, :, :, None, None]
        return x.reshape(KVH, B, MB * BLK, d).transpose(0, 1)

    kg, vg = gather(k_pool), gather(v_pool)
    slots = torch.arange(MB * BLK, device=q.device)
    in_len = slots[None, :] < q_pos.clamp(min=0)[:, None]     # [B, S]
    sentinel = ~real.repeat_interleave(BLK, dim=1)
    s = torch.einsum("bkgd,bksd->bkgs", q3, kg)
    s = torch.where(sentinel[:, None, None], MASK_VALUE, s)
    s = torch.where(in_len[:, None, None], s, float("-inf"))
    m = s.amax(dim=-1)
    live = torch.isfinite(m)
    p = torch.exp(s - torch.where(live, m, 0.0)[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bkgs,bksd->bkgd", p, vg)
    out = torch.where(live[..., None], o / torch.where(l > 0, l, 1.0)[
        ..., None], 0.0)
    if G % 8 == 0:
        out = out.to(q.dtype).float()
    return out, m, l


def stock_paged_decode_reference(
    q: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    table: torch.Tensor,
    q_pos: torch.Tensor,
    layer: Optional[int] = None,
) -> torch.Tensor:
    """The plain version of ``stock_paged_decode``: the pool pass
    (``stock_paged_pool_reference``), then the step's own slot merged at
    the softmax level.  Returns [B, 1, H, d] in q's dtype."""
    k_pool, v_pool, layer = _stock_args(q, k_pool, v_pool, layer)
    out_pool, m, l = stock_paged_pool_reference(q, k_pool, v_pool, table,
                                                q_pos, layer)
    return _merge_new_slot(q, k_new, v_new, out_pool, m, l)


def _stock_check(q, k_new, v_new, k_pool, v_pool, table, q_pos) -> None:
    B, _, H, d = q.shape
    L, KVH, NB, BLK, dp = k_pool.shape
    if v_pool.shape != k_pool.shape or dp != d or KVH == 0 or H % KVH:
        raise ValueError(f"stock_paged_decode: shape mismatch q "
                         f"{tuple(q.shape)}, pools {tuple(k_pool.shape)}")
    if tuple(k_new.shape) != (B, 1, KVH, d) or v_new.shape != k_new.shape:
        raise ValueError(f"stock_paged_decode: k_new, v_new must be "
                         f"{(B, 1, KVH, d)}, got {tuple(k_new.shape)}")
    if table.dim() != 2 or table.shape[0] != B \
            or tuple(q_pos.shape) != (B,):
        raise ValueError(f"stock_paged_decode: table must be [B, MB] and "
                         f"q_pos [B]; got {tuple(table.shape)}, "
                         f"{tuple(q_pos.shape)}")
    if q.dtype not in _DTYPE_CODE or k_pool.dtype not in _DTYPE_CODE \
            or v_pool.dtype != k_pool.dtype or k_new.dtype != q.dtype \
            or v_new.dtype != q.dtype:
        raise TypeError(f"stock_paged_decode: q, k_new, v_new of one and "
                        f"the pools of one of {list(_DTYPE_CODE)}; got "
                        f"{q.dtype}, {k_new.dtype}, {v_new.dtype}, "
                        f"{k_pool.dtype}, {v_pool.dtype}")
    if table.dtype != torch.int32 or q_pos.dtype != torch.int32:
        raise TypeError("stock_paged_decode: table and q_pos must be int32")
    if d not in _STOCK_HEAD_DIMS:
        raise ValueError(f"stock_paged_decode: head_dim {d} not supported "
                         f"(have {_STOCK_HEAD_DIMS})")
    if H // KVH > STOCK_MAX_GROUP:
        raise ValueError(f"stock_paged_decode: {H // KVH} query heads per "
                         f"KV head; the kernel holds 1..{STOCK_MAX_GROUP}")
    _on_card("stock_paged_decode", [
        ("q", q), ("k_new", k_new), ("v_new", v_new), ("k_pool", k_pool),
        ("v_pool", v_pool), ("table", table), ("q_pos", q_pos)])


def stock_paged_decode(
    q: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    table: torch.Tensor,
    q_pos: torch.Tensor,
    layer: Optional[int] = None,
) -> torch.Tensor:
    """One T = 1 decode step over (pool blocks + the step's own slot),
    the stock-paged slot (JAX :473).

    q [B, 1, H, d] holds the step's queries, k_new/v_new [B, 1, KVH, d]
    its projections; k_pool, v_pool [L, KVH, NB, BLK, d] (or one layer,
    [KVH, NB, BLK, d]) in bf16 or float32; table [B, MB] int32 block ids
    (NB or any id outside [0, NB): unused); q_pos [B] int32, the step's
    position (-1: an inactive row).  Row b attends the first
    max(q_pos[b], 0) slots of its table (the pool's fill; slot index ==
    position on the insert path), then the step's own slot, merged at the
    softmax level.  The pool is only read.  Returns [B, 1, H, d] in q's
    dtype; an inactive row's output is finite and meant to be ignored.

    A CPU tensor runs ``stock_paged_decode_reference``; a CUDA tensor
    launches ``csrc/stock_paged.cu`` (its split pass and its combine
    pass: ``STOCK_KERNELS_PER_CALL`` launches, each counted) or raises.
    T != 1, an int8 pool and a multi-layer pool without ``layer`` raise
    before any launch."""
    k_pool, v_pool, layer = _stock_args(q, k_pool, v_pool, layer)
    if q.device.type == "cpu":
        return stock_paged_decode_reference(q, k_new, v_new, k_pool, v_pool,
                                            table, q_pos, layer)
    if q.device.type != "cuda":
        raise ValueError(f"stock_paged_decode: unsupported device "
                         f"{q.device}")
    return stock_paged_launch(q, k_new, v_new, k_pool, v_pool, table, q_pos,
                              layer, STOCK_SPLIT)


def stock_paged_launch(
    q: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    table: torch.Tensor,
    q_pos: torch.Tensor,
    layer: int,
    split: int,
) -> torch.Tensor:
    """``stock_paged_decode``'s card launch with ``split`` slots of a row
    per block of the split pass (a multiple of 16, at most 512; the
    wrapper passes ``STOCK_SPLIT``, and the card tests and
    ``chip_smoke.py`` other sizes): the wrapper's checks, then the split
    and the combine pass, counted on ``stock_paged_decode``.  It has no
    plain version: tensors off the card raise."""
    if split <= 0 or split % 16 or split > 512:
        raise ValueError(f"stock_paged_decode: split {split} is not a "
                         f"multiple of 16 in 16..512")
    if q.device.type != "cuda":
        raise ValueError(f"stock_paged_launch: needs CUDA tensors, got "
                         f"{q.device}")
    k_pool, v_pool, layer = _stock_args(q, k_pool, v_pool, layer)
    _stock_check(q, k_new, v_new, k_pool, v_pool, table, q_pos)
    B, _, H, d = q.shape
    L, KVH, NB, BLK, _ = k_pool.shape
    MB = table.shape[1]
    G = H // KVH
    n_split = -(-(MB * BLK) // split)
    o_ptr, m_ptr, l_ptr, _scratch = stock_scratch(B, KVH, n_split, G, d,
                                                  q.device)
    out = torch.empty_like(q)
    fn = _lib_fn(STOCK_KERNEL, "stock_paged_decode",
                 [ctypes.c_void_p] * 11 + [ctypes.c_int] * 12
                 + [ctypes.c_float, ctypes.c_void_p,
                    ctypes.POINTER(ctypes.c_int)])
    rc, code = _launch(q.device, fn, q.data_ptr(), k_new.data_ptr(),
                       v_new.data_ptr(), k_pool.data_ptr(),
                       v_pool.data_ptr(), table.data_ptr(), q_pos.data_ptr(),
                       o_ptr, m_ptr, l_ptr, out.data_ptr(), B, KVH, G, d, NB,
                       BLK, MB, layer, _DTYPE_CODE[q.dtype],
                       _DTYPE_CODE[k_pool.dtype], split, n_split,
                       1.0 / math.sqrt(d))
    if rc != 0:
        raise RuntimeError(f"stock_paged_decode launch failed: cudaError_t "
                           f"{rc}")
    _count(stock_paged_decode, stock_instance_name(code),
           STOCK_KERNELS_PER_CALL)
    return out


# Launches of the CUDA kernels in this process, the split and the combine
# pass each counted (the plain version never counts), and wrapper calls
# by the split pass's instance as the C entry point reports it
# (``stock_instance_name``); callers reset them by assigning 0 and {}.
stock_paged_decode.launches = 0
stock_paged_decode.launches_by_instance = {}


def _stock_name(q_f32: bool, pool_f32: bool) -> str:
    return (f"mma_sync_q_{'f32x3' if q_f32 else 'bf16'}"
            f"_pool_{'f32' if pool_f32 else 'bf16'}")


def stock_instance_name(code: int) -> str:
    """The split-pass instance ``csrc/stock_paged.cu``'s entry point
    reports it launched, code 1 + 2*(float32 q) + (float32 pool).  Every
    instance puts q.k and P.v on the tensor cores (``mma.sync``); a
    float32 q enters them as three bf16 terms ("f32x3"), a bf16 q as one;
    a float32 pool's K/V are rounded to bf16 as they are read."""
    if not 1 <= code <= 4:
        raise RuntimeError(f"stock_paged_decode: no instance has code "
                           f"{code}")
    return _stock_name(bool((code - 1) & 2), bool((code - 1) & 1))


def stock_instance(q_dtype: torch.dtype, pool_dtype: torch.dtype) -> str:
    """The split-pass instance a card call with these dtypes is expected
    to run (what ``stock_instance_name`` of the reported code should
    say)."""
    if q_dtype not in _DTYPE_CODE or pool_dtype not in _DTYPE_CODE:
        raise TypeError(f"stock_paged_decode: no instance for q {q_dtype}, "
                        f"pool {pool_dtype}")
    return _stock_name(q_dtype == torch.float32, pool_dtype == torch.float32)


def stock_scratch(B: int, KVH: int, n_split: int, G: int, d: int,
                  device) -> Tuple[int, int, int, torch.Tensor]:
    """The split pass's float32 partials as three pieces of one
    allocation: o_part [B, KVH, n_split, G, d], then m_part and l_part
    [B, KVH, n_split, G].  Returns their addresses and the allocation
    (which the caller keeps alive until the launches are enqueued)."""
    n = B * KVH * n_split * G
    scratch = torch.empty(n * (d + 2), dtype=torch.float32, device=device)
    o_ptr = scratch.data_ptr()
    m_ptr = o_ptr + n * d * 4
    return o_ptr, m_ptr, m_ptr + n * 4, scratch


def stock_paged_decode_attention(
    q: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    table: torch.Tensor,
    q_pos: torch.Tensor,
    layer: Optional[int] = None,
) -> torch.Tensor:
    """The model's entry point for the stock-paged slot (JAX :592), the
    drop-in twin of ``paged_decode_attention`` at T == 1 over a
    full-precision pool: the kernel on one device.  The JAX package's
    per-shard branch under a mesh comes with ROADMAP A14."""
    return stock_paged_decode(q, k_new, v_new, k_pool, v_pool, table, q_pos,
                              layer)
