"""The port's program layer (``jax_llama_tpu_torch/utils/programs.py``) on
the CPU: keys as ``jax.jit`` keys its cache (static arguments by value,
tensors by shape, dtype and device; an undeclared Python scalar raises),
donated arguments updated in place and returned as the same tensors, a
program called inside another running inline, and the batcher's
``jit_cache_entries()`` counting every registered program's keys, held
against the JAX batcher's jit cache on the same traffic, both counted
from empty caches (``jax.clear_caches()`` and the port's
``programs.clear_caches()``), so that what ran before in the process
does not count.  On the CPU a
program runs eagerly; its CUDA graphs are held on the card in
tests/test_torch_programs_cuda.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax_llama_tpu as jlt
from jax_llama_tpu import serving as jserving

import jax_llama_tpu_torch as ptl
from jax_llama_tpu_torch import serving
from jax_llama_tpu_torch.utils import programs
from jax_llama_tpu_torch.utils.programs import Program


def _prog(fn, **kw):
    """A program outside the registry (the registry holds the port's)."""
    return Program(fn, kw.pop("name", fn.__name__), kw.pop("static", ()),
                   kw.pop("donate", ()), kw.pop("returns", ()),
                   kw.pop("graph", False))


@dataclasses.dataclass
class _Pair:
    a: torch.Tensor
    b: torch.Tensor


def test_static_arguments_key_by_value_tensors_by_shape_and_dtype():
    p = _prog(lambda x, *, n: x[:n], name="slice", static=("n",))
    x = torch.zeros(4)
    assert p.key(x, n=2) == p.key(torch.ones(4), n=2)     # values: no
    assert p.key(x, n=2) != p.key(x, n=3)                 # static: yes
    assert p.key(x, n=2) != p.key(torch.zeros(5), n=2)    # shape
    assert p.key(x, n=2) != p.key(x.double(), n=2)        # dtype
    pair = _prog(lambda pr, gens: pr.a + pr.b, name="pair")
    g = torch.Generator()
    k = pair.key(_Pair(x, x), [g, None])
    # A generator slot is keyed by its place, set or not (JAX's keys rows).
    assert k == pair.key(_Pair(x, x), [None, g])
    assert k != pair.key(_Pair(x, torch.zeros(3)), [g, None])


@pytest.mark.parametrize("value", [3, 2.5, True, "x"])
def test_undeclared_host_scalar_raises(value):
    p = _prog(lambda x, m: x, name="scalar")
    with pytest.raises(TypeError, match="not static"):
        p(torch.zeros(2), value)
    with pytest.raises(TypeError, match="not static"):
        p(torch.zeros(2), [torch.zeros(1), value])   # nested too


def test_cache_size_counts_keys():
    p = _prog(lambda x, *, n: x * n, name="count", static=("n",))
    for shape, n in [(2, 1), (2, 1), (3, 1), (2, 2), (3, 1)]:
        p(torch.zeros(shape), n=n)
    assert p.cache_size() == 3


def test_donated_arguments_are_updated_in_place_and_returned():
    def fn(x, y, pool):
        pool[0] += 1.0                     # written in place
        return x + 1.0, y * 2.0            # x's new value, a live output

    p = _prog(fn, name="donate", donate=("x", "pool"),
              returns=("x", "y2"))
    x, y, pool = torch.zeros(3), torch.ones(3), torch.zeros(2, 2)
    x_out, y2 = p(x, y, pool)
    assert x_out is x and torch.equal(x, torch.ones(3))
    assert x_out.untyped_storage().data_ptr() == x.untyped_storage(
        ).data_ptr()
    assert y2 is not y and torch.equal(y, torch.ones(3))
    assert torch.equal(pool[0], torch.ones(2))


def test_a_program_inside_another_runs_inline():
    inner = _prog(lambda x, *, n: x + n, name="inner", static=("n",))
    outer = _prog(lambda x, *, n: inner(x, n=n) * 2, name="outer",
                  static=("n",))
    assert torch.equal(outer(torch.ones(2), n=1), torch.full((2,), 4.0))
    assert outer.cache_size() == 1 and inner.cache_size() == 0
    inner(torch.ones(2), n=1)
    assert inner.cache_size() == 1


def test_registry_names_are_jaxs_programs():
    """JAX's serving programs, its two jitted kernel wrappers, its
    ``engine.generate`` and ``score``, and the body of ``generate``'s
    decode loop (``_generate_step``, which the port dispatches from the
    host); every program but the kernel wrappers is captured as a CUDA
    graph on the card."""
    reg = programs.registry()
    assert set(reg) == set(jserving._programs()) | {
        "splash_prefill", "stock_paged_decode", "generate", "score",
        "_generate_step"}
    assert {n for n, p in reg.items() if not p.graph} == {
        "splash_prefill", "stock_paged_decode"}
    for name, prog in reg.items():
        assert set(prog.donate) <= set(prog.returns) | {
            "pool", "t_pool", "d_pool", "generators", "state", "pos",
            "cache", "buf", "next_tok", "done"}, name


def test_clear_caches_forgets_every_programs_keys():
    p = _prog(lambda x: x + 1, name="cleared")
    p(torch.zeros(2))
    p(torch.zeros(3))
    assert p.cache_size() == 2
    programs.clear_caches()
    assert p.cache_size() == 0
    p(torch.zeros(2))
    assert p.cache_size() == 1


def _tiny():
    cfg = jlt.get_config("tiny", vocab_size=128, dim=64, n_layers=2,
                         n_heads=4, n_kv_heads=2, multiple_of=16,
                         max_seq_len=64)
    import jax

    jparams = jlt.init_params(jax.random.PRNGKey(0), cfg)
    pparams = ptl.from_jax_params(jax.tree.map(np.asarray, jparams),
                                  device="cpu")
    pcfg = ptl.get_config("tiny", vocab_size=128, dim=64, n_layers=2,
                          n_heads=4, n_kv_heads=2, multiple_of=16,
                          max_seq_len=64, dtype="float32",
                          param_dtype="float32")
    return cfg, jparams, pcfg, pparams


def _count_like_jax(cfg, jparams, pcfg, pparams):
    """The same traffic through both packages' batchers, each counted
    from empty caches; returns {package: {program: keys added}}."""
    import jax

    rng = np.random.RandomState(0)
    prompts = [list(rng.randint(1, 128, n)) for n in (5, 20, 37, 9)]
    counts = {}
    for name, entries, make in (
        ("jax", jserving.jit_cache_entries, lambda: jserving.ContinuousBatcher(
            jparams, cfg, n_slots=2, max_len=64, block_size=16,
            decode_chunk=4, prefix_cache=False)),
        ("port", serving.jit_cache_entries,
         lambda: serving.ContinuousBatcher(
             pparams, pcfg, n_slots=2, max_len=64, block_size=16,
             decode_chunk=4, prefix_cache=False, device="cpu")),
    ):
        jax.clear_caches()
        programs.clear_caches()
        before = entries()
        cb = make()
        for p in prompts:
            cb.submit(p, max_new_tokens=6)
        cb.run_to_completion()
        after = entries()
        counts[name] = {k: after[k] - before.get(k, 0) for k in after}
    return counts


def _assert_counts_like_jax(counts):
    from jax_llama_tpu_torch.analysis.contracts import REGISTRY

    assert set(jserving.jit_cache_entries()) <= set(counts["port"])
    for prog in ("_paged_decode_chunk", "_paged_insert", "_scatter_rows"):
        assert counts["port"][prog] == counts["jax"][prog], prog
    assert all(counts["port"][n] <= c.max_cache_keys
               for n, c in REGISTRY.items())


def test_jit_cache_entries_count_every_program_like_jax():
    """The same traffic through both packages' batchers: every registered
    program appears, the decode chunk's and the insert's keys grow as
    JAX's jit cache entries do (n_iter buckets, the insert's row and
    width buckets), and each stays within its contract.  Both counts
    start from empty caches, whatever ran before in the process."""
    _assert_counts_like_jax(_count_like_jax(*_tiny()))


def test_jit_cache_entries_count_like_jax_after_a_port_batcher():
    """The comparison above, after a port batcher of the same shapes has
    already run its programs in this process (as an earlier test module
    does in a shared worker): its keys are forgotten, so the counts are
    still JAX's."""
    cfg, jparams, pcfg, pparams = _tiny()
    cb = serving.ContinuousBatcher(pparams, pcfg, n_slots=2, max_len=64,
                                   block_size=16, decode_chunk=4,
                                   prefix_cache=False, device="cpu")
    rng = np.random.RandomState(0)
    for n in (5, 20, 37, 9):
        cb.submit(list(rng.randint(1, 128, n)), max_new_tokens=6)
    cb.run_to_completion()
    assert serving.jit_cache_entries()["_scatter_rows"] > 0
    _assert_counts_like_jax(_count_like_jax(cfg, jparams, pcfg, pparams))
