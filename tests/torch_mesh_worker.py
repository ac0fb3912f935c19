"""Ranks for the port's mesh tests: a pool of CPU processes joined by a
gloo process group, each running the port (never jax) on its own shard.

``MeshPool(world)`` spawns ``world`` ranks once; ``pool.run(case,
**kwargs)`` runs the function ``case`` of this module on every rank with
the same keyword arguments (numpy arrays and plain values) and returns
the ranks' results in rank order, raising with a rank's traceback if one
failed.  A case builds its mesh with ``_mesh(axes)``.  This module imports
no jax and no test module, so that the spawned ranks do not either; each
rank checks that at start.
"""

from __future__ import annotations

import os
import socket
import sys
import traceback
from typing import Any, Dict, List

import numpy as np

_STATE: Dict[str, Any] = {}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class MeshPool:
    """``world`` spawned ranks on one gloo process group (CPU)."""

    def __init__(self, world: int, timeout_s: float = 600.0):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.world = world
        self.timeout_s = timeout_s
        self._cmd = [ctx.Queue() for _ in range(world)]
        self._res = ctx.Queue()
        port = free_port()
        self._procs = [
            ctx.Process(target=_worker, daemon=True,
                        args=(r, world, port, self._cmd[r], self._res))
            for r in range(world)]
        for p in self._procs:
            p.start()
        self.run("_ready")

    def run(self, case: str, **kwargs) -> List[Any]:
        import queue
        import time

        for q in self._cmd:
            q.put((case, kwargs))
        out: List[Any] = [None] * self.world
        errors: List[str] = []
        deadline = time.monotonic() + self.timeout_s
        got = 0
        while got < self.world:
            try:
                rank, ok, value = self._res.get(timeout=2)
            except queue.Empty:
                dead = [p.exitcode for p in self._procs if not p.is_alive()]
                if dead or time.monotonic() > deadline:
                    raise AssertionError(
                        f"{case}: ranks exited {dead} or timed out; "
                        f"errors so far: {errors}")
                continue
            got += 1
            if ok:
                out[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
                # The other ranks may wait in a collective this one left.
                deadline = min(deadline, time.monotonic() + 20)
        if errors:
            raise AssertionError("\n".join(errors))
        return out

    def close(self) -> None:
        for q in self._cmd:
            q.put(None)
        for p in self._procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)


def _worker(rank: int, world: int, port: int, cmd, res) -> None:
    import torch

    torch.set_num_threads(1)
    from jax_llama_tpu_torch.parallel import distributed

    distributed.initialize(f"localhost:{port}", world, rank, backend="gloo")
    try:
        while True:
            item = cmd.get()
            if item is None:
                break
            case, kwargs = item
            try:
                res.put((rank, True, globals()[case](**kwargs)))
            except BaseException:
                res.put((rank, False, traceback.format_exc()))
    finally:
        distributed.shutdown()


# ---------------------------------------------------------------------------
# Helpers run on the ranks
# ---------------------------------------------------------------------------

def _ready() -> Dict[str, Any]:
    from jax_llama_tpu_torch.parallel import distributed

    assert "jax" not in sys.modules, "a rank imported jax"
    return dict(jax_loaded="jax" in sys.modules,
                jax_package_loaded=any(m.startswith("jax_llama_tpu.")
                                       or m == "jax_llama_tpu"
                                       for m in sys.modules),
                rank=distributed.process_index(),
                world=distributed.process_count(), pid=os.getpid())


def _mesh(axes: Dict[str, int], device: str = "cpu"):
    """This rank's mesh of ``axes``, every rank on ``device`` (cached:
    groups are made once per geometry, by every rank in the same
    order)."""
    from jax_llama_tpu_torch.parallel import make_mesh

    key = (tuple(sorted(axes.items())), device)
    if key not in _STATE:
        n = int(np.prod(list(axes.values()) or [1]))
        _STATE[key] = make_mesh(**axes, devices=[device] * n)
    return _STATE[key]


def _model(cfg: Dict[str, Any], tree):
    import jax_llama_tpu_torch as ptl

    config = ptl.get_config("tiny", **cfg)
    return ptl.from_jax_params(tree, device="cpu"), config


def _sharded(params, config, mesh):
    from jax_llama_tpu_torch.parallel import shard_params

    return shard_params(params, mesh, config)


def forward(cfg, tree, axes, tokens, positions, **fw) -> Dict[str, Any]:
    """Sharded (``fsdp=True``: the ZeRO-3 layout) and unsharded
    ``forward`` logits (and the aux outputs a flag asks for) of the same
    inputs; the local qkv shape."""
    import torch

    import jax_llama_tpu_torch as ptl
    from jax_llama_tpu_torch.parallel import use_mesh

    from jax_llama_tpu_torch.parallel import shard_params

    params, config = _model(cfg, tree)
    config = config.replace(**fw.pop("config", {}))
    mesh = _mesh(axes)
    sp = shard_params(params, mesh, config, fsdp=fw.pop("fsdp", False))
    t = torch.from_numpy(tokens)
    pos = torch.from_numpy(positions)
    with torch.inference_mode():
        want = ptl.forward(params, t, pos, config, **fw)
        mesh.collectives.clear()
        with use_mesh(mesh):
            got = ptl.forward(sp, t, pos, config, **fw)
    out = dict(logits=got[0].numpy(), unsharded=want[0].numpy(),
               qkv_shape=tuple(sp["layers"]["qkv"].shape),
               collectives={"/".join((k[0],) + k[1]): v
                            for k, v in mesh.collectives.items()})
    if len(got) == 3:
        aux, waux = got[2], want[2]
        for name in ("last_hidden_state", "hidden_states", "attentions"):
            a, w = getattr(aux, name), getattr(waux, name)
            if a is not None:
                out[name] = a.numpy()
                out[name + "_unsharded"] = w.numpy()
    return out


def cached_forward(cfg, tree, axes, tokens, positions, chunk) -> Dict:
    """A prefill in chunks through a KV cache, then one decode step: the
    sharded run's logits and its cache's local shape."""
    import torch

    import jax_llama_tpu_torch as ptl
    from jax_llama_tpu_torch.parallel import use_mesh

    params, config = _model(cfg, tree)
    mesh = _mesh(axes)
    sp = _sharded(params, config, mesh)
    t = torch.from_numpy(tokens)
    pos = torch.from_numpy(positions)
    B, T = t.shape

    def run(p, m):
        with torch.inference_mode(), use_mesh(m):
            cache = ptl.init_cache(config, B, max_len=T + 4, device="cpu")
            outs = []
            for s in range(0, T, chunk):
                lg, cache = ptl.forward(p, t[:, s:s + chunk],
                                        pos[:, s:s + chunk], config,
                                        cache=cache)
                outs.append(lg)
            nxt = outs[-1][:, -1].argmax(-1)
            lg, cache = ptl.forward(p, nxt[:, None].int(),
                                    pos[:, -1:] + 1, config, cache=cache)
            outs.append(lg)
            return torch.cat(outs, 1).numpy(), tuple(cache.k.shape)

    got, shape = run(sp, mesh)
    want, _ = run(params, None)
    return dict(logits=got, unsharded=want, cache_shape=shape)


def generate(cfg, tree, axes, prompt, mask, max_new, spec=False,
             n_draft=2) -> Dict[str, Any]:
    """Greedy ``engine.generate`` (or ``generate_speculative`` with the
    target as its own draft) with and without the mesh, and through
    ``LLaMA(mesh=)``."""
    import torch

    import jax_llama_tpu_torch as ptl
    from jax_llama_tpu_torch.engine import GenerationConfig, generate as gen

    params, config = _model(cfg, tree)
    mesh = _mesh(axes)
    sp = _sharded(params, config, mesh)
    gc = GenerationConfig(max_new_tokens=max_new, temperature=0.0)
    t = torch.from_numpy(prompt)
    m = torch.from_numpy(mask)
    if spec:
        def run(p, mm):
            return ptl.generate_speculative(
                p, p, t, m, target_config=config, draft_config=config,
                gen_config=gc, n_draft=n_draft, device="cpu", mesh=mm)[0]
    else:
        def run(p, mm):
            return gen(p, t, m, config=config, gen_config=gc, device="cpu",
                       mesh=mm)
    got, want = run(sp, mesh).numpy(), run(params, None).numpy()
    llm = ptl.LLaMA(sp, config, ptl.ByteTokenizer(), device="cpu",
                    mesh=mesh)
    via_llama = llm.generate(prompt, mask, max_new, temperature=0.0)
    score = ptl.score(sp, t, m, config=config, mesh=mesh).numpy()
    return dict(tokens=got, unsharded=want, via_llama=via_llama,
                score=score,
                score_unsharded=ptl.score(params, t, m,
                                          config=config).numpy())


def ambient_mesh_refused(axes) -> str:
    """``generate`` under an ambient ``use_mesh`` without ``mesh=``."""
    import torch

    from jax_llama_tpu_torch import get_config, init_params
    from jax_llama_tpu_torch.engine import GenerationConfig, generate as gen
    from jax_llama_tpu_torch.parallel import use_mesh

    config = get_config("tiny", vocab_size=64, dim=32, n_layers=1,
                        n_heads=4, n_kv_heads=2, multiple_of=32,
                        max_seq_len=32, dtype="float32",
                        param_dtype="float32")
    mesh = _mesh(axes)
    params = init_params(config, seed=0, device="cpu", mesh=mesh)
    t = torch.ones((2, 3), dtype=torch.int32)
    try:
        with use_mesh(mesh):
            gen(params, t, t > 0, config=config,
                gen_config=GenerationConfig(max_new_tokens=2,
                                            temperature=0.0), device="cpu")
    except ValueError as e:
        return str(e)
    return ""


def init_params_shard(cfg, axes, seed) -> bool:
    """``init_params(mesh=)`` equals ``shard_params`` of the tree drawn
    without a mesh, leaf for leaf."""
    import torch

    import jax_llama_tpu_torch as ptl

    config = ptl.get_config("tiny", **cfg)
    mesh = _mesh(axes)
    full = ptl.init_params(config, seed=seed, device="cpu")
    a = _sharded(full, config, mesh)
    b = ptl.init_params(config, seed=seed, device="cpu", mesh=mesh)

    def leaves(t):
        return ([x for v in t.values() for x in leaves(v)]
                if isinstance(t, dict) else [t])

    return all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))


def load_checkpoint_shard(cfg, tree, axes, path) -> Dict[str, Any]:
    """Rank 0 saves the full tree; every rank loads its shard from the
    file and checks it against ``shard_params``; saving a tensor-parallel
    shard without its mesh is refused, and under it gathers."""
    import torch

    from jax_llama_tpu_torch.convert import load_checkpoint, save_checkpoint

    params, config = _model(cfg, tree)
    mesh = _mesh(axes)
    if mesh.rank == 0:
        save_checkpoint(path, params, config)
    mesh.barrier()
    got, _ = load_checkpoint(path, mesh=mesh)
    want = _sharded(params, config, mesh)

    def leaves(t):
        return ([x for v in t.values() for x in leaves(v)]
                if isinstance(t, dict) else [t])

    same = all(torch.equal(x, y) for x, y in zip(leaves(got), leaves(want)))
    try:
        save_checkpoint(path + "_again", got, config)
        refused = ""
    except ValueError as e:
        refused = str(e)
    mesh.barrier()
    # Saving from the mesh gathers the shards: rank 0 writes the files,
    # and so the manifest, of the unsharded save.
    from jax_llama_tpu_torch.parallel import use_mesh

    with use_mesh(mesh):
        save_checkpoint(path + "_mesh", got, config)
    import json

    manifests = [json.load(open(f"{p}/manifest.json"))
                 for p in (path, path + "_mesh")]
    return dict(same=same, refused=refused,
                manifest_same=manifests[0] == manifests[1],
                qkv=tuple(got["layers"]["qkv"].shape))


def serve(cfg, tree, axes, scenario, **cb_kw) -> Dict[str, Any]:
    """A serving scenario (``SCENARIOS``) on this rank's shard under the
    mesh (``axes``; {} for the unsharded batcher), with the host state a
    rank must share: block tables, the free list, the radix digest."""
    params, config = _model(cfg, tree)
    mesh = _mesh(axes) if axes else None
    p = _sharded(params, config, mesh) if mesh is not None else params
    spec = cb_kw.pop("self_draft", False)
    if spec:
        cb_kw.update(draft_params=p, draft_config=config)
    return SCENARIOS[scenario](p, config, mesh, **cb_kw)


def _batcher(params, config, mesh, **kw):
    from jax_llama_tpu_torch.serving import ContinuousBatcher

    return ContinuousBatcher(params, config, mesh=mesh, device="cpu", **kw)


def _host_state(cb) -> Dict[str, Any]:
    # The digest's epoch is a per-store random token; the rest (the
    # chains' hash, node and block counts, versions) must agree.
    digest = (cb.kv_digest.summary() if cb.kv_digest is not None
              else {})
    digest.pop("epoch", None)
    return dict(table=cb.table.tolist(), free=sorted(cb.free_blocks),
                digest=digest, stats={k: v for k, v in cb.stats().items()
                                      if not k.endswith("_ms")
                                      and "ms_" not in k},
                pool_k=tuple(cb.pool.k.shape),
                placed=bool(getattr(cb, "_mesh_placed", False)),
                describe_mesh=cb.describe()["serve_mesh"])


def _drain(cb, rids, logprobs, steps=None):
    toks: Dict[int, List[int]] = {}
    lps: Dict[int, List[float]] = {}
    n = 0
    while cb.pending() and (steps is None or n < steps):
        n += 1
        assert n < 500
        for ev in cb.step():
            toks.setdefault(ev[0], []).append(ev[1])
            if logprobs:
                lps.setdefault(ev[0], []).append(ev[3])
    return toks, lps


def _scenario_chunks(params, config, mesh, prefill_budget=0,
                     logprobs=False, fused_admission=False, **kw):
    """The JAX ``test_serve_mesh._serve`` mix: a greedy request stopping
    mid-chunk and a seeded sampled one, 2 slots, decode_chunk 2, then a
    40-token prompt admitted mid-decode (the fused lane at a prefill
    budget, a classic insert without)."""
    rng = np.random.RandomState(7)
    prompts = [rng.randint(1, 128, size=n).tolist() for n in (5, 9)]
    policies = [dict(max_new_tokens=4),
                dict(max_new_tokens=6, temperature=0.9, seed=11)]
    cb = _batcher(params, config, mesh, n_slots=2, max_len=128,
                  decode_chunk=2, prefill_budget=prefill_budget,
                  logprobs=logprobs, **kw)
    rids = [cb.submit(p, **pol) for p, pol in zip(prompts, policies)]
    toks, lps = _drain(cb, rids, logprobs, steps=2)
    if fused_admission:
        long = rng.randint(1, 128, size=40).tolist()
        rids.append(cb.submit(long, max_new_tokens=3, seed=99))
    more_t, more_l = _drain(cb, rids, logprobs)
    for r, t in more_t.items():
        toks.setdefault(r, []).extend(t)
    for r, lp in more_l.items():
        lps.setdefault(r, []).extend(lp)
    return dict(tokens=[toks[r] for r in rids],
                logprobs=[lps.get(r) for r in rids],
                fused=cb.fused_admissions_total,
                prefill_chunks=cb.prefill_chunks_total,
                decode_dispatches=cb.decode_dispatches_total,
                **_host_state(cb))


def _scenario_spec(params, config, mesh, **kw):
    """The JAX ``test_sharded_spec_chunk_parity`` mix: 4 slots, 2 spec
    rounds a step, n_draft 2, a greedy and a sampled request."""
    cb = _batcher(params, config, mesh, n_slots=4, max_len=128,
                  decode_chunk=1, spec_rounds=2, n_draft=2, **kw)
    rids = [cb.submit([5, 17, 99, 3, 42], max_new_tokens=6),
            cb.submit([7, 8, 9], max_new_tokens=5, temperature=0.8,
                      seed=13)]
    toks, _ = _drain(cb, rids, False)
    return dict(tokens=[toks[r] for r in rids],
                acceptance=cb.acceptance_rate(), **_host_state(cb))


def _scenario_host_tier(params, config, mesh, **kw):
    """The JAX ``test_sharded_host_tier_restore_on_mesh`` drill: serve,
    demote the chain into the host tier, serve the same prompt again
    (the swap-in restores through the staging planes)."""
    prompt = np.random.RandomState(5).randint(1, 128, 50).tolist()
    cb = _batcher(params, config, mesh, n_slots=4, max_len=128,
                  block_size=16, decode_chunk=4, host_kv_blocks=16, **kw)

    def once():
        r = cb.submit(prompt, max_new_tokens=5, seed=7)
        return _drain(cb, [r], False)[0][r]

    first = once()
    demoted = cb.demote_idle(8)
    host = cb._store.host_blocks()
    second = once()
    return dict(tokens=[first, second], demoted=demoted, host=host,
                swap_in_blocks=cb.swap_in_blocks_total, **_host_state(cb))


def _scenario_prefix(params, config, mesh, **kw):
    """Two prompts admitted together (one insert of 2 rows: under data = 2
    each data rank computes one row), then a prompt that extends the
    second: a prefix hit on blocks the other data rank computed."""
    rng = np.random.RandomState(3)
    a = rng.randint(1, 128, 40).tolist()
    b = rng.randint(1, 128, 40).tolist()
    cb = _batcher(params, config, mesh, n_slots=2, max_len=128,
                  block_size=16, decode_chunk=2, **kw)
    first = [cb.submit(a, max_new_tokens=4), cb.submit(b, max_new_tokens=4)]
    toks, _ = _drain(cb, first, False)
    r = cb.submit(b[:32] + rng.randint(1, 128, 9).tolist(), max_new_tokens=5)
    more, _ = _drain(cb, [r], False)
    toks.update(more)
    return dict(tokens=[toks[x] for x in first + [r]],
                hits=cb.prefix_requests_hit,
                reused=cb.prefix_blocks_reused, **_host_state(cb))


def _scenario_placement(params, config, mesh, **kw):
    """Pool and state shapes before and after dispatches (the port's
    placement: the pool's local head slice, replicated state rows)."""
    cb = _batcher(params, config, mesh, n_slots=2, max_len=128,
                  decode_chunk=2, **kw)

    def shapes():
        return dict(k=(tuple(cb.pool.k.shape), str(cb.pool.k.device)),
                    pos=tuple(cb.pool.pos.shape),
                    fill=tuple(cb.d_fill.shape),
                    table=tuple(cb.d_table.shape), tau=tuple(cb.tau.shape))

    cb.submit([5, 17, 99, 3, 42], max_new_tokens=6)
    cb.step()
    first = shapes()
    while cb.pending():
        cb.step()
    return dict(first=first, after=shapes(), **_host_state(cb))


SCENARIOS = {
    "chunks": _scenario_chunks,
    "spec": _scenario_spec,
    "host_tier": _scenario_host_tier,
    "prefix": _scenario_prefix,
    "placement": _scenario_placement,
}


def forward_on_card(cfg, axes, seed, B, T) -> Dict[str, Any]:
    """Every rank on cuda:0 (gloo): the seed's tree drawn as this rank's
    shard and whole, then the same prompts through the sharded and the
    unsharded forward (flash prefill) and greedy generate, with the flash
    kernel's launches of the sharded run."""
    import importlib

    import torch

    import jax_llama_tpu_torch as ptl
    from jax_llama_tpu_torch.engine import GenerationConfig, generate as gen
    from jax_llama_tpu_torch.parallel import use_mesh

    torch.cuda.set_device(0)
    fa = importlib.import_module("jax_llama_tpu_torch.ops.flash_attention")
    config = ptl.get_config("tiny", **cfg)
    mesh = _mesh(axes, "cuda:0")
    full = ptl.init_params(config, seed=seed, device="cuda")
    sp = ptl.init_params(config, seed=seed, device="cuda", mesh=mesh)
    rng = np.random.RandomState(seed)
    t = torch.from_numpy(rng.randint(0, config.vocab_size, (B, T))).cuda()
    pos = torch.arange(T, device="cuda", dtype=torch.int32)[None].repeat(
        B, 1)
    with torch.inference_mode():
        want = ptl.forward(full, t, pos, config)[0].float()
        fa.flash_attention.launches = 0
        with use_mesh(mesh):
            got = ptl.forward(sp, t, pos, config)[0].float()
        launches = fa.flash_attention.launches
    gc = GenerationConfig(max_new_tokens=8, temperature=0.0)
    mask = torch.ones_like(t, dtype=torch.bool)
    return dict(
        rel=((got - want).abs().max() / want.abs().max()).item(),
        launches=launches, kvh=int(sp["layers"]["qkv"].shape[1]),
        tokens=gen(sp, t, mask, config=config, gen_config=gc,
                   device="cuda", mesh=mesh).cpu().numpy(),
        unsharded=gen(full, t, mask, config=config, gen_config=gc,
                      device="cuda").cpu().numpy())


def run_cli(argv, stdin="") -> str:
    """``python -m jax_llama_tpu_torch.run *argv`` on this rank, as
    torchrun would start it (``WORLD_SIZE`` set; the process group is
    this pool's): what the rank printed to stdout."""
    import contextlib
    import io

    from jax_llama_tpu_torch import run as prun
    from jax_llama_tpu_torch.parallel import distributed

    saved = sys.argv, sys.stdin, os.environ.get("WORLD_SIZE")
    out = io.StringIO()
    os.environ["WORLD_SIZE"] = str(distributed.process_count())
    sys.argv, sys.stdin = ["run", *argv], io.StringIO(stdin)
    try:
        with contextlib.redirect_stdout(out):
            prun.main()
    finally:
        sys.argv, sys.stdin = saved[:2]
        os.environ.pop("WORLD_SIZE")
        if saved[2] is not None:
            os.environ["WORLD_SIZE"] = saved[2]
    return out.getvalue()


def serve_mesh_checks(cfg, axes) -> Dict[str, Any]:
    """``build_serve_mesh`` over the pool's ranks and the refusals a
    batcher gives a mesh it cannot serve."""
    import jax_llama_tpu_torch as ptl
    from jax_llama_tpu_torch.parallel import serve_mesh as smesh

    config = ptl.get_config("tiny", **cfg)
    spec = smesh.ServeMeshSpec(axes.get("data", 1), axes.get("tensor", 1))
    mesh = smesh.build_serve_mesh(spec, devices=["cpu"] * spec.n_devices)
    out = dict(shape=smesh.mesh_shape(mesh),
               placement_ok=smesh.placement_ok(config, mesh, 4))
    params = ptl.init_params(config, seed=0, device="cpu", mesh=mesh)
    try:
        _batcher(params, config, mesh, n_slots=3, max_len=64)
        out["odd_slots"] = ""
    except ValueError as e:
        out["odd_slots"] = str(e)
    return out


# ---------------------------------------------------------------------------
# Sequence, pipeline and sharded training (ROADMAP A14 part 2)
# ---------------------------------------------------------------------------

def _tree_dict(items):
    """A nested dict from ``train.tree_items`` (name, tensor) pairs."""
    out: Dict[str, Any] = {}
    for name, t in items:
        node = out
        *path, leaf = name.split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = t
    return out


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return tree.detach().float().numpy()


def ring_sdpa_case(q, k, v, q_pos, kv_pos, axes, g=None, rate=0.0,
                   seed=None, routes=None) -> Dict[str, Any]:
    """``ring_sdpa`` on this rank's rows (over data) and slice of T (over
    seq) of global inputs; the out gathered whole on every rank, and
    with a cotangent ``g`` the gathered dq, dk, dv.  ``routes`` replaces
    the mesh's collective routes (the gloo-on-CUDA ones, on the CPU)."""
    import torch

    from jax_llama_tpu_torch.parallel import ring, use_mesh

    mesh = _mesh(axes)
    saved = dict(mesh.routes)
    if routes:
        mesh.routes.update(routes)
    n, i = mesh.shape["seq"], mesh.axis_index("seq")
    rows, r = mesh.axis_size(("data", "fsdp")), mesh.axis_index(
        ("data", "fsdp"))
    B, T = q_pos.shape
    bs, ts = slice(r * B // rows, (r + 1) * B // rows), slice(
        i * T // n, (i + 1) * T // n)

    def local(a, dims=2):
        t = torch.from_numpy(a)[bs][:, ts]
        return t.clone().requires_grad_(g is not None) if dims else t

    ql, kl, vl = local(q), local(k), local(v)
    mesh.collectives.clear()
    try:
        with use_mesh(mesh):
            out = ring.ring_sdpa(
                ql, kl, vl, local(q_pos, 0), local(kv_pos, 0),
                dropout_rng=seed if rate > 0 else None, dropout_rate=rate)
            res = {"out": out}
            if g is not None:
                (out * local(g, 0)).sum().backward()
                res.update(dq=ql.grad, dk=kl.grad, dv=vl.grad)
            full = {name: mesh.all_gather(mesh.all_gather(t.detach(), "seq",
                                                          dim=1),
                                          ("data", "fsdp"), dim=0).numpy()
                    for name, t in res.items()}
    finally:
        mesh.routes.clear()
        mesh.routes.update(saved)
    full["collectives"] = {"/".join((kk[0],) + kk[1]): vv
                           for kk, vv in mesh.collectives.items()}
    return full


def collective_routes_case(axes) -> Dict[str, Any]:
    """``ppermute`` and ``reduce_scatter`` on each route: the written-out
    gloo-on-CUDA routes give what the p2p and reduce-scatter ones give."""
    import torch

    mesh = _mesh(axes)
    saved = dict(mesh.routes)
    x = torch.arange(8, dtype=torch.float32) + 100 * mesh.rank
    out = {}
    for route in ({"ppermute": "p2p", "reduce_scatter": "reduce_scatter"},
                  {"ppermute": "all_gather_take",
                   "reduce_scatter": "all_reduce_slice"}):
        mesh.routes.update(route)
        name = route["ppermute"]
        out[name] = dict(
            fwd=mesh.ppermute(x, "seq", 1).numpy(),
            back=mesh.ppermute(x, "seq", -1).numpy(),
            rs=mesh.reduce_scatter(x, "seq").numpy())
    mesh.routes.clear()
    mesh.routes.update(saved)
    out["seq_index"] = mesh.axis_index("seq")
    return out


def cached_ring_case(cfg, tree, axes, prompt, steps) -> Dict[str, Any]:
    """A prompt, then single-token steps, through a seq-sharded cache
    (``ring_decode``): each step's last logits, and the cache's local
    slot count."""
    import torch

    import jax_llama_tpu_torch as ptl
    from jax_llama_tpu_torch.parallel import use_mesh

    params, config = _model(cfg, tree)
    config = config.replace(attn_impl="ring")
    mesh = _mesh(axes)
    sp = _sharded(params, config, mesh)
    B, P = prompt.shape
    ppos = torch.arange(P, dtype=torch.int32).expand(B, P)
    out = []
    mesh.collectives.clear()
    with torch.inference_mode(), use_mesh(mesh):
        cache = ptl.init_cache(config, B, max_len=config.max_seq_len,
                               device="cpu")
        lg, cache = ptl.forward(sp, torch.from_numpy(prompt), ppos, config,
                                cache=cache)
        out.append(lg[:, -1].numpy())
        for j in range(steps.shape[1]):
            lg, cache = ptl.forward(
                sp, torch.from_numpy(steps[:, j:j + 1]),
                torch.full((B, 1), P + j, dtype=torch.int32), config,
                cache=cache)
            out.append(lg[:, 0].numpy())
    return dict(logits=np.stack(out), slots=int(cache.max_len),
                index=int(cache.index),
                collectives={"/".join((kk[0],) + kk[1]): vv
                             for kk, vv in mesh.collectives.items()})


def train_case(cfg, tree, axes, tokens, loss_mask=None, steps=1,
               fsdp=False, lr=1e-3, dropout_seed=None, config=None,
               grads_only=False, unsharded=False,
               backward_thread=False) -> Dict[str, Any]:
    """``steps`` train_steps on the mesh from the shards of ``tree``
    (``fsdp`` for ZeRO-3) over ``shard_batch`` of the global batch: the
    losses and the updated params gathered whole; with ``grads_only``,
    the first step's loss and gradients instead (reduced as train_step
    reduces them, dropout seeded with ``dropout_seed``), gathered whole.
    ``unsharded`` runs the same steps (or the same gradients) without a
    mesh too.  ``backward_thread`` runs every ``torch.autograd.grad`` on
    a thread of its own, where no mesh is active, as autograd runs the
    backward of CUDA tensors."""
    import torch

    from jax_llama_tpu_torch import data, train
    from jax_llama_tpu_torch.parallel import use_mesh
    from jax_llama_tpu_torch.parallel.partition import (
        gather_params, leaf_specs, shard_params)

    params, conf = _model(cfg, tree)
    conf = conf.replace(**(config or {}))
    mesh = _mesh(axes)
    sp = shard_params(params, mesh, conf, fsdp=fsdp)
    mask = (np.ones(tokens.shape, bool) if loss_mask is None
            else loss_mask)
    batch = data.shard_batch(data.Batch(tokens=tokens, loss_mask=mask),
                             mesh)
    opt = train.make_optimizer(lr)
    mesh.collectives.clear()
    if grads_only:
        for p in train.tree_leaves(sp):
            p.requires_grad_(True)
        with use_mesh(mesh):
            loss = train.lm_loss(sp, batch.tokens, conf, batch.loss_mask,
                                 dropout_rng=dropout_seed)
            items = train.tree_items(sp)
            names = [n for n, _ in items]
            grads = list(torch.autograd.grad(loss, [p for _, p in items]))
            specs = leaf_specs(conf, mesh, sp, fsdp=fsdp)
            with torch.no_grad():
                train._reduce_grads(mesh, specs, names, grads)
            loss = loss.detach().clone()
            for a in train._TOKEN_AXES:
                mesh.all_reduce(loss, a)
        full = gather_params(_tree_dict(zip(names, grads)), mesh, conf,
                             fsdp=fsdp)
        out = dict(grads=_numpy_tree(full), loss=float(loss))
        if unsharded:
            ref = _model(cfg, tree)[0]
            for p in train.tree_leaves(ref):
                p.requires_grad_(True)
            ref_loss = train.lm_loss(ref, torch.from_numpy(tokens), conf,
                                     torch.from_numpy(mask),
                                     dropout_rng=dropout_seed)
            items = train.tree_items(ref)
            ref_grads = torch.autograd.grad(ref_loss, [p for _, p in items])
            out.update(ref_loss=float(ref_loss), ref_grads=_numpy_tree(
                _tree_dict(zip([n for n, _ in items], ref_grads))))
        return out
    state = train.init_train_state(sp, opt)
    losses = []
    grad = torch.autograd.grad
    if backward_thread:
        import threading

        def threaded(*a, **k):
            box = {}
            t = threading.Thread(target=lambda: box.update(r=grad(*a, **k)))
            t.start()
            t.join()
            return box["r"]

        torch.autograd.grad = threaded
    try:
        for _ in range(steps):
            state, loss = train.train_step(
                state, batch.tokens, conf, opt, loss_mask=batch.loss_mask,
                mesh=mesh, dropout_seed=dropout_seed)
            losses.append(float(loss))
    finally:
        torch.autograd.grad = grad
    out = dict(losses=losses,
               params=_numpy_tree(gather_params(state.params, mesh, conf,
                                                fsdp=fsdp)),
               local_qkv=tuple(state.params["layers"]["qkv"].shape),
               collectives={"/".join((kk[0],) + kk[1]): vv
                            for kk, vv in mesh.collectives.items()})
    if unsharded:
        ref = train.init_train_state(_model(cfg, tree)[0], opt)
        ref_losses = []
        for _ in range(steps):
            ref, loss = train.train_step(
                ref, torch.from_numpy(tokens), conf, opt,
                loss_mask=torch.from_numpy(mask), dropout_seed=dropout_seed)
            ref_losses.append(float(loss))
        out.update(ref_losses=ref_losses, ref_params=_numpy_tree(ref.params))
    return out


def dropout_forward_case(cfg, tree, axes, tokens, config, seed,
                         fsdp=False) -> Dict[str, Any]:
    """``forward(dropout_rng=seed)`` on the mesh and without one, the
    same config: the logits of both (the generator masks are the
    unsharded run's)."""
    import torch

    import jax_llama_tpu_torch as ptl
    from jax_llama_tpu_torch.parallel import use_mesh
    from jax_llama_tpu_torch.parallel.partition import shard_params

    params, conf = _model(cfg, tree)
    conf = conf.replace(**config)
    mesh = _mesh(axes)
    sp = shard_params(params, mesh, conf, fsdp=fsdp)
    t = torch.from_numpy(tokens)
    B, T = t.shape
    pos = torch.arange(T, dtype=torch.int32).expand(B, T)
    with torch.no_grad():
        want = ptl.forward(params, t, pos, conf, dropout_rng=seed)[0]
        with use_mesh(mesh):
            got = ptl.forward(sp, t, pos, conf, dropout_rng=seed)[0]
    return dict(logits=got.numpy(), unsharded=want.numpy())


def train_state_roundtrip(cfg, tree, axes, tokens, path,
                          fsdp=False) -> Dict[str, Any]:
    """One train step on the mesh, ``save_train_state(mesh=)``, then
    ``load_train_state(mesh=, fsdp=)``: the loaded shards equal the
    saved ones; a second step from each gives the same loss."""
    import torch

    from jax_llama_tpu_torch import data, train
    from jax_llama_tpu_torch.convert import (load_train_state,
                                             save_train_state)
    from jax_llama_tpu_torch.parallel.partition import shard_params

    params, conf = _model(cfg, tree)
    mesh = _mesh(axes)
    opt = train.make_optimizer(1e-3)
    state = train.init_train_state(
        shard_params(params, mesh, conf, fsdp=fsdp), opt)
    b = data.shard_batch(data.Batch(tokens=tokens,
                                    loss_mask=np.ones(tokens.shape, bool)),
                         mesh)
    state, _ = train.train_step(state, b.tokens, conf, opt, mesh=mesh)
    from jax_llama_tpu_torch.parallel import use_mesh

    with use_mesh(mesh):
        save_train_state(path, state, conf)
    back, _ = load_train_state(path, mesh=mesh, fsdp=fsdp)
    same = all(torch.equal(x.detach(), y.detach()) for x, y in zip(
        train.tree_leaves(state.params) + train.tree_leaves(state.opt_state.mu)
        + train.tree_leaves(state.opt_state.nu),
        train.tree_leaves(back.params) + train.tree_leaves(back.opt_state.mu)
        + train.tree_leaves(back.opt_state.nu)))
    _, la = train.train_step(state, b.tokens, conf, opt, mesh=mesh)
    _, lb = train.train_step(back, b.tokens, conf, opt, mesh=mesh)
    return dict(same=same, count=back.opt_state.count, step=back.step,
                losses=(float(la), float(lb)))


def fsdp_load_case(cfg, tree, axes, path) -> Dict[str, Any]:
    """``load_checkpoint(mesh=, fsdp=True)`` against
    ``shard_params(fsdp=True)``; the save from the mesh's manifest
    against the unsharded save's."""
    import json

    import torch

    from jax_llama_tpu_torch.convert import load_checkpoint, save_checkpoint
    from jax_llama_tpu_torch.parallel.partition import shard_params
    from jax_llama_tpu_torch.train import tree_leaves

    params, config = _model(cfg, tree)
    mesh = _mesh(axes)
    got, _ = load_checkpoint(path, mesh=mesh, fsdp=True)
    want = shard_params(params, mesh, config, fsdp=True)
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(got),
                                                 tree_leaves(want)))
    from jax_llama_tpu_torch.parallel import use_mesh

    with use_mesh(mesh):
        save_checkpoint(path + "_mesh", got, config)
    manifests = [json.load(open(f"{p}/manifest.json"))
                 for p in (path, path + "_mesh")]
    return dict(same=same, manifest_same=manifests[0] == manifests[1],
                qkv=tuple(got["layers"]["qkv"].shape))


def train_on_card(cfg, axes, fsdp, B, T, steps=2) -> Dict[str, Any]:
    """``steps`` train_steps on two ranks sharing cuda:0 (gloo, so
    ppermute and reduce_scatter take their written-out routes) against
    the same steps unsharded on this rank: losses, the largest leaf
    difference, the rank's kernel launches and routes."""
    import importlib

    import torch

    import jax_llama_tpu_torch as ptl
    from jax_llama_tpu_torch import data, train
    from jax_llama_tpu_torch.parallel.partition import (gather_params,
                                                        shard_params)

    fa = importlib.import_module("jax_llama_tpu_torch.ops.flash_attention")
    torch.cuda.set_device(0)
    config = ptl.get_config("tiny", **cfg)
    mesh = _mesh(axes, device="cuda:0")
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, config.vocab_size, (B, T)).astype(np.int32)
    batch = data.Batch(tokens=tokens, loss_mask=np.ones((B, T), bool))
    opt = train.make_optimizer(1e-3)
    ref = train.init_train_state(
        ptl.init_params(config, seed=0, device="cuda"), opt)
    sp = shard_params(ptl.init_params(config, seed=0, device="cuda"), mesh,
                      config, fsdp=fsdp)
    st = train.init_train_state(sp, opt)
    local = data.shard_batch(batch, mesh)
    before = fa.flash_attention.launches
    mesh.collectives.clear()
    losses = []
    for _ in range(steps):
        st, loss = train.train_step(st, local.tokens, config, opt,
                                    loss_mask=local.loss_mask, mesh=mesh)
        losses.append(loss.item())
    launches = fa.flash_attention.launches - before
    ref_losses = []
    for _ in range(steps):
        ref, loss = train.train_step(ref, torch.from_numpy(tokens).cuda(),
                                     config, opt)
        ref_losses.append(loss.item())
    full = gather_params(st.params, mesh, config, fsdp=fsdp)
    diff = max((a.float() - b.float()).abs().max().item() for a, b in zip(
        train.tree_leaves(full), train.tree_leaves(ref.params)))
    return dict(losses=losses, ref_losses=ref_losses, max_diff=diff,
                launches=launches, routes=dict(mesh.routes),
                collectives={"/".join((kk[0],) + kk[1]): vv
                             for kk, vv in mesh.collectives.items()})


# ---------------------------------------------------------------------------
# The HTTP server and the replica router over a serving mesh (ROADMAP A14
# part 3): rank 0 leads (LLMServer, ReplicaRouter), the others follow.
# ---------------------------------------------------------------------------

def _http(url, path, payload=None, timeout=120):
    """(status, parsed body) of one request; NDJSON bodies as lists."""
    import json
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url + path, data=data)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            status, raw, ctype = r.status, r.read(), r.headers.get(
                "Content-Type", "")
    except urllib.error.HTTPError as e:
        status, raw, ctype = e.code, e.read(), e.headers.get(
            "Content-Type", "")
    if "ndjson" in ctype:
        return status, [json.loads(x) for x in raw.splitlines()]
    if "json" in ctype:
        return status, json.loads(raw)
    return status, raw.decode()


def _send_together(url, requests):
    """Every (path, payload) of ``requests`` at once, one thread each;
    the replies in the same order."""
    import threading

    out = [None] * len(requests)

    def run(i):
        out[i] = _http(url, *requests[i])

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(requests))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    return out


def _serving_stack(cfg, tree, rank_file, axes, timeouts=None):
    """This rank's mesh (a fresh one with ``timeouts``), its weight shard,
    the Llama-3 tokenizer over ``rank_file`` and its chat format."""
    from jax_llama_tpu_torch.parallel import make_mesh
    from jax_llama_tpu_torch.tokenizers import ChatFormat, LLaMA3Tokenizer

    params, config = _model(cfg, tree)
    if timeouts is not None:
        n = int(np.prod(list(axes.values())))
        mesh = make_mesh(**axes, devices=["cpu"] * n, **timeouts)
    else:
        mesh = _mesh(axes)
    tok = LLaMA3Tokenizer(rank_file)
    return _sharded(params, config, mesh), config, mesh, tok, \
        ChatFormat(tok)


def _serving_batcher(params, config, mesh, tok, injector=None, seed=0,
                     **kw):
    """test_torch_server's batcher (2 slots, max_len 64, decode_chunk 4,
    the tokenizer's stop ids) on ``mesh``."""
    kw = dict(dict(n_slots=2, max_len=64, decode_chunk=4), **kw)
    return _batcher(params, config, mesh,
                    stop_tokens=tuple(sorted(tok.stop_tokens)),
                    fault_injector=injector, seed=seed, **kw)


def _lockstep_summary(leader):
    return dict(leader.stats(), broken=None if leader.broken is None
                else f"{type(leader.broken).__name__}: {leader.broken}")


def server_mesh(cfg, tree, rank_file, axes, requests, faults=None,
                fault_ranks=None, timeouts=None, batcher_kw=None,
                server_kw=None) -> Dict[str, Any]:
    """``LLMServer`` over a batcher on the mesh ``axes``: rank 0 serves
    ``requests`` (sent together), then its /healthz and /metrics and the
    host state through the log; every other rank follows.  ``faults``
    arms an injector on the ``fault_ranks`` (default: every rank).  A
    rank whose log broke raises its error."""
    from jax_llama_tpu_torch.faults import FaultInjector
    from jax_llama_tpu_torch.parallel import lockstep
    from jax_llama_tpu_torch.server import LLMServer

    params, config, mesh, tok, chat = _serving_stack(cfg, tree, rank_file,
                                                     axes, timeouts)
    armed = faults is not None and (fault_ranks is None
                                    or mesh.rank in fault_ranks)
    injector = FaultInjector(faults) if armed else None
    cb = _serving_batcher(params, config, mesh, tok, injector,
                          **(batcher_kw or {}))
    if mesh.rank != 0:
        return dict(rank=mesh.rank, **lockstep.follow(mesh, lambda _: cb))
    leader = lockstep.leader_for(mesh)
    srv = LLMServer(leader.make(0, lambda: cb), tokenizer=tok,
                    chat_format=chat, **(server_kw or {})).start()
    try:
        replies = _send_together(srv.address, requests)
        out = dict(rank=0, replies=replies)
        if leader.broken is None:
            out.update(
                health=_http(srv.address, "/healthz"),
                metrics=_http(srv.address, "/metrics")[1],
                states=[srv.call_on_loop(lambda b: b.host_state())])
    finally:
        srv.stop()
        leader.stop()
    if leader.broken is not None:
        raise leader.broken
    return dict(out, lockstep=_lockstep_summary(leader))


def router_mesh(cfg, tree, rank_file, axes, scenario,
                timeouts=None) -> Dict[str, Any]:
    """Two replicas time-sharing the mesh ``axes`` behind a
    ``ReplicaRouter`` (cache-aware): rank 0 runs ``scenario`` (``ROUTER
    _SCENARIOS``), every other rank follows, building each replica's
    batcher through the log (``make`` records)."""
    from jax_llama_tpu_torch.parallel import lockstep
    from jax_llama_tpu_torch.router import ReplicaRouter
    from jax_llama_tpu_torch.server import LLMServer

    params, config, mesh, tok, chat = _serving_stack(cfg, tree, rank_file,
                                                     axes, timeouts)

    def make(i):
        return _serving_batcher(params, config, mesh, tok, seed=i,
                                max_len=128)

    if mesh.rank != 0:
        return dict(rank=mesh.rank, **lockstep.follow(mesh, make))
    leader = lockstep.leader_for(mesh)
    servers = []

    def make_replica(i):
        srv = LLMServer(leader.make(i, lambda: make(i)), tokenizer=tok,
                        chat_format=chat, replica_id=i).start()
        servers.append(srv)
        return srv

    try:
        first = [make_replica(0), make_replica(1)]
        router = ReplicaRouter(
            first, policy="cache-aware", tokenizer=tok, chat_format=chat,
            block_size=first[0].batcher.block_size).start()
        try:
            out = ROUTER_SCENARIOS[scenario](router, servers, make_replica)
        finally:
            router.stop()
    finally:
        for srv in servers:
            srv.stop()
        leader.stop()
    if leader.broken is not None:
        raise leader.broken
    return dict(out, rank=0, lockstep=_lockstep_summary(leader))


def _states(servers):
    """Each live replica's host state, taken through the log (so every
    rank computes and compares its own at the same point); none for
    JAX's servers, whose one process needs no log."""
    return [s.call_on_loop(lambda b: b.host_state()) for s in servers
            if not s._closed.is_set() and hasattr(s.batcher, "host_state")]


ROUTER_PROMPT = ("the quick brown fox jumps over the lazy dog while the "
                 "sphinx of black quartz judges my vow")


def _router_routed(router, servers, make_replica):
    """A session's first turn, an unrelated prompt, and the session's
    revisit (routed to the replica holding its chain); /healthz and
    /metrics of the router and the replicas."""
    turns = [{"text": ROUTER_PROMPT, "max_new_tokens": 6},
             {"text": "pack my box with five dozen liquor jugs",
              "max_new_tokens": 6},
             {"text": ROUTER_PROMPT + " again", "max_new_tokens": 6}]
    replies = []
    for i, payload in enumerate(turns):
        replies.append(_http(router.address, "/generate", payload))
        router.check_health_now()
    return dict(replies=replies, health=_http(router.address, "/healthz"),
                metrics=_http(router.address, "/metrics")[1],
                replica_health=[_http(s.address, "/healthz")
                                for s in servers],
                replica_metrics=[_http(s.address, "/metrics")[1]
                                 for s in servers],
                states=_states(servers))


def _router_handoff(router, servers, make_replica):
    """The router's handoff path (``migrate_chain``: its worker exports on
    replica 0's serving loop and imports on replica 1's, as
    ``handoff_prefix`` does on two batchers): serve a prompt on replica
    0 (cold), move its chain to replica 1, serve it there (a prefix
    hit)."""
    from jax_llama_tpu_torch.kvcache import chain_keys

    prompt = [int(t) for t in np.random.RandomState(3).randint(1, 128, 50)]
    payload = {"prompt": prompt, "max_new_tokens": 6, "seed": 5}
    cold = _http(servers[0].address, "/generate", payload)
    keys = chain_keys(prompt, servers[0].batcher.block_size)
    router.migrate_chain([k.hex() for k in keys], 0, 1)
    idle = router.wait_handoffs(60.0)
    hit = _http(servers[1].address, "/generate", payload)
    stats = [s.call_on_loop(lambda b: b.stats()) for s in servers]
    return dict(cold=cold, hit=hit, idle=idle,
                completed=router.handoffs_completed_total,
                exported=stats[0]["kv_export_blocks_total"],
                imported=stats[1]["kv_import_blocks_total"],
                hits=stats[1]["prefix_requests_hit_total"],
                states=_states(servers))


def _router_elastic(router, servers, make_replica):
    """One FleetController scale-up (a third replica, built on every rank
    through the log), a session served on it, then a scale-down that
    drains it by migration onto a survivor (and drops its batcher on
    every rank); the session's revisit through the router after."""
    from jax_llama_tpu_torch.router import FleetController

    ctl = FleetController(router, replica_factory=make_replica,
                          min_replicas=1, max_replicas=3,
                          drain_timeout_s=60.0)
    try:
        up = ctl.scale_up()
        new = up.get("replica")
        prompt = [int(t) for t in
                  np.random.RandomState(11).randint(1, 128, 40)]
        payload = {"prompt": prompt, "max_new_tokens": 4}
        served = _http(servers[new].address, "/generate", payload)
        grown = _states(servers)
        down = ctl.scale_down(victim=new)
        revisit = _http(router.address, "/generate", payload)
        return dict(up=up, served=served, down=down, revisit=revisit,
                    grown=grown, after=_states(servers),
                    replicas=len(servers))
    finally:
        ctl.close(stop_owned=True)


ROUTER_SCENARIOS = {"routed": _router_routed, "handoff": _router_handoff,
                    "elastic": _router_elastic}


def run_http_cli(argv, requests) -> Dict[str, Any]:
    """``run.main()`` with ``--http`` on this rank, as ``run_cli`` runs
    it, through ``_serve_http``'s test hook: rank 0 sends ``requests`` in
    turn, and returns the replies and what it printed; the other ranks
    return what they printed."""
    from jax_llama_tpu_torch import run as prun

    got = {}

    def hook(srv):
        got["replies"] = [_http(srv.address, *r) for r in requests]
        got["health"] = _http(srv.address, "/healthz")

    orig = prun._serve_http
    prun._serve_http = lambda *a, **kw: orig(*a, **dict(kw, _test_hook=hook))
    try:
        out = run_cli(argv)
    finally:
        prun._serve_http = orig
    return dict(got, out=out)


def run_router_cli(argv, requests) -> Dict[str, Any]:
    """``run.main()`` with ``--http`` and ``--replicas`` on this rank, as
    ``run_cli`` runs it, through ``_serve_router``'s test hook: rank 0
    sends ``requests`` to the router in turn, then takes each replica's
    host state through the log and reads the router's and the batchers'
    fault injectors; a follower returns the host states it computed."""
    from jax_llama_tpu_torch import run as prun
    from jax_llama_tpu_torch.parallel import lockstep

    got = {}

    def hook(router, servers):
        got["replies"] = [_http(router.address, *r) for r in requests]
        got["states"] = [s.call_on_loop(lambda b: b.host_state())
                         for s in servers]
        got["recoveries"] = [s.recoveries_total for s in servers]
        for name, inj in (("router_faults", router.fault_injector),
                          ("batcher_faults",
                           servers[0].batcher.fault_injector)):
            got[name] = dict(calls=dict(inj.calls),
                             injected=dict(inj.injected),
                             delays=inj.delays_total, same=inj is (
                                 servers[0].batcher.fault_injector))

    def follow(*a, **kw):
        got.update(orig[1](*a, **kw))
        return got

    orig = prun._serve_router, lockstep.follow
    prun._serve_router = lambda *a, **kw: orig[0](*a, **dict(
        kw, _test_hook=hook))
    lockstep.follow = follow
    try:
        out = run_cli(argv)
    finally:
        prun._serve_router, lockstep.follow = orig
    return dict(got, out=out)
