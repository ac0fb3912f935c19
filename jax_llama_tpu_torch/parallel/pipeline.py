"""Pipeline parallelism: the GPipe microbatch schedule over the ``stage``
mesh axis (port of ``jax_llama_tpu/parallel/pipeline.py``).

Stage ``s`` holds layers ``[s L/S, (s+1) L/S)`` (``shard_params`` on a
``stage > 1`` mesh).  The batch splits into M microbatches and the
schedule runs ``M + S - 1`` ticks: at tick ``t`` stage 0 injects
microbatch ``min(t, M-1)``, stage ``s`` runs microbatch ``t - s`` (its
index clamped on bubble ticks), and after each tick but the last every
stage passes its output, positions and slot positions to the next one
(``Mesh.ppermute`` round the stage ring); the last stage keeps its
outputs.  A bubble tick computes nothing here: its result would be
discarded (the JAX program computes it, SPMD), and the ring still turns
on every tick, so every rank issues the same collectives.

The backward pass is the same schedule in reverse, written out rather
than left to autograd: autograd runs a ``ppermute`` node's backward only
on a rank whose received tensor reaches the loss, which differs between
stages, and two ranks that disagree on the collectives they issue wait
for each other for ever.  ``_Pipeline`` keeps each tick's graph; its
backward walks the ticks last to first, takes each stage's gradient
through its own graph (``torch.autograd.grad``) and sends the input's
gradient one stage back on every tick.  The result leaves the last stage
through an all-reduce over ``stage`` whose backward is the identity
(the other stages contribute zeros), and the input's gradient is summed
over ``stage`` (``copy_f``), so a leaf used outside the pipeline (the
embedding, the head) gets its whole gradient on every stage.

Composition: tensor, data and fsdp collectives run inside each stage as
on a plain stack; ``seq > 1`` together with ``stage > 1`` is refused
(JAX ``models/llama.py:1192``).
"""

from __future__ import annotations

from typing import Any, Callable, List

import torch

StageFn = Callable[
    [Any, torch.Tensor, torch.Tensor, torch.Tensor, int], torch.Tensor
]


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _leaves(x)]
    return [tree] if isinstance(tree, torch.Tensor) else []


class _Pipeline(torch.autograd.Function):
    """The schedule with its hand-written backward (module docstring).
    ``run`` carries the stage function, its tree, the mesh and the
    schedule's sizes; the tensors after it are the input and the
    stage's leaves, whose gradients the backward returns."""

    @staticmethod
    def forward(ctx, run, x, *leaves):
        mesh, axis, S, M = run["mesh"], run["axis"], run["S"], run["M"]
        stage = mesh.axis_index(axis)
        x_mb, pos_mb, spos_mb = run["x_mb"](x), run["pos_mb"], run["spos_mb"]
        grad = run["grad"]
        mb, T, D = x_mb.shape[1:]
        state = torch.zeros((mb, T, D), dtype=x.dtype, device=x.device)
        state_pos = torch.zeros_like(pos_mb[0])
        state_spos = torch.full_like(spos_mb[0], -1)
        outs = [None] * M
        ticks = []
        for t in range(M + S - 1):
            i = t - stage
            live = 0 <= i <= M - 1
            if stage == 0:
                xx, pos, spos = x_mb[min(t, M - 1)], pos_mb[min(t, M - 1)], \
                    spos_mb[min(t, M - 1)]
            else:
                xx, pos, spos = state, state_pos, state_spos
            if live:
                if grad:
                    with torch.enable_grad():
                        inp = xx.detach().requires_grad_()
                        y = run["stage_fn"](run["tree"], inp, pos, spos,
                                            min(max(i, 0), M - 1))
                    ticks.append((t, inp, y))
                    y = y.detach()
                else:
                    y = run["stage_fn"](run["tree"], xx, pos, spos,
                                        min(max(i, 0), M - 1))
            else:
                y = torch.zeros_like(state)
            m = t - (S - 1)
            if stage == S - 1 and 0 <= m < M:
                outs[m] = y
            if t < M + S - 2:
                state = mesh.ppermute(y, axis, 1)
                state_pos = mesh.ppermute(pos, axis, 1)
                state_spos = mesh.ppermute(spos, axis, 1)
        ctx.run, ctx.ticks, ctx.stage = run, ticks, stage
        ctx.x_shape, ctx.leaves = x.shape, leaves
        if stage == S - 1:
            return torch.cat(outs).reshape(x.shape)
        return torch.zeros_like(x)

    @staticmethod
    def backward(ctx, g_out):
        run, stage = ctx.run, ctx.stage
        mesh, axis, S, M = run["mesh"], run["axis"], run["S"], run["M"]
        leaves = ctx.leaves
        g_out_mb = g_out.reshape((M, -1) + tuple(g_out.shape[1:]))
        g_leaves = [torch.zeros_like(p) if p.requires_grad else None
                    for p in leaves]
        g_x = torch.zeros_like(g_out_mb)
        by_tick = {t: (inp, y) for t, inp, y in ctx.ticks}
        g_next = torch.zeros_like(g_out_mb[0])  # grad of this tick's y
        for t in reversed(range(M + S - 1)):
            m = t - (S - 1)
            if stage == S - 1:
                g_y = g_out_mb[m] if 0 <= m < M else torch.zeros_like(
                    g_next)
            else:
                g_y = g_next
            g_in = torch.zeros_like(g_next)
            if t in by_tick:
                inp, y = by_tick.pop(t)
                want = [inp] + [p for p in leaves if p.requires_grad]
                got = torch.autograd.grad(y, want, g_y, allow_unused=True)
                g_in = got[0]
                it = iter(got[1:])
                for j, p in enumerate(leaves):
                    if p.requires_grad:
                        gp = next(it)
                        if gp is not None:
                            g_leaves[j] += gp
                if stage == 0:
                    g_x[min(t, M - 1)] += g_in
            if t >= 1:
                # The gradient of what stage s - 1 sent at tick t - 1.
                g_next = mesh.ppermute(g_in, axis, -1)
        ctx.ticks = None
        return (None, g_x.reshape(ctx.x_shape), *g_leaves)


def pipeline_blocks(
    stage_fn: StageFn,
    layer_params: Any,
    x: torch.Tensor,
    positions: torch.Tensor,
    slot_pos: torch.Tensor,
    *,
    mesh,
    n_microbatches: int,
    axis_name: str = "stage",
    n_layers: int = None,
) -> torch.Tensor:
    """Run this stage's layers as a pipeline over the ``stage`` axis (JAX
    :43).

    Args:
      stage_fn: ``(stage_layers, x, positions, slot_pos, mb_index) -> x``
        applying this stage's layers to one microbatch; ``mb_index`` is
        the microbatch's index (callers fold it into their dropout
        draws).
      layer_params: this stage's layer tree (``shard_params`` on the
        stage mesh: leaves [L/S, ...]), handed to ``stage_fn`` as it is;
        its tensors are the ones whose gradients the backward returns.
      x: [B, T, D] this rank's rows; positions, slot_pos: [B, T] int32.
      mesh: the active mesh; n_microbatches: M, which must divide B.
      n_layers: the model's L, checked against the stage count.
    Returns:
      [B, T, D], the same on every stage.
    """
    S = mesh.shape[axis_name]
    M = int(n_microbatches)
    B, T, D = x.shape
    leaves = _leaves(layer_params)
    L = n_layers if n_layers is not None else leaves[0].shape[0] * S
    if L % S:
        raise ValueError(f"n_layers={L} not divisible by stage={S}")
    if B % M:
        raise ValueError(f"batch={B} not divisible by microbatches={M}")
    mb = B // M
    grad = torch.is_grad_enabled() and (
        x.requires_grad or any(p.requires_grad for p in leaves))
    run = dict(
        mesh=mesh, axis=axis_name, S=S, M=M, tree=layer_params,
        stage_fn=stage_fn, grad=grad,
        x_mb=lambda t: t.reshape(M, mb, T, D),
        pos_mb=positions.reshape(M, mb, T),
        spos_mb=slot_pos.reshape(M, mb, T))
    x = mesh.copy_f(x, axis_name)
    out = _Pipeline.apply(run, x, *leaves)
    return mesh.reduce_g(out, axis_name)


__all__ = ["pipeline_blocks"]
