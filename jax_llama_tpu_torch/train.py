"""Training: the LM loss and an AdamW train step (port of
``jax_llama_tpu/train.py``).

    opt = make_optimizer()
    state = init_train_state(params, opt)
    for batch in data.batches(docs, batch_size=4, seq_len=2048):
        batch = data.to_device(batch, "cuda")
        state, loss = train_step(state, batch.tokens, cfg, opt,
                                 loss_mask=batch.loss_mask, dropout_seed=0)

``lm_loss`` is a masked next-token cross-entropy, fused (the chunked LM
head of ``ops.loss``) or dense.  Under ``attn_impl="flash"`` every layer's
attention runs the flash forward kernel and, in the backward pass, the dQ
and dK/dV kernels (``ops.flash_attention``); ``config.remat`` recomputes
each block in the backward pass (``models.llama``).

The optimizer is written out in plain torch rather than built on
``torch.optim.AdamW``: it computes what the JAX package's optax chain
computes, in optax's order (global-norm clipping, scaled by
``max_norm / norm`` only when ``norm >= max_norm``; Adam moments with bias
correction at the incremented count; decoupled weight decay on every
parameter, scaled by the learning rate; ``warmup_cosine_decay_schedule``
evaluated at the pre-increment count, so step 0 has lr 0 under warmup),
and keeps its moments in the state the caller holds, like optax's.
``torch.optim`` keeps a hidden per-parameter step and folds the decay in
before the Adam step, which would have to be matched around it.  The
update runs in place on the parameters and moments (JAX donates the
state instead), which saves a copy of each.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .config import LLaMAConfig
from .models.llama import forward
from .ops.loss import chunked_softmax_xent

Params = Dict[str, Any]

_ADAM_EPS = 1e-8  # optax.adamw's default, which the JAX package keeps


def tree_items(tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(name, tensor) for each tensor of a nested dict, in a fixed
    (sorted-key) order; a name joins the keys with "/"."""
    if isinstance(tree, dict):
        return [item for key in sorted(tree)
                for item in tree_items(tree[key], f"{prefix}{key}/")]
    return [(prefix[:-1], tree)]


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict, in ``tree_items`` order."""
    return [t for _, t in tree_items(tree)]


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    return torch.zeros_like(tree, requires_grad=False)


@dataclasses.dataclass
class AdamWState:
    """The optimizer's moments (the params' structure and dtypes) and the
    count of updates made (optax's ``ScaleByAdamState``)."""

    mu: Params
    nu: Params
    count: int = 0


@dataclasses.dataclass
class TrainState:
    params: Params
    opt_state: AdamWState
    step: int = 0


@dataclasses.dataclass(frozen=True)
class AdamW:
    """AdamW with global-norm clipping and an optional linear-warmup +
    cosine-decay schedule: optax ``chain(clip_by_global_norm(grad_clip),
    adamw(schedule, b1, b2, eps=1e-8, weight_decay))``."""

    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 1.0
    warmup_steps: int = 0
    total_steps: Optional[int] = None

    def lr(self, count: int) -> float:
        """The learning rate at update ``count`` (0-based)."""
        if not (self.warmup_steps or self.total_steps):
            return self.learning_rate
        warmup = max(self.warmup_steps, 1)
        decay = max(self.total_steps or self.warmup_steps * 10, 2)
        if count < warmup:
            return self.learning_rate * min(max(count, 0), warmup) / warmup
        steps = decay - warmup
        t = min(count - warmup, steps)
        return self.learning_rate * 0.5 * (1.0 + math.cos(math.pi * t / steps))

    def init(self, params: Params) -> AdamWState:
        return AdamWState(mu=_zeros_like(params), nu=_zeros_like(params))

    @torch.no_grad()
    def update(self, params: Params, grads: List[torch.Tensor],
               state: AdamWState) -> AdamWState:
        """One update of ``params`` in place from ``grads`` (in
        ``tree_leaves(params)`` order); returns the advanced state."""
        ps = tree_leaves(params)
        mus, nus = tree_leaves(state.mu), tree_leaves(state.nu)
        norm = torch.stack([torch.linalg.vector_norm(g, dtype=torch.float32)
                            for g in grads]).square().sum().sqrt()
        # optax: t where norm < max_norm, else (t / norm) * max_norm.
        one = torch.ones_like(norm)
        keep = norm < self.grad_clip
        div = torch.where(keep, one, norm)
        mul = torch.where(keep, one, one * self.grad_clip)
        count = state.count + 1
        bc1 = float(np.float32(1.0) - np.float32(self.b1) ** np.float32(count))
        bc2 = float(np.float32(1.0) - np.float32(self.b2) ** np.float32(count))
        lr = self.lr(state.count)
        for p, g, mu, nu in zip(ps, grads, mus, nus):
            g = g / div * mul
            mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            u = (mu / bc1) / ((nu / bc2).sqrt_() + _ADAM_EPS)
            u.add_(p, alpha=self.weight_decay)
            p.add_(u, alpha=-lr)
        return AdamWState(state.mu, state.nu, count)


def make_optimizer(
    learning_rate: float = 3e-4,
    weight_decay: float = 0.1,
    b1: float = 0.9,
    b2: float = 0.95,
    grad_clip: float = 1.0,
    warmup_steps: int = 0,
    total_steps: Optional[int] = None,
) -> AdamW:
    """AdamW with the usual LLM hyperparameters: global-norm clipping and an
    optional linear-warmup + cosine-decay schedule (JAX ``make_optimizer``)."""
    return AdamW(learning_rate, weight_decay, b1, b2, grad_clip,
                 warmup_steps, total_steps)


def init_train_state(params: Params, optimizer: AdamW) -> TrainState:
    """The state of step 0.  The params become autograd leaves
    (``requires_grad``) and are updated in place by ``train_step``."""
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return TrainState(params=params, opt_state=optimizer.init(params))


def lm_loss(
    params: Params,
    tokens: torch.Tensor,
    config: LLaMAConfig,
    loss_mask: Optional[torch.Tensor] = None,
    dropout_rng=None,
    fused: bool = True,
) -> torch.Tensor:
    """Masked next-token cross-entropy (float32 scalar).

    tokens: [B, T] integer; position t predicts token t+1.
    loss_mask: optional [B, T] bool, query-position-indexed: mask[:, t]
      gates the loss term predicting token t+1 from position t (the
      convention ``data.pack_documents`` emits; mask[:, -1] is never
      consumed).  Defaults to all positions.
    dropout_rng: a ``torch.Generator`` or int seed enabling the config's
      dropout (see ``models.llama.forward``).
    fused: take the LM head and the softmax cross-entropy chunkwise
      (``ops.loss.chunked_softmax_xent``) over the forward's last hidden
      state, never materializing the [B, T, V] logits; False runs the
      dense path (the parity oracle).
    """
    device = params["embed"]["embedding"].device
    tokens = tokens.to(device)
    B, T = tokens.shape
    targets = tokens[:, 1:]
    positions = torch.arange(T, dtype=torch.int32, device=device).expand(B, T)
    if loss_mask is not None:
        loss_mask = loss_mask.to(device)
    if fused:
        _, _, aux = forward(params, tokens, positions, config,
                            dropout_rng=dropout_rng, compute_logits=False,
                            output_last_hidden=True)
        h = aux.last_hidden_state[:, :-1]  # [B, T-1, D] post-final-norm
        if config.tie_word_embeddings:
            head, head_t = params["embed"]["embedding"], True
        else:
            head, head_t = params["lm_head"], False
        w = (loss_mask[:, :-1].float() if loss_mask is not None
             else torch.ones((B, T - 1), device=device))
        tot, wsum = chunked_softmax_xent(
            h.reshape(B * (T - 1), -1), head, targets.reshape(-1),
            w.reshape(-1), head_transposed=head_t)
        return tot / wsum.clamp(min=1.0)
    logits, _ = forward(params, tokens, positions, config,
                        dropout_rng=dropout_rng)
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    nll = -logp.gather(-1, targets[:, :, None].long())[..., 0]
    if loss_mask is not None:
        m = loss_mask[:, :-1].float()
        return (nll * m).sum() / m.sum().clamp(min=1.0)
    return nll.mean()


def step_generator(dropout_seed: int, step: int, device) -> torch.Generator:
    """The dropout generator of one step: seeded from (run seed, step), as
    the JAX package folds the step count into its run key."""
    seed = np.random.SeedSequence([int(dropout_seed), int(step)])
    return torch.Generator(device=device).manual_seed(
        int(seed.generate_state(1, np.uint64)[0]))


def train_step(
    state: TrainState,
    tokens: torch.Tensor,
    config: LLaMAConfig,
    optimizer: AdamW,
    loss_mask: Optional[torch.Tensor] = None,
    mesh=None,
    dropout_seed: Optional[int] = None,
) -> Tuple[TrainState, torch.Tensor]:
    """One optimizer step: the loss and its gradients, then the AdamW
    update of ``state.params`` in place.  Returns (the advanced state, the
    step's loss, a float32 scalar tensor).

    ``dropout_seed``: a per-run int enabling dropout at the config's
    rates; each step draws its masks from a generator seeded with (seed,
    step).  A ``mesh`` (data/FSDP/tensor sharding) is not ported.
    """
    if mesh is not None:
        raise NotImplementedError("ROADMAP A14")
    device = state.params["embed"]["embedding"].device
    gen = (step_generator(dropout_seed, state.step, device)
           if dropout_seed is not None else None)
    loss = lm_loss(state.params, tokens, config, loss_mask, gen)
    grads = torch.autograd.grad(loss, tree_leaves(state.params))
    opt_state = optimizer.update(state.params, list(grads), state.opt_state)
    return TrainState(state.params, opt_state, state.step + 1), loss.detach()
