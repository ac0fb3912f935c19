"""Training input pipeline: document packing and the host-to-device feed
(port of ``jax_llama_tpu/data.py``).

Fixed-size [B, T] batches, greedy document packing with EOS separators
(no padding waste) and a loss mask that excludes padding targets, as
numpy; the behaviour, the shuffle's draws included, is the JAX
package's.  ``to_device`` puts a batch on one card; ``shard_batch``
gives each rank of a mesh its rows (one process per rank):

    docs = (tok.encode(line, bos=True, eos=True) for line in corpus)
    for batch in batches(docs, batch_size=8, seq_len=2048, pad_id=0):
        batch = shard_batch(batch, mesh)          # or to_device(batch)
        state, loss = train_step(state, batch.tokens, cfg, opt,
                                 loss_mask=batch.loss_mask, mesh=mesh)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from .models.llama import resolve_device


@dataclasses.dataclass
class Batch:
    """One packed training batch.

    tokens:    [B, T] int32 (numpy, or a tensor after ``to_device``).
    loss_mask: [B, T] bool, query-position-indexed: loss_mask[t] gates the
               loss term predicting token t+1 from position t; False where
               that target would be padding.  Cross-document EOS->BOS
               transitions are trained on (the packed-LM convention);
               ``train.lm_loss`` consumes this same indexing.
    """

    tokens: Any
    loss_mask: Any


def pack_documents(
    docs: Iterable[Sequence[int]],
    seq_len: int,
    pad_id: int = 0,
) -> Iterator[Batch]:
    """Greedily pack token sequences into fixed [seq_len] rows.

    Documents are concatenated back to back; a document longer than
    ``seq_len`` spans several rows.  The final partial row is padded with
    ``pad_id`` and those positions are masked out of the loss.  Yields one
    row at a time (see ``batches``).
    """
    if seq_len < 2:
        raise ValueError("seq_len must be >= 2 (need a target per position)")
    buf: List[int] = []
    for doc in docs:
        buf.extend(int(t) for t in doc)
        while len(buf) >= seq_len:
            row = np.asarray(buf[:seq_len], dtype=np.int32)
            del buf[:seq_len]
            yield Batch(tokens=row, loss_mask=np.ones((seq_len,), dtype=bool))
    if buf:
        row = np.full((seq_len,), pad_id, dtype=np.int32)
        row[: len(buf)] = buf
        mask = np.zeros((seq_len,), dtype=bool)
        # The loss target of position i is token i+1, so the last real
        # position's target is padding: mask it too.
        mask[: max(len(buf) - 1, 0)] = True
        del buf[:]
        yield Batch(tokens=row, loss_mask=mask)


def batches(
    docs: Iterable[Sequence[int]],
    batch_size: int,
    seq_len: int,
    pad_id: int = 0,
    drop_remainder: bool = True,
    seed: Optional[int] = None,
    shuffle_buffer: int = 0,
) -> Iterator[Batch]:
    """Assemble packed rows into [batch_size, seq_len] batches.

    ``shuffle_buffer > 0`` shuffles packed rows through a bounded buffer
    with a deterministic RNG (``seed``).
    """
    rows = pack_documents(docs, seq_len, pad_id)
    if shuffle_buffer > 0:
        rows = _buffered_shuffle(rows, shuffle_buffer, seed or 0)

    toks: List[np.ndarray] = []
    masks: List[np.ndarray] = []
    for row in rows:
        toks.append(row.tokens)
        masks.append(row.loss_mask)
        if len(toks) == batch_size:
            yield Batch(tokens=np.stack(toks), loss_mask=np.stack(masks))
            toks, masks = [], []
    if toks and not drop_remainder:
        # Static shapes: pad the last batch with fully masked rows rather
        # than emitting a ragged batch.
        pad_rows = batch_size - len(toks)
        toks.extend(np.full((seq_len,), pad_id, dtype=np.int32)
                    for _ in range(pad_rows))
        masks.extend(np.zeros((seq_len,), dtype=bool)
                     for _ in range(pad_rows))
        yield Batch(tokens=np.stack(toks), loss_mask=np.stack(masks))


def _buffered_shuffle(rows: Iterator[Batch], buffer: int,
                      seed: int) -> Iterator[Batch]:
    rng = np.random.RandomState(seed)
    pool: List[Batch] = []
    for row in rows:
        pool.append(row)
        if len(pool) >= buffer:
            i = rng.randint(len(pool))
            pool[i], pool[-1] = pool[-1], pool[i]
            yield pool.pop()
    rng.shuffle(pool)
    yield from pool


def shard_batch(batch: Batch, mesh: Any) -> Batch:
    """This rank's rows of a global host batch on its mesh device (JAX
    :129): the batch dimension splits over ``("data", "fsdp")`` in the
    axes' rank order, every other axis holds every row (tokens int32,
    loss_mask bool).  Every rank passes the same global batch."""
    from .parallel.mesh import ROWS

    n, i = mesh.axis_size(ROWS), mesh.axis_index(ROWS)
    B = np.shape(batch.tokens)[0]
    if B % n:
        raise ValueError(
            f"data*fsdp={n} must divide the batch of {B} rows")
    rows = slice(i * (B // n), (i + 1) * (B // n))
    return Batch(
        tokens=torch.as_tensor(np.asarray(batch.tokens)[rows],
                               dtype=torch.int32, device=mesh.device),
        loss_mask=torch.as_tensor(np.asarray(batch.loss_mask)[rows],
                                  dtype=torch.bool, device=mesh.device),
    )


def to_device(batch: Batch, device="cuda", mesh: Any = None) -> Batch:
    """Copy a host batch onto ``device`` (tokens int32, loss_mask bool);
    with ``mesh``, ``shard_batch``."""
    if mesh is not None:
        return shard_batch(batch, mesh)
    device = resolve_device(device)
    return Batch(
        tokens=torch.as_tensor(batch.tokens, dtype=torch.int32, device=device),
        loss_mask=torch.as_tensor(batch.loss_mask, dtype=torch.bool,
                                  device=device),
    )
